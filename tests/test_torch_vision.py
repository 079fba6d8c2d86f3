"""The port's ``vision`` package against the JAX package's, on the CPU:
the model zoo (one forward per family, the weights carried from the
reference by ``convert.zoo_from_jax``), every transform (the random ones
replayed from one numpy seed) and every dataset reader over files this
test writes in the published formats.

The reference models are built under a global initializer of numpy
zeros (its own per-parameter draws, and even ``Constant``, compile one
XLA program per shape), given seeded
numpy weights and statistics, and run under one ``jax.jit`` per family:
its eager forward compiles every layer's operations one by one, several
times slower than one program. Each family runs at its smallest scale
and the smallest input its layers take; VGG and AlexNet run without
their fully connected heads (``num_classes=0``), whose 25088 x 4096 and
9216 x 4096 layers would take most of the file's time to make.

Tolerance (float32, eval mode): the largest difference at most 1e-4 of
the largest logit. The transforms are the same numpy arithmetic in both
packages and must agree exactly.
"""
import gzip
import io
import pickle
import struct
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.layer import buffer_state, functional_call, param_state
from paddle_tpu.vision import datasets as JD
from paddle_tpu.vision import models as JM
from paddle_tpu.vision import transforms as JT
from paddle_tpu_torch import vision
from paddle_tpu_torch.convert import zoo_from_jax
from paddle_tpu_torch.vision import datasets as TD
from paddle_tpu_torch.vision import models as TM
from paddle_tpu_torch.vision import transforms as TT

ZOO_RTOL = 1e-4  # of the largest |logit|


class _NumpyZeros(JI.Initializer):
    """Zeros made by numpy: a placeholder the seeded state replaces."""

    def __call__(self, key, shape, dtype):
        return jnp.asarray(np.zeros(shape, np.float32))


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the tier-1 run puts six test processes on
    the machine's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_namespaces_hold_the_reference_all():
    import paddle_tpu.vision as jv

    for name in ("models", "transforms", "datasets", "ops"):
        assert name in vision.__all__
    for mod in ("models", "transforms", "datasets"):
        want = set(getattr(jv, mod).__all__)
        got = getattr(vision, mod)
        assert want == set(got.__all__)
        assert all(hasattr(got, n) for n in want)


# ------------------------------------------------------------------ zoo
# family: (constructor, kwargs, input shape)
ZOO = {
    "lenet": ("LeNet", dict(num_classes=10), (2, 1, 28, 28)),
    "vgg": ("vgg11", dict(batch_norm=True, num_classes=0), (1, 3, 32, 32)),
    "mobilenet_v1": ("mobilenet_v1", dict(scale=0.25, num_classes=5),
                     (1, 3, 32, 32)),
    "mobilenet_v2": ("mobilenet_v2", dict(scale=0.25, num_classes=5),
                     (1, 3, 32, 32)),
    "mobilenet_v3_small": ("mobilenet_v3_small",
                           dict(scale=0.25, num_classes=5), (1, 3, 32, 32)),
    "mobilenet_v3_large": ("mobilenet_v3_large",
                           dict(scale=0.25, num_classes=5), (1, 3, 32, 32)),
    "alexnet": ("alexnet", dict(num_classes=0), (1, 3, 64, 64)),
    "squeezenet": ("squeezenet1_1", dict(num_classes=5), (1, 3, 48, 48)),
    "shufflenet_v2": ("shufflenet_v2_swish", dict(num_classes=5),
                      (1, 3, 32, 32)),
    "densenet": ("densenet121", dict(num_classes=5), (1, 3, 32, 32)),
    "googlenet": ("googlenet", dict(num_classes=5), (1, 3, 32, 32)),
    "inception_v3": ("inception_v3", dict(num_classes=5), (1, 3, 75, 75)),
}


def _seeded_state(jm, seed):
    """Numpy weights for every entry of ``jm``'s state: each weight
    normal with variance 1 / fan-in, BatchNorm means normal(0, 0.2) and
    variances uniform on [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("_mean"):
            a = rng.normal(0.0, 0.2, shape)
        elif k.endswith("_variance"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            a = rng.normal(0.0, 1.0 / np.sqrt(max(fan_in, 1)), shape)
        state[k] = a.astype(np.float32)
    return state


@pytest.mark.parametrize("family", list(ZOO))
def test_zoo_forward_matches_the_reference(family):
    ctor, kw, shape = ZOO[family]
    JI.set_global_initializer(_NumpyZeros(), _NumpyZeros())
    try:
        jm = getattr(JM, ctor)(**kw)
    finally:
        JI.set_global_initializer(None, None)
    jm.eval()
    state = _seeded_state(jm, 7)
    missing, unexpected = jm.set_state_dict(
        {k: jnp.asarray(v) for k, v in state.items()})
    assert not missing and not unexpected
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    f = jax.jit(lambda p, b, a: functional_call(jm, p, b, a)[0])
    want = np.asarray(f(param_state(jm), buffer_state(jm), jnp.asarray(x)))

    tm = zoo_from_jax(state, ctor, device="cpu", **kw)
    assert not tm.training
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ZOO_RTOL * scale)


def test_zoo_state_names_and_constructors():
    """Every constructor builds (the largest ones' names checked against
    a twin on a meta device would cost the same: these are the small
    ones), ``pretrained=True`` raises, and a state missing a name is
    refused by name."""
    g = torch.Generator().manual_seed(0)
    m = TM.shufflenet_v2_x0_5(num_classes=3, device="cpu", generator=g)
    assert m(torch.zeros(1, 3, 32, 32)).shape == (1, 3)
    with pytest.raises(ValueError, match="pretrained"):
        TM.mobilenet_v3_small(pretrained=True, device="cpu")
    with pytest.raises(ValueError, match="version"):
        TM.SqueezeNet("2.0", device="cpu")
    state = {k: v.numpy() for k, v in TM.LeNet(device="cpu").state_dict()
             .items()}
    state.pop("fc.2.bias")
    with pytest.raises(KeyError, match="fc.2.bias"):
        zoo_from_jax(state, "LeNet", device="cpu")
    # the constructor table is the reference's
    ctors = [n for n in JM.__all__ if n[0].islower()]
    assert all(callable(getattr(TM, n)) for n in ctors)


# ------------------------------------------------------------ transforms
def _img(seed=0, shape=(20, 28, 3), dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.random(shape).astype(dtype)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


FUNCTIONAL = [
    ("resize", ((12, 17),), {}),
    ("resize", (9,), {"interpolation": "nearest"}),
    ("resize", (31,), {}),
    ("crop", (2, 3, 10, 11), {}),
    ("center_crop", (8,), {}),
    ("hflip", (), {}),
    ("vflip", (), {}),
    ("pad", (2,), {"fill": 9}),
    ("pad", ((1, 2),), {"padding_mode": "reflect"}),
    ("pad", ((1, 2, 3, 4),), {"padding_mode": "edge"}),
    ("normalize", ([10.0, 20.0, 30.0], [2.0, 3.0, 4.0]),
     {"data_format": "HWC"}),
    ("to_tensor", (), {}),
    ("adjust_brightness", (1.3,), {}),
    ("adjust_contrast", (0.7,), {}),
    ("adjust_saturation", (1.6,), {}),
    ("adjust_hue", (0.2,), {}),
    ("to_grayscale", (3,), {}),
    ("erase", (2, 3, 4, 5, 7), {}),
    ("rotate", (30,), {}),
    ("rotate", (45,), {"expand": True, "interpolation": "nearest"}),
    ("affine", (15, (2, -3), 1.1, (5, 3)), {}),
    ("perspective", ([(0, 0), (27, 0), (27, 19), (0, 19)],
                     [(2, 1), (25, 0), (26, 18), (1, 19)]), {}),
]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("name,args,kwargs", FUNCTIONAL,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(FUNCTIONAL)])
def test_functional_transform(name, args, kwargs, dtype):
    img = _img(1, dtype=dtype)
    _same(getattr(TT, name)(img, *args, **kwargs),
          getattr(JT, name)(img, *args, **kwargs))


def _pipelines(T):
    return [
        T.Compose([T.Resize((24, 24)), T.CenterCrop(20), T.ToTensor(),
                   T.Normalize([0.5, 0.4, 0.3], [0.2, 0.2, 0.2])]),
        T.Compose([T.RandomResizedCrop(16), T.RandomHorizontalFlip(),
                   T.RandomVerticalFlip(0.7), T.Transpose()]),
        T.RandomCrop(16, padding=2, pad_if_needed=True),
        T.Pad(3, fill=1),
        T.BrightnessTransform(0.4),
        T.ColorJitter(0.3, 0.3, 0.3, 0.1),
        T.Grayscale(3),
        T.RandomRotation(20),
        T.RandomAffine(10, translate=(0.1, 0.2), scale=(0.9, 1.1),
                       shear=(-5, 5, -3, 3)),
        T.RandomPerspective(prob=1.0),
        T.RandomErasing(prob=1.0, value=3),
        T.ContrastTransform(0.5),
        T.SaturationTransform(0.5),
        T.HueTransform(0.3),
    ]


def test_transform_pipelines_replay_from_one_seed():
    """Every transform class, the random ones drawing from np.random as
    the reference's do: the same seed gives the same images."""
    img = _img(2)
    for i, (ours, ref) in enumerate(zip(_pipelines(TT), _pipelines(JT))):
        np.random.seed(100 + i)
        got = ours(img)
        np.random.seed(100 + i)
        _same(got, ref(img))
    base = TT.BaseTransform(keys=("image", "label"))
    base._apply_image = lambda im: im[:2]
    out = base((img, 5, "extra"))
    assert out[1] == 5 and out[2] == "extra" and out[0].shape == (2, 28, 3)


# ------------------------------------------------------------- datasets
def _both(cls_name, *args, **kwargs):
    return getattr(TD, cls_name)(*args, **kwargs), \
        getattr(JD, cls_name)(*args, **kwargs)


def _same_samples(ours, ref):
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        for a, b in zip(ours[i], ref[i]):
            _same(a, b)


def _idx(path, magic, dims, data, gz):
    raw = struct.pack(">I" + "I" * len(dims), magic, *dims) + data.tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(raw)


def test_fake_data_and_mnist_readers(tmp_path):
    _same_samples(*_both("FakeData", num_samples=4, image_shape=(1, 6, 6),
                         num_classes=3, seed=5))
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 5).astype(np.uint8)
    for gz in (False, True):
        ext = ".gz" if gz else ""
        ip, lp = tmp_path / f"img{ext}", tmp_path / f"lab{ext}"
        _idx(str(ip), 2051, (5, 28, 28), imgs, gz)
        _idx(str(lp), 2049, (5,), labels, gz)
        for cls in ("MNIST", "FashionMNIST"):
            _same_samples(*_both(cls, str(ip), str(lp),
                                 transform=TT.ToTensor()))
    _idx(str(tmp_path / "bad"), 7, (5, 28, 28), imgs, False)
    with pytest.raises(ValueError, match="magic"):
        TD.MNIST(str(tmp_path / "bad"), str(lp))


def _cifar_tar(path, members, label_key):
    rng = np.random.default_rng(4)
    with tarfile.open(path, "w:gz") as tar:
        for name in members:
            blob = pickle.dumps({b"data": rng.integers(
                0, 256, (3, 3072)).astype(np.uint8),
                label_key: [int(v) for v in rng.integers(0, 10, 3)]})
            info = tarfile.TarInfo(f"cifar/{name}")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))


def test_cifar_readers(tmp_path):
    c10 = str(tmp_path / "c10.tar.gz")
    _cifar_tar(c10, [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"],
               b"labels")
    c100 = str(tmp_path / "c100.tar.gz")
    _cifar_tar(c100, ["train", "test"], b"fine_labels")
    for mode in ("train", "test"):
        _same_samples(*_both("Cifar10", c10, mode=mode))
        _same_samples(*_both("Cifar100", c100, mode=mode))
    with pytest.raises(FileNotFoundError):
        TD.Cifar10(str(tmp_path / "absent.tar.gz"))


def _jpeg(path, seed, size=(10, 12)):
    from PIL import Image

    Image.fromarray(_img(seed, size + (3,))).save(path, quality=95)


def test_folder_readers(tmp_path):
    from PIL import Image

    def pil_loader(path):
        return np.asarray(Image.open(path).convert("RGB"))

    for c, cls in enumerate(("cat", "dog")):
        d = tmp_path / cls
        d.mkdir()
        for i in range(2):
            np.save(d / f"{i}.npy", _img(10 * c + i, (6, 6, 3)))
        _jpeg(str(d / "x.jpg"), 20 + c)
        (d / "notes.txt").write_text("skipped")
    ours, ref = _both("DatasetFolder", str(tmp_path), extensions=(".npy",))
    assert ours.classes == ref.classes == ["cat", "dog"]
    _same_samples(ours, ref)
    _same_samples(*_both("DatasetFolder", str(tmp_path), loader=lambda p: (
        np.load(p) if p.endswith(".npy") else pil_loader(p))))
    _same_samples(*_both("ImageFolder", str(tmp_path), loader=lambda p: (
        np.load(p) if p.endswith(".npy") else pil_loader(p))))
    with pytest.raises(ValueError, match="decoder"):
        TD.ImageFolder(str(tmp_path))[2]


def test_flowers_and_voc_readers(tmp_path):
    import scipy.io as sio
    from PIL import Image

    jpg = tmp_path / "jpg"
    jpg.mkdir()
    for i in range(1, 5):
        _jpeg(str(jpg / f"image_{i:05d}.jpg"), i)
    sio.savemat(str(tmp_path / "labels.mat"),
                {"labels": np.array([[3, 1, 2, 3]])})
    sio.savemat(str(tmp_path / "setid.mat"),
                {"trnid": np.array([[1, 3]]), "valid": np.array([[2]]),
                 "tstid": np.array([[4]])})
    for mode in ("train", "valid", "test"):
        _same_samples(*_both("Flowers", str(jpg), str(tmp_path / "labels.mat"),
                             str(tmp_path / "setid.mat"), mode=mode))
    voc = tmp_path / "VOC2012"
    for sub in ("ImageSets/Segmentation", "JPEGImages", "SegmentationClass"):
        (voc / sub).mkdir(parents=True)
    (voc / "ImageSets/Segmentation/train.txt").write_text("a\nb\n")
    (voc / "ImageSets/Segmentation/val.txt").write_text("b\n")
    for i, name in enumerate("ab"):
        _jpeg(str(voc / "JPEGImages" / f"{name}.jpg"), 30 + i)
        Image.fromarray(_img(40 + i, (10, 12)) % 21).save(
            str(voc / "SegmentationClass" / f"{name}.png"))
    for mode in ("train", "valid"):
        _same_samples(*_both("VOC2012", str(voc), mode=mode))

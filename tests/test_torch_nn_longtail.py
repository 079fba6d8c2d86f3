"""The rest of ``nn`` against the JAX package, on the CPU: the functions
``nn.functional`` gained (one parity case each, parametrised where cases
repeat each other), the common layer classes, ``HSigmoidLoss`` and the
``nn.utils`` reparametrizations, on the same seeded numpy inputs.

Tolerances (float32): elementwise and reshaping functions rtol 1e-6 /
atol 1e-6; reductions, resizes and losses rtol 1e-5 / atol 1e-5 (sums
taken in another order). The sampled functions (``gumbel_softmax``,
``alpha_dropout``, ``dropout2d``, ``dropout3d``, ``class_center_sample``)
draw from torch's generators, not JAX's, so they hold the reference's
invariants instead of its bits: a keep rate within five binomial
standard deviations, dropped values where the reference puts them, a
one-hot hard sample with the soft sample's gradient, every positive
class kept and remapped consistently.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.layer import buffer_state, functional_call, param_state
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn import utils as jutils
from paddle_tpu_torch.nn import utils as tutils

EXACT = dict(rtol=1e-6, atol=1e-6)
CLOSE = dict(rtol=1e-5, atol=1e-5)


class _NumpyZeros(JI.Initializer):
    """Zeros made by numpy: the reference's own draws compile one program
    per shape, and every layer here is given seeded weights after."""

    def __call__(self, key, shape, dtype):
        return jnp.asarray(np.zeros(shape, np.float32))


@pytest.fixture(autouse=True, scope="module")
def numpy_initializer():
    JI.set_global_initializer(_NumpyZeros(), _NumpyZeros())
    yield
    JI.set_global_initializer(None, None)


def _rand(shape, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _to_j(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _to_t(a):
    return torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a


def _check(got, want, tol):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w, tol)
        return
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **tol)


def _reference(fn, args, kwargs):
    """``fn(*args, **kwargs)`` of the reference, compiled once: its float
    arrays traced, everything else (ids, sizes, tables) held constant.
    One program per call costs less than the eager calls' one program
    per operation."""
    traced = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)
              and np.issubdtype(a.dtype, np.floating)]

    def call(*xs):
        full = list(args)
        for i, x in zip(traced, xs):
            full[i] = x
        return fn(*full, **kwargs)

    return jax.jit(call)(*[jnp.asarray(args[i]) for i in traced])


def _parity(name, args, kwargs=None, tol=EXACT):
    """``name`` from both packages on the same numpy arguments."""
    kwargs = kwargs or {}
    want = _reference(getattr(JF, name), args, kwargs)
    got = getattr(TF, name)(*[_to_t(a) for a in args], **kwargs)
    _check(got, want, tol)
    return got


X = _rand((3, 5), 1)
IMG = _rand((2, 3, 6, 7), 2)
LABELS = np.array([1, 0, 3, 2], np.int64)

CASES = [
    ("relu_", (X,), {}, EXACT),
    ("tanh_", (X,), {}, EXACT),
    ("softmax_", (X,), {"axis": 0}, EXACT),
    ("elu_", (X,), {"alpha": 0.7}, EXACT),
    ("softplus_", (X * 30,), {}, EXACT),
    ("embedding", (np.array([[0, 2, 5], [2, 1, 9]]), _rand((10, 4), 3)),
     {"padding_idx": 2}, EXACT),
    ("label_smooth", (np.eye(5, dtype=np.float32)[[0, 3, 1]],), {}, EXACT),
    ("label_smooth", (np.eye(5, dtype=np.float32)[[0, 3]],),
     {"prior_dist": _rand((5,), 4, 0, 1), "epsilon": 0.2}, EXACT),
    ("normalize", (_rand((3, 4, 5), 5),), {}, CLOSE),
    ("normalize", (_rand((3, 4, 5), 5),), {"p": 1, "axis": -1}, CLOSE),
    ("pixel_shuffle", (_rand((2, 8, 3, 4), 6), 2), {}, EXACT),
    ("pixel_shuffle", (_rand((2, 3, 4, 8), 6), 2), {"data_format": "NHWC"},
     EXACT),
    ("pixel_unshuffle", (_rand((2, 2, 6, 4), 7), 2), {}, EXACT),
    ("pixel_unshuffle", (_rand((2, 6, 4, 2), 7), 2),
     {"data_format": "NHWC"}, EXACT),
    ("channel_shuffle", (_rand((2, 6, 3, 2), 8), 3), {}, EXACT),
    ("channel_shuffle", (_rand((2, 3, 2, 6), 8), 2),
     {"data_format": "NHWC"}, EXACT),
    ("unfold", (IMG, [2, 3]), {"strides": [1, 2], "paddings": 1,
                               "dilations": [2, 1]}, EXACT),
    ("fold", (_rand((2, 12, 20), 9), [4, 5], [2, 2]),
     {"strides": 1, "paddings": [1, 0]}, CLOSE),
    ("zeropad2d", (IMG, [1, 2, 0, 3]), {}, EXACT),
    ("zeropad2d", (_rand((1, 4, 5, 2), 10), 1), {"data_format": "NHWC"},
     EXACT),
    ("pad", (IMG, [1, 2, 3, 0]), {"mode": "reflect"}, EXACT),
    ("pad", (IMG, [1, 1, 2, 2]), {"value": 3.0}, EXACT),
    ("temporal_shift", (_rand((4, 8, 2, 2), 11), 2), {}, EXACT),
    ("diag_embed", (_rand((2, 3), 12),), {"offset": 1}, EXACT),
    ("diag_embed", (_rand((2, 3), 12),),
     {"offset": -1, "dim1": 0, "dim2": 2}, EXACT),
    ("pairwise_distance", (_rand((4, 6), 13), _rand((4, 6), 14)), {}, CLOSE),
    ("pairwise_distance", (_rand((4, 6), 13), _rand((4, 6), 14)),
     {"p": 1.0, "keepdim": True}, CLOSE),
    ("bilinear", (_rand((3, 4), 15), _rand((3, 5), 16), _rand((2, 4, 5), 17),
                  _rand((2,), 18)), {}, CLOSE),
    ("sequence_mask", (np.array([1, 3, 0]),), {"maxlen": 4}, EXACT),
    ("sequence_mask", (np.array([[2], [4]]),),
     {"maxlen": 5, "dtype": "int64"}, EXACT),
    ("square_error_cost", (X, _rand((3, 5), 19)), {}, EXACT),
    ("log_loss", (_rand((6, 1), 20, 0.05, 0.95),
                  (np.arange(6) % 2).astype(np.float32)[:, None]), {}, CLOSE),
    ("dice_loss", (np.asarray(jax.nn.softmax(_rand((2, 3, 3, 4), 21))),
                   np.random.default_rng(22).integers(0, 4, (2, 3, 3, 1))),
     {}, CLOSE),
    ("npair_loss", (_rand((4, 5), 23), _rand((4, 5), 24),
                    np.array([0, 1, 0, 2])), {}, CLOSE),
    ("sigmoid_focal_loss", (_rand((4, 3), 25),
                            (_rand((4, 3), 26) > 0).astype(np.float32)),
     {"normalizer": np.float32(3.0)}, CLOSE),
    ("sigmoid_focal_loss", (_rand((4, 3), 25),
                            (_rand((4, 3), 26) > 0).astype(np.float32)),
     {"reduction": "none", "gamma": 1.5, "alpha": 0.4}, CLOSE),
    ("softmax_with_cross_entropy", (_rand((4, 6), 27), LABELS[:, None]),
     {"return_softmax": True}, CLOSE),
    ("softmax_with_cross_entropy",
     (_rand((4, 6), 27), np.asarray(jax.nn.softmax(_rand((4, 6), 28)))),
     {"soft_label": True}, CLOSE),
    ("margin_cross_entropy", (_rand((4, 6), 29, -1, 1), LABELS),
     {"return_softmax": True}, CLOSE),
    ("margin_cross_entropy", (_rand((4, 6), 29, -1, 1), LABELS),
     {"margin1": 0.9, "margin2": 0.2, "margin3": 0.1, "scale": 16.0,
      "reduction": "none"}, CLOSE),
    ("hsigmoid_loss", (_rand((4, 3), 30), LABELS, 6, _rand((5, 3), 31),
                       _rand((5,), 32)), {}, CLOSE),
    ("hsigmoid_loss", (_rand((4, 3), 30), LABELS, 6, _rand((5, 3), 31)),
     {"path_table": np.array([[0, 2, -1]] * 2 + [[1, 4, 3]] * 2),
      "path_code": np.array([[1, 0, 0]] * 2 + [[0, 1, 1]] * 2)}, CLOSE),
    ("affine_grid", (_rand((2, 2, 3), 33), [2, 3, 4, 5]), {}, CLOSE),
    ("affine_grid", (_rand((2, 2, 3), 33), [2, 3, 4, 5]),
     {"align_corners": False}, CLOSE),
    ("gather_tree", (np.random.default_rng(34).integers(0, 9, (4, 2, 3)),
                     np.random.default_rng(35).integers(0, 3, (4, 2, 3))),
     {}, EXACT),
]


@pytest.mark.parametrize("name,args,kwargs,tol", CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_function_matches_the_reference(name, args, kwargs, tol):
    _parity(name, args, kwargs, tol)


def test_in_place_names_return_and_leave_the_input():
    x = torch.from_numpy(X.copy())
    for name in ("relu_", "tanh_", "softmax_", "elu_", "softplus_"):
        out = getattr(TF, name)(x)
        assert out is not x and torch.equal(x, torch.from_numpy(X))


def test_one_hot_is_float32_and_zero_outside_the_classes():
    ids = np.array([[0, 3], [-1, 5]])
    got = _parity("one_hot", (ids, 4))
    assert got.dtype == torch.float32 and float(got[1].sum()) == 0.0


def test_sequence_mask_needs_maxlen():
    with pytest.raises(ValueError):
        TF.sequence_mask(torch.tensor([1, 2]))


# interpolate: each mode up and down, both layouts, align_corners
RESIZE = [
    ("nearest", False, (13, 9), "NCHW"),
    ("nearest", False, (3, 4), "NCHW"),
    ("nearest", True, (5, 11), "NHWC"),
    ("bilinear", False, (13, 9), "NCHW"),
    ("bilinear", False, (3, 4), "NHWC"),
    ("bilinear", True, (13, 3), "NCHW"),
    ("bicubic", False, (14, 10), "NCHW"),
    ("bicubic", False, (4, 3), "NCHW"),
    ("bicubic", True, (9, 12), "NCHW"),
    ("area", False, (3, 2), "NCHW"),
    ("area", False, (12, 14), "NHWC"),
]


@pytest.mark.parametrize("mode,align,size,fmt", RESIZE)
def test_interpolate_2d(mode, align, size, fmt):
    x = IMG if fmt == "NCHW" else IMG.transpose(0, 2, 3, 1).copy()
    _parity("interpolate", (x,), dict(size=size, mode=mode,
                                      align_corners=align,
                                      data_format=fmt), CLOSE)


@pytest.mark.parametrize("mode,scale", [("linear", 2.5), ("nearest", 0.5)])
def test_interpolate_1d_and_upsample(mode, scale):
    x = _rand((2, 3, 8), 36)
    _parity("upsample", (x,), dict(scale_factor=scale, mode=mode,
                                   data_format="NCW"), CLOSE)


def test_interpolate_trilinear():
    x = _rand((1, 2, 4, 5, 6), 37)
    _parity("interpolate", (x,), dict(size=(6, 3, 7), mode="trilinear",
                                      data_format="NCDHW"), CLOSE)
    _parity("interpolate", (x,), dict(scale_factor=(1.5, 0.6, 2.0),
                                      mode="trilinear", align_corners=True,
                                      data_format="NCDHW"), CLOSE)


GRID = [("bilinear", "zeros", True), ("bilinear", "border", False),
        ("bilinear", "reflection", True), ("bilinear", "reflection", False),
        ("nearest", "zeros", False), ("nearest", "reflection", True)]


@pytest.mark.parametrize("mode,padding,align", GRID)
def test_grid_sample(mode, padding, align):
    grid = _rand((2, 4, 3, 2), 38, -1.3, 1.3)
    _parity("grid_sample", (IMG, grid), dict(mode=mode, padding_mode=padding,
                                             align_corners=align), CLOSE)


def test_sparse_attention_masks_by_csr_rows():
    q, k, v = (_rand((1, 2, 4, 3), s) for s in (39, 40, 41))
    # head 0: a banded pattern; head 1: row 2 keeps nothing (averages V)
    offs = np.array([[[0, 1, 3, 5, 7], [0, 2, 4, 4, 6]]])
    cols = np.array([[[0, 0, 1, 1, 2, 2, 3], [0, 1, 1, 2, 0, 3, 0]]])
    got = _parity("sparse_attention", (q, k, v, offs, cols), {}, CLOSE)
    np.testing.assert_allclose(got[0, 1, 2].numpy(), v[0, 1].mean(0),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ sampled functions
def _binomial_ok(kept, n, p_keep):
    return abs(kept - n * p_keep) <= 5 * math.sqrt(n * p_keep * (1 - p_keep))


def test_dropout2d_and_3d_drop_whole_channels():
    for fn, shape, fmt in ((TF.dropout2d, (8, 16, 5, 5), "NCHW"),
                           (TF.dropout3d, (8, 16, 3, 3, 3), "NCDHW")):
        x = torch.ones(shape)
        y = fn(x, p=0.3, data_format=fmt)
        per_channel = y.flatten(2)
        assert torch.all((per_channel == 0).all(-1)
                         | (per_channel - 1 / 0.7).abs().lt(1e-6).all(-1))
        kept = int((per_channel[..., 0] != 0).sum())
        assert _binomial_ok(kept, 8 * 16, 0.7)
        assert torch.equal(fn(x, p=0.3, training=False), x)
    # channels-last drops along the last axis
    y = TF.dropout2d(torch.ones(8, 5, 5, 16), p=0.5, data_format="NHWC")
    assert torch.all((y == y[:, :1, :1, :]).all())


def test_alpha_dropout_rate_and_values():
    x = torch.from_numpy(_rand((200, 50), 42))
    p = 0.2
    y = TF.alpha_dropout(x, p=p)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = 1.0 / math.sqrt((1 - p) * (1 + p * alpha_p ** 2))
    b = -a * alpha_p * p
    kept = (y - (a * x + b)).abs() < 1e-5
    dropped = (y - (a * alpha_p + b)).abs() < 1e-5
    assert bool((kept | dropped).all())
    assert _binomial_ok(int(kept.sum()), x.numel(), 1 - p)
    assert torch.equal(TF.alpha_dropout(x, p, training=False), x)
    # the layer wraps it
    layer = tnn.AlphaDropout(p).eval()
    assert torch.equal(layer(x), x)


def test_gumbel_softmax_samples_and_straight_through():
    x = torch.from_numpy(_rand((64, 7), 43)).requires_grad_()
    soft = TF.gumbel_softmax(x, temperature=0.5)
    torch.testing.assert_close(soft.sum(-1), torch.ones(64))
    hard = TF.gumbel_softmax(x, temperature=0.5, hard=True)
    assert torch.equal(hard.sum(-1), torch.ones(64))
    assert set(hard.unique().tolist()) == {0.0, 1.0}
    w = torch.from_numpy(_rand((64, 7), 44))
    (g_hard,) = torch.autograd.grad((hard * w).sum(), x)
    assert g_hard.abs().sum() > 0
    # straight-through: the hard sample's gradient is the soft one's of
    # the same draw
    from paddle_tpu_torch.nn.layer import rng_context

    with rng_context({"gumbel": 5}):
        s = TF.gumbel_softmax(x, 0.5)
    with rng_context({"gumbel": 5}):
        h = TF.gumbel_softmax(x, 0.5, hard=True)
    (gs,) = torch.autograd.grad((s * w).sum(), x)
    (gh,) = torch.autograd.grad((h * w).sum(), x)
    torch.testing.assert_close(gh, gs)
    assert torch.equal(h.argmax(-1), s.argmax(-1))


def test_class_center_sample_keeps_positives_and_remaps():
    from paddle_tpu_torch.framework import random as framework_random

    label = torch.tensor([7, 2, 7, 11, 2, 0])
    framework_random.seed(3)
    remapped, sampled = TF.class_center_sample(label, 20, 8)
    assert sampled.dtype == torch.int64 and sampled.numel() == 8
    pos = sorted(set(label.tolist()))
    assert sampled[:len(pos)].tolist() == pos
    neg = sampled[len(pos):].tolist()
    assert neg == sorted(neg) and not set(neg) & set(pos)
    assert torch.equal(sampled[remapped], label)
    framework_random.seed(3)
    again = TF.class_center_sample(label, 20, 8)
    assert torch.equal(again[1], sampled)
    # the reference's own draw keeps the same invariants
    jr, js = JF.class_center_sample(np.asarray(label), 20, 8)
    assert np.array_equal(np.asarray(js)[np.asarray(jr)], label.numpy())
    assert np.asarray(js)[:len(pos)].tolist() == pos


# ------------------------------------------------------------------ layers
def _layer_pair(name, args, kwargs, seed=0):
    jl = getattr(jnn, name)(*args, **kwargs)
    tl = getattr(tnn, name)(*args, **kwargs)
    state = {k: _rand(tuple(v.shape), seed + i)
             for i, (k, v) in enumerate(sorted(jl.state_dict().items()))}
    if state:
        jl.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
        tl.load_state_dict({k: torch.from_numpy(v) for k, v in
                            state.items()})
    return jl.eval(), tl.eval()


LAYERS = [
    ("Flatten", (), {}, [(2, 3, 4, 5)]),
    ("Flatten", (0, 2), {}, [(2, 3, 4, 5)]),
    ("Identity", (3, "ignored"), {"k": 1}, [(2, 3)]),
    ("Upsample", (), {"scale_factor": 2, "mode": "bilinear"}, [(1, 2, 3, 4)]),
    ("UpsamplingBilinear2D", ((5, 7),), {}, [(1, 2, 3, 4)]),
    ("UpsamplingNearest2D", (None, 3), {}, [(1, 2, 3, 4)]),
    ("Pad1D", ([1, 2],), {"mode": "replicate"}, [(2, 3, 5)]),
    ("Pad2D", ([1, 0, 2, 1],), {"value": 2.0}, [(1, 2, 3, 4)]),
    ("Pad3D", ([1, 1, 0, 1, 2, 0],), {"mode": "circular"},
     [(1, 2, 3, 3, 4)]),
    ("ZeroPad2D", ([2, 1, 0, 1],), {}, [(1, 2, 3, 4)]),
    ("CosineSimilarity", (), {"axis": 2}, [(2, 3, 4), (2, 3, 4)]),
    ("PixelShuffle", (2,), {}, [(1, 8, 2, 3)]),
    ("PixelUnshuffle", (2,), {}, [(1, 2, 4, 6)]),
    ("Unfold", ([2, 2],), {"strides": 2}, [(1, 3, 4, 6)]),
    ("Fold", ([4, 6], [2, 2]), {"strides": 2}, [(1, 12, 6)]),
    ("Bilinear", (4, 5, 3), {}, [(2, 4), (2, 5)]),
    ("PairwiseDistance", (), {"p": 3.0}, [(3, 4), (3, 4)]),
    ("ChannelShuffle", (2,), {}, [(1, 4, 2, 2)]),
    ("Dropout2D", (0.5,), {}, [(2, 3, 4, 4)]),
    ("Dropout3D", (0.5,), {}, [(2, 3, 2, 2, 2)]),
    ("AlphaDropout", (0.5,), {}, [(4, 5)]),
]


@pytest.mark.parametrize("name,args,kwargs,shapes", LAYERS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(LAYERS)])
def test_layer_matches_the_reference(name, args, kwargs, shapes):
    """Eval mode (the dropouts are the identity there; their training
    draws are the functions' invariants above)."""
    jl, tl = _layer_pair(name, args, kwargs)
    xs = [_rand(s, 50 + i) for i, s in enumerate(shapes)]
    want = jax.jit(lambda p, b, *a: functional_call(jl, p, b, *a)[0])(
        param_state(jl), buffer_state(jl), *[jnp.asarray(x) for x in xs])
    got = tl(*[torch.from_numpy(x) for x in xs])
    _check(got, want, CLOSE)


def test_bilinear_and_hsigmoid_parameters_keep_the_reference_layout():
    jl = jnn.Bilinear(4, 5, 3)
    tl = tnn.Bilinear(4, 5, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in jl.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in tl.state_dict().items()}
    assert tnn.Bilinear(4, 5, 3, bias_attr=False).bias is None
    jh, th = _layer_pair("HSigmoidLoss", (3, 6), {})
    assert tuple(th.weight.shape) == (5, 3) and tuple(th.bias.shape) == (5,)
    x = _rand((4, 3), 60)
    _check(th(torch.from_numpy(x), torch.from_numpy(LABELS)),
           jh(jnp.asarray(x), jnp.asarray(LABELS)), CLOSE)


# ---------------------------------------------------------------- nn.utils
def _linear_pair(seed=0):
    jl = jnn.Linear(4, 3)
    tl = tnn.Linear(4, 3, device="cpu")
    w, b = _rand((4, 3), seed), _rand((3,), seed + 1)
    jl.set_state_dict({"weight": jnp.asarray(w), "bias": jnp.asarray(b)})
    tl.load_state_dict({"weight": torch.from_numpy(w),
                        "bias": torch.from_numpy(b)})
    return jl, tl


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_and_its_removal(dim):
    jl, tl = _linear_pair(61)
    jutils.weight_norm(jl, dim=dim)
    tutils.weight_norm(tl, dim=dim)
    assert sorted(n for n, _ in tl.named_parameters()) == \
        sorted(jl.state_dict()) == ["bias", "weight_g", "weight_v"]
    _check(tl.weight_g, jl.weight_g, CLOSE)
    x = _rand((2, 4), 62)
    _check(tl(torch.from_numpy(x)), jl(jnp.asarray(x)), CLOSE)
    # g trains the magnitude: double it, the output's weight term doubles
    with torch.no_grad():
        tl.weight_g.mul_(2.0)
    jl.set_state_dict({"weight_g": jl.weight_g * 2.0})
    _check(tl(torch.from_numpy(x)), jl(jnp.asarray(x)), CLOSE)
    grads = torch.autograd.grad(tl(torch.from_numpy(x)).sum(),
                                [tl.weight_g, tl.weight_v])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    jutils.remove_weight_norm(jl)
    tutils.remove_weight_norm(tl)
    assert sorted(n for n, _ in tl.named_parameters()) == ["bias", "weight"]
    _check(tl.weight, jl.weight, CLOSE)
    with pytest.raises(ValueError):
        tutils.remove_weight_norm(tl)


def test_spectral_norm_iterates_from_the_same_vectors():
    jl, tl = _linear_pair(63)
    jutils.spectral_norm(jl, n_power_iterations=2)
    tutils.spectral_norm(tl, n_power_iterations=2)
    assert sorted(n for n, _ in tl.named_parameters()) == [
        "bias", "weight_orig"]
    # the initial vectors are each generator's own draw: start both from
    # the reference's
    with torch.no_grad():
        tl.weight_u.copy_(torch.from_numpy(np.array(jl.weight_u)))
        tl.weight_v.copy_(torch.from_numpy(np.array(jl.weight_v)))
    x = _rand((2, 4), 64)
    _check(tl(torch.from_numpy(x)), jl(jnp.asarray(x)), CLOSE)
    _check(tl.weight_u, jl.weight_u, CLOSE)
    _check(tl.weight, jl.weight, CLOSE)


def test_parameters_to_vector_and_back():
    jl, tl = _linear_pair(65)
    jv = jutils.parameters_to_vector(list(jl.parameters()))
    tv = tutils.parameters_to_vector(list(tl.parameters()))
    _check(tv, jv, EXACT)
    back = tutils.vector_to_parameters(tv * 2, list(tl.parameters()))
    jback = jutils.vector_to_parameters(jv * 2, list(jl.parameters()))
    _check(back, jback, EXACT)
    assert torch.equal(tl.weight, torch.from_numpy(_rand((4, 3), 65)))

"""The port's initializers, parameter creation and containers
(paddle_tpu_torch.nn.initializer, nn.layers.common, nn.layers.containers)
against the JAX package's.

Deterministic initializers (Constant, Assign, Dirac, Bilinear) must equal
the reference exactly. Random ones cannot (jax.random and torch's
generators differ), so each is held to the distribution the reference
draws from: the same fans, bounds and scale, by its sample moments (a
sample of 2^16 values: the standard error of a standard deviation is
about 0.3 % of it, so 2 % is over six standard errors) and by its bounds,
and the reference's own sample is held to the same numbers. The global
initializer is restored after every test.
"""
import math

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.layers.common import Embedding as JaxEmbedding
from paddle_tpu.nn.layers.common import Linear as JaxLinear
from paddle_tpu.nn.layers import containers as JC
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layers import containers as C
from paddle_tpu_torch.nn.layers.common import Embedding, Linear

SHAPE = (256, 256)  # 2^16 values
MOMENT_RTOL = 0.02


@pytest.fixture(autouse=True)
def restore_global_initializer():
    yield
    I.set_global_initializer(None, None)
    JI.set_global_initializer(None, None)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _jax(init, shape=SHAPE):
    return np.asarray(init(jax.random.PRNGKey(0), shape, np.float32))


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (8, 4, 3, 3),
                                   (6, 2, 5)])
def test_fans_match_jax(shape):
    assert I._fans(shape) == JI._fans(shape)


@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.5,), (3, 4)),
    ("Assign", (np.arange(12.0).reshape(3, 4),), (3, 4)),
    ("Assign", (np.arange(12.0),), (3, 4)),
    ("Dirac", (), (4, 4, 3, 3)),
    ("Dirac", (2,), (6, 3, 3)),
    ("Bilinear", (), (2, 3, 4, 4)),
    ("Bilinear", (), (1, 1, 5, 5)),
])
def test_exact_initializers_equal_jax(name, args, shape):
    want = _jax(getattr(JI, name)(*args), shape)
    got = getattr(I, name)(*args)(shape)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bilinear_rejects_what_the_reference_rejects():
    for shape in ((3, 4, 4), (1, 1, 3, 4)):
        with pytest.raises(ValueError):
            JI.Bilinear()(None, shape, np.float32)
        with pytest.raises(ValueError):
            I.Bilinear()(shape)


def _std_and_limit(name, args):
    """The reference's scale for SHAPE: (std, bound) of the draw."""
    fin, fout = JI._fans(SHAPE)
    if name == "XavierNormal":
        return math.sqrt(2.0 / (fin + fout)), None
    if name == "XavierUniform":
        lim = math.sqrt(6.0 / (fin + fout))
        return lim / math.sqrt(3.0), lim
    if name == "KaimingNormal":
        return math.sqrt(2.0) / math.sqrt(fin), None
    if name == "KaimingUniform":
        lim = math.sqrt(2.0) * math.sqrt(3.0 / fin)
        return lim / math.sqrt(3.0), lim
    raise KeyError(name)


@pytest.mark.parametrize("name", ["XavierNormal", "XavierUniform",
                                  "KaimingNormal", "KaimingUniform"])
def test_fan_scaled_initializers_draw_the_reference_distribution(name):
    std, limit = _std_and_limit(name, ())
    got = getattr(I, name)()(SHAPE, generator=_gen()).numpy()
    want = _jax(getattr(JI, name)())
    for x in (got, want):
        assert abs(x.mean()) < 5 * std / math.sqrt(x.size)
        assert x.std() == pytest.approx(std, rel=MOMENT_RTOL)
        if limit is not None:
            assert np.abs(x).max() <= limit
            assert np.abs(x).max() > 0.99 * limit


def test_normal_uniform_and_truncated_normal_moments():
    mean, std = 0.5, 2.0
    pairs = [(I.Normal(mean, std)(SHAPE, generator=_gen()).numpy(),
              _jax(JI.Normal(mean, std)), std, None)]
    # a normal truncated at 2 sigma has std sigma * 0.8796
    trunc_std = std * math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                                / math.erf(math.sqrt(2)))
    pairs.append((I.TruncatedNormal(mean, std)(SHAPE, generator=_gen()).numpy(),
                  _jax(JI.TruncatedNormal(mean, std)), trunc_std, 2 * std))
    for got, want, s, bound in pairs:
        for x in (got, want):
            assert abs(x.mean() - mean) < 5 * s / math.sqrt(x.size)
            assert x.std() == pytest.approx(s, rel=MOMENT_RTOL)
            if bound is not None:
                assert np.abs(x - mean).max() <= bound * (1 + 1e-6)
    lo, hi = -0.25, 0.75
    for x in (I.Uniform(lo, hi)(SHAPE, generator=_gen()).numpy(),
              _jax(JI.Uniform(lo, hi))):
        assert lo <= x.min() and x.max() < hi
        assert x.mean() == pytest.approx((lo + hi) / 2, abs=0.01)


@pytest.mark.parametrize("shape", [(64, 16), (16, 64), (4, 8, 32)])
def test_orthogonal_is_orthogonal_like_jax(shape):
    gain = 1.5
    for w in (I.Orthogonal(gain)(shape, generator=_gen()).numpy(),
              _jax(JI.Orthogonal(gain), shape)):
        m = w.reshape(-1, shape[-1])
        small = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        np.testing.assert_allclose(small, gain ** 2 * np.eye(len(small)),
                                   atol=1e-5)


def test_random_initializers_replay_their_generator_and_global_seed():
    a = I.XavierUniform()((8, 8), generator=_gen(3))
    assert torch.equal(a, I.XavierUniform()((8, 8), generator=_gen(3)))
    assert not torch.equal(a, I.XavierUniform()((8, 8), generator=_gen(4)))
    trandom.seed(7)
    b = I.Normal()((8, 8))
    trandom.seed(7)
    assert torch.equal(b, I.Normal()((8, 8)))
    assert I.Normal()((4,), dtype=torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["tanh", "relu", "leaky_relu", "selu",
                                  "linear", "sigmoid"])
def test_calculate_gain_and_aliases_match_jax(name):
    assert I.calculate_gain(name) == JI.calculate_gain(name)
    assert I.calculate_gain("leaky_relu", 0.2) == \
        JI.calculate_gain("leaky_relu", 0.2)
    for alias in ("constant", "normal", "uniform", "xavier_normal",
                  "xavier_uniform", "kaiming_normal", "kaiming_uniform"):
        assert getattr(I, alias).__name__ == getattr(JI, alias).__name__


class _Attr:
    """A ParamAttr-like object carrying an initializer."""

    def __init__(self, initializer):
        self.initializer = initializer


def test_resolution_priority_matches_jax():
    for mod, const in ((JI, JI.Constant), (I, I.Constant)):
        default = const(1.0)
        assert mod._resolve_initializer(None, default) is default
        glob_w, glob_b = const(2.0), const(3.0)
        mod.set_global_initializer(glob_w, glob_b)
        assert mod._resolve_initializer(None, default) is glob_w
        assert mod._resolve_initializer(None, default, is_bias=True) is glob_b
        assert mod._resolve_initializer(False, default) is glob_w
        own = const(4.0)
        assert mod._resolve_initializer(own, default) is own
        assert mod._resolve_initializer(_Attr(own), default) is own
        mod.set_global_initializer(None)
        assert mod._resolve_initializer(_Attr(None), default) is default
    with pytest.raises(TypeError):
        I.set_global_initializer("xavier")
    with pytest.raises(TypeError):
        I.set_global_initializer(None, 0.0)


def test_linear_parameters_follow_the_reference_order():
    lin = Linear(6, 4, device="cpu", generator=_gen())
    limit = math.sqrt(6.0 / 10)
    assert lin.weight.shape == (6, 4)
    assert float(lin.weight.abs().max()) <= limit
    assert torch.equal(lin.bias, torch.zeros(4))
    I.set_global_initializer(I.Constant(0.25), I.Constant(-1.0))
    JI.set_global_initializer(JI.Constant(0.25), JI.Constant(-1.0))
    jl = JaxLinear(6, 4)
    tl = Linear(6, 4, device="cpu")
    for name in ("weight", "bias"):
        np.testing.assert_array_equal(getattr(tl, name).detach().numpy(),
                                      np.asarray(getattr(jl, name)))
    # an attribute's initializer beats the global one, on both sides
    jl = JaxLinear(6, 4, weight_attr=JI.Constant(0.5), bias_attr=False)
    tl = Linear(6, 4, weight_attr=I.Constant(0.5), bias_attr=False,
                device="cpu")
    assert jl.bias is None and tl.bias is None
    assert "bias" not in dict(tl.named_parameters())
    np.testing.assert_array_equal(tl.weight.detach().numpy(),
                                  np.asarray(jl.weight))


def test_std_keyword_draws_as_before():
    """``std=`` (the GPT and Llama blocks' draw) is ``normal_(0, std)`` on
    the given generator, a zero bias; ``has_bias=False`` drops the bias."""
    lin = Linear(5, 3, std=0.02, device="cpu", generator=_gen(9))
    want = torch.empty(5, 3).normal_(0.0, 0.02, generator=_gen(9))
    assert torch.equal(lin.weight, want)
    assert torch.equal(lin.bias, torch.zeros(3))
    assert Linear(5, 3, std=0.02, has_bias=False, device="cpu").bias is None
    emb = Embedding(7, 3, std=0.02, device="cpu", generator=_gen(9))
    assert torch.equal(emb.weight, torch.empty(7, 3).normal_(
        0.0, 0.02, generator=_gen(9)))


def test_embedding_padding_idx_matches_jax():
    trandom.seed(0)
    jemb = JaxEmbedding(10, 4, padding_idx=2)
    emb = Embedding(10, 4, padding_idx=2, device="cpu")
    assert float(emb.weight[2].abs().max()) == 0.0
    emb.weight.data = torch.from_numpy(np.array(jemb.weight))
    emb.weight.data[2] = 1.0  # a trained pad row still looks up as zeros
    jw = np.asarray(jemb.weight).copy()
    jw[2] = 1.0
    ids = np.array([[1, 2, 3], [2, 2, 9]])
    import paddle_tpu.nn.functional as JF

    want = np.asarray(JF.embedding(ids, jw, padding_idx=2))
    got = emb(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    assert float(emb.weight.grad[2].abs().max()) == 0.0
    assert float(emb.weight.grad[9].abs().max()) > 0.0


def _names(jax_layer):
    return sorted(jax_layer.state_dict())


def test_container_parameter_names_match_jax():
    def lin():
        return Linear(2, 3, device="cpu")

    cases = [
        (JC.LayerList([JaxLinear(2, 3), JaxLinear(2, 3)]),
         C.LayerList([lin(), lin()])),
        (JC.Sequential(JaxLinear(2, 3), JaxLinear(3, 3)),
         C.Sequential(lin(), Linear(3, 3, device="cpu"))),
        (JC.Sequential([("a", JaxLinear(2, 3)), ("b", JaxLinear(3, 3))]),
         C.Sequential([("a", lin()), ("b", Linear(3, 3, device="cpu"))])),
        (JC.LayerDict({"x": JaxLinear(2, 3)}), C.LayerDict({"x": lin()})),
    ]
    for jl, tl in cases:
        assert _names(jl) == sorted(dict(tl.named_parameters()))


def test_containers_behave_as_the_reference():
    layers = C.LayerList()
    layers.append(Linear(2, 2, device="cpu")).append(
        Linear(2, 2, device="cpu"))
    layers.insert(0, Linear(2, 2, device="cpu"))
    assert len(layers) == 3 and [n for n, _ in layers.named_children()] == \
        ["0", "1", "2"]
    assert isinstance(layers[1:], C.LayerList) and len(layers[1:]) == 2
    seq = C.Sequential(Linear(2, 3, device="cpu"), Linear(3, 1, device="cpu"))
    x = torch.ones(4, 2)
    assert torch.equal(seq(x), seq[1](seq[0](x)))
    assert isinstance(seq[:1], C.Sequential)
    d = C.LayerDict()
    d.update([("p", Linear(2, 2, device="cpu"))])
    d["q"] = Linear(2, 2, device="cpu")
    assert list(d) == ["p", "q"] and "q" in d
    del d["p"]
    assert list(d.keys()) == ["q"]
    params = C.ParameterList([torch.nn.Parameter(torch.zeros(2))])
    params.append(torch.nn.Parameter(torch.ones(3)))
    params[0] = np.full(2, 5.0, dtype=np.float32)
    assert len(params) == 2 and isinstance(params[0], torch.nn.Parameter)
    assert float(params[0].sum()) == 10.0
    assert [n for n, _ in params.named_parameters()] == ["0", "1"]

"""The port's normalization functions and layers against the JAX
package's, on the CPU: ``batch_norm`` in training, eval and
``use_global_stats`` modes (outputs, gradients and the running
statistics after three training forwards, paddle's momentum and the
unbiased variance), bf16 inputs with float32 statistics, O2's bf16
weights with float32 buffers (through ``amp.decorate``, ``Module.to`` and
the state-dict round trip), and the other norm layers.

Inputs are numpy arrays from seeds; weights cross by name
(``convert.layer_from_jax``). Tolerances: float32 outputs and running
statistics rtol 1e-4 / atol 1e-5, gradients rtol 2e-4 / atol 2e-5 (the
reference's); bf16 outputs rtol / atol 2e-2 (the reference's bf16
bounds, ``tests/test_torch_amp.py``).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layers import norm as JN
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import norm as TN
from paddle_tpu_torch.optimizer import Momentum

FWD = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _state(jm):
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


# (data_format, input shape, training, use_global_stats)
BN_CASES = [
    ("NCHW", (4, 3, 5, 6), True, None),
    ("NCHW", (4, 3, 5, 6), False, None),
    ("NCHW", (4, 3, 5, 6), True, True),
    ("NHWC", (4, 5, 6, 3), True, None),
    ("NCL", (6, 3, 7), True, None),
    ("NLC", (6, 7, 3), False, None),
    ("NCDHW", (2, 3, 3, 4, 5), True, None),
    ("NCL", (8, 3), True, None),
]


@pytest.mark.parametrize("case", BN_CASES,
                         ids=[f"{c[0]}-{'train' if c[2] else 'eval'}"
                              f"{'-global' if c[3] else ''}-{i}"
                              for i, c in enumerate(BN_CASES)])
def test_batch_norm_function(case):
    """Outputs, the input / weight / bias gradients and the new running
    statistics of one call."""
    fmt, shape, training, global_stats = case
    C = shape[1] if fmt.startswith("NC") else shape[-1]
    x = _rand(shape, 1, 2.0, 0.5)
    rm, rv = _rand((C,), 2) * 0.1, np.abs(_rand((C,), 3)) + 0.5
    w, b = _rand((C,), 4), _rand((C,), 5)
    kw = dict(training=training, momentum=0.8, epsilon=1e-5,
              data_format=fmt, use_global_stats=global_stats)
    out_j, vjp, (nm_j, nv_j) = jax.vjp(
        lambda a, ww, bb: JF.batch_norm(a, jnp.asarray(rm), jnp.asarray(rv),
                                        ww, bb, **kw)[0],
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)) + (
        JF.batch_norm(jnp.asarray(x), jnp.asarray(rm), jnp.asarray(rv),
                      jnp.asarray(w), jnp.asarray(b), **kw)[1:],)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    out_t, nm_t, nv_t = F.batch_norm(ts[0], torch.from_numpy(rm),
                                     torch.from_numpy(rv), ts[1], ts[2], **kw)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **FWD)
    np.testing.assert_allclose(nm_t.numpy(), np.asarray(nm_j), **FWD)
    np.testing.assert_allclose(nv_t.numpy(), np.asarray(nv_j), **FWD)
    assert not nm_t.requires_grad and not nv_t.requires_grad
    cot = _rand(out_j.shape, 6)
    g_j = vjp(jnp.asarray(cot))
    (out_t * torch.from_numpy(cot)).sum().backward()
    for gj, t in zip(g_j, ts):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), **BWD)


def test_batch_norm_momentum_and_unbiased_variance():
    """Paddle's momentum keeps ``momentum`` of the old value, and the
    running variance takes the unbiased batch variance (n / (n - 1))."""
    x = _rand((5, 2, 3), 7)
    rm, rv = torch.zeros(2), torch.ones(2)
    _, nm, nv = F.batch_norm(torch.from_numpy(x), rm, rv, training=True,
                             momentum=0.9, data_format="NCL")
    xs = x.transpose(1, 0, 2).reshape(2, -1)
    np.testing.assert_allclose(nm.numpy(), 0.1 * xs.mean(1), **FWD)
    np.testing.assert_allclose(nv.numpy(), 0.9 + 0.1 * xs.var(1, ddof=1),
                               **FWD)


@pytest.mark.parametrize("cls,fmt,shape", [
    ("BatchNorm2D", "NCHW", (4, 3, 5, 6)),
    ("BatchNorm2D", "NHWC", (4, 5, 6, 3)),
    ("BatchNorm1D", "NCL", (6, 3, 7)),
    ("BatchNorm3D", "NCDHW", (2, 3, 3, 4, 5)),
])
def test_batch_norm_layer_three_forwards(cls, fmt, shape):
    """Three training forwards on different batches move ``_mean`` and
    ``_variance`` as the reference's layer moves them (float32 buffers,
    no gradient); an eval forward then normalises by them."""
    pt.seed(1)
    jm = getattr(JN, cls)(3, momentum=0.7, data_format=fmt)
    tm = layer_from_jax(getattr(TN, cls)(3, momentum=0.7, data_format=fmt),
                        _state(jm)).train()
    jm.train()
    for i in range(3):
        x = _rand(shape, 10 + i, 1.5, 0.3 * i)
        np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(jm(jnp.asarray(x))), **FWD)
    for name in ("_mean", "_variance"):
        buf = getattr(tm, name)
        assert buf.dtype == torch.float32 and not buf.requires_grad
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(getattr(jm, name)), **FWD)
    assert not np.allclose(tm._mean.numpy(), 0.0)
    jm.eval()
    tm.eval()
    x = _rand(shape, 20)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(x))), **FWD)
    assert set(tm.state_dict()) == set(jm.state_dict())


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_bf16_input_float32_statistics(training):
    """bf16 inputs: the statistics are taken in float32 and the running
    ones stay float32; the output is bf16 with bf16 weights (O2) and
    float32 with float32 ones (JAX's promotion)."""
    x = _rand((4, 3, 5, 6), 21, 2.0, 1.0)
    rm, rv = _rand((3,), 22) * 0.1, np.abs(_rand((3,), 23)) + 0.5
    w, b = _rand((3,), 24), _rand((3,), 25)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for wdt_j, wdt_t in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
        out_j, nm_j, nv_j = JF.batch_norm(
            xj, jnp.asarray(rm), jnp.asarray(rv), jnp.asarray(w).astype(wdt_j),
            jnp.asarray(b).astype(wdt_j), training=training)
        out_t, nm_t, nv_t = F.batch_norm(
            xt, torch.from_numpy(rm), torch.from_numpy(rv),
            torch.from_numpy(w).to(wdt_t), torch.from_numpy(b).to(wdt_t),
            training=training)
        assert str(out_t.dtype).split(".")[-1] == str(out_j.dtype)
        assert nm_t.dtype == nv_t.dtype == torch.float32
        np.testing.assert_allclose(out_t.float().numpy(),
                                   np.asarray(out_j.astype(jnp.float32)),
                                   **BF16)
        np.testing.assert_allclose(nm_t.numpy(), np.asarray(nm_j), **FWD)
        np.testing.assert_allclose(nv_t.numpy(), np.asarray(nv_j), **FWD)


def test_o2_keeps_running_statistics_float32():
    """``amp.decorate`` O2 casts the BatchNorm's weight and bias to bf16
    and leaves ``_mean`` / ``_variance`` float32, as the reference's does;
    so does ``Module.to(bfloat16)`` (the reference's ``Layer.to`` casts
    parameters only), and a bf16 forward keeps updating them in
    float32."""
    pt.seed(2)
    jm = jamp.decorate(JN.BatchNorm2D(3), level="O2", dtype="bfloat16")
    assert jm.weight.dtype == jnp.bfloat16
    assert jm._mean.dtype == jnp.float32
    tm, opt = amp.decorate(TN.BatchNorm2D(3), Momentum(0.1), level="O2",
                           dtype="bfloat16")
    assert tm.weight.dtype == torch.bfloat16
    assert tm._mean.dtype == tm._variance.dtype == torch.float32
    other = TN.BatchNorm2D(3).to(torch.bfloat16)
    assert other.weight.dtype == torch.bfloat16
    assert other._mean.dtype == other._variance.dtype == torch.float32
    x = torch.from_numpy(_rand((4, 3, 5, 5), 26)).to(torch.bfloat16)
    tm.train()(x)
    assert tm._mean.dtype == torch.float32 and tm._mean.abs().sum() > 0
    # the state round trip through numpy keeps them float32
    sd = {k: v.float().numpy() for k, v in tm.state_dict().items()}
    fresh = layer_from_jax(TN.BatchNorm2D(3), sd)
    assert fresh._mean.dtype == torch.float32
    np.testing.assert_array_equal(fresh._mean.numpy(), tm._mean.numpy())


def test_batch_norm_legacy_act_and_sync():
    """The legacy ``BatchNorm(act=...)`` applies the named activation;
    ``SyncBatchNorm`` without an axis is BatchNorm, with one it raises
    naming A8; ``convert_sync_batchnorm`` keeps the state."""
    pt.seed(3)
    jm = JN.BatchNorm(3, act="relu")
    tm = layer_from_jax(TN.BatchNorm(3, act="relu"), _state(jm)).train()
    jm.train()
    x = _rand((4, 3, 5, 5), 27)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(x))), **FWD)
    sync = TN.SyncBatchNorm(3)
    sync.train()(torch.from_numpy(x))
    ref = TN.BatchNorm2D(3).train()
    ref(torch.from_numpy(x))
    np.testing.assert_array_equal(sync._mean.numpy(), ref._mean.numpy())
    with pytest.raises(NotImplementedError, match="A8"):
        TN.SyncBatchNorm(3, axis_name="data")
    seq = torch.nn.Sequential(TN.BatchNorm2D(3), torch.nn.ReLU())
    seq[0](torch.from_numpy(x))
    converted = TN.SyncBatchNorm.convert_sync_batchnorm(seq)
    assert isinstance(converted[0], TN.SyncBatchNorm)
    np.testing.assert_array_equal(converted[0]._mean.numpy(),
                                  ref._mean.numpy())


# (class, constructor args, input shape, data_format)
OTHER_CASES = [
    ("GroupNorm", (2, 6), (3, 6, 4, 5), "NCHW"),
    ("GroupNorm", (3, 6), (3, 4, 5, 6), "NHWC"),
    ("GroupNorm", (1, 4), (3, 4, 7), "NCL"),
    ("InstanceNorm1D", (4,), (3, 4, 7), "NCL"),
    ("InstanceNorm2D", (4,), (3, 4, 5, 6), "NCHW"),
    ("InstanceNorm2D", (4,), (3, 5, 6, 4), "NHWC"),
    ("InstanceNorm3D", (4,), (2, 4, 3, 4, 5), "NCDHW"),
    ("LocalResponseNorm", (3,), (2, 6, 4, 5), "NCHW"),
    ("LocalResponseNorm", (4,), (2, 4, 5, 6), "NHWC"),
]


@pytest.mark.parametrize("case", OTHER_CASES,
                         ids=[f"{c[0]}-{c[3]}-{i}" for i, c in
                              enumerate(OTHER_CASES)])
def test_other_norm_layers(case):
    """Outputs and input / parameter gradients of the group, instance and
    local-response norms."""
    cls, args, shape, fmt = case
    pt.seed(4)
    jm = getattr(JN, cls)(*args, data_format=fmt)
    tm = getattr(TN, cls)(*args, data_format=fmt)
    sd = _state(jm)
    if sd:
        # non-trivial affine parameters
        sd = {k: v + _rand(v.shape, 28) * 0.3 for k, v in sd.items()}
        jm.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
        tm = layer_from_jax(tm, sd)
    x = _rand(shape, 29, 1.5, 0.5)
    names = [k for k, _ in jm.named_parameters()]

    def jloss(params, a):
        for k, v in params.items():
            jm._set_by_path(k, v)
        return jm(a)

    params = {k: jnp.asarray(sd[k]) for k in names}
    out_j, vjp = jax.vjp(jloss, params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out_t = tm(xt)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **FWD)
    cot = _rand(out_j.shape, 30)
    g_p, g_x = vjp(jnp.asarray(cot))
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **BWD)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g_p[k]),
                                   err_msg=k, **BWD)


def test_instance_norm_without_affine_and_spectral_norm():
    x = _rand((2, 3, 6), 31)
    np.testing.assert_allclose(
        TN.InstanceNorm1D(3, weight_attr=False)(torch.from_numpy(x)).numpy(),
        np.asarray(JN.InstanceNorm1D(3, weight_attr=False)(jnp.asarray(x))),
        **FWD)
    pt.seed(5)
    jm = JN.SpectralNorm((6, 4, 3), dim=1, power_iters=3)
    tm = layer_from_jax(TN.SpectralNorm((6, 4, 3), dim=1, power_iters=3),
                        _state(jm))
    w = _rand((6, 4, 3), 32)
    np.testing.assert_allclose(tm(torch.from_numpy(w)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(w))), **FWD)


def test_bf16_state_buffer_loads_float32():
    """A buffer given as bf16 (``ml_dtypes``) still loads into the
    float32 running statistics."""
    tm = TN.BatchNorm2D(2)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    sd["_mean"] = np.asarray([0.5, -1.25], np.float32).astype(
        ml_dtypes.bfloat16)
    layer_from_jax(tm, sd)
    assert tm._mean.dtype == torch.float32
    np.testing.assert_array_equal(tm._mean.numpy(), [0.5, -1.25])

"""The port's flash-attention backward and dropout
(paddle_tpu_torch.kernels.flash_attention) against the JAX package.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas backward in interpret mode (the fixture of
tests/test_flash_attention.py, block 128). Inputs come from numpy seeds.
Tolerance: rtol 2e-4 / atol 2e-5 in float32, the reference's own backward
test tolerance (the two sides differ in summation order only).

The JAX kernels' dropout uses the TPU PRNG, which has no CPU lowering, so
dropout is held to the port's own invariants: the autograd function equals
autograd through the plain forward given the same mask, the per-element
Philox mask equals any window of itself, and a fixed seed replays. The
tests marked ``cuda`` hold the CUDA kernels and the CUDA mask against the
plain versions on the card and skip without one:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_bwd.py``.
"""
from unittest import mock

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture()
def jfa():
    from paddle_tpu.kernels import flash_attention

    return flash_attention


@pytest.fixture()
def interpret_pallas(jfa):
    orig = jfa.pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(jfa.pl, "pallas_call", interp):
        yield


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(B, H, Lq, Lk, D):
    return _rand((B, H, Lq, D), 0), _rand((B, H, Lk, D), 1), _rand((B, H, Lk, D), 2)


def _jax_grads(jfa, q, k, v, g, causal, bias=None, bias_grad=True):
    import jax
    import jax.numpy as jnp

    args = [jnp.asarray(a) for a in (q, k, v)]
    argnums = (0, 1, 2)
    if bias is not None:
        args.append(jnp.asarray(bias))
        argnums = (0, 1, 2, 3)

    def loss(q, k, v, bias=None):
        o = jfa.flash_attention_bhld(q, k, v, causal=causal, bias=bias,
                                     block_q=128, block_k=128,
                                     bias_grad=bias_grad)
        return jnp.sum(o * jnp.asarray(g))

    return [np.asarray(x) for x in jax.grad(loss, argnums=argnums)(*args)]


def _torch_grads(q, k, v, g, causal, bias=None, bias_grad=True,
                 dropout_p=0.0, seed=0, fn=None):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_()
    if fn is None:
        o = tfa.flash_attention_bhld(*ts, causal=causal, bias=tb,
                                     bias_grad=bias_grad, dropout_p=dropout_p,
                                     seed=seed)
    else:
        o = fn(*ts, tb)
    (o * torch.from_numpy(g)).sum().backward()
    grads = [t.grad.numpy() for t in ts]
    if tb is not None:
        grads.append(tb.grad.numpy())
    return grads


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk", [(256, 256), (128, 256), (256, 128)])
def test_backward_matches_jax(jfa, interpret_pallas, causal, lq, lk):
    q, k, v = _qkv(1, 2, lq, lk, 64)
    g = _rand((1, 2, lq, 64), 3)
    for gt, gj in zip(_torch_grads(q, k, v, g, causal),
                      _jax_grads(jfa, q, k, v, g, causal)):
        np.testing.assert_allclose(gt, gj, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_shape", [(1, 2, 256, 256), (2, 1, 256, 256)])
def test_backward_bias_and_dbias_match_jax(jfa, interpret_pallas, causal,
                                           bias_shape):
    q, k, v = _qkv(2, 2, 256, 256, 64)
    bias = _rand(bias_shape, 7)
    g = _rand((2, 2, 256, 64), 3)
    got = _torch_grads(q, k, v, g, causal, bias=bias)
    want = _jax_grads(jfa, q, k, v, g, causal, bias=bias)
    assert got[3].shape == bias_shape
    for gt, gj in zip(got, want):
        np.testing.assert_allclose(gt, gj, **TOL)


def test_bias_grad_false_matches_jax(jfa, interpret_pallas):
    """``bias_grad=False`` skips dS: dbias is zero on both sides, and dq,
    dk, dv are unchanged."""
    q, k, v = _qkv(1, 2, 256, 256, 64)
    bias = _rand((1, 2, 256, 256), 7)
    g = _rand((1, 2, 256, 64), 3)
    got = _torch_grads(q, k, v, g, True, bias=bias, bias_grad=False)
    want = _jax_grads(jfa, q, k, v, g, True, bias=bias, bias_grad=False)
    assert not got[3].any() and not want[3].any()
    for gt, gj in zip(got[:3], want[:3]):
        np.testing.assert_allclose(gt, gj, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_impl_matches_jax(jfa, interpret_pallas, causal):
    """The port's ``flash_attention_bwd`` against ``_flash_bwd_impl`` on the
    same (o, lse, dO)."""
    import jax.numpy as jnp

    q, k, v = _qkv(1, 2, 256, 256, 64)
    do = _rand((1, 2, 256, 64), 4)
    o, lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), None, jnp.int32(0), causal,
                                 0.0, block_q=128, block_k=128)
    want = jfa._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None, jnp.int32(0), o, lse[..., 0],
                               jnp.asarray(do), causal, 0.0, block_q=128,
                               block_k=128)
    got = tfa.flash_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v)), None,
        torch.from_numpy(np.array(o)),
        torch.from_numpy(np.asarray(lse)[..., 0].copy()),
        torch.from_numpy(do), causal)
    assert got[3] is None and want[3] is None
    for gt, gj in zip(got[:3], want[:3]):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)


def _plain_attention(causal, keep=None):
    def fn(q, k, v, bias):
        return tfa.reference_attention_fwd(q, k, v, causal=causal, bias=bias,
                                           keep_mask=keep)[0]
    return fn


@pytest.mark.parametrize("dropout_p", [0.0, 0.2])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_equals_autograd_of_plain_forward(causal,
                                                            dropout_p):
    """``FlashAttention``'s written-out backward equals torch autograd
    through the plain forward given the mask the kernels use."""
    q, k, v = _qkv(2, 2, 48, 80, 64)
    bias = _rand((1, 2, 48, 80), 7)
    g = _rand((2, 2, 48, 64), 3)
    keep = None
    if dropout_p:
        keep = tfa.dropout_mask(11, 2, 2, 48, 80, dropout_p)
    got = _torch_grads(q, k, v, g, causal, bias=bias, dropout_p=dropout_p,
                       seed=11)
    want = _torch_grads(q, k, v, g, causal, bias=bias,
                        fn=_plain_attention(causal, keep))
    for gt, gw in zip(got, want):
        np.testing.assert_allclose(gt, gw, rtol=1e-5, atol=1e-5)


def test_blhd_gradients_equal_bhld():
    q, k, v = _qkv(2, 3, 40, 40, 64)
    g = _rand((2, 3, 40, 64), 3)
    want = _torch_grads(q, k, v, g, True, dropout_p=0.1, seed=5)

    def blhd(q, k, v, bias):
        return tfa.flash_attention_blhd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, dropout_p=0.1, seed=5).transpose(1, 2)

    for gt, gw in zip(_torch_grads(q, k, v, g, True, fn=blhd), want):
        np.testing.assert_allclose(gt, gw, rtol=1e-6, atol=1e-6)


def test_philox_known_answers():
    """Random123's Philox4x32-10 known-answer vectors (first output word)."""
    cases = [(0, (0, 0, 0, 0), 0x6627E8D5),
             (2 ** 64 - 1, (0xFFFFFFFF,) * 4, 0x408F276D),
             (0x299F31D0A4093822,
              (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), 0xD16CFE09)]
    for seed, ctr, want in cases:
        c = [torch.tensor([x], dtype=torch.int64) for x in ctr]
        assert int(tfa.philox_bits(seed, *c)) == want


@pytest.mark.parametrize("window", [(0, 5, 0, 7), (3, 4, 9, 6), (17, 1, 2, 31)])
def test_mask_window_equals_full_mask(window):
    """Bits are keyed per element: any window equals the same window of
    the full mask (what lets forward and backward tile differently)."""
    row0, rows, col0, cols = window
    full = tfa.dropout_bits(99, 2, 3, 24, 40)
    part = tfa.dropout_bits(99, 2, 3, rows, cols, row0=row0, col0=col0)
    assert torch.equal(part, full[:, :, row0:row0 + rows, col0:col0 + cols])
    assert int(full.min()) >= 0 and int(full.max()) < 2 ** 32


def test_mask_replays_and_keep_rate_is_binomial():
    p, n = 0.1, 2 * 4 * 128 * 128
    a = tfa.dropout_mask(1234, 2, 4, 128, 128, p)
    assert torch.equal(a, tfa.dropout_mask(1234, 2, 4, 128, 128, p))
    assert not torch.equal(a, tfa.dropout_mask(1235, 2, 4, 128, 128, p))
    kept = int((a > 0).sum())
    # within 5 standard deviations of n (1 - p)
    assert abs(kept - n * (1 - p)) <= 5 * (n * p * (1 - p)) ** 0.5
    assert set(torch.unique(a).tolist()) == {0.0, float(np.float32(1) /
                                                        np.float32(1 - p))}


def test_dropout_forward_on_cpu_uses_the_plain_mask():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 32, 32, 64))
    o = tfa.flash_attention_bhld(q, k, v, causal=True, dropout_p=0.3, seed=8)
    keep = tfa.dropout_mask(8, 1, 2, 32, 32, 0.3)
    want = tfa.reference_attention_fwd(q, k, v, causal=True, keep_mask=keep)[0]
    assert torch.equal(o, want)
    other = tfa.flash_attention_bhld(q, k, v, causal=True, dropout_p=0.3,
                                     seed=9)
    assert not torch.equal(o, other)


def _bf16_ulp(x):
    _, e = torch.frexp(x.float().abs())
    return torch.where(x == 0, 0.0, torch.exp2((e - 8).float()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,lq,lk,d,bias", [
    (True, 1500, 1500, 128, False), (False, 384, 640, 64, True),
    (True, 256, 256, 256, True)])
def test_cuda_backward_matches_plain(cuda_device, dtype, causal, lq, lk, d,
                                     bias):
    """On the card: both backward kernels against the plain version.
    Tolerance: float32 rtol 2e-4 / atol 2e-5 of the gradients' scale
    (summation order); bfloat16 two ulps of each reference element plus
    a float32 floor of 2e-3 of the gradient's largest magnitude (the
    kernel and the plain version round differently ordered float32 sums)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rn(*s):
        return torch.randn(*s, generator=g, device=cuda_device)

    q, k, v = (rn(2, 3, n, d).to(dtype) for n in (lq, lk, lk))
    do = rn(2, 3, lq, d).to(dtype)
    b = rn(1, 3, lq, lk) if bias else None
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, bias=b)
    before = (tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    got = tfa.flash_attention_bwd(q, k, v, b, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                      before[1] + 1)
    dq, dk, dv, ds = tfa.reference_attention_bwd(q, k, v, b, o, lse, do,
                                                 causal)
    want = [dq, dk, dv, None if b is None else ds.sum(0, keepdim=True)]
    for x, y in zip(got, want):
        if y is None:
            assert x is None
            continue
        err = (x.float() - y.float()).abs()
        if dtype == torch.float32:
            limit = 2e-4 * y.abs() + 2e-5 * y.abs().max()
        else:
            limit = 2 * _bf16_ulp(y) + 2e-3 * y.float().abs().max()
        assert bool((err <= limit).all()), float(err.max())


@pytest.mark.cuda
def test_cuda_mask_equals_plain_mask(cuda_device):
    bits = tfa.dropout_bits(77, 2, 3, 100, 300, device=cuda_device,
                            row0=5, col0=11)
    plain = tfa.philox_bits(
        77, torch.arange(11, 311, device=cuda_device).view(1, 1, 1, -1),
        torch.arange(5, 105, device=cuda_device).view(1, 1, -1, 1),
        torch.arange(3, device=cuda_device).view(1, -1, 1, 1),
        torch.arange(2, device=cuda_device).view(-1, 1, 1, 1))
    assert torch.equal(bits, plain.expand_as(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_dropout_forward_and_backward_match_plain(cuda_device, causal):
    """p = 0.1 on the card: the kernels against the plain versions given
    the plain Philox mask (float32, rtol 2e-4 / atol 2e-5 of the scale)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, do = (torch.randn(2, 4, 320, 128, generator=g,
                               device=cuda_device) for _ in range(4))
    keep = tfa.dropout_mask(42, 2, 4, 320, 320, 0.1, cuda_device)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, dropout_p=0.1,
                                     seed=42)
    o_ref, lse_ref = tfa.reference_attention_fwd(q, k, v, causal=causal,
                                                 keep_mask=keep)
    assert (o - o_ref).abs().max().item() <= 1e-4
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    got = tfa.flash_attention_bwd(q, k, v, None, o, lse, do, causal, 0.1, 42)
    want = tfa.reference_attention_bwd(q, k, v, None, o, lse, do, causal,
                                       keep)
    for x, y in zip(got[:3], want[:3]):
        assert bool(((x - y).abs() <= 2e-4 * y.abs()
                     + 2e-5 * y.abs().max()).all())

"""The port's flash attention (paddle_tpu_torch.kernels.flash_attention)
against the JAX package's Pallas kernel.

On the CPU the port's wrappers run their plain version; the JAX side runs
its Pallas kernel in interpret mode, patched in the test exactly as
tests/test_flash_attention.py does. Inputs come from numpy seeds.
Tolerance: rtol/atol 1e-5 in float32 (the reference's own kernel test
tolerance; the two sides differ only in summation order).

The CUDA kernel itself runs only on the card: the tests marked ``cuda``
hold it against the plain version there and skip without a GPU. The JAX
side is imported inside fixtures, so on a machine without JAX the
``cuda`` tests run alone:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``.
"""
from unittest import mock

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa

TOL = dict(rtol=1e-5, atol=1e-5)


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
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(B, H, Lq, Lk, D):
    return _rand((B, H, Lq, D), 0), _rand((B, H, Lk, D), 1), _rand((B, H, Lk, D), 2)


def _both(jfa, q, k, v, causal, bias=None):
    import jax.numpy as jnp

    o_j = jfa.flash_attention_bhld(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bias=None if bias is None else jnp.asarray(bias),
        block_q=128, block_k=128)
    o_t = tfa.flash_attention_bhld(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, bias=None if bias is None else torch.from_numpy(bias))
    return np.asarray(o_j), o_t.numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(jfa, interpret_pallas, causal):
    o_j, o_t = _both(jfa, *_qkv(2, 2, 256, 256, 64), causal)
    np.testing.assert_allclose(o_t, o_j, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk", [(128, 256), (256, 128)])
def test_forward_lq_ne_lk_matches_jax(jfa, interpret_pallas, causal, lq, lk):
    """Lq != Lk: both sides align the causal mask top-left."""
    o_j, o_t = _both(jfa, *_qkv(1, 2, lq, lk, 64), causal)
    np.testing.assert_allclose(o_t, o_j, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_shape", [(1, 2, 256, 256), (2, 1, 256, 256)])
def test_forward_bias_matches_jax(jfa, interpret_pallas, causal, bias_shape):
    bias = _rand(bias_shape, 7)
    o_j, o_t = _both(jfa, *_qkv(2, 2, 256, 256, 64), causal, bias=bias)
    np.testing.assert_allclose(o_t, o_j, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_jax(jfa, interpret_pallas, causal):
    import jax.numpy as jnp

    q, k, v = _qkv(1, 2, 256, 256, 64)
    _, lse_j = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), None, jnp.int32(0), causal,
                                   0.0, block_q=128, block_k=128)
    _, lse_t = tfa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal)
    assert lse_t.shape == (1, 2, 256)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], **TOL)


def test_blhd_layout_matches_bhld():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 3, 40, 40, 64))
    o_bhld = tfa.flash_attention_bhld(q, k, v, causal=True)
    o_blhd = tfa.flash_attention_blhd(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=True)
    np.testing.assert_allclose(o_blhd.transpose(1, 2).numpy(), o_bhld.numpy(),
                               **TOL)


def test_gate_is_false_on_cpu():
    q = torch.zeros(1, 2048, 16, 128)
    assert not tfa.should_use_flash(q, q, None, 0.0)


def test_gate_shape_rules_match_jax_where_tpu_rules_do_not_apply():
    """The port keeps the JAX gate's head-dim and bias-shape rules; only
    the device decides on the CPU, so probe the rules with a tensor that
    claims to be on CUDA. The gate admits exactly the dtypes that have a
    kernel route (float32, bfloat16, float16)."""
    class FakeCuda:
        def __init__(self, shape, dtype=torch.float32):
            self.shape, self.ndim, self.is_cuda = shape, len(shape), True
            self.dtype = dtype

    q = FakeCuda((2, 64, 4, 128))
    assert tfa.should_use_flash(q, q, None, 0.0)
    assert not tfa.should_use_flash(FakeCuda((2, 64, 4, 96)),
                                    FakeCuda((2, 64, 4, 96)), None, 0.0)
    assert tfa.should_use_flash(q, q, FakeCuda((1, 4, 64, 64)), 0.0)
    assert not tfa.should_use_flash(q, q, FakeCuda((3, 4, 64, 64)), 0.0)
    assert not tfa.should_use_flash(q, q, FakeCuda((64, 64)), 0.0)
    # no TPU length rules: short and ragged lengths go to the kernel
    assert tfa.should_use_flash(FakeCuda((1, 37, 4, 64)),
                                FakeCuda((1, 37, 4, 64)), None, 0.0)
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        x = FakeCuda((2, 64, 4, 128), dtype)
        routed = tfa.kernel_route(dtype, 128, "fwd") != "fma"
        assert tfa.should_use_flash(x, x, None, 0.0) == routed
        assert routed == (dtype != torch.float64)


def _bf16_ulp(x):
    """bf16 spacing at |x| (8 significant bits), elementwise; 0 at 0."""
    _, e = torch.frexp(x.float().abs())
    return torch.where(x == 0, 0.0, torch.exp2((e - 8).float()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, None)])
@pytest.mark.parametrize("causal,lq,lk,d", [(True, 1500, 1500, 128),
                                            (False, 384, 640, 64),
                                            (True, 256, 256, 256)])
def test_cuda_kernel_matches_plain(cuda_device, dtype, tol, causal, lq, lk, d):
    """On the card: the kernel against its plain version. Tolerance: f32
    1e-4 (summation order); bf16 two ulps of each reference element plus
    1e-6 (both sides round one f32 value, equal to ~1e-6, to bf16)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(2, 3, lq, d, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(2, 3, lk, d, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(2, 3, lk, d, generator=g, device=cuda_device).to(dtype)
    bias = torch.randn(1, 3, lq, lk, generator=g, device=cuda_device)
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, bias=bias)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    o_ref, lse_ref = tfa.reference_attention_fwd(q, k, v, causal=causal,
                                                 bias=bias)
    limit = tol if tol is not None else 2 * _bf16_ulp(o_ref) + 1e-6
    assert bool(((o.float() - o_ref.float()).abs() <= limit).all())
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_unsupported_input(cuda_device):
    """A head dim no kernel takes raises; float16, which the kernels take
    (on the wgmma_f16 route), launches and matches the plain version
    within the float32 tolerance plus one float16 ulp of the output."""
    q = torch.zeros(1, 2, 16, 96, device=cuda_device)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, q, q)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(1, 2, 16, 64, generator=g, device=cuda_device)
               .half() for _ in range(3))
    before = tfa.flash_attention_fwd.routes["wgmma_f16"]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.routes["wgmma_f16"] == before + 1
    o_ref, lse_ref = tfa.reference_attention_fwd(q, k, v, causal=True)
    _, e = torch.frexp(o_ref.float().abs())
    limit = 1e-5 + 1e-5 * o_ref.float().abs() + torch.exp2(
        torch.clamp(e - 11, min=-24).float())
    assert o.dtype == torch.float16
    assert bool(((o.float() - o_ref.float()).abs() <= limit).all())
    torch.testing.assert_close(lse, lse_ref, rtol=1e-5, atol=1e-5)

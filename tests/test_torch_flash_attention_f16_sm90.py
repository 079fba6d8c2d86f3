"""The native float16 kernels of the port's flash attention (route
``wgmma_f16``): the forward of ``csrc/flash_attention_fwd_f16_sm90.cu`` at
head dims 64, 128 and 256 and the dQ and dK/dV kernels of
``csrc/flash_attention_bwd_f16_sm90.cu`` (head dims 64 and 128) and
``csrc/flash_attention_bwd_f16_d256_sm90.cu`` (head dim 256), their
arithmetic emulated in plain torch against the JAX kernels, their routing,
and, on the card, the kernels against their plain version.

The kernels keep the reference's float32-operand numerics
(``_operand_dtype``) with float16 tensor-core products where they are exact:
- S = Q K^T and dP = dO V^T are one float16 product each (a product of two
  float16 values has 22 significant bits, exact in float32);
- P V takes P M s (s a power of two, P M s < 2^15; M the dropout
  multiplier) as a float16 hi/lo pair against V, and divides by s and by
  the row sum l;
- dS K and dS^T Q take dS as three bf16 terms and the float16 operand as
  its two bf16 terms (exact), keeping the five term pairs with a + j <= 2;
- (P M)^T dO takes P M s (s a power of two, P M s < 2^15) as a float16
  hi/lo pair against dO, and divides by s.
The CPU tests emulate that in float32 torch on float16 values and hold it
against the Pallas kernels in interpret mode on the same float16 inputs,
made from a seed: O and the gradients, float16 on both sides, within the
reference's float32 forward tolerance (1e-5 + 1e-5 |ref|) or backward
tolerance (rtol 2e-4, atol 2e-5) plus one float16 ulp of the element (each
side rounds a float32 value to float16 once, and two values within the
float32 tolerance may round to neighbours); LSE and dbias, float32 on both
sides, within the float32 tolerance.

The tests marked ``cuda`` run the kernels on the card and skip without one:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_f16_sm90.py``.
"""
import math
from unittest import mock

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
from torch_threads import few_torch_threads  # noqa: F401

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-5)


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
        pytest.skip("needs a CUDA device (the wgmma kernels have no CPU mode)")
    return torch.device("cuda")


def _f16(shape, seed, scale=1.0):
    """Standard normals from ``seed``, times ``scale``, as float16."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return x.astype(np.float16)


def f16_ulp(x):
    """float16 spacing at |x| (11 significant bits, subnormal spacing
    2^-24 below 2^-14)."""
    _, e = torch.frexp(x.float().abs())
    return torch.exp2(torch.clamp(e - 11, min=-24).float())


def assert_f16_close(got, want, do_scale=1.0, tol=BWD_TOL):
    """float16 ``got`` against float16 ``want``: the float32 tolerance
    ``tol`` (the backward's unless given) plus one float16 ulp of the
    element. The gradients are linear in dO, so for a dO ``do_scale`` times
    the unit-scale inputs the tolerance was set for, its absolute part
    scales with it."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.dtype == want.dtype == torch.float16
    limit = tol["atol"] * do_scale + tol["rtol"] * want.float().abs() \
        + f16_ulp(want)
    err = (got.float() - want.float()).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


# ------------------------------------------------- the arithmetic, emulated
def bf16_terms(x: torch.Tensor, terms: int):
    """A float32 tensor as ``terms`` bf16 parts (``csrc/sm90.cuh``
    ``split_slice``; for a float16 x, two are exact), each as float32."""
    parts = []
    for _ in range(terms):
        t = x.to(torch.bfloat16).float()
        parts.append(t)
        x = x - t
    return parts


#: the five pairs (term of dS, term of the float16 operand) the kernels
#: keep, in the order they issue them (the float32 kernels' order: the
#: operand's small term first, dS's small terms before its main one)
PAIRS = ((1, 1), (0, 1), (2, 0), (1, 0), (0, 0))


def five_pairs(ds, y, eq):
    """``einsum(eq, ds, y)`` as the kernels take dS K and dS^T Q: dS's three
    bf16 terms against the two of the float16 values ``y``, the pairs of
    :data:`PAIRS`, each pair's product summed in float32."""
    a, b = bf16_terms(ds, 3), bf16_terms(y, 2)
    out = torch.zeros(())
    for i, j in PAIRS:
        out = out + torch.einsum(eq, a[i], b[j])
    return out


def pm_scale(kept: float) -> float:
    """The kernels' power of two s for the hi/lo pair of P M: kept <
    2^e, s = 2^(15 - e), so P M s < 2^15."""
    _, e = math.frexp(kept)
    return 2.0 ** (15 - e)


def f16_pair(x: torch.Tensor):
    """The float16 hi/lo pair of a float32 tensor (values below 65504):
    hi = f16(x), lo = f16(x - hi), both as float32."""
    hi = x.half().float()
    return hi, (x - hi).half().float()


def emulated_bwd(q, k, v, bias, o, lse, do, causal, keep=None, kept=1.0):
    """``(dq, dk, dv, ds)`` as the wgmma_f16 kernels take them, on float32
    tensors that hold float16 values (q, k, v, do): dq, dk, dv float32
    before their rounding to float16, ds float32. ``keep`` is the dropout
    multiplier (0 or ``kept``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p * torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    pm = p
    if keep is not None:
        dp = dp * keep
        pm = p * keep
    ds = p * (dp - (do * o).sum(-1)[..., None])
    dq = five_pairs(ds, k, "bhqk,bhkd->bhqd") * scale
    dk = five_pairs(ds, q, "bhqk,bhqd->bhkd") * scale
    sc = pm_scale(kept)
    hi, lo = f16_pair(pm * sc)
    dv = (torch.einsum("bhqk,bhqd->bhkd", lo, do)
          + torch.einsum("bhqk,bhqd->bhkd", hi, do)) / sc
    return dq, dk, dv, ds


def attention_f64(q, k, v, causal):
    """Attention computed in float64 throughout (no bias, no dropout)."""
    q, k, v = q.double(), k.double(), v.double()
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool,
                                      device=s.device).tril(), float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def matmul_f32(eq, a, b):
    """``einsum(eq, a, b)`` of float32 tensors that hold float16 values,
    summed in float64 and rounded to float32: the products are exact in
    either type, and the float64 sum keeps the emulation independent of
    the order and the accuracy of the CPU's float32 matrix products
    (which need not be the card's, and need not repeat from call to
    call)."""
    return torch.einsum(eq, a.double(), b.double()).float()


def emulated_fwd(q, k, v, causal, bias=None, keep=None, kept=1.0,
                 pair=True):
    """``(o, lse)`` as the wgmma_f16 forward takes them, on float32 tensors
    that hold float16 values: S = Q K^T as one product (exact products),
    P M s as a float16 hi/lo pair against V (its hi part alone with
    ``pair=False``), divided by s and by the row sum l; o float32 before
    its rounding to float16. ``keep`` is the dropout multiplier (0 or
    ``kept``). The two products' sums are taken in float64 and rounded to
    float32 (:func:`matmul_f32`)."""
    s = matmul_f32("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(),
                          float("-inf"))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    pm = p if keep is None else p * keep
    sc = pm_scale(kept)
    hi, lo = f16_pair(pm * sc)
    pv = matmul_f32("bhqk,bhkd->bhqd", hi, v)
    if pair:
        pv = matmul_f32("bhqk,bhkd->bhqd", lo, v) + pv
    return pv / sc / l[..., None], m + torch.log(l)


def test_float16_values_are_two_exact_bf16_terms():
    """Every finite float16 value (all 63488, subnormals included) is the
    sum of its two bf16 terms: K's and Q's terms lose nothing."""
    bits = torch.arange(0, 2 ** 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.float16)
    x = x[torch.isfinite(x)].float()
    assert x.numel() == 63488
    t0, t1 = bf16_terms(x, 2)
    assert torch.equal(t0 + t1, x)
    assert torch.equal(t1, t1.to(torch.bfloat16).float())


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.9])
def test_hi_lo_pair_of_pm_keeps_float32_accuracy(p):
    """P M s as a float16 hi/lo pair: P M s stays finite and below 2^15, and
    the pair is within 2^-22 of each element of P M, or 2^-25 / s absolute
    for the smallest ones (subnormal lo; 2^-39 at p < 1/2), across P from 1
    down to 1e-30."""
    kept = float(np.float32(1.0) / np.float32(1.0 - p)) if p else 1.0
    sc = pm_scale(kept)
    rng = np.random.default_rng(3)
    x = torch.from_numpy((10.0 ** rng.uniform(-30, 0, 20000)).astype(np.float32))
    x = torch.cat([x, torch.tensor([1.0, 0.0])]) * np.float32(kept)
    hi, lo = f16_pair(x * sc)
    assert bool(torch.isfinite(hi).all()) and float((x * sc).max()) < 2 ** 15
    err = (x.double() - (hi.double() + lo.double()) / sc).abs()
    assert bool((err <= torch.clamp(2.0 ** -22 * x.double().abs(),
                                    min=2.0 ** -25 / sc)).all())


# (D, causal, Lq, Lk, bias): D 64, 128 and 256, causal and not, a bias
# broadcast over the batch, Lq != Lk (non-causal) both ways
_FWD_CASES = [(64, True, 256, 256, False), (64, False, 256, 256, False),
              (64, True, 256, 256, True), (128, True, 256, 256, False),
              (128, False, 128, 256, True), (128, False, 256, 128, False),
              (256, True, 256, 256, False), (256, False, 256, 128, True)]


@pytest.mark.parametrize("d,causal,lq,lk,bias", _FWD_CASES)
def test_f16_forward_emulation_matches_jax(jfa, interpret_pallas, d, causal,
                                           lq, lk, bias):
    """O and LSE of the emulated wgmma_f16 forward against
    ``_flash_fwd_impl`` in interpret mode on the same float16 q, k, v: O
    (float16 on both sides) within the float32 forward tolerance plus one
    float16 ulp, LSE within the float32 forward tolerance."""
    import jax.numpy as jnp

    q, k, v = _f16((2, 2, lq, d), 0), _f16((2, 2, lk, d), 1), \
        _f16((2, 2, lk, d), 2)
    b = _f16((1, 2, lq, lk), 3).astype(np.float32) if bias else None
    o_j, lse_j = jfa._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if b is None else jnp.asarray(b), jnp.int32(0), causal, 0.0,
        block_q=128, block_k=128)
    o_j = torch.from_numpy(np.asarray(o_j))
    assert o_j.dtype == torch.float16
    o, lse = emulated_fwd(*(torch.from_numpy(x.astype(np.float32))
                            for x in (q, k, v)), causal,
                          None if b is None else torch.from_numpy(b))
    assert_f16_close(o.half(), o_j, tol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0],
                               **FWD_TOL)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_f16_forward_pair_keeps_float32_accuracy_and_its_hi_does_not(d):
    """Before its rounding to float16, the emulated O is within a few
    float32 roundings of a float64 forward on the same float16 inputs;
    P's hi part alone (P as one float16 operand) is not: the hi/lo pair is
    what keeps the reference's float32-operand accuracy."""
    q, k, v = (torch.from_numpy(_f16((1, 2, 256, d), s).astype(np.float32))
               for s in range(3))
    want = attention_f64(q, k, v, True)
    pair, _ = emulated_fwd(q, k, v, True)
    hi, _ = emulated_fwd(q, k, v, True, pair=False)
    assert (pair.double() - want).abs().max() < 1e-6
    assert (hi.double() - want).abs().max() > 1e-5


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_f16_forward_emulation_with_dropout_matches_plain(d, p):
    """Dropout with the Philox mask (the TPU's PRNG has no CPU lowering):
    the emulated forward against the port's plain forward given the same
    mask, O within the float32 forward tolerance plus one float16 ulp, LSE
    (which ignores the mask) within the float32 tolerance. At p = 0.5 the
    kept multiplier is 2 and s = 2^13."""
    B, H, L, seed = 1, 2, 192, 98
    q, k, v = (torch.from_numpy(_f16((B, H, L, d), s)) for s in range(3))
    keep = tfa.dropout_mask(seed, B, H, L, L, p)
    kept = float(keep.max())
    want, lse_want = tfa.reference_attention_fwd(q, k, v, causal=True,
                                                 keep_mask=keep)
    o, lse = emulated_fwd(q.float(), k.float(), v.float(), True, None, keep,
                          kept)
    assert_f16_close(o.half(), want, tol=FWD_TOL)
    torch.testing.assert_close(lse, lse_want, **FWD_TOL)


def _jax_bwd(jfa, q, k, v, do, bias, causal):
    import jax.numpy as jnp

    b = None if bias is None else jnp.asarray(bias)
    o, lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), b, jnp.int32(0), causal, 0.0,
                                 block_q=128, block_k=128)
    grads = jfa._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), b, jnp.int32(0), o,
                                lse[..., 0], jnp.asarray(do), causal, 0.0,
                                block_q=128, block_k=128)
    return np.asarray(o), np.asarray(lse)[..., 0].copy(), grads


@pytest.mark.parametrize("d,causal,lq,lk,bias", [
    (64, True, 256, 256, False), (64, False, 256, 256, False),
    (128, True, 256, 256, False), (128, False, 128, 256, True),
    (64, True, 256, 256, True), (256, True, 256, 256, False),
    (256, False, 128, 256, True)])
def test_f16_backward_emulation_matches_jax(jfa, interpret_pallas, d, causal,
                                            lq, lk, bias):
    """dQ, dK and dV of the emulated wgmma_f16 kernels, rounded to float16,
    against ``_flash_bwd_impl`` in interpret mode on the same float16 (q, k,
    v, dO) and its own (o, lse): the float32 backward tolerance plus one
    float16 ulp; dbias (the dQ kernel's dS, summed) within the float32
    tolerance."""
    q, do = _f16((1, 2, lq, d), 0), _f16((1, 2, lq, d), 3)
    k, v = _f16((1, 2, lk, d), 1), _f16((1, 2, lk, d), 2)
    b = _f16((1, 2, lq, lk), 7).astype(np.float32) if bias else None
    o, lse, (dq_j, dk_j, dv_j, db_j) = _jax_bwd(jfa, q, k, v, do, b, causal)
    t = [torch.from_numpy(x.astype(np.float32)) for x in (q, k, v, o, do)]
    dq, dk, dv, ds = emulated_bwd(
        t[0], t[1], t[2], None if b is None else torch.from_numpy(b), t[3],
        torch.from_numpy(lse), t[4], causal)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert_f16_close(got.half(), torch.from_numpy(np.asarray(want)))
    if bias:
        np.testing.assert_allclose(ds.sum(0, keepdim=True).numpy(),
                                   np.asarray(db_j), **BWD_TOL)


def test_f16_backward_emulation_at_the_loss_scale(jfa, interpret_pallas):
    """dO as large as a loss scale makes it (2^13 times standard normals,
    up to about 4e4, inside float16's range): dP passes float16's 65504,
    so a float16 dS would overflow, and the emulation, with dS as bf16
    terms, stays finite and matches the reference (the absolute tolerance
    scaled with dO, :func:`assert_f16_close`)."""
    d, L = 64, 256
    q, k, v = (_f16((1, 2, L, d), s) for s in range(3))
    do = _f16((1, 2, L, d), 3, scale=2.0 ** 13)
    o, lse, (dq_j, dk_j, dv_j, _) = _jax_bwd(jfa, q, k, v, do, None, True)
    t = [torch.from_numpy(x.astype(np.float32)) for x in (q, k, v, o, do)]
    dq, dk, dv, ds = emulated_bwd(t[0], t[1], t[2], None, t[3],
                                  torch.from_numpy(lse), t[4], True)
    dp = torch.einsum("bhqd,bhkd->bhqk", t[4], t[2])
    assert float(dp.abs().max()) > 65504
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert bool(torch.isfinite(got.half()).all())
        assert_f16_close(got.half(), torch.from_numpy(np.asarray(want)),
                         do_scale=2.0 ** 13)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_f16_backward_emulation_with_dropout_matches_plain(d):
    """p = 0.1 with the Philox mask (the TPU's PRNG has no CPU lowering):
    the emulation against the port's plain backward given the same mask,
    within the float32 backward tolerance plus one float16 ulp."""
    B, H, L, p, seed = 1, 2, 192, 0.1, 99
    q, k, v, do = (torch.from_numpy(_f16((B, H, L, d), s)) for s in range(4))
    keep = tfa.dropout_mask(seed, B, H, L, L, p)
    kept = float(keep.max())
    o, lse = tfa.reference_attention_fwd(q, k, v, causal=True, keep_mask=keep)
    want = tfa.reference_attention_bwd(q, k, v, None, o, lse, do, True, keep)
    got = emulated_bwd(q.float(), k.float(), v.float(), None, o.float(), lse,
                       do.float(), True, keep, kept)
    for x, y in zip(got[:3], want[:3]):
        assert_f16_close(x.half(), y)


# ------------------------------------------------------------ routing
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_float16_route_table(kernel, d):
    """The float16 forward, dQ and dK/dV take wgmma_f16 at every D, D = 256
    included; bf16 and float32 keep their routes."""
    assert tfa.kernel_route(torch.float16, d, kernel) == "wgmma_f16"
    assert tfa.kernel_route(torch.bfloat16, d, kernel) == "wgmma"
    assert tfa.kernel_route(torch.float32, d, kernel) == "wgmma_f32"


def test_float16_backward_wrapper_splits_nothing():
    """On the wgmma_f16 route the dQ and dK/dV wrappers launch their
    kernels on q, k, v and dO as they are, with no split pre-pass; the
    launcher is stubbed (the kernels need a card)."""
    calls = []
    q = torch.zeros(1, 2, 64, 128, dtype=torch.float16)
    stats = torch.zeros(1, 2, 64)

    def sm90(which, route, *a):
        calls.append((which, route, a[-1]))

    with mock.patch.object(tfa, "_launch_bwd_sm90", sm90), \
            mock.patch.object(tfa, "split_bf16_terms",
                              lambda *a: pytest.fail("split launched")):
        tfa.reset_launch_counts()
        tfa.flash_attention_bwd_dq(q, q, q, None, q, stats, stats, True)
        tfa.flash_attention_bwd_dkv(q, q, q, None, q, stats, stats, True)
    assert calls == [("dq", "wgmma_f16", None), ("dkv", "wgmma_f16", None)]
    assert tfa.launch_counts()["dq"]["wgmma_f16"] == 1
    assert tfa.launch_counts()["dkv"]["wgmma_f16"] == 1
    tfa.reset_launch_counts()


class _FakeStream:
    cuda_stream = 0


def test_float16_backward_wrapper_at_d256_splits_nothing():
    """At D = 256 the float16 dQ and dK/dV wrappers launch the wgmma_f16
    kernels on q, k, v (views of a fused qkv) and dO (a view of the
    [B, L, H, D] gradient) as they are, with no split pre-pass and no
    wgmma_f32 kernel; the C entries are stubbed (the kernels need a
    card)."""
    B, H, L, d = 2, 3, 64, 256
    calls = []
    qkv = torch.zeros(B, L, 3, H, d, dtype=torch.float16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.zeros(B, L, H, d, dtype=torch.float16).transpose(1, 2)
    stats = torch.zeros(B, H, L)

    def entry_of(which, route, head_dim):
        def entry(*a):
            calls.append((which, route, a))
            return 0
        return entry

    with mock.patch.object(tfa, "_bwd_sm90_fn", entry_of), \
            mock.patch.object(tfa, "split_bf16_terms",
                              lambda *a: pytest.fail("split launched")), \
            mock.patch.object(torch.cuda, "device",
                              lambda dev: mock.MagicMock()), \
            mock.patch.object(torch.cuda, "current_stream",
                              lambda dev: _FakeStream()):
        tfa.reset_launch_counts()
        dq, _ = tfa.flash_attention_bwd_dq(q, k, v, None, do, stats, stats,
                                           True)
        dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, None, do, stats, stats,
                                             True)
    assert [c[:2] for c in calls] == [("dq", "wgmma_f16"),
                                      ("dkv", "wgmma_f16")]
    for _, _, a in calls:
        assert list(a[:3]) + [a[4]] == [t.data_ptr() for t in (q, k, v, do)]
        assert a[13] == d
    for w in ("dq", "dkv"):
        assert tfa.launch_counts()[w] == {"fma": 0, "wgmma": 0,
                                          "wgmma_f32": 0, "wgmma_f16": 1}
    assert all(t.dtype == torch.float16 for t in (dq, dk, dv))
    tfa.reset_launch_counts()


@pytest.mark.parametrize("route,d,source,name", [
    ("wgmma_f16", 256, "flash_attention_bwd_f16_d256_sm90.cu", "f16_d256"),
    ("wgmma_f16", 128, "flash_attention_bwd_f16_sm90.cu", "f16"),
    ("wgmma_f16", 64, "flash_attention_bwd_f16_sm90.cu", "f16"),
    ("wgmma_f32", 256, "flash_attention_bwd_f32_d256_sm90.cu", "f32_d256")])
def test_backward_entries_by_route_and_head_dim(route, d, source, name):
    """Each (route, D) loads its own source's C entries: the float16
    D = 256 kernels their own file; the float32 D = 256 file, whose float16
    instantiation is the yardstick on no route, stays callable directly.
    The library loader is stubbed (the build needs nvcc)."""
    loaded = []

    class Lib:
        def __getattr__(self, entry):
            loaded.append(entry)
            return mock.MagicMock()

    with mock.patch.object(tfa._build, "load",
                           lambda src: loaded.append(src) or Lib()):
        for which in ("dq", "dkv"):
            tfa._bwd_sm90_fn.__wrapped__(which, route, d)
    assert loaded == [source, f"pt_flash_attention_bwd_dq_{name}_sm90",
                      source, f"pt_flash_attention_bwd_dkv_{name}_sm90"]
    assert source in tfa._build.SOURCES


@pytest.mark.parametrize("d", [64, 128, 256])
def test_float16_forward_wrapper_splits_nothing(d):
    """On the wgmma_f16 route the forward wrapper launches its kernel on q,
    k, v as they are (the float16 views of a fused qkv, read by TMA: their
    own pointers, maps of B batches), with no split pre-pass; the C entry
    is stubbed (the kernel needs a card)."""
    B, H, L = 2, 3, 64
    calls = []
    qkv = torch.zeros(B, L, 3, H, d, dtype=torch.float16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))

    def entry(*a):
        calls.append(a)
        return 0

    with mock.patch.object(tfa, "_fwd_f16_sm90_fn", lambda: entry), \
            mock.patch.object(tfa, "_fwd_f32_sm90_fn",
                              lambda: pytest.fail("wgmma_f32 launched")), \
            mock.patch.object(tfa, "split_bf16_terms",
                              lambda *a: pytest.fail("split launched")), \
            mock.patch.object(torch.cuda, "device",
                              lambda dev: mock.MagicMock()), \
            mock.patch.object(torch.cuda, "current_stream",
                              lambda dev: _FakeStream()):
        tfa.reset_launch_counts()
        o, lse = tfa._launch_fwd(q, k, v, True, None, None, 0.0, 0)
    assert len(calls) == 1
    assert list(calls[0][:3]) == [t.data_ptr() for t in (q, k, v)]
    geo = list(calls[0][11])  # 3 maps of 14 words: D, then dims
    assert [w for i in range(3) for w in geo[14 * i + 1:14 * i + 4]
            if w not in (H, L)] == [B] * 3
    assert tfa.launch_counts()["fwd"] == {"fma": 0, "wgmma": 0,
                                          "wgmma_f32": 0, "wgmma_f16": 1}
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    tfa.reset_launch_counts()


# ------------------------------------------------------------ on the card
def _views(device, B, L, H, D, seed, n=3):
    """float16 q/k/v as the GPT path hands them over: views of a fused
    [B, L, n, H, D] tensor."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn(B, L, n, H, D, generator=g, device=device).half()
    return tuple(t[:, :, i].transpose(1, 2) for i in range(n))


def _case(device, d, causal, lq, lk, bias, seed, do_scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    if lq == lk:
        q, k, v = _views(device, 1, lq, 8, d, seed)
    else:
        q, k, v = (rn(1, 8, n, d).half() for n in (lq, lk, lk))
    do = (rn(1, lq, 8, d) * do_scale).half().transpose(1, 2)
    b = rn(1, 8, lq, lk) if bias else None
    return q, k, v, do, b


def _assert_f16_route(splits=0):
    for w in ("dq", "dkv"):
        assert tfa.launch_counts()[w] == {"fma": 0, "wgmma": 0,
                                          "wgmma_f32": 0, "wgmma_f16": 1}
    assert tfa.split_bf16_terms.launches == splits


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,lq,lk,bias", [
    (128, True, 1024, 1024, False), (64, True, 1024, 1024, False),
    (128, False, 384, 640, True), (64, False, 384, 640, True),
    (128, True, 1500, 1500, False), (128, True, 1024, 1024, True),
    (256, True, 1024, 1024, False), (256, False, 384, 640, True),
    (256, True, 1500, 1500, False), (256, True, 1024, 1024, True)])
def test_cuda_f16_kernels_match_plain(cuda_device, d, causal, lq, lk, bias):
    """dQ, dK and dV of the wgmma_f16 kernels against the plain backward:
    float16 within the float32 backward tolerance plus one float16 ulp;
    dbias (float32, the dQ kernel's dS) within the float32 tolerance, zero
    above a causal diagonal; no split launch."""
    q, k, v, do, b = _case(cuda_device, d, causal, lq, lk, bias, 21)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, bias=b)
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, b, o, lse, do, causal)
    torch.cuda.synchronize()
    _assert_f16_route()
    want = tfa.reference_attention_bwd(q, k, v, b, o, lse, do, causal)
    for x, y in zip(got[:3], want[:3]):
        assert_f16_close(x, y)
    if bias:
        torch.testing.assert_close(got[3], want[3].sum(0, keepdim=True),
                                   **BWD_TOL)
        if causal:
            assert bool((got[3].triu(1) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f16_kernels_at_the_loss_scale(cuda_device, d):
    """dO of a scaled loss (2^11 times standard normals, so that the
    gradients stay well inside float16's range): dP passes float16's
    65504, and the kernels' gradients are finite and within the tolerance
    of the plain backward (its absolute part scaled with dO)."""
    scale = 2.0 ** 11
    q, k, v, do, _ = _case(cuda_device, d, True, 1024, 1024, False, 22,
                           do_scale=scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    assert float(dp.abs().max()) > 65504
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    got = tfa.flash_attention_bwd(q, k, v, None, o, lse, do, True)
    want = tfa.reference_attention_bwd(q, k, v, None, o, lse, do, True)
    for x, y in zip(got[:3], want[:3]):
        assert bool(torch.isfinite(y).all())
        assert bool(torch.isfinite(x).all())
        assert_f16_close(x, y, do_scale=scale)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f16_dropout_matches_plain_and_replays(cuda_device, d):
    """p = 0.1: the kernels against the plain backward given the plain
    Philox mask, and a fixed seed replays bit for bit."""
    q, k, v, do, _ = _case(cuda_device, d, True, 1024, 1024, False, 23)
    seed, p = 77, 0.1
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_p=p,
                                     seed=seed)
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, None, o, lse, do, True, p, seed)
    again = tfa.flash_attention_bwd(q, k, v, None, o, lse, do, True, p, seed)
    torch.cuda.synchronize()
    assert tfa.launch_counts()["dq"]["wgmma_f16"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))
    keep = tfa.dropout_mask(seed, 1, 8, 1024, 1024, p, cuda_device)
    want = tfa.reference_attention_bwd(q, k, v, None, o, lse, do, True, keep)
    for x, y in zip(got[:3], want[:3]):
        assert_f16_close(x, y)


@pytest.mark.cuda
def test_cuda_f16_kernels_replay_bit_for_bit(cuda_device):
    """No atomics: the same inputs give the same dQ, dS, dK and dV."""
    q, k, v, do, b = _case(cuda_device, 128, True, 1500, 1500, True, 24)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, bias=b)
    first = tfa.flash_attention_bwd(q, k, v, b, o, lse, do, True)
    second = tfa.flash_attention_bwd(q, k, v, b, o, lse, do, True)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_cuda_f16_d256_takes_the_native_kernels(cuda_device):
    """float16 at D = 256 takes the wgmma_f16 dQ and dK/dV (one launch
    each), with no split and no wgmma_f32 launch, at [2, 16, 1024, 256]
    (more CTAs than SMs), and matches the plain backward."""
    g = torch.Generator(device=cuda_device).manual_seed(25)
    q, k, v, do = (torch.randn(2, 16, 1024, 256, generator=g,
                               device=cuda_device).half() for _ in range(4))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, None, o, lse, do, True)
    torch.cuda.synchronize()
    _assert_f16_route()
    want = tfa.reference_attention_bwd(q, k, v, None, o, lse, do, True)
    for x, y in zip(got[:3], want[:3]):
        assert_f16_close(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
def test_cuda_f16_d256_float32_kernels_still_match_plain(cuda_device, bias):
    """The float16 instantiation of the float32 D = 256 dQ and dK/dV,
    launched directly on the split's terms (no route takes it; the
    yardstick the wgmma_f16 pair is timed against), against the plain
    backward: the float32 tolerance plus one float16 ulp, dS within the
    float32 tolerance."""
    q, k, v, do, b = _case(cuda_device, 256, True, 1024, 1024, bias, 26)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, bias=b)
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1).contiguous()
    terms = tfa._backward_terms(q, k, v, do)
    dq, dk, dv = (tfa._empty_like_rows(t) for t in (q, k, v))
    ds = torch.empty(1, 8, 1024, 1024, device=cuda_device) if bias else None
    tfa.reset_launch_counts()
    tfa._launch_bwd_sm90("dq", "wgmma_f32", q, k, v, b, do, lse, delta, dq,
                         ds, dq.stride()[:3], True, 0.0, 0, terms)
    tfa._launch_bwd_sm90("dkv", "wgmma_f32", q, k, v, b, do, lse, delta, dk,
                         dv, (*dk.stride()[:3], *dv.stride()[:3]), True, 0.0,
                         0, terms)
    torch.cuda.synchronize()
    want = tfa.reference_attention_bwd(q, k, v, b, o, lse, do, True)
    for x, y in zip((dq, dk, dv), want[:3]):
        assert_f16_close(x, y)
    if bias:
        torch.testing.assert_close(ds, want[3], **BWD_TOL)


# ---------------------------------------------- the forward on the card
def _assert_f16_fwd_route(launches=1):
    assert tfa.launch_counts()["fwd"] == {"fma": 0, "wgmma": 0,
                                          "wgmma_f32": 0,
                                          "wgmma_f16": launches}
    assert tfa.split_bf16_terms.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,lq,lk,bias", [
    (128, True, 1024, 1024, False), (64, True, 1024, 1024, False),
    (256, True, 1024, 1024, False), (128, False, 384, 640, True),
    (64, False, 384, 640, True), (256, False, 384, 640, True),
    (128, True, 1500, 1500, False), (128, True, 1024, 1024, True)])
def test_cuda_f16_forward_matches_plain(cuda_device, d, causal, lq, lk,
                                        bias):
    """The wgmma_f16 forward against the plain forward: O float16 within
    the float32 forward tolerance plus one float16 ulp, LSE within the
    float32 forward tolerance; one launch on the route, no split."""
    q, k, v, _, b = _case(cuda_device, d, causal, lq, lk, bias, 31)
    tfa.reset_launch_counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, bias=b)
    torch.cuda.synchronize()
    _assert_f16_fwd_route()
    o_ref, lse_ref = tfa.reference_attention_fwd(q, k, v, causal=causal,
                                                 bias=b)
    assert_f16_close(o, o_ref, tol=FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f16_forward_dropout_matches_plain_and_replays(cuda_device, d,
                                                            p):
    """Dropout in the wgmma_f16 forward: O against the plain forward given
    the plain Philox mask, and a fixed seed replays bit for bit."""
    q, k, v, _, _ = _case(cuda_device, d, True, 1024, 1024, False, 32)
    seed = 76
    tfa.reset_launch_counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_p=p,
                                     seed=seed)
    again = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_p=p,
                                    seed=seed)
    torch.cuda.synchronize()
    _assert_f16_fwd_route(2)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    keep = tfa.dropout_mask(seed, 1, 8, 1024, 1024, p, cuda_device)
    o_ref, lse_ref = tfa.reference_attention_fwd(q, k, v, causal=True,
                                                 keep_mask=keep)
    assert_f16_close(o, o_ref, tol=FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f16_forward_replays_bit_for_bit(cuda_device, d):
    """No atomics: the same inputs (a bias, a ragged length) give the same
    O and LSE."""
    q, k, v, _, b = _case(cuda_device, d, True, 1500, 1500, True, 33)
    first = tfa.flash_attention_fwd(q, k, v, causal=True, bias=b)
    second = tfa.flash_attention_fwd(q, k, v, causal=True, bias=b)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_cuda_f16_forward_at_the_d256_shape(cuda_device):
    """[1, 8, 1024, 256] float16, the shape of the D = 256 backward's
    case, takes the wgmma_f16 forward (one CTA per SM) and matches the
    plain forward."""
    g = torch.Generator(device=cuda_device).manual_seed(34)
    q, k, v = (torch.randn(1, 8, 1024, 256, generator=g, device=cuda_device)
               .half() for _ in range(3))
    tfa.reset_launch_counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_f16_fwd_route()
    o_ref, lse_ref = tfa.reference_attention_fwd(q, k, v, causal=True)
    assert_f16_close(o, o_ref, tol=FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)


@pytest.mark.cuda
def test_cuda_f16_self_check_covers_the_native_forms(cuda_device):
    """The float16 self-check runs the native float16 SS form and the RS
    forms at N = 64, 128 and 256 (m64n256k16, the forward's P V at
    D = 256): float16 products are exact, so both results are within
    float32 summation of a float64 product."""
    for d in (64, 128, 256):
        a, b, c1, c2 = tfa.wgmma_selfcheck(d, cuda_device,
                                           dtype=torch.float16)
        torch.cuda.synchronize()
        for got, x, y in ((c1, a, b.T), (c2, a[:, :64], b)):
            limit = 2 * x.shape[1] * 2.0 ** -24 * (x.double().abs()
                                                   @ y.double().abs())
            assert bool(((got.double() - x.double() @ y.double()).abs()
                         <= limit).all())


def _rel_l2(x, ref):
    return ((x.double() - ref).norm() / ref.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f16_flash_attention_grads_match_plain(cuda_device, d):
    """FlashAttention in float16 (the wgmma_f16 forward, dQ and dK/dV, no
    split) against plain attention's autograd on the same float16 inputs:
    each gradient within twice plain attention's own distance from a
    float64 reference (relative L2), the output within the forward's
    tolerance of plain attention's."""
    q, k, v, do, _ = _case(cuda_device, d, True, 1024, 1024, False, 35)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def grads(attend, ts):
        o = attend(*ts)
        return o, torch.autograd.grad(o, ts, do.to(o.dtype))

    tfa.reset_launch_counts()
    o_k, g_k = grads(lambda *t: tfa.flash_attention_bhld(*t, causal=True),
                     leaves)
    torch.cuda.synchronize()
    assert tfa.launch_counts() == {
        w: {"fma": 0, "wgmma": 0, "wgmma_f32": 0, "wgmma_f16": 1}
        for w in ("fwd", "dq", "dkv")}
    assert tfa.split_bf16_terms.launches == 0
    o_p, g_p = grads(
        lambda *t: tfa.reference_attention_bhld(*t, causal=True), leaves)
    _, g_r = grads(lambda *t: attention_f64(*t, True),
                   [t.detach().double().requires_grad_() for t in leaves])
    assert_f16_close(o_k, o_p, tol=FWD_TOL)
    for gk, gp, gr in zip(g_k, g_p, g_r):
        assert gk.dtype == torch.float16
        assert _rel_l2(gk, gr) <= 2 * _rel_l2(gp, gr) + 2.0 ** -24

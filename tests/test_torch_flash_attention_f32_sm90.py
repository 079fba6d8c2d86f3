"""The float32 tensor-core kernels of the port's flash attention (route
``wgmma_f32``): the forward (``csrc/flash_attention_fwd_f32_sm90.cu``) and
the dQ and dK/dV backward (``csrc/flash_attention_bwd_f32_sm90.cu`` at head
dims 64 and 128, ``csrc/flash_attention_bwd_f32_d256_sm90.cu`` at 256). Their
arithmetic emulated in plain torch against the JAX kernels, their split
pre-pass, their routing, and, on the card, the kernels against their plain
versions.

The kernels keep the reference's float32-operand numerics on bf16 tensor
cores: each float32 operand x of every product (Q, K, V and dO, and the P,
P M and dS the kernels make) enters as three bf16 terms ``x0 = bf16(x)``,
``x1 = bf16(x - x0)``, ``x2 = bf16(x - x0 - x1)``, and each product keeps
the six term pairs with ``i + j <= 2``. The CPU tests emulate that in
float32 torch (products of bf16 values are exact in float32) and hold it
against the Pallas kernels in interpret mode at the reference's float32
tolerances (forward 1e-5; backward rtol 2e-4, atol 2e-5) on float32 inputs
that are not bf16 values. The dropped pairs and the truncation of each
operand are of order 2^-24 of the products, float32's own rounding, so the
emulation is also close to a float64 computation, which one bf16 term per
operand is not.

The forward and the backward run at head dims 64, 128 and 256; the
emulation covers all three.

The tests marked ``cuda`` run the kernels on the card and skip without one:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_f32_sm90.py``.
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


def _f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------- the split, emulated
def split_terms(x: torch.Tensor, terms: int):
    """A float32 tensor as ``terms`` bf16 parts (``csrc/sm90.cuh``
    ``split_slice``), each returned as float32."""
    parts = []
    for _ in range(terms):
        t = x.to(torch.bfloat16).float()
        parts.append(t)
        x = x - t
    return parts


def pair_product(a, b, eq, terms):
    """``einsum(eq, a, b)`` with both float32 operands as ``terms`` bf16
    terms, keeping the term pairs ``i + j < terms`` (six for three terms),
    each pair's product summed in float32: what the kernel's wgmmas do."""
    ta, tb = split_terms(a, terms), split_terms(b, terms)
    return sum(torch.einsum(eq, ta[i], tb[j]) for i in range(terms)
               for j in range(terms) if i + j < terms)


def emulated_fwd(q, k, v, causal, bias, terms=3):
    """(o, lse) with S = Q K^T and O = P V as :func:`pair_product`."""
    s = pair_product(q, k, "bhqd,bhkd->bhqk", terms) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    return pair_product(p, v, "bhqk,bhkd->bhqd", terms), lse


def emulated_bwd(q, k, v, bias, o, lse, do, causal, terms=3):
    """``(dq, dk, dv, ds)`` as the wgmma_f32 dQ and dK/dV kernels take them:
    S = Q K^T, dP = dO V^T, dQ = dS K, dK = dS^T Q and dV = P^T dO each as
    :func:`pair_product`; ``ds`` float32, what the dQ kernel writes as the
    bias gradient before its reduction."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = pair_product(q, k, "bhqd,bhkd->bhqk", terms) * scale
    if bias is not None:
        s = s + bias
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p * torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    dp = pair_product(do, v, "bhqd,bhkd->bhqk", terms)
    ds = p * (dp - (do * o).sum(-1)[..., None])
    dq = pair_product(ds, k, "bhqk,bhkd->bhqd", terms) * scale
    dk = pair_product(ds, q, "bhqk,bhqd->bhkd", terms) * scale
    dv = pair_product(p, do, "bhqk,bhqd->bhkd", terms)
    return dq, dk, dv, ds


# (causal, D, Lq, Lk, bias): causal and not, D 64, 128 and 256, Lq != Lk
# both ways, a bias broadcast over the batch
_JAX_CASES = [(True, 64, 256, 256, False), (False, 64, 256, 256, False),
              (True, 128, 256, 256, False), (False, 128, 128, 256, True),
              (True, 128, 128, 256, True), (False, 64, 256, 128, True),
              (True, 256, 256, 256, False), (False, 256, 128, 256, True)]


@pytest.mark.parametrize("causal,d,lq,lk,bias", _JAX_CASES)
def test_six_product_forward_matches_jax(jfa, interpret_pallas, causal, d,
                                         lq, lk, bias):
    """The kernel's arithmetic on float32 inputs against the Pallas
    forward at the reference's float32 forward tolerance."""
    import jax.numpy as jnp

    q, k, v = _f32((2, 2, lq, d), 0), _f32((2, 2, lk, d), 1), \
        _f32((2, 2, lk, d), 2)
    b = _f32((1, 2, lq, lk), 3) if bias else None
    o_j, lse_j = jfa._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if b is None else jnp.asarray(b), jnp.int32(0), causal, 0.0,
        block_q=128, block_k=128)
    o_t, lse_t = emulated_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal, None if b is None else
                              torch.from_numpy(b))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               **FWD_TOL)


@pytest.mark.parametrize("causal,d,lq,lk,bias", _JAX_CASES)
def test_six_product_backward_matches_jax(jfa, interpret_pallas, causal, d,
                                          lq, lk, bias):
    """The backward kernels' arithmetic on float32 inputs against
    ``_flash_bwd_impl`` on the forward's own (o, lse), at the reference's
    float32 backward tolerance: dQ, dK, dV, and dbias, the emulated dS summed
    over the batch the bias broadcasts over."""
    import jax.numpy as jnp

    q, k, v = _f32((2, 2, lq, d), 10), _f32((2, 2, lk, d), 11), \
        _f32((2, 2, lk, d), 12)
    do = _f32((2, 2, lq, d), 13)
    b = _f32((1, 2, lq, lk), 14) if bias else None
    jb = None if b is None else jnp.asarray(b)
    o, lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jb, jnp.int32(0), causal,
                                 0.0, block_q=128, block_k=128)
    dq_j, dk_j, dv_j, dbias_j = jfa._flash_bwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, jnp.int32(0), o,
        lse[..., 0], jnp.asarray(do), causal, 0.0, block_q=128, block_k=128)
    dq, dk, dv, ds = emulated_bwd(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if b is None else torch.from_numpy(b),
        torch.from_numpy(np.array(o)),
        torch.from_numpy(np.asarray(lse)[..., 0].copy()),
        torch.from_numpy(do), causal)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD_TOL)
    if bias:
        np.testing.assert_allclose(ds.sum(0, keepdim=True).numpy(),
                                   np.asarray(dbias_j), **BWD_TOL)
    else:
        assert dbias_j is None


@pytest.mark.parametrize("d", [64, 128, 256])
def test_six_product_backward_keeps_float32_accuracy(d):
    """The backward's six term pairs against a float64 backward: within
    a few 1e-6 of the gradients' scale, where bf16 operands (one term
    each) are off by more than 1e-3 of it."""
    q, k, v, do = (torch.from_numpy(_f32((1, 2, 128, d), s))
                   for s in (15, 16, 17, 18))
    o, lse = emulated_fwd(q, k, v, True, None)
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", q64, k64) / math.sqrt(d)
                  - lse.double()[..., None]).tril()
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do64, v64)
              - (do64 * o.double()).sum(-1)[..., None])
    want = (torch.einsum("bhqk,bhkd->bhqd", ds, k64) / math.sqrt(d),
            torch.einsum("bhqk,bhqd->bhkd", ds, q64) / math.sqrt(d),
            torch.einsum("bhqk,bhqd->bhkd", p, do64))
    for terms, low, high in ((3, 0.0, 4e-6), (1, 1e-3, float("inf"))):
        got = emulated_bwd(q, k, v, None, o, lse, do, True, terms)
        for x, y in zip(got[:3], want[:3]):
            rel = ((x.double() - y).abs().max() / y.abs().max()).item()
            assert low < rel < high, (terms, rel)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_six_products_keep_float32_accuracy_and_one_term_does_not(d):
    """What the split buys: six term pairs are within 1e-6 of a float64
    forward, or (at D = 256, where float32 itself is further off) as close
    as the plain float32 forward is; bf16 operands (one term each) are far
    from it."""
    q, k, v = (torch.from_numpy(_f32((1, 2, 128, d), s)) for s in (4, 5, 6))
    scale = 1.0 / math.sqrt(d)
    s64 = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * scale
    s64 = s64.masked_fill(~torch.ones(128, 128, dtype=torch.bool).tril(),
                          float("-inf"))
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s64, -1), v.double())
    six, _ = emulated_fwd(q, k, v, True, None, terms=3)
    one, _ = emulated_fwd(q, k, v, True, None, terms=1)
    f32 = tfa.reference_attention_fwd(q, k, v, causal=True)[0]
    limit = max(1e-6, (f32.double() - want).abs().max().item())
    assert (six.double() - want).abs().max() < limit
    assert (one.double() - want).abs().max() > 1e-4


def test_three_terms_truncate_below_float32_rounding():
    """The split's remainder: |x - x0 - x1 - x2| <= 2^-24 |x| on values
    across many binades, and every term is a bf16 value."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal(8192)
                          * np.exp2(rng.integers(-30, 30, 8192)))
                         .astype(np.float32))
    parts = split_terms(x, 3)
    for t in parts:
        assert torch.equal(t, t.to(torch.bfloat16).float())
    err = (x.double() - sum(t.double() for t in parts)).abs()
    assert bool((err <= 2.0 ** -24 * x.double().abs()).all())


# ------------------------------------------------- the split pre-pass
def test_plain_prepass_equals_split_terms():
    """The pre-pass's plain version (what the kernel writes, and what the
    wrapper runs on CPU tensors) on strided views of a fused qkv: three
    bf16 terms per operand, term t at batch t B + b."""
    B, L, H, D = 2, 40, 3, 64
    qkv = torch.from_numpy(_f32((B, L, 3, H, D), 8))
    views = tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
    outs = tfa.split_bf16_terms(*views)
    assert tfa.split_bf16_terms.launches == 0  # CPU: no kernel
    for x, got in zip(views, outs):
        assert got.dtype == torch.bfloat16 and got.shape == (3 * B, H, L, D)
        assert got.is_contiguous()
        for t, part in enumerate(split_terms(x, 3)):
            assert torch.equal(got[t * B:(t + 1) * B].float(), part)


def test_prepass_takes_one_to_three_operands():
    x = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="1 to 3"):
        tfa.split_bf16_terms()
    with pytest.raises(ValueError, match="1 to 3"):
        tfa.split_bf16_terms(x, x, x, x)


# ------------------------------------------------------------ routing
class _FakeStream:
    cuda_stream = 0


@pytest.mark.parametrize("dtype,d,route", [
    (torch.float32, 64, "wgmma_f32"), (torch.float32, 128, "wgmma_f32"),
    (torch.float32, 256, "wgmma_f32"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.float16, 64, "wgmma_f16"), (torch.float16, 128, "wgmma_f16"),
    (torch.float16, 256, "wgmma_f16")])
def test_forward_launches_the_route_of_dtype_and_head_dim(dtype, d, route):
    """``_launch_fwd`` hands a (dtype, D) input to the C entry of its
    route, and only to it, and counts the launch there. The C entries are
    stubbed (the kernels need a card); the wrapper's own logic runs as it
    does on one. The float32 route reads the split's [3 B, H, L, D] terms,
    whose TMA maps span 3 B batches."""
    B, H, L = 2, 3, 64
    calls = []

    def entry(name):
        return lambda: lambda *a: calls.append((name, a)) or 0

    qkv = torch.zeros(B, L, 3, H, d, dtype=dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    with mock.patch.object(tfa, "_fwd_fn", entry("fma")), \
            mock.patch.object(tfa, "_fwd_sm90_fn", entry("wgmma")), \
            mock.patch.object(tfa, "_fwd_f32_sm90_fn", entry("wgmma_f32")), \
            mock.patch.object(tfa, "_fwd_f16_sm90_fn", entry("wgmma_f16")), \
            mock.patch.object(torch.cuda, "device",
                              lambda dev: mock.MagicMock()), \
            mock.patch.object(torch.cuda, "current_stream",
                              lambda dev: _FakeStream()):
        tfa.reset_launch_counts()
        o, lse = tfa._launch_fwd(q, k, v, True, None, None, 0.0, 0)
    assert [name for name, _ in calls] == [route]
    assert tfa.launch_counts()["fwd"] == {
        r: int(r == route) for r in ("fma", "wgmma", "wgmma_f32",
                                     "wgmma_f16")}
    assert o.dtype == dtype and o.shape == (B, H, L, d)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, L)
    if route != "fma":
        geo = list(calls[0][1][11])  # 3 maps of 14 words: D, then dims
        batches = [w for i in range(3) for w in geo[14 * i + 1:14 * i + 4]
                   if w not in (H, L)]
        assert batches == [3 * B if route == "wgmma_f32" else B] * 3
    tfa.reset_launch_counts()


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 256),
                                     (torch.float32, 128)])
def test_fma_forward_launcher_takes_any_input_and_counts_nothing(dtype, d):
    """``_launch_fwd_fma``, the yardstick the tensor-core forwards are
    timed against, hands an input that routes to the tensor cores to the
    FMA entry, and to it only, and moves no launch count. The C entries
    are stubbed, as above."""
    B, H, L = 2, 3, 64
    calls = []

    def entry(name):
        return lambda: lambda *a: calls.append(name) or 0

    q, k, v = (torch.zeros(B, H, L, d, dtype=dtype) for _ in range(3))
    with mock.patch.object(tfa, "_fwd_fn", entry("fma")), \
            mock.patch.object(tfa, "_fwd_sm90_fn", entry("wgmma")), \
            mock.patch.object(tfa, "_fwd_f32_sm90_fn", entry("wgmma_f32")), \
            mock.patch.object(tfa, "_fwd_f16_sm90_fn", entry("wgmma_f16")), \
            mock.patch.object(torch.cuda, "device",
                              lambda dev: mock.MagicMock()), \
            mock.patch.object(torch.cuda, "current_stream",
                              lambda dev: _FakeStream()):
        tfa.reset_launch_counts()
        o, lse = tfa._launch_fwd_fma(q, k, v, True, None, None, 0.0, 0)
    assert tfa.kernel_route(dtype, d, "fwd") != "fma"
    assert calls == ["fma"]
    assert all(n == 0 for c in tfa.launch_counts().values()
               for n in c.values())
    assert o.shape == (B, H, L, d) and lse.shape == (B, H, L)


@pytest.mark.parametrize("d,route", [(64, "wgmma_f32"), (128, "wgmma_f32"),
                                     (256, "wgmma_f32")])
@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_float32_backward_takes_the_tensor_cores_at_every_head_dim(which, d,
                                                                   route):
    """float32 dQ and dK/dV take the wgmma_f32 kernels at every head dim,
    as the forward does (D = 256: flash_attention_bwd_f32_d256_sm90.cu)."""
    assert tfa.kernel_route(torch.float32, d, which) == route


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_backward_refuses_terms_of_another_shape(which, d):
    """The wgmma_f32 kernels read the given terms by TMA, which reads past a
    tensor's end as zeros: terms that are not [3 B, H, L, D] bf16 raise
    before any launch, at D = 64 and at D = 256 (its own kernels)."""
    q = torch.zeros(2, 2, 64, d)
    stats = torch.zeros(2, 2, 64)
    good = tfa._backward_terms(q, q, q, q)
    wrapper = getattr(tfa, f"flash_attention_bwd_{which}")
    for bad in ((good[0][:3], *good[1:]),
                (*good[:3], good[3].float()),
                (good[0], good[1].transpose(2, 3).contiguous()
                 .transpose(2, 3), *good[2:])):
        with pytest.raises(ValueError, match="terms of"):
            wrapper(q, q, q, None, q, stats, stats, True, terms=bad)


def test_kernel_route_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="fwd, dq or dkv"):
        tfa.kernel_route(torch.float32, 128, "bwd")


# ------------------------------------------------------ on the card
def _views(device, B, L, H, D, seed):
    """q, k, v as the GPT path hands them over: strided [B, H, L, D]
    views of one fused float32 [B, L, 3, H, D] tensor."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn(B, L, 3, H, D, generator=g, device=device)
    return tuple(t[:, :, i].transpose(1, 2) for i in range(3))


def _check_fwd(q, k, v, causal, bias=None):
    tfa.reset_launch_counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, bias=bias)
    torch.cuda.synchronize()
    assert tfa.launch_counts()["fwd"] == {"fma": 0, "wgmma": 0,
                                          "wgmma_f32": 1, "wgmma_f16": 0}
    assert tfa.split_bf16_terms.launches == 1
    o_ref, lse_ref = tfa.reference_attention_fwd(q, k, v, causal=causal,
                                                 bias=bias)
    torch.testing.assert_close(o, o_ref, **FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)
    return o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("L", [64, 512, 1024, 2048])
def test_cuda_f32_forward_matches_plain_at_the_prefill_buckets(cuda_device,
                                                               L):
    """Tolerance: the reference's float32 forward tolerance, 1e-5."""
    _check_fwd(*_views(cuda_device, 1, L, 16, 128, L), causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1024, 2048])
def test_cuda_f32_forward_matches_plain_at_d256(cuda_device, L):
    """D = 256 at the D = 256 prefill's buckets: [1, 8, L, 256] views of
    a fused qkv. Tolerance: the reference's float32 forward tolerance."""
    _check_fwd(*_views(cuda_device, 1, L, 8, 256, L), causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,lq,lk", [(128, False, 384, 640),
                                            (64, True, 640, 384),
                                            (256, False, 384, 640)])
def test_cuda_f32_forward_with_bias_matches_plain(cuda_device, d, causal, lq,
                                                  lk):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(2, 4, n, d, generator=g, device=cuda_device)
               for n in (lq, lk, lk))
    bias = torch.randn(1, 4, lq, lk, generator=g, device=cuda_device)
    _check_fwd(q, k, v, causal, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f32_forward_ragged_matches_plain(cuda_device, d):
    _check_fwd(*_views(cuda_device, 2, 1500, 4, d, 2), causal=True)


@pytest.mark.cuda
def test_cuda_f32_forward_replays_bit_for_bit(cuda_device):
    """No atomics: the same inputs give the same O and LSE."""
    q, k, v = _views(cuda_device, 1, 1500, 16, 128, 3)
    first = tfa.flash_attention_fwd(q, k, v, causal=True)
    second = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_cuda_f32_forward_replays_bit_for_bit_at_d256(cuda_device):
    """No atomics at D = 256 either, with a bias and at the ragged edge."""
    q, k, v = _views(cuda_device, 1, 1500, 8, 256, 3)
    bias = torch.randn(1, 8, 1500, 1500, device=cuda_device)
    first = tfa.flash_attention_fwd(q, k, v, causal=True, bias=bias)
    second = tfa.flash_attention_fwd(q, k, v, causal=True, bias=bias)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f32_dropout_matches_plain_with_the_same_mask(cuda_device, d):
    """p = 0.1: the kernel against the plain version given the plain
    Philox mask, and a fixed seed replays bit for bit."""
    q, k, v = _views(cuda_device, 2, 320, 3, d, 4)
    keep = tfa.dropout_mask(42, 2, 3, 320, 320, 0.1, cuda_device)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                     seed=42)
    again, _ = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                       seed=42)
    o_ref, lse_ref = tfa.reference_attention_fwd(q, k, v, causal=True,
                                                 keep_mask=keep)
    assert torch.equal(o, again)
    torch.testing.assert_close(o, o_ref, **FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)


@pytest.mark.cuda
def test_cuda_split_kernel_equals_plain_bit_for_bit(cuda_device):
    views = _views(cuda_device, 2, 1500, 16, 128, 5)
    tfa.reset_launch_counts()
    got = tfa.split_bf16_terms(*views)
    torch.cuda.synchronize()
    assert tfa.split_bf16_terms.launches == 1
    for x, t in zip(views, got):
        assert torch.equal(t, tfa._plain_split(x))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f32_selfcheck(cuda_device, d):
    """Both products of the float32 path on [64, D] float32 operands
    against float64: the six term pairs leave a few 2^-24 of sum |a b|,
    the float32 sum over K another K 2^-24 of it."""
    a, b, c1, c2 = tfa.wgmma_selfcheck(d, cuda_device, dtype=torch.float32)
    torch.cuda.synchronize()
    for got, x, y in ((c1, a, b.T), (c2, a[:, :64], b)):
        limit = 2 * (x.shape[1] + 4) * 2.0 ** -24 * (x.double().abs()
                                                      @ y.double().abs())
        assert bool(((got.double() - x.double() @ y.double()).abs()
                     <= limit).all())


# ------------------------------------------- the backward on the card
def _bwd_case(device, d, causal, lq, lk, bias, seed):
    """float32 (q, k, v, do, bias) of 2 batches and 3 heads (D = 256: 8
    heads, the D = 256 model's): at Lq == Lk q/k/v are views of a fused qkv
    and dO a transposed [B, L, H, D] gradient, as the GPT path hands them
    over; otherwise contiguous."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    B, H = 2, 8 if d == 256 else 3
    if lq == lk:
        q, k, v = _views(device, B, lq, H, d, seed)
        do = rn(B, lq, H, d).transpose(1, 2)
    else:
        q, k, v, do = rn(B, H, lq, d), rn(B, H, lk, d), rn(B, H, lk, d), \
            rn(B, H, lq, d)
    return q, k, v, do, rn(1, H, lq, lk) if bias else None


# (d, causal, lq, lk, bias): D 64, 128 and 256, causal and not, the
# training length, ragged lengths, Lq != Lk, a trained bias under the
# causal mask; D = 256 at the float32 D = 256 run's [2, 8, 1024, 256]
_BWD_CUDA_CASES = [(64, True, 1024, 1024, False),
                   (128, True, 1024, 1024, False),
                   (128, True, 1500, 1500, False),
                   (64, False, 1500, 1500, False),
                   (128, False, 384, 640, True),
                   (64, True, 1000, 1000, True),
                   (256, True, 1024, 1024, False),
                   (256, True, 1500, 1500, False),
                   (256, False, 384, 640, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,lq,lk,bias", _BWD_CUDA_CASES)
def test_cuda_f32_backward_matches_plain(cuda_device, d, causal, lq, lk,
                                         bias):
    """dQ, dK, dV (and dbias, from the dS the dQ kernel writes) of the
    wgmma_f32 kernels against the plain backward, at the reference's
    float32 backward tolerance; one split launch for q, k, v and one for
    dO, shared by both kernels."""
    q, k, v, do, b = _bwd_case(cuda_device, d, causal, lq, lk, bias, 6)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, bias=b)
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, b, o, lse, do, causal)
    torch.cuda.synchronize()
    for which in ("dq", "dkv"):
        assert tfa.launch_counts()[which] == {"fma": 0, "wgmma": 0,
                                              "wgmma_f32": 1, "wgmma_f16": 0}
    assert tfa.split_bf16_terms.launches == 2
    want = tfa.reference_attention_bwd(q, k, v, b, o, lse, do, causal)
    for x, y in zip(got[:3], want[:3]):
        torch.testing.assert_close(x, y, **BWD_TOL)
    if bias:
        torch.testing.assert_close(got[3], want[3].sum(0, keepdim=True),
                                   **BWD_TOL)
    else:
        assert got[3] is None


def _assert_f32_route(*which, splits):
    """Every kernel in ``which`` launched once per call on wgmma_f32, the
    split ``splits`` times (two per operand set: q, k, v, then dO)."""
    for w in which:
        assert tfa.launch_counts()[w] == {"fma": 0, "wgmma": 0,
                                          "wgmma_f32": 1, "wgmma_f16": 0}
    assert tfa.split_bf16_terms.launches == splits


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f32_dq_writes_ds_with_zeros_above_the_diagonal(cuda_device, d):
    """The dQ kernel's float32 dS (the bias gradient before its reduction)
    against the plain dS, causal and ragged: every element above the
    diagonal, in the diagonal tiles and in the tiles the kernel skips, is
    written as 0."""
    q, k, v, do, b = _bwd_case(cuda_device, d, True, 700, 700, True, 7)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, bias=b)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    tfa.reset_launch_counts()
    _, ds = tfa.flash_attention_bwd_dq(q, k, v, b, do, lse, delta, True,
                                       emit_ds=True)
    torch.cuda.synchronize()
    _assert_f32_route("dq", splits=2)
    want = tfa.reference_attention_bwd(q, k, v, b, o, lse, do, True)[3]
    torch.testing.assert_close(ds, want, **BWD_TOL)
    assert bool((ds.triu(1) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f32_backward_replays_bit_for_bit(cuda_device, d):
    """No atomics: the same inputs give the same dQ, dS, dK and dV."""
    q, k, v, do, b = _bwd_case(cuda_device, d, True, 1500, 1500, True, 8)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, bias=b)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    terms = tfa._backward_terms(q, k, v, do)

    def run():
        return (*tfa.flash_attention_bwd_dq(q, k, v, b, do, lse, delta, True,
                                            emit_ds=True, terms=terms),
                *tfa.flash_attention_bwd_dkv(q, k, v, b, do, lse, delta,
                                             True, terms=terms))

    tfa.reset_launch_counts()
    first = run()
    torch.cuda.synchronize()
    _assert_f32_route("dq", "dkv", splits=0)
    second = run()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f32_backward_dropout_matches_plain_with_the_same_mask(
        cuda_device, d):
    """p = 0.1: dQ, dK and dV against the plain backward given the plain
    Philox mask, at the reference's backward tolerance, and a fixed seed
    replays bit for bit."""
    q, k, v, do, _ = _bwd_case(cuda_device, d, True, 320, 320, False, 9)
    B, H = q.shape[:2]
    keep = tfa.dropout_mask(42, B, H, 320, 320, 0.1, cuda_device)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                     seed=42)
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, None, o, lse, do, True, 0.1, 42)
    torch.cuda.synchronize()
    _assert_f32_route("dq", "dkv", splits=2)
    again = tfa.flash_attention_bwd(q, k, v, None, o, lse, do, True, 0.1, 42)
    assert tfa.launch_counts()["dkv"]["wgmma_f32"] == 2
    want = tfa.reference_attention_bwd(q, k, v, None, o, lse, do, True, keep)
    for x, y, z in zip(got[:3], again[:3], want[:3]):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, **BWD_TOL)


# ------------------------------------------------------------ float16
# float16 inputs take the native float16 kernels (wgmma_f16) at every
# head dim, and the wgmma_f32 forward stays callable on them as the
# yardstick of the native float16 forward: a float16 value is exactly two
# bf16 terms (11
# significant bits; bf16 has float32's exponent range), so the split is
# exact and the kernels compute what the float32 ones compute on the
# upcast inputs, the reference's float32-operand arithmetic. O and the
# gradients are then rounded to float16 once: against the plain version
# (the same float32 arithmetic, rounded once) they may differ by the
# float32 tolerance plus one float16 ulp of the element, where the two
# float32 values fall on either side of a rounding boundary.
def _f16_ulp(x):
    """float16 spacing at |x| (11 significant bits, subnormal spacing
    2^-24 below 2^-14), elementwise."""
    _, e = torch.frexp(x.float().abs())
    return torch.exp2(torch.clamp(e - 11, min=-24).float())


def _assert_f16_close(got, want, tol):
    assert got.dtype == want.dtype == torch.float16
    limit = tol["atol"] + tol["rtol"] * want.float().abs() + _f16_ulp(want)
    assert bool(((got.float() - want.float()).abs() <= limit).all())


def test_plain_prepass_splits_float16_exactly():
    """Every finite float16 value (all 63488 bit patterns that are not inf
    or nan, subnormals included) is the sum of its first two bf16 terms,
    and its third term is zero."""
    bits = torch.arange(0, 2 ** 16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.float16)
    x = x[torch.isfinite(x)]
    assert x.numel() == 63488
    terms = tfa.split_bf16_terms(x.view(1, 1, -1, 1).expand(1, 1, -1, 4)
                                 .contiguous())[0]
    t = terms.float().view(3, -1, 4)[:, :, 0]
    assert torch.equal(t[0] + t[1], x.float())
    assert not bool(t[2].any())


def test_float16_takes_the_float32_kernels_on_the_card_only():
    """float16 routes to the native float16 kernels (wgmma_f16) for the
    forward, dQ and dK/dV at every head dim, to the float32 ones
    (wgmma_f32) nowhere; the gate admits it on the card; on the CPU the
    wrappers run the plain version, which computes in float32 and rounds O
    once."""
    for d in tfa.SUPPORTED_HEAD_DIMS:
        for kernel in ("fwd", "dq", "dkv"):
            assert tfa.kernel_route(torch.float16, d, kernel) == "wgmma_f16"
    q, k, v = (torch.from_numpy(_f32((1, 2, 40, 64), s)).half()
               for s in range(3))
    tfa.reset_launch_counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert all(n == 0 for c in tfa.launch_counts().values()
               for n in c.values())
    o32, lse32 = tfa.reference_attention_fwd(q.float(), k.float(),
                                             v.float(), causal=True)
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    assert torch.equal(o, o32.half()) and torch.equal(lse, lse32)


def _f16_views(device, B, L, H, D, seed):
    return tuple(t.half() for t in _views(device, B, L, H, D, seed))


@pytest.mark.cuda
def test_cuda_split_kernel_equals_plain_for_float16(cuda_device):
    """The split kernel reads float16 views of a fused qkv as they are and
    writes what the plain split writes, bit for bit: two exact terms and a
    zero third."""
    views = _f16_views(cuda_device, 2, 1500, 16, 128, 15)
    tfa.reset_launch_counts()
    got = tfa.split_bf16_terms(*views)
    torch.cuda.synchronize()
    assert tfa.split_bf16_terms.launches == 1
    for x, t in zip(views, got):
        assert torch.equal(t, tfa._plain_split(x))
        assert not bool(t[2 * x.shape[0]:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_f16_selfcheck(cuda_device, d):
    """Both products of the float16 self-check (the wgmma_f16 kernels'
    native forms) on [64, D] float16 operands against float64, within the
    float32 self-check's limit."""
    a, b, c1, c2 = tfa.wgmma_selfcheck(d, cuda_device, dtype=torch.float16)
    torch.cuda.synchronize()
    for got, x, y in ((c1, a, b.T), (c2, a[:, :64], b)):
        limit = 2 * (x.shape[1] + 4) * 2.0 ** -24 * (x.double().abs()
                                                      @ y.double().abs())
        assert bool(((got.double() - x.double() @ y.double()).abs()
                     <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,lq,lk,bias", [
    (128, True, 1024, 1024, False), (64, True, 1500, 1500, False),
    (256, True, 1024, 1024, False), (128, False, 384, 640, True)])
def test_cuda_f16_forward_matches_plain(cuda_device, d, causal, lq, lk, bias):
    """The wgmma_f32 forward on float16 inputs, launched directly (the
    yardstick of the wgmma_f16 forward, which the route takes): O float16
    within the float32 tolerance plus one float16 ulp of the plain O, LSE
    float32 within the float32 tolerance; one split launch, no count on a
    route."""
    q, k, v, _, b = _bwd_case(cuda_device, d, causal, lq, lk, bias, 16)
    q, k, v = q.half(), k.half(), v.half()
    tfa.reset_launch_counts()
    o, lse = tfa._launch_fwd_sm90("wgmma_f32", q, k, v, causal, b, None,
                                  0.0, 0)
    torch.cuda.synchronize()
    assert tfa.launch_counts()["fwd"] == {"fma": 0, "wgmma": 0,
                                          "wgmma_f32": 0, "wgmma_f16": 0}
    assert tfa.split_bf16_terms.launches == 1
    o_ref, lse_ref = tfa.reference_attention_fwd(q, k, v, causal=causal,
                                                 bias=b)
    _assert_f16_close(o, o_ref, FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, **FWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,lq,lk,bias", [
    (128, True, 1024, 1024, False), (64, True, 1500, 1500, False),
    (256, True, 1024, 1024, False), (128, False, 384, 640, True)])
def test_cuda_f16_backward_matches_plain(cuda_device, d, causal, lq, lk,
                                         bias):
    """dQ, dK and dV of the float16 kernels (wgmma_f16 at every D, no
    split) on float16 inputs, float16 within the float32 backward
    tolerance plus one float16 ulp; dbias (float32, from dS) within the
    float32 tolerance."""
    q, k, v, do, b = _bwd_case(cuda_device, d, causal, lq, lk, bias, 17)
    q, k, v, do = q.half(), k.half(), v.half(), do.half()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, bias=b)
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, b, o, lse, do, causal)
    torch.cuda.synchronize()
    for w in ("dq", "dkv"):
        assert tfa.launch_counts()[w] == {"fma": 0, "wgmma": 0,
                                          "wgmma_f32": 0, "wgmma_f16": 1}
    assert tfa.split_bf16_terms.launches == 0
    want = tfa.reference_attention_bwd(q, k, v, b, o, lse, do, causal)
    for x, y in zip(got[:3], want[:3]):
        _assert_f16_close(x, y, BWD_TOL)
    if bias:
        torch.testing.assert_close(got[3], want[3].sum(0, keepdim=True),
                                   **BWD_TOL)

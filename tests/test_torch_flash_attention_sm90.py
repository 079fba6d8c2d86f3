"""The bf16 tensor-core route of the port's flash attention: the wgmma
forward, dQ and dK/dV kernels (``csrc/flash_attention_fwd_sm90.cu``,
``csrc/flash_attention_bwd_dq_sm90.cu``,
``csrc/flash_attention_bwd_dkv_sm90.cu``; all three at head dims 64, 128
and 256), their routing and the TMA geometry their wrappers compute.

The kernels keep the reference's default numerics (``_operand_dtype``:
float32 operands for both probability products, also for bf16 inputs) by
feeding each float32 matrix they make (P, dS) to bf16 tensor cores as a sum
of bf16 terms, ``t0 = bf16(x)``, ``t1 = bf16(x - t0)``, ``t2 = bf16(x - t0
- t1)``. The CPU tests emulate that arithmetic in plain torch and hold it
against the JAX kernels in Pallas interpret mode, on float32 inputs rounded
to bf16-representable values (so no rounding of the outputs to bf16 hides
a difference). Tolerance: 1e-5, the reference's float32 forward
tolerance; each bf16 term keeps 8 significant bits, so two terms leave at
most 2^-16 of sum |p v| per element and three 2^-24 (float32's own
rounding), both below it at these sizes. The backward is held to the
reference's float32 backward tolerance (rtol 2e-4, atol 2e-5).

The tests marked ``cuda`` run the kernels on the card against the plain
versions and skip without one:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_sm90.py``.
"""
import math
from unittest import mock

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import _build
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


def _bf16_values(shape, seed):
    """float32 standard normals rounded to bf16-representable values."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _qkv(B, H, Lq, Lk, D):
    return (_bf16_values((B, H, Lq, D), 0), _bf16_values((B, H, Lk, D), 1),
            _bf16_values((B, H, Lk, D), 2))


# ------------------------------------------------- the split, emulated
def split_terms(x: torch.Tensor, terms: int):
    """The kernels' split of a float32 matrix into ``terms`` bf16 parts
    (``csrc/sm90.cuh`` ``split_slice``), each returned as float32."""
    parts = []
    for _ in range(terms):
        t = x.to(torch.bfloat16).float()
        parts.append(t)
        x = x - t
    return parts


def split_product(a: torch.Tensor, b: torch.Tensor, terms: int, eq: str):
    """``einsum(eq, a, b)`` with the float32 ``a`` taken as its bf16 terms
    and each term's product summed in float32 (what the wgmma kernels do;
    ``b`` holds bf16 values)."""
    return sum(torch.einsum(eq, t, b) for t in split_terms(a, terms))


def _scores(q, k, causal, bias):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def emulated_fwd(q, k, v, causal, bias, terms):
    s = _scores(q, k, causal, bias)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    return split_product(p, v, terms, "bhqk,bhkd->bhqd"), lse


def emulated_bwd(q, k, v, bias, o, lse, do, causal, terms):
    """``(dq, dk, dv, ds)`` as the wgmma dQ and dK/dV kernels take them:
    dS (float32, also what the dQ kernel writes as the bias gradient)
    enters dS K and dS^T Q, and P enters P^T dO, as ``terms`` bf16 terms."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal, bias) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    delta = (do * o).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = split_product(ds, k, terms, "bhqk,bhkd->bhqd") * scale
    dv = split_product(p, do, terms, "bhqk,bhqd->bhkd")
    dk = split_product(ds, q, terms, "bhqk,bhqd->bhkd") * scale
    return dq, dk, dv, ds


def test_split_terms_bound():
    """Each term keeps 8 significant bits: |x - sum of n terms| <=
    2^-8n |x|, and the terms are bf16 values."""
    x = torch.from_numpy(np.random.default_rng(5).random(4096).astype(np.float32))
    for terms, bound in ((1, 2.0 ** -8), (2, 2.0 ** -16), (3, 2.0 ** -24)):
        parts = split_terms(x, terms)
        for t in parts:
            assert torch.equal(t, t.to(torch.bfloat16).float())
        err = (x.double() - sum(t.double() for t in parts)).abs()
        assert bool((err <= bound * x.double().abs()).all())


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("causal", [False, True])
def test_split_forward_matches_jax(jfa, interpret_pallas, causal, terms):
    import jax.numpy as jnp

    q, k, v = _qkv(1, 2, 256, 256, 64)
    o_j = jfa.flash_attention_bhld(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   block_q=128, block_k=128)
    o_t, _ = emulated_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                          None, terms)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **FWD_TOL)


@pytest.mark.parametrize("terms", [2, 3])
def test_split_forward_with_bias_matches_jax(jfa, interpret_pallas, terms):
    import jax.numpy as jnp

    q, k, v = _qkv(2, 2, 128, 256, 128)
    bias = _bf16_values((1, 2, 128, 256), 7)
    o_j = jfa.flash_attention_bhld(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   bias=jnp.asarray(bias), block_q=128,
                                   block_k=128)
    o_t, _ = emulated_fwd(*(torch.from_numpy(a) for a in (q, k, v)), True,
                          torch.from_numpy(bias), terms)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **FWD_TOL)


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("causal", [False, True])
def test_split_backward_matches_jax(jfa, interpret_pallas, causal, terms):
    """dK and dV of the split against ``_flash_bwd_impl`` on the same
    (o, lse, dO)."""
    import jax.numpy as jnp

    q, k, v = _qkv(1, 2, 256, 256, 64)
    do = _bf16_values((1, 2, 256, 64), 4)
    o, lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), None, jnp.int32(0), causal,
                                 0.0, block_q=128, block_k=128)
    _, dk_j, dv_j, _ = jfa._flash_bwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, jnp.int32(0),
        o, lse[..., 0], jnp.asarray(do), causal, 0.0, block_q=128,
        block_k=128)
    _, dk, dv, _ = emulated_bwd(
        *(torch.from_numpy(a) for a in (q, k, v)), None,
        torch.from_numpy(np.array(o)),
        torch.from_numpy(np.asarray(lse)[..., 0].copy()),
        torch.from_numpy(do), causal, terms)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_j), **BWD_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_j), **BWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_split_forward_matches_jax_at_d256(jfa, interpret_pallas, causal):
    """D = 256, as the forward kernel takes it there: the three-term P V
    against ``flash_attention_bhld`` in interpret mode."""
    import jax.numpy as jnp

    q, k, v = _qkv(1, 2, 256, 256, 256)
    o_j = jfa.flash_attention_bhld(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   block_q=128, block_k=128)
    o_t, _ = emulated_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                          None, 3)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_split_backward_matches_jax_at_d256(jfa, interpret_pallas, causal):
    """D = 256: dK and dV of the split against ``_flash_bwd_impl`` on the
    same (o, lse, dO). The kernel's warpgroups each own 128 of the columns
    (``dS^T Q[:, half]``, ``(P M)^T dO[:, half]``, S^T and dP^T over all
    256), which changes no element's sum: each output column is its own
    product."""
    q, k, v = _qkv(1, 2, 256, 256, 256)
    do = _bf16_values((1, 2, 256, 256), 4)
    o, lse, _, dk_j, dv_j, _ = _jax_bwd(jfa, q, k, v, None, do, causal)
    _, dk, dv, _ = emulated_bwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                None, torch.from_numpy(o),
                                torch.from_numpy(lse), torch.from_numpy(do),
                                causal, 3)
    np.testing.assert_allclose(dk.numpy(), dk_j, **BWD_TOL)
    np.testing.assert_allclose(dv.numpy(), dv_j, **BWD_TOL)


def _jax_bwd(jfa, q, k, v, bias, do, causal):
    """``_flash_bwd_impl`` on the forward's own (o, lse): returns numpy
    ``(o, lse, dq, dk, dv, dbias)``."""
    import jax.numpy as jnp

    jb = None if bias is None else jnp.asarray(bias)
    o, lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jb, jnp.int32(0), causal,
                                 0.0, block_q=128, block_k=128)
    grads = jfa._flash_bwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, jnp.int32(0), o,
        lse[..., 0], jnp.asarray(do), causal, 0.0, block_q=128, block_k=128)
    return (np.array(o), np.asarray(lse)[..., 0].copy(),
            *(None if x is None else np.asarray(x) for x in grads))


@pytest.mark.parametrize("terms", [2, 3])
@pytest.mark.parametrize("causal", [False, True])
def test_split_dq_matches_jax(jfa, interpret_pallas, causal, terms):
    """dQ of the split (dS K with dS as its bf16 terms) against
    ``_flash_bwd_impl``'s dq on the same (o, lse, dO)."""
    q, k, v = _qkv(1, 2, 256, 256, 64)
    do = _bf16_values((1, 2, 256, 64), 4)
    o, lse, dq_j, _, _, _ = _jax_bwd(jfa, q, k, v, None, do, causal)
    dq, _, _, _ = emulated_bwd(*(torch.from_numpy(a) for a in (q, k, v)),
                               None, torch.from_numpy(o),
                               torch.from_numpy(lse), torch.from_numpy(do),
                               causal, terms)
    np.testing.assert_allclose(dq.numpy(), dq_j, **BWD_TOL)


def emulated_dq_d256(q, k, v, bias, o, lse, do, causal):
    """``(dq, ds)`` as the D = 256 dQ kernel forms them: per 64-key tile,
    each of the two warpgroups makes S and dP for its 32 keys (over all 256
    columns) and dS there; dS meets in shared memory as three bf16 terms,
    and each warpgroup adds dS K[:, its 128 columns] into its half of dQ,
    16 keys and one term at a time, in float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    Lq, Lk = q.shape[2], k.shape[2]
    delta = (do * o).sum(-1)
    dq = torch.zeros_like(q)
    ds = torch.zeros(*q.shape[:3], Lk)
    rows = torch.arange(Lq)[:, None]
    for k0 in range(0, Lk, 64):
        tile = torch.zeros(*q.shape[:3], 64)
        for kh in (0, 32):                      # the two warpgroups' keys
            keys = slice(k0 + kh, min(k0 + kh + 32, Lk))
            s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, keys]) * scale
            if bias is not None:
                s = s + bias[..., keys]
            p = torch.exp(s - lse[..., None])
            if causal:
                p = p * (rows >= torch.arange(keys.start, keys.stop))
            dp = torch.einsum("bhqd,bhkd->bhqk", do, v[:, :, keys])
            part = p * (dp - delta[..., None])
            tile[..., kh:kh + part.shape[-1]] = part
            ds[..., keys] = part
        for col0 in (0, 128):                   # the two warpgroups' columns
            cols = slice(col0, col0 + 128)
            for kk in range(0, min(64, Lk - k0), 16):
                kt = k[:, :, k0 + kk:k0 + kk + 16, cols]
                for term in split_terms(tile[..., kk:kk + kt.shape[2]], 3):
                    dq[..., cols] += torch.einsum("bhqk,bhkd->bhqd", term, kt)
    return dq * scale, ds


@pytest.mark.parametrize("causal", [False, True])
def test_split_dq_matches_jax_at_d256(jfa, interpret_pallas, causal):
    """D = 256: dQ and dS of the dQ kernel's layout (key halves for S and
    dP, column halves for dQ, dS as three bf16 terms) against
    ``_flash_bwd_impl``'s dq and dbias (a bias of one batch, so dbias is
    dS itself) on the same (o, lse, dO), at the reference's float32
    backward tolerance."""
    q, k, v = _qkv(1, 2, 256, 256, 256)
    bias = _bf16_values((1, 2, 256, 256), 8)
    do = _bf16_values((1, 2, 256, 256), 4)
    o, lse, dq_j, _, _, dbias_j = _jax_bwd(jfa, q, k, v, bias, do, causal)
    dq, ds = emulated_dq_d256(*(torch.from_numpy(a) for a in (q, k, v)),
                              torch.from_numpy(bias), torch.from_numpy(o),
                              torch.from_numpy(lse), torch.from_numpy(do),
                              causal)
    np.testing.assert_allclose(dq.numpy(), dq_j, **BWD_TOL)
    np.testing.assert_allclose(ds.numpy(), dbias_j, **BWD_TOL)


@pytest.mark.parametrize("terms", [2, 3])
def test_split_dq_and_dbias_with_a_trained_bias_match_jax(
        jfa, interpret_pallas, terms):
    """Causal, with a bias broadcast over the batch: the emulated dS summed
    over the batch against the reference's dbias (the dQ kernel writes dS,
    the wrapper reduces it), and dQ with the bias in S."""
    q, k, v = _qkv(2, 2, 256, 256, 128)
    bias = _bf16_values((1, 2, 256, 256), 8)
    do = _bf16_values((2, 2, 256, 128), 9)
    o, lse, dq_j, _, _, dbias_j = _jax_bwd(jfa, q, k, v, bias, do, True)
    dq, _, _, ds = emulated_bwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(bias), torch.from_numpy(o),
                                torch.from_numpy(lse), torch.from_numpy(do),
                                True, terms)
    np.testing.assert_allclose(dq.numpy(), dq_j, **BWD_TOL)
    np.testing.assert_allclose(ds.sum(0, keepdim=True).numpy(), dbias_j,
                               **BWD_TOL)


def test_split_is_closer_to_float32_than_bf16_p():
    """What the split buys: rounding P to bf16 (the reference's
    PT_FLASH_BF16=1 mode) moves O far more than three terms do."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 128, 128, 64))
    p = torch.softmax(_scores(q.double(), k.double(), True, None), -1)
    want = torch.einsum("bhqk,bhkd->bhqd", p, v.double())
    split, _ = emulated_fwd(q, k, v, True, None, 3)
    bf16_p, _ = emulated_fwd(q, k, v, True, None, 1)
    assert (split.double() - want).abs().max() < 1e-6
    assert (bf16_p.double() - want).abs().max() > 1e-4


# ------------------------------------------------------------ routing
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 64, "wgmma_f32"),
    (torch.float32, 128, "wgmma_f32"), (torch.float32, 256, "wgmma_f32"),
    (torch.float16, 128, "wgmma_f16"), (torch.float16, 64, "wgmma_f16"),
    (torch.float16, 256, "wgmma_f16"), (torch.float16, 96, "fma"),
    (torch.float64, 128, "fma")])
def test_route_is_picked_by_dtype_and_head_dim(dtype, d, route, kernel):
    """bf16 takes the wgmma kernels at every head dim, float32 the
    wgmma_f32 ones, float16 the native float16 ones (wgmma_f16; forward,
    dQ and dK/dV alike); what no tensor-core kernel takes (float64, a head
    dim of 96) answers fma, which the wrappers refuse."""
    assert tfa.kernel_route(dtype, d, kernel) == route


def test_cpu_tensors_launch_nothing():
    """CPU tensors run the plain versions on every route: no count moves."""
    tfa.reset_launch_counts()
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 2, 40, 40, 64))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    tfa.flash_attention_bwd(q, k, v, None, o, lse, torch.ones_like(o), True)
    assert tfa.launch_counts() == {"fwd": {"fma": 0, "wgmma": 0,
                                           "wgmma_f32": 0, "wgmma_f16": 0},
                                   "dq": {"fma": 0, "wgmma": 0,
                                          "wgmma_f32": 0, "wgmma_f16": 0},
                                   "dkv": {"fma": 0, "wgmma": 0,
                                           "wgmma_f32": 0, "wgmma_f16": 0}}


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 64, "wgmma_f32"),
    (torch.float32, 128, "wgmma_f32"), (torch.float32, 256, "wgmma_f32"),
    (torch.float16, 64, "wgmma_f16"), (torch.float16, 128, "wgmma_f16"),
    (torch.float16, 256, "wgmma_f16")])
@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_backward_wrappers_launch_the_route_of_dtype_and_head_dim(
        which, dtype, d, route):
    """The dQ and dK/dV wrappers hand a (dtype, D) input to the launcher of
    its :func:`kernel_route` and count the launch under that route, never
    the FMA launcher (no route takes it); the wgmma_f32 launcher gets the
    four operands' bf16 terms, the wgmma and wgmma_f16 ones none. The
    launchers are stubbed (the kernels need a card); the wrapper's own
    logic runs as it does on one."""
    calls = []
    q = torch.zeros(1, 2, 64, d, dtype=dtype)
    stats = torch.zeros(1, 2, 64)
    wrapper = getattr(tfa, f"flash_attention_bwd_{which}")

    def sm90(*a):
        calls.append((a[1], a[0]))
        terms = a[-1]
        assert (terms is None) == (a[1] != "wgmma_f32")
        if terms is not None:
            assert [t.shape for t in terms] == [(3, 2, 64, d)] * 4
            assert all(t.dtype == torch.bfloat16 for t in terms)

    with mock.patch.object(tfa, "_launch_bwd_sm90", sm90), \
            mock.patch.object(tfa, "_launch_bwd",
                              lambda *a: calls.append(("fma", a[0]))):
        tfa.reset_launch_counts()
        wrapper(q, q, q, None, q, stats, stats, True)
    assert calls == [(route, which)]
    assert tfa.launch_counts()[which] == {
        r: int(r == route) for r in ("fma", "wgmma", "wgmma_f32",
                                     "wgmma_f16")}
    tfa.reset_launch_counts()


def test_wgmma_sources_are_built_with_the_rest():
    for source in ("flash_attention_fwd_sm90.cu",
                   "flash_attention_fwd_f32_sm90.cu",
                   "flash_attention_fwd_f16_sm90.cu",
                   "flash_attention_bwd_dq_sm90.cu",
                   "flash_attention_bwd_dkv_sm90.cu",
                   "flash_attention_bwd_f32_sm90.cu",
                   "flash_attention_bwd_f32_d256_sm90.cu",
                   "flash_attention_bwd_f16_sm90.cu"):
        assert source in _build.SOURCES
        text = (_build.CSRC_DIR / source).read_text()
        assert "Replaces: paddle_tpu/kernels/flash_attention.py" in text
        assert '#include "sm90.cuh"' in text


# ------------------------------------------------------- TMA geometry
def _fused_qkv(B, L, H, D):
    t = torch.zeros(B, L, 3, H, D, dtype=torch.bfloat16)
    return tuple(t[:, :, i].transpose(1, 2) for i in range(3))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_tma_geometry_of_fused_qkv_views(i):
    """q, k, v as the GPT path hands them over: [B, H, L, D] views of one
    [B, L, 3, H, D] tensor. Heads are 2D bytes apart, rows 6HD: the map
    puts heads first."""
    B, L, H, D = 2, 1024, 16, 128
    x = _fused_qkv(B, L, H, D)[i]
    assert tfa.tma_geometry(x) == (D, H, L, B,
                                   2 * D, 2 * 3 * H * D, 2 * 3 * H * D * L,
                                   64, 1, 64, 1,
                                   2, 1, 3)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_tma_geometry_of_fused_qkv_views_at_d256(i):
    """D = 256: the same views; a row is four 64-column (128-byte) boxes,
    which the kernels load as the tile's four swizzle atoms."""
    B, L, H, D = 1, 1024, 8, 256
    x = _fused_qkv(B, L, H, D)[i]
    geo = tfa.tma_geometry(x)
    assert geo == (D, H, L, B,
                   2 * D, 2 * 3 * H * D, 2 * 3 * H * D * L,
                   64, 1, 64, 1,
                   2, 1, 3)
    assert geo[0] // geo[7] == 4


def test_tma_geometry_of_a_transposed_gradient():
    """dO as autograd hands it over: a transposed [B, L, H, D] tensor."""
    B, L, H, D = 2, 1024, 16, 64
    g = torch.zeros(B, L, H, D, dtype=torch.bfloat16).transpose(1, 2)
    assert tfa.tma_geometry(g) == (D, H, L, B, 2 * D, 2 * H * D,
                                   2 * H * D * L, 64, 1, 64, 1, 2, 1, 3)


def test_tma_geometry_of_a_contiguous_tensor():
    B, H, L, D = 2, 16, 1500, 128
    t = torch.zeros(B, H, L, D, dtype=torch.bfloat16)
    assert tfa.tma_geometry(t) == (D, L, H, B, 2 * D, 2 * D * L,
                                   2 * D * L * H, 64, 64, 1, 1, 1, 2, 3)


def test_tma_geometry_puts_size_one_dims_last_with_packed_strides():
    t = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)
    assert tfa.tma_geometry(t) == (64, 64, 1, 1, 128, 8192, 8192,
                                   64, 64, 1, 1, 1, 2, 3)


def test_tma_geometry_refuses_misaligned_strides():
    # rows of 68 bf16 values (136 bytes) cannot be a TMA stride
    t = torch.zeros(1, 2, 64, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 16"):
        tfa.tma_geometry(t)
    assert not tfa._tma_ok(t)


def test_tma_geometry_refuses_a_misaligned_base():
    flat = torch.zeros(1 + 2 * 64 * 64, dtype=torch.bfloat16)
    t = flat[1:].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="aligned"):
        tfa.tma_geometry(t)


def test_tma_geometry_refuses_a_strided_last_dim():
    t = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dim"):
        tfa.tma_geometry(t)


# ------------------------------------------------------ on the card
def _bf16_ulp(x):
    _, e = torch.frexp(x.float().abs())
    return torch.where(x == 0, 0.0, torch.exp2((e - 8).float()))


def _cuda_case(device, d, causal, lq, lk, bias):
    g = torch.Generator(device=device).manual_seed(0)

    def rn(*s):
        return torch.randn(*s, generator=g, device=device)

    q = rn(2, 3, lq, d).to(torch.bfloat16)
    k, v = (rn(2, 3, lk, d).to(torch.bfloat16) for _ in range(2))
    do = rn(2, 3, lq, d).to(torch.bfloat16)
    b = rn(1, 3, lq, lk) if bias else None
    return q, k, v, do, b


# D = 256: the ragged edge (L 1000), a trained bias under the causal mask,
# and Lq != Lk without it
_CUDA_CASES = [(64, True, 1500, 1500, False), (128, True, 1500, 1500, True),
               (64, False, 384, 640, True), (128, False, 256, 256, False),
               (256, True, 1000, 1000, False), (256, True, 1000, 1000, True),
               (256, False, 384, 640, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,lq,lk,bias", _CUDA_CASES)
def test_cuda_wgmma_forward_matches_plain(cuda_device, d, causal, lq, lk,
                                          bias):
    """Tolerance: two bf16 ulps of each reference element plus 1e-6 (both
    sides round one float32 value, equal to ~1e-6, to bf16)."""
    q, k, v, _, b = _cuda_case(cuda_device, d, causal, lq, lk, bias)
    tfa.reset_launch_counts()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, bias=b)
    torch.cuda.synchronize()
    assert tfa.launch_counts()["fwd"] == {"fma": 0, "wgmma": 1,
                                           "wgmma_f32": 0, "wgmma_f16": 0}
    o_ref, lse_ref = tfa.reference_attention_fwd(q, k, v, causal=causal,
                                                 bias=b)
    limit = 2 * _bf16_ulp(o_ref) + 1e-6
    assert bool(((o.float() - o_ref.float()).abs() <= limit).all())
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,lq,lk,bias", _CUDA_CASES)
def test_cuda_wgmma_backward_matches_plain(cuda_device, d, causal, lq, lk,
                                           bias):
    """dQ (with dS as the bias gradient where there is a bias), dK and dV
    from the wgmma kernels. Tolerance:
    two bf16 ulps of each reference element plus 1e-5 of the gradient's
    largest magnitude; dbias (float32) the reference's backward tolerance,
    rtol 2e-4 and atol 2e-5."""
    q, k, v, do, b = _cuda_case(cuda_device, d, causal, lq, lk, bias)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, bias=b)
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, b, o, lse, do, causal)
    torch.cuda.synchronize()
    assert tfa.launch_counts()["dkv"] == {"fma": 0, "wgmma": 1,
                                          "wgmma_f32": 0, "wgmma_f16": 0}
    dq_route = tfa.kernel_route(torch.bfloat16, d, "dq")
    assert tfa.launch_counts()["dq"] == {
        r: int(r == dq_route) for r in ("fma", "wgmma", "wgmma_f32",
                                        "wgmma_f16")}
    want = tfa.reference_attention_bwd(q, k, v, b, o, lse, do, causal)
    for x, y in zip(got[:3], want[:3]):
        limit = 2 * _bf16_ulp(y) + 1e-5 * y.float().abs().max()
        assert bool(((x.float() - y.float()).abs() <= limit).all())
    if bias:
        torch.testing.assert_close(got[3], want[3].sum(0, keepdim=True),
                                   **BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_wgmma_dq_replays_bit_for_bit(cuda_device, d):
    """No atomics: two calls on the same inputs give the same dQ and dS."""
    q, k, v, do, b = _cuda_case(cuda_device, d, True, 1500, 1500, True)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, bias=b)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    first = tfa.flash_attention_bwd_dq(q, k, v, b, do, lse, delta, True,
                                       emit_ds=True)
    second = tfa.flash_attention_bwd_dq(q, k, v, b, do, lse, delta, True,
                                        emit_ds=True)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_wgmma_dq_writes_ds_with_zeros_above_the_diagonal(cuda_device,
                                                               d):
    """The dQ kernel's float32 dS (the bias gradient before its reduction)
    against the plain dS, causal and ragged: every element above the
    diagonal, in the diagonal tiles and in the tiles the kernel skips, is
    written as 0. Tolerance: the reference's backward tolerance."""
    q, k, v, do, b = _cuda_case(cuda_device, d, True, 700, 700, True)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, bias=b)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    tfa.reset_launch_counts()
    _, ds = tfa.flash_attention_bwd_dq(q, k, v, b, do, lse, delta, True,
                                       emit_ds=True)
    assert tfa.launch_counts()["dq"]["wgmma"] == 1
    want = tfa.reference_attention_bwd(q, k, v, b, o, lse, do, True)[3]
    torch.testing.assert_close(ds, want, **BWD_TOL)
    assert bool((ds.triu(1) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_wgmma_forward_and_dkv_replay_bit_for_bit(cuda_device, d):
    """No atomics: two calls on the same inputs give the same O, LSE, dK
    and dV, with a trained bias under the causal mask and at the ragged
    edge."""
    q, k, v, do, b = _cuda_case(cuda_device, d, True, 1000, 1000, True)
    first, second = (tfa.flash_attention_fwd(q, k, v, causal=True, bias=b)
                     for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    o, lse = first
    delta = (do.float() * o.float()).sum(-1).contiguous()
    tfa.reset_launch_counts()
    first, second = (tfa.flash_attention_bwd_dkv(q, k, v, b, do, lse, delta,
                                                 True) for _ in range(2))
    assert tfa.launch_counts()["dkv"]["wgmma"] == 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_wgmma_dropout_matches_plain_with_the_same_mask(cuda_device, d):
    """p = 0.1: the wgmma kernels against the plain versions given the
    plain Philox mask, and a fixed seed replays bit for bit."""
    q, k, v, do, _ = _cuda_case(cuda_device, d, True, 320, 320, False)
    keep = tfa.dropout_mask(42, 2, 3, 320, 320, 0.1, cuda_device)
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_p=0.1,
                                     seed=42)
    o_ref, _ = tfa.reference_attention_fwd(q, k, v, causal=True,
                                           keep_mask=keep)
    assert bool(((o.float() - o_ref.float()).abs()
                 <= 2 * _bf16_ulp(o_ref) + 1e-6).all())
    got = tfa.flash_attention_bwd(q, k, v, None, o, lse, do, True, 0.1, 42)
    again = tfa.flash_attention_bwd(q, k, v, None, o, lse, do, True, 0.1, 42)
    want = tfa.reference_attention_bwd(q, k, v, None, o, lse, do, True, keep)
    for x, y, z in zip(got[:3], want[:3], again[:3]):
        assert torch.equal(x, z)
        limit = 2 * _bf16_ulp(y) + 1e-5 * y.float().abs().max()
        assert bool(((x.float() - y.float()).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_wgmma_selfcheck(cuda_device, d):
    """The descriptor self-check: both wgmma forms against torch.matmul in
    float32 (bf16 products are exact; summation order only)."""
    a, b, c1, c2 = tfa.wgmma_selfcheck(d, cuda_device)
    torch.cuda.synchronize()
    torch.testing.assert_close(c1, a.float() @ b.float().T, rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(c2, a[:, :64].float() @ b.float(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
def test_cuda_wgmma_route_refuses_what_tma_cannot_read(cuda_device):
    q = torch.zeros(1, 2, 64, 68, device=cuda_device,
                    dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, q, q)

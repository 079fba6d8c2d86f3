"""The port's ``F.scaled_dot_product_attention`` against the JAX
package's, on the CPU.

The plain branch (what both packages run without a kernel: here, always)
is held with every mask form: none, boolean ``[B, 1, 1, Lk]`` and ``[B, 1,
Lq, Lk]``, a float mask (its gradient too), and causal with ``Lq == Lk``
and ``Lq != Lk`` (bottom-right aligned); outputs and the gradients of q,
k, v against ``jax.grad``. The kernel branch is held with both packages'
gates patched to True in the test: the JAX side runs its Pallas kernels in
interpret mode (patched as tests/test_torch_flash_attention.py does), the
port's wrappers their plain versions (CPU tensors), through the mask
conversion (a boolean mask as a -1e30 bias with no gradient, a float mask
as a trained bias). Tolerances, float32: outputs 1e-5, gradients rtol
2e-4 / atol 2e-5 (the reference's kernel tolerances; the two sides differ
only in summation order). Dropout cannot match the TPU PRNG, so it is
held to the port's own invariants.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import rng_context
from torch_threads import few_torch_threads  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
BWD = dict(rtol=2e-4, atol=2e-5)
B, H, D = 2, 2, 64


@pytest.fixture()
def jfa():
    from paddle_tpu.kernels import flash_attention

    return flash_attention


@pytest.fixture()
def kernel_gates(jfa):
    """Both gates open and the JAX Pallas kernels in interpret mode."""
    orig = jfa.pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(jfa.pl, "pallas_call", interp), \
            mock.patch.object(jfa, "should_use_flash", lambda *a: True), \
            mock.patch.object(tfa, "should_use_flash", lambda *a: True):
        yield


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(Lq, Lk):
    return (_rand((B, Lq, H, D), 0), _rand((B, Lk, H, D), 1),
            _rand((B, Lk, H, D), 2), _rand((B, Lq, H, D), 3))


def _key_padding(Lq, Lk, full_rows: bool):
    """A boolean keep-mask of key padding (row b keeps its first Lk - 7b
    keys), ``[B, 1, 1, Lk]`` or broadcast to ``[B, 1, Lq, Lk]``."""
    keep = np.arange(Lk)[None, :] < (Lk - 7 * np.arange(B))[:, None]
    m = keep[:, None, None, :]
    return np.ascontiguousarray(np.broadcast_to(m, (B, 1, Lq, Lk))) \
        if full_rows else m


def _both(q, k, v, do, mask=None, causal=False, train_mask=False):
    """Output and gradients (q, k, v, and the mask when trained) of both
    packages' SDPA on the same numpy inputs."""
    def jax_f(q_, k_, v_, m_):
        o = JF.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_,
                                            is_causal=causal, training=False)
        return jnp.sum(o * jnp.asarray(do)), o

    jm = None if mask is None else jnp.asarray(mask)
    argnums = (0, 1, 2, 3) if train_mask else (0, 1, 2)
    (_, o_j), g_j = jax.value_and_grad(jax_f, argnums=argnums, has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    if train_mask:
        tm.requires_grad_()
        xs.append(tm)
    o_t = F.scaled_dot_product_attention(xs[0], xs[1], xs[2], attn_mask=tm,
                                         is_causal=causal, training=False)
    g_t = torch.autograd.grad(o_t, xs, torch.from_numpy(do))
    return (np.asarray(o_j), [np.asarray(g) for g in g_j],
            o_t.detach().numpy(), [g.numpy() for g in g_t])


def _check(res):
    o_j, g_j, o_t, g_t = res
    assert np.isfinite(o_t).all()
    np.testing.assert_allclose(o_t, o_j, **FWD)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, **BWD)


@pytest.mark.parametrize("Lq,Lk", [(16, 16), (12, 20)])
def test_plain_branch_no_mask(Lq, Lk):
    _check(_both(*_inputs(Lq, Lk)))


@pytest.mark.parametrize("full_rows", [False, True])
@pytest.mark.parametrize("Lq,Lk", [(16, 16), (12, 20)])
def test_plain_branch_bool_mask(Lq, Lk, full_rows):
    _check(_both(*_inputs(Lq, Lk), mask=_key_padding(Lq, Lk, full_rows)))


@pytest.mark.parametrize("mshape", [(B, 1, 12, 20), (1, H, 12, 20),
                                    (12, 20)])
def test_plain_branch_float_mask_and_its_gradient(mshape):
    _check(_both(*_inputs(12, 20), mask=_rand(mshape, 4), train_mask=True))


@pytest.mark.parametrize("Lq,Lk", [(16, 16), (12, 20)])
def test_plain_branch_causal_is_bottom_right(Lq, Lk):
    res = _both(*_inputs(Lq, Lk), causal=True)
    _check(res)
    # bottom-right: the last query row sees every key
    q, k, v, _ = _inputs(Lq, Lk)
    full = F.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), training=False)
    np.testing.assert_allclose(res[2][:, -1], full[:, -1].numpy(), **FWD)


def test_plain_branch_causal_with_mask():
    _check(_both(*_inputs(16, 16), mask=_key_padding(16, 16, True),
                 causal=True))


@pytest.mark.parametrize("mask_kind", ["bool", "float", "trained"])
@pytest.mark.parametrize("Lq,Lk", [(128, 128), (128, 256)])
def test_kernel_branch_matches_jax_kernels(kernel_gates, Lq, Lk, mask_kind):
    """Non-causal with a mask: self-attention and cross-attention
    (Lq != Lk), a boolean mask (no mask gradient), a float mask, and a
    float mask that is trained (the dQ kernel's dS, reduced over the
    broadcast batch)."""
    q, k, v, do = _inputs(Lq, Lk)
    if mask_kind == "bool":
        mask = _key_padding(Lq, Lk, True)
    else:
        mask = _rand((1, H, Lq, Lk), 5)
    _check(_both(q, k, v, do, mask=mask, train_mask=mask_kind == "trained"))


def test_kernel_branch_causal_and_no_mask(kernel_gates):
    _check(_both(*_inputs(128, 128), causal=True))
    _check(_both(*_inputs(128, 256)))


def test_kernel_branch_converts_masks_as_the_reference(kernel_gates):
    """A boolean mask reaches the kernels as a float32 0 / -1e30 bias with
    bias_grad False; a float mask as itself, with bias_grad True."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(128, 128))
    seen = []
    orig = tfa.flash_attention_blhd

    def spy(*a, **kw):
        seen.append((kw["bias"], kw["bias_grad"]))
        return orig(*a, **kw)

    with mock.patch.object(tfa, "flash_attention_blhd", spy):
        m = torch.from_numpy(_key_padding(128, 128, True))
        F.scaled_dot_product_attention(q, k, v, attn_mask=m, training=False)
        f = torch.from_numpy(_rand((1, H, 128, 128), 6))
        F.scaled_dot_product_attention(q, k, v, attn_mask=f, training=False)
    (b0, g0), (b1, g1) = seen
    assert b0.dtype == torch.float32 and not g0
    assert torch.equal(b0, torch.where(m, 0.0, -1e30))
    assert b1 is f and g1


def test_causal_lq_ne_lk_never_takes_the_kernels(kernel_gates):
    """The kernels mask top-left, the semantics bottom-right: a causal
    call with Lq != Lk runs the plain branch even with the gate open."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(128, 256))

    def refuse(*a, **kw):
        raise AssertionError("causal Lq != Lk reached the kernels")

    with mock.patch.object(tfa, "flash_attention_blhd", refuse):
        got = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             training=False)
    keep = torch.ones(128, 256, dtype=torch.bool).tril(128)
    want = F._plain_attention(q, k, v, keep)
    assert torch.equal(got, want)


def test_fully_masked_row_splits_as_in_the_reference(kernel_gates, jfa):
    """A row that masks every key: NaN on the plain branch (-inf), a
    uniform average of V on the kernel branch (-1e30); the reference's
    own split."""
    q, k, v, _ = _inputs(128, 128)
    mask = _key_padding(128, 128, True)
    mask[0, :, 3, :] = False
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kern = F.scaled_dot_product_attention(tq, tk, tv,
                                          attn_mask=torch.from_numpy(mask),
                                          training=False)
    np.testing.assert_allclose(kern[0, 3].numpy(), tv[0].mean(0).numpy(),
                               **FWD)
    plain = F._plain_attention(tq, tk, tv, torch.from_numpy(mask))
    assert torch.isnan(plain[0, 3]).all()
    with mock.patch.object(jfa, "should_use_flash", lambda *a: False):
        jplain = JF.scaled_dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            attn_mask=jnp.asarray(mask), training=False)
    assert np.isnan(np.asarray(jplain)[0, 3]).all()


def test_kernel_branch_dropout_seed_and_replay(kernel_gates):
    """With dropout the kernel branch draws its seed from the "dropout"
    stream (``take_rng_key % (2^31 - 1)``), so a stream replays its mask
    and another stream draws another; eval mode drops nothing."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(128, 128))
    with rng_context({"dropout": 5}) as ctx:
        seed = ctx.fork().next("dropout") % (2 ** 31 - 1)
        a = F.scaled_dot_product_attention(q, k, v, dropout_p=0.25)
    want = tfa.flash_attention_blhd(q, k, v, dropout_p=0.25, seed=seed)
    assert torch.equal(a, want)
    with rng_context({"dropout": 5}):
        assert torch.equal(F.scaled_dot_product_attention(
            q, k, v, dropout_p=0.25), a)
    with rng_context({"dropout": 6}):
        assert not torch.equal(F.scaled_dot_product_attention(
            q, k, v, dropout_p=0.25), a)
    assert torch.equal(
        F.scaled_dot_product_attention(q, k, v, dropout_p=0.25,
                                       training=False),
        F.scaled_dot_product_attention(q, k, v, training=False))


def test_plain_branch_dropout_drops_probabilities():
    """The plain branch drops probabilities with the "dropout" stream:
    it replays, it keeps about 1 - p of them (every kept one scaled by
    1 / (1 - p)), and p = 0 equals eval mode."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(16, 16))
    ones = torch.ones(B, 16, H, D)
    with rng_context({"dropout": 1}):
        a = F.scaled_dot_product_attention(q, k, ones, dropout_p=0.5)
    with rng_context({"dropout": 1}):
        assert torch.equal(F.scaled_dot_product_attention(
            q, k, ones, dropout_p=0.5), a)
    # with V all ones each output is the row's kept probability mass x 2
    mass = a[..., 0] / 2.0
    assert 0.35 < float(mass.mean()) < 0.65
    assert torch.equal(
        F.scaled_dot_product_attention(q, k, v, dropout_p=0.0),
        F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                       training=False))

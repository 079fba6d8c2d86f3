"""The port's Llama family (paddle_tpu_torch.models.llama) against the JAX
package's, on the CPU at ``llama_tiny`` (hidden 128, 2 layers, 4 heads
of 32 and 2 KV heads: GQA, intermediate 512, vocab 1024).

A seeded JAX model is converted by name with ``llama_from_jax``; the same
numpy token ids go through both. Tolerances, float32: 1e-4 absolute on
logits and 1e-5 relative on losses (the GPT tests' bounds: the same math
in two frameworks, other summation orders through two layers); gradients
2e-4 of each tensor's largest magnitude; the RoPE tables bit for bit.
bfloat16: one bf16 ulp (2^-7 relative) where both sides round one float32
value, and the O2 AdamW trajectory at ``tests/test_torch_train.py``'s
bounds. Greedy tokens must be identical; a served sampled stream must
equal a solo ``generate()`` with the same seed (torch's generators are not
``jax.random``).

The JAX side is imported inside fixtures, so on a machine without JAX the
``cuda`` test runs alone:
``python -m pytest --noconftest -m cuda tests/test_torch_llama.py``.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import llama_from_jax
from paddle_tpu_torch.framework.jit import TrainStep
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           llama2_7b, llama_flops_per_token,
                                           llama_loss_fn, llama_tiny)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers.common import Linear
from paddle_tpu_torch.nn.layers.norm import RMSNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import InferenceServer

ATOL = 1e-4
GEO = dict(max_length=64, prefill_buckets=(32,))
BF16_REL = 2.0 ** -7  # one bf16 ulp, relative: 8 significant bits


@pytest.fixture(scope="module")
def J():
    """The reference modules (imported here, not at the top: see the
    module docstring)."""
    import jax
    import jax.numpy as jnp

    import paddle_tpu as pt
    from paddle_tpu import amp as jamp
    from paddle_tpu.framework.jit import TrainStep as JaxTrainStep
    from paddle_tpu.models import generation as jgen
    from paddle_tpu.models import llama as jllama
    from paddle_tpu.nn import functional as JF
    from paddle_tpu.nn.layer import functional_call, param_state
    from paddle_tpu.nn.layers.norm import RMSNorm as JaxRMSNorm
    from paddle_tpu.optimizer import AdamW as JaxAdamW

    return SimpleNamespace(jax=jax, jnp=jnp, pt=pt, amp=jamp,
                           TrainStep=JaxTrainStep, gen=jgen, llama=jllama,
                           F=JF, functional_call=functional_call,
                           param_state=param_state, RMSNorm=JaxRMSNorm,
                           AdamW=JaxAdamW)


def _jax_model(J, seed=11, **kw):
    J.pt.seed(seed)
    return J.llama.LlamaForCausalLM(J.llama.llama_tiny(**kw))


def _pair(J, seed=11, **kw):
    jm = _jax_model(J, seed, **kw)
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, llama_from_jax(state, llama_tiny(**kw), device="cpu"), state


@pytest.fixture(scope="module")
def pair(J):
    jm, tm, state = _pair(J)
    jm.eval()
    return jm, tm, state


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, shape).astype(np.int32)


def _long(ids):
    return torch.as_tensor(ids, dtype=torch.long)


# ------------------------------------------------------------ nn pieces
def test_linear_without_bias_registers_no_bias():
    lin = Linear(8, 4, has_bias=False, device="cpu")
    assert [n for n, _ in lin.named_parameters()] == ["weight"]
    assert lin.bias is None
    x = torch.randn(3, 8)
    torch.testing.assert_close(lin(x), x @ lin.weight, rtol=0, atol=0)
    assert [n for n, _ in Linear(8, 4, device="cpu").named_parameters()] \
        == ["weight", "bias"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(J, dtype):
    """Float32: 1e-6 relative (summation order of the mean). bf16: both
    sides normalise in float32, round to bf16, then multiply by the bf16
    weight: within one bf16 ulp of each other."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jd = getattr(J.jnp, dtype)
    td = getattr(torch, dtype)
    want = np.asarray(J.F.rms_norm(J.jnp.asarray(x, jd), J.jnp.asarray(w, jd),
                                   1e-5)).astype(np.float32)
    got = F.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                     1e-5)
    assert got.dtype == td
    rtol = 1e-6 if dtype == "float32" else BF16_REL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-6)
    # the layer: weight of ones, epsilon kept
    layer = RMSNorm(64, epsilon=1e-5, device="cpu").to(td)
    jlayer = J.RMSNorm(64, epsilon=1e-5)
    assert [n for n, _ in layer.named_parameters()] == ["weight"]
    assert torch.equal(layer.weight, torch.ones(64, dtype=td))
    want = np.asarray(jlayer(J.jnp.asarray(x, jd))).astype(np.float32)
    np.testing.assert_allclose(layer(torch.from_numpy(x).to(td)).float()
                               .detach().numpy(), want, rtol=rtol, atol=1e-6)


def test_silu_matches_jax(J):
    x = np.linspace(-8, 8, 101, dtype=np.float32)
    np.testing.assert_allclose(F.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(J.jax.nn.silu(J.jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("head_dim,max_len,theta", [(32, 256, 10000.0),
                                                    (128, 4096, 10000.0),
                                                    (64, 100, 500000.0)])
def test_rope_tables_bit_for_bit(J, head_dim, max_len, theta):
    cos, sin = tllama._rope_tables(head_dim, max_len, theta, "cpu")
    jcos, jsin = J.llama._rope_tables(head_dim, max_len, theta)
    assert cos.dtype == torch.float32
    np.testing.assert_array_equal(cos.numpy(), jcos)
    np.testing.assert_array_equal(sin.numpy(), jsin)
    # one copy per (head_dim, max_len, theta, device)
    assert tllama._rope_tables(head_dim, max_len, theta, "cpu")[0] is cos


def test_rope_tables_made_under_inference_mode_serve_training():
    """Serving may make the shared tables first, under inference_mode;
    a training step that rotates with them afterwards still runs its
    backward."""
    with torch.inference_mode():
        cos, _ = tllama._rope_tables(32, 48, 1234.0, "cpu")
    assert not cos.is_inference()
    tm = LlamaForCausalLM(llama_tiny(max_position_embeddings=48,
                                     rope_theta=1234.0), device="cpu")
    ids = _long(_ids((1, 12)))
    tm(ids, ids).backward()
    assert tm.model.embed_tokens.weight.grad is not None


@pytest.mark.parametrize("offset", [0, 5, 253, "vector"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rotary_matches_jax(J, offset, dtype):
    """An int offset (253 + L = 259 overruns the 256-row tables: both
    sides clamp the window start to 256 - L) and a per-row [B] offset.
    Float32 within 1e-6; bf16 (tables cast to bf16 before the products,
    as the reference does) within two bf16 ulps of the largest input."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 6, 4, 32)).astype(np.float32)
    k = rng.standard_normal((3, 6, 2, 32)).astype(np.float32)
    cos, sin = tllama._rope_tables(32, 256, 10000.0, "cpu")
    jcos, jsin = J.llama._rope_tables(32, 256, 10000.0)
    if offset == "vector":
        pos = np.array([0, 17, 250], np.int32)  # 250 + 6 = 256: the last rows
        jpos, tpos = J.jnp.asarray(pos), torch.from_numpy(pos)
    else:
        jpos = tpos = offset
    jd, td = getattr(J.jnp, dtype), getattr(torch, dtype)
    wq, wk = J.llama.apply_rotary(J.jnp.asarray(q, jd), J.jnp.asarray(k, jd),
                                  jcos, jsin, jpos)
    gq, gk = tllama.apply_rotary(torch.from_numpy(q).to(td),
                                 torch.from_numpy(k).to(td), cos, sin, tpos)
    assert gq.dtype == td and gk.dtype == td
    for got, want, x in ((gq, wq, q), (gk, wk, k)):
        want = np.asarray(want).astype(np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        else:
            limit = 2 * BF16_REL * np.abs(x).max()
            assert np.abs(got.float().numpy() - want).max() <= limit


def test_config_rules_match_jax(J):
    for kw in (dict(), dict(hidden_size=4096), dict(hidden_size=5120,
                                                    num_heads=40),
               dict(num_kv_heads=None)):
        mine, ref = llama_tiny(**kw), J.llama.llama_tiny(**kw)
        assert (mine.intermediate_size, mine.num_kv_heads) == \
            (ref.intermediate_size, ref.num_kv_heads)
    assert llama2_7b().intermediate_size == 11008
    assert LlamaConfig(hidden_size=4096).intermediate_size == 11008
    with pytest.raises(ValueError):
        llama_tiny(num_kv_heads=3)


# ------------------------------------------------------------ the model
def test_state_dict_names_match_jax(pair):
    _, tm, state = pair
    assert len(state) == 21
    assert set(tm.state_dict()) == set(state)
    assert not any(k.endswith("bias") for k in state)
    attn = getattr(tm.model.layers, "0").self_attn
    assert attn.k_proj.weight.shape == (128, 64)  # 2 KV heads of 32


@pytest.mark.parametrize("tie", [False, True])
def test_full_sequence_logits_match_jax(J, tie):
    jm, tm, state = _pair(J, tie_word_embeddings=tie)
    assert ("lm_head.weight" in state) == (not tie)
    jm.eval()
    ids = _ids((2, 24))
    lj = np.asarray(jm(J.jnp.asarray(ids)))
    with torch.no_grad():
        lt = tm(_long(ids)).numpy()
    assert lt.shape == lj.shape == (2, 24, 1024)
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=0)


def _jax_loss_and_grads(J, jm, ids):
    def loss(p):
        out, _ = J.functional_call(jm, p, None, J.jnp.asarray(ids),
                                   J.jnp.asarray(ids))
        return out

    value, grads = J.jax.value_and_grad(loss)(J.param_state(jm))
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


def _torch_loss_and_grads(tm, ids):
    tm.zero_grad(set_to_none=True)
    loss = tm(_long(ids), _long(ids))
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy()
                                  for k, p in tm.named_parameters()}


@pytest.mark.parametrize("loss_chunk", [0, 8, 7])
def test_loss_and_every_grad_match_jax(J, loss_chunk):
    """The plain loss, the chunked loss (8 and 7 divide L-1 = 23
    unevenly), and the gradient of every parameter: GQA's repeat of K and
    V sums its gradient over the query heads of each group."""
    jm, tm, _ = _pair(J, loss_chunk=loss_chunk)
    jm.train()
    tm.train()
    ids = _ids((2, 24), seed=1)
    lj, gj = _jax_loss_and_grads(J, jm, ids)
    lt, gt = _torch_loss_and_grads(tm, ids)
    assert lt == pytest.approx(lj, rel=1e-5)
    assert set(gt) == set(gj) and len(gt) == 21
    for k in gj:
        scale = np.abs(gj[k]).max()
        np.testing.assert_allclose(gt[k], gj[k], rtol=0, atol=2e-4 * scale,
                                   err_msg=k)


def test_recompute_equals_no_recompute():
    ids = _long(_ids((2, 24), seed=2))

    def grads(**kw):
        tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu").train()
        loss = tm(ids, ids)
        loss.backward()
        return loss.item(), {k: p.grad for k, p in tm.named_parameters()}

    l0, g0 = grads()
    l1, g1 = grads(use_recompute=True, loss_chunk=8)
    assert l1 == pytest.approx(l0, rel=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-7)


def test_cached_prefill_and_decode_match_jax(J, pair):
    """Bucketed prefill (padded to 32, last real token gathered) then 8
    greedy decode steps fed the JAX argmax: logits within 1e-4, equal
    argmaxes. The cache holds the 2 KV heads, rotated."""
    jm, tm, _ = pair
    P = 13
    ids = np.zeros((1, 32), np.int32)
    ids[0, :P] = _ids((P,), seed=3)
    jc = J.gen.init_cache(jm, 1, 64)
    tc = tgen.init_cache(tm, 1, 64)
    assert tc[0][0].shape == (1, 64, 2, 32)
    lj, jc = jm(J.jnp.asarray(ids), cache=jc, position_offset=0,
                gather_last=P - 1)
    with torch.no_grad():
        lt, tc = tm(_long(ids), cache=tc, position_offset=0,
                    gather_last=P - 1)
    np.testing.assert_allclose(tc[1][0].numpy()[:, :P],
                               np.asarray(jc[1][0])[:, :P], atol=1e-5, rtol=0)
    for pos in range(P, P + 8):
        lj_np, lt_np = np.asarray(lj)[:, -1], lt[:, -1].numpy()
        np.testing.assert_allclose(lt_np, lj_np, atol=ATOL, rtol=0)
        tok = int(lj_np.argmax())
        assert int(lt_np.argmax()) == tok
        lj, jc = jm(J.jnp.asarray([[tok]], J.jnp.int32), cache=jc,
                    position_offset=pos)
        with torch.no_grad():
            lt, tc = tm(torch.tensor([[tok]]), cache=tc, position_offset=pos)


def test_vector_position_offset_matches_jax_and_full_forward(J, pair):
    """Per-row decode positions (the reference's
    test_vector_position_offset_matches_scalar_decode): row 0 advances
    while row 1 replays a position, so the rows rotate, write and mask at
    different frontiers; both sides agree within 1e-4 and equal the full
    forward within the reference test's 2e-4."""
    jm, tm, _ = pair
    ids = _ids((2, 8), seed=13)
    with torch.no_grad():
        full = tm(_long(ids)).numpy()
    jc = J.gen.init_cache(jm, 2, 16)
    tc = tgen.init_cache(tm, 2, 16)
    _, jc = jm(J.jnp.asarray(ids[:, :5]), cache=jc, position_offset=0)
    with torch.no_grad():
        _, tc = tm(_long(ids[:, :5]), cache=tc, position_offset=0)
    steps = [(np.stack([ids[0, 5:6], ids[1, 5:6]]), [5, 5]),
             (np.stack([ids[0, 6:7], ids[1, 5:6]]), [6, 5])]
    for tok, pos in steps:
        pos = np.asarray(pos, np.int32)
        lj, jc = jm(J.jnp.asarray(tok), cache=jc,
                    position_offset=J.jnp.asarray(pos))
        with torch.no_grad():
            lt, tc = tm(_long(tok), cache=tc,
                        position_offset=torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0)
    out = lt.numpy()[:, 0]
    np.testing.assert_allclose(out[0], full[0, 6], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out[1], full[1, 5], rtol=2e-4, atol=2e-4)


def test_greedy_generate_matches_jax(pair):
    jm, tm, _ = pair
    ids = _ids((2, 10), seed=5)
    out_j = np.asarray(jm.generate(ids, max_new_tokens=9, **GEO))
    out_t = tm.generate(ids, max_new_tokens=9, **GEO)
    np.testing.assert_array_equal(out_t, out_j)


def test_gather_last_slices_before_the_head(pair):
    """Serving keeps one position before the untied head: the logits are
    [B, 1, vocab] and equal that position of the full logits."""
    _, tm, _ = pair
    ids = _long(_ids((1, 20), seed=8))
    with torch.no_grad():
        full = tm(ids)
        one = tm(ids, gather_last=11)
    assert one.shape == (1, 1, 1024)
    torch.testing.assert_close(one[:, 0], full[:, 11], rtol=0, atol=1e-6)


# ------------------------------------------------------------ training
def _run_jax(J, jm, opt, batches):
    step = J.TrainStep(jm, opt, loss_fn=None)
    losses = [float(step((b, b))) for b in batches]
    return losses, {k: np.asarray(v, np.float32) for k, v in step.params.items()}


def test_o2_adamw_trajectory_matches_jax(J):
    """Three AdamW steps under amp O2 bf16 with recompute and the chunked
    loss; ``tests/test_torch_train.py``'s bounds: losses within 2e-2
    relative, every parameter within 7e-3, at most 1 % of the elements
    parted by more than one lr."""
    kw = dict(use_recompute=True, loss_chunk=8)
    jm, tm, _ = _pair(J, **kw)
    jm.train()
    tm.train()
    jm, jopt = J.amp.decorate(jm, J.AdamW(learning_rate=1e-3,
                                          weight_decay=0.01),
                              level="O2", dtype="bfloat16")
    tm, topt = amp.decorate(tm, AdamW(learning_rate=1e-3, weight_decay=0.01),
                            level="O2", dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    batches = [_ids((2, 24), seed=s) for s in range(3)]
    step = TrainStep(tm, topt, loss_fn=None)
    masters = step.opt_state["master_weights"]
    lt = [float(step((b, b))) for b in batches]
    lj, pj = _run_jax(J, jm, jopt, batches)
    np.testing.assert_allclose(lt, lj, rtol=2e-2)
    parted = total = 0
    for k, p in step.params.items():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, masters[k].to(torch.bfloat16))
        diff = np.abs(p.detach().float().numpy() - pj[k])
        assert diff.max() <= 7e-3, k
        parted += int((diff > 1e-3).sum())
        total += diff.size
    assert parted <= 1e-2 * total


def test_llama_loss_fn_step_equals_loss_in_forward(J):
    ids = _ids((2, 24), seed=4)
    _, a_model, _ = _pair(J)
    a = TrainStep(a_model.train(), AdamW(learning_rate=1e-3),
                  loss_fn=llama_loss_fn(a_model))
    _, b_model, _ = _pair(J)
    b = TrainStep(b_model.train(), AdamW(learning_rate=1e-3), loss_fn=None)
    assert float(b((ids, ids))) == pytest.approx(float(a((ids, ids))),
                                                 rel=1e-6)


def test_llama_from_jax_loads_bf16_state(J):
    jm = _jax_model(J)
    jm, _ = J.amp.decorate(jm, J.AdamW(), level="O2", dtype="bfloat16")
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    assert all(v.dtype.name == "bfloat16" for v in state.values())
    tm = llama_from_jax(state, llama_tiny(), device="cpu")
    for k, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      state[k].astype(np.float32))


@pytest.mark.parametrize("broken", ["missing", "extra", "shape"])
def test_llama_from_jax_rejects_mismatched_state(pair, broken):
    _, _, state = pair
    bad = dict(state)
    if broken == "missing":
        del bad["model.layers.1.mlp.down_proj.weight"]
        err = KeyError
    elif broken == "extra":
        bad["model.layers.0.self_attn.q_proj.bias"] = np.zeros(128, np.float32)
        err = KeyError
    else:
        bad["model.norm.weight"] = np.zeros((64,), np.float32)
        err = ValueError
    with pytest.raises(err):
        llama_from_jax(bad, llama_tiny(), device="cpu")


@pytest.mark.parametrize("kw,seq", [(dict(), 4096),
                                    (dict(num_kv_heads=8), 4096),
                                    (dict(num_layers=8), 2048),
                                    (dict(tie_word_embeddings=True), 1024)])
def test_llama_flops_per_token_matches_jax(J, kw, seq):
    assert llama_flops_per_token(llama2_7b(**kw), seq) == \
        J.llama.llama_flops_per_token(J.llama.llama2_7b(**kw), seq)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        LlamaForCausalLM(llama_tiny(sequence_parallel=True), device="cpu")
    tm = LlamaForCausalLM(llama_tiny(use_recompute=True,
                                     recompute_policy="save_dots"),
                          device="cpu").train()
    ids = _long(_ids((1, 8)))
    with pytest.raises(NotImplementedError):
        tm(ids, ids)


def test_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny())


# ------------------------------------------------------------ serving
def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 1024, (n,)).astype(np.int32)


def test_served_streams_match_solo_generate(pair):
    """Two staggered requests (greedy, then seeded top-p sampling) in a
    two-slot batch: each equals its solo batch-1 generate(). The decode
    step rotates and masks every slot at its own position."""
    _, tm, _ = pair
    p0, p1 = _prompt(9, 4), _prompt(14, 5)
    solo0 = tm.generate(p0[None], max_new_tokens=10, **GEO)[0]
    solo1 = tm.generate(p1[None], max_new_tokens=7, do_sample=True,
                        temperature=0.8, top_p=0.9, seed=5, **GEO)[0]
    with InferenceServer(tm, slots=2, device="cpu", **GEO) as srv:
        h0 = srv.submit(p0, max_new_tokens=10)
        time.sleep(0.05)  # h1 arrives while h0 is mid-decode
        h1 = srv.submit(p1, max_new_tokens=7, do_sample=True,
                        temperature=0.8, top_p=0.9, seed=5)
        np.testing.assert_array_equal(h0.result(timeout=120), solo0)
        np.testing.assert_array_equal(h1.result(timeout=120), solo1)
        snap = srv.snapshot()
    assert snap["requests_completed"] == 2
    assert snap["requests_requeued"] == 0 and snap["requests_failed"] == 0


# ------------------------------------------------------------ the card
@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_attention(cuda_device):
    """llama_tiny at hidden 256 (4 heads of 64, 2 KV heads: the kernels
    need D in {64, 128, 256}), float32, on the card: the logits and the
    loss's gradients with the flash kernels (wgmma_f32: one forward, dQ
    and dK/dV per layer) against plain attention. Logits within 1e-4
    absolute and every gradient within 1e-3 relative L2 (chip_smoke.py's
    float32 training bound): the kernels keep float32 accuracy."""
    from paddle_tpu_torch.kernels import flash_attention as tfa

    cfg = llama_tiny(hidden_size=256)
    tm = LlamaForCausalLM(cfg, device=cuda_device).train()
    ids = torch.as_tensor(_ids((2, 192), seed=6), device=cuda_device,
                          dtype=torch.long)
    params = list(tm.parameters())

    def run(flash):
        tm.cfg.use_flash_attention = flash
        logits = tm(ids)
        loss = tm.loss(logits, ids)
        return logits.detach(), torch.autograd.grad(loss, params)

    tfa.reset_launch_counts()
    lk, gk = run(True)
    counts = tfa.launch_counts()
    lp, gp = run(False)
    assert counts["fwd"]["wgmma_f32"] == 2
    assert counts["dq"]["wgmma_f32"] == 2 and counts["dkv"]["wgmma_f32"] == 2
    assert (lk - lp).abs().max().item() <= 1e-4
    for a, b in zip(gk, gp):
        assert ((a - b).norm() / b.norm()).item() <= 1e-3

"""The port's GPT (paddle_tpu_torch.models.gpt) against the JAX package's.

A seeded JAX ``gpt_tiny`` is converted by name with ``gpt_from_jax``; the
same numpy token ids go through both. Tolerance: 1e-4 absolute on
float32 logits (two frameworks, same float32 math, different summation
orders through two layers). Greedy tokens must be identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import gpt_from_jax
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models import lm_utils as tlm
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny

ATOL = 1e-4
GEO = dict(max_length=64, prefill_buckets=(32,))


@pytest.fixture(scope="module")
def pair():
    pt.seed(11)
    jm = JaxGPT(jax_gpt_tiny(hidden_dropout_prob=0.0,
                             attention_dropout_prob=0.0))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = gpt_from_jax(state, gpt_tiny(hidden_dropout_prob=0.0,
                                      attention_dropout_prob=0.0),
                      device="cpu")
    return jm, tm, state


def _ids(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, shape).astype(np.int32)


def test_state_dict_names_and_count(pair):
    _, tm, state = pair
    assert len(state) == 28
    assert set(tm.state_dict()) == set(state)
    assert getattr(tm.gpt.h, "0").attn.qkv_proj.weight.shape == (128, 384)


def test_full_sequence_logits_match(pair):
    jm, tm, _ = pair
    ids = _ids((2, 24))
    lj = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        lt = tm(torch.as_tensor(ids, dtype=torch.long)).numpy()
    assert lt.shape == lj.shape == (2, 24, 1024)
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=0)


def test_cached_prefill_and_decode_match(pair):
    """Bucketed prefill (padded to 32, last real token gathered) then 8
    greedy decode steps, each fed the JAX argmax so both sides see the
    same inputs: logits agree within 1e-4 and argmaxes are identical."""
    jm, tm, _ = pair
    P = 13
    ids = np.zeros((1, 32), np.int32)
    ids[0, :P] = _ids((P,), seed=3)
    jc = jgen.init_cache(jm, 1, 64)
    tc = tgen.init_cache(tm, 1, 64)
    lj, jc = jm(jnp.asarray(ids), cache=jc, position_offset=0,
                gather_last=P - 1)
    with torch.no_grad():
        lt, tc = tm(torch.as_tensor(ids, dtype=torch.long), cache=tc,
                    position_offset=0, gather_last=P - 1)
    for pos in range(P, P + 8):
        lj_np, lt_np = np.asarray(lj)[:, -1], lt[:, -1].numpy()
        np.testing.assert_allclose(lt_np, lj_np, atol=ATOL, rtol=0)
        tok = int(lj_np.argmax())
        assert int(lt_np.argmax()) == tok
        lj, jc = jm(jnp.asarray([[tok]], jnp.int32), cache=jc,
                    position_offset=pos)
        with torch.no_grad():
            lt, tc = tm(torch.tensor([[tok]]), cache=tc, position_offset=pos)


def test_greedy_generate_matches(pair):
    jm, tm, _ = pair
    ids = _ids((2, 10), seed=5)
    out_j = np.asarray(jm.generate(ids, max_new_tokens=9, **GEO))
    out_t = tm.generate(ids, max_new_tokens=9, **GEO)
    np.testing.assert_array_equal(out_t, out_j)


def test_cached_decode_equals_full_forward(pair):
    """The port's own invariant: prefill + decode logits equal the full
    uncached forward at every position."""
    _, tm, _ = pair
    ids = torch.as_tensor(_ids((1, 20), seed=9), dtype=torch.long)
    with torch.no_grad():
        full = tm(ids)
        cache = tgen.init_cache(tm, 1, 64)
        first, cache = tm(ids[:, :12], cache=cache, position_offset=0)
        np.testing.assert_allclose(first.numpy(), full[:, :12].numpy(),
                                   atol=ATOL, rtol=0)
        for p in range(12, 20):
            step, cache = tm(ids[:, p:p + 1], cache=cache, position_offset=p)
            np.testing.assert_allclose(step[:, 0].numpy(), full[:, p].numpy(),
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("broken", ["missing", "extra", "shape"])
def test_gpt_from_jax_rejects_mismatched_state(pair, broken):
    _, _, state = pair
    bad = dict(state)
    if broken == "missing":
        del bad["gpt.h.1.mlp.fc_out.bias"]
        err = KeyError
    elif broken == "extra":
        bad["lm_head.weight"] = np.zeros((128, 1024), np.float32)
        err = KeyError
    else:
        bad["gpt.ln_f.weight"] = np.zeros((64,), np.float32)
        err = ValueError
    with pytest.raises(err):
        gpt_from_jax(bad, gpt_tiny(), device="cpu")


def test_cached_attention_vector_positions_match_jax():
    """Per-row decode positions: the mask frontier of each row follows its
    own offset, on both sides."""
    from paddle_tpu.models import lm_utils as jlm

    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    pos = np.array([0, 7, 23], np.int32)
    oj = np.asarray(jlm.cached_attention(jnp.asarray(q), jnp.asarray(kc),
                                         jnp.asarray(vc), jnp.asarray(pos)))
    ot = tlm.cached_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(pos))
    np.testing.assert_allclose(ot.numpy(), oj, atol=1e-5, rtol=1e-5)


def test_update_kv_cache_vector_positions_match_jax():
    from paddle_tpu.models import lm_utils as jlm

    rng = np.random.default_rng(2)
    k = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    pos = np.array([0, 3, 7], np.int32)
    kj, _ = jlm.update_kv_cache((jnp.asarray(k), jnp.asarray(k)),
                                jnp.asarray(new), jnp.asarray(new),
                                jnp.asarray(pos))
    kt, _ = tlm.update_kv_cache((torch.from_numpy(k.copy()),
                                 torch.from_numpy(k.copy())),
                                torch.from_numpy(new), torch.from_numpy(new),
                                torch.from_numpy(pos))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))


@pytest.mark.parametrize("causal_shape", [(8, 8), (4, 8)])
def test_plain_causal_attention_matches_jax(causal_shape):
    """The plain path keeps the reference's bottom-right aligned mask
    (``tril(k=Lk-Lq)``), unlike the top-left aligned kernel."""
    from paddle_tpu.models import lm_utils as jlm

    lq, lk = causal_shape
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, lq, 2, 16)).astype(np.float32)
    k = rng.standard_normal((2, lk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, lk, 2, 16)).astype(np.float32)
    oj = np.asarray(jlm.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), training=False))
    ot = tlm.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), training=False)
    np.testing.assert_allclose(ot.numpy(), oj, atol=1e-5, rtol=1e-5)


def test_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt_tiny())


def test_config_fields_match_jax_and_sequence_parallel_raises():
    """The port's GPTConfig has every field of the reference's, with the
    same defaults, so a config copied field by field builds; the field
    the port does not implement, ``sequence_parallel``, builds when False
    and raises NotImplementedError in the model when True, as Llama's."""
    import dataclasses

    from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from paddle_tpu_torch.models.gpt import GPTConfig

    ref = {f.name: f.default for f in dataclasses.fields(JaxGPTConfig)}
    mine = {f.name: f.default for f in dataclasses.fields(GPTConfig)}
    assert mine == ref
    cfg = GPTConfig(**dataclasses.asdict(jax_gpt_tiny(
        sequence_parallel=False)))
    assert cfg.sequence_parallel is False
    GPTForCausalLM(gpt_tiny(sequence_parallel=False), device="cpu")
    with pytest.raises(NotImplementedError, match="sequence_parallel"):
        GPTForCausalLM(gpt_tiny(sequence_parallel=True), device="cpu")

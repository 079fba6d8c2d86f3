"""The port's int8 KV cache (paddle_tpu_torch.quantization and the cache
plumbing of models/generation.py, models/lm_utils.py and
serving/engine.py) against the JAX package's.

What must hold, as in ``tests/test_kv_quant.py``:

1. ``kv_quantize`` gives the reference's int8 values and float32 scales
   bit for bit on the same float32 input, and the round trip is within
   half a quantization step;
2. a quantized cache is at most half the bytes of a full-precision one;
3. prefill logits are bit-identical across ``kv_dtype`` (prefill attends
   the un-quantized fresh block) and teacher-forced decode drifts less
   than 5 % (relative to the largest logit) from the full cache;
4. greedy tokens through the int8 cache equal the JAX package's.

Resharding the cache (the reference's ``:96``) waits for the distributed
checkpoint slice, and LoRA over QAT (``:128``) for the QAT half of
``quantization`` (``QuantedLinear``'s ``in_features``, ROADMAP A9).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu.quantization import kv_dequantize as jax_kv_dequantize
from paddle_tpu.quantization import kv_quantize as jax_kv_quantize
from paddle_tpu_torch.models.generation import (cache_nbytes, init_cache,
                                                normalize_kv_dtype,
                                                scatter_cache_rows,
                                                slice_cache_rows)
from paddle_tpu_torch.quantization import (is_quantized_kv, kv_dequantize,
                                           kv_quantize)
from torch_threads import few_torch_threads  # noqa: F401

GEO = dict(max_length=64, prefill_buckets=(32,))


@pytest.fixture(scope="module")
def gpt_pair():
    """gpt_tiny seeded in JAX and converted by name into the port."""
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from paddle_tpu_torch.convert import gpt_from_jax
    from paddle_tpu_torch.models.gpt import gpt_tiny

    over = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                use_flash_attention=False)
    pt.seed(7)
    jm = JaxGPT(jax_gpt_tiny(**over))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, gpt_from_jax(state, gpt_tiny(**over), device="cpu")


@pytest.mark.parametrize("shape,std", [((2, 5, 3, 8), 3.0),
                                       ((1, 7, 2, 64), 0.02),
                                       ((3, 4, 4, 128), 40.0)])
def test_kv_quantize_bit_equal_to_jax(shape, std):
    """Values and scales equal the reference's bit for bit (exact ties
    at .5 included: both round half to even)."""
    x = np.random.default_rng(len(shape) + int(std)).normal(
        0, std, shape).astype(np.float32)
    # a head whose elements sit exactly on rounding ties of its scale
    x[0, 0, 0, :4] = np.float32([127.0, 0.5, -2.5, 63.5]) * np.float32(0.25)
    x[0, 0, 0, 4:] = 0.0
    jq, js = jax_kv_quantize(jnp.asarray(x))
    tq, ts = kv_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(
        kv_dequantize(tq, ts).numpy(),
        np.asarray(jax_kv_dequantize(jq, js)))


def test_roundtrip_error_within_half_step():
    x = np.random.default_rng(0).normal(
        0, 3.0, (2, 5, 3, 8)).astype(np.float32)
    q, scale = kv_quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and tuple(q.shape) == x.shape
    assert scale.dtype == torch.float32 and tuple(scale.shape) == (2, 5, 3, 1)
    deq = kv_dequantize(q, scale).numpy()
    # symmetric round-to-nearest: |err| <= scale / 2 per element
    bound = np.broadcast_to(scale.numpy() / 2 + 1e-7, x.shape)
    assert (np.abs(deq - x) <= bound).all()
    assert np.abs(deq - x).max() / np.abs(x).max() < 0.01


def test_zero_head_dequantizes_to_exact_zero():
    q, scale = kv_quantize(torch.zeros(1, 2, 2, 8))
    assert (q == 0).all()
    assert (kv_dequantize(q, scale) == 0.0).all()
    # a bf16 input dequantizes back to bf16 on request
    assert kv_dequantize(q, scale, torch.bfloat16).dtype == torch.bfloat16


def test_is_quantized_kv_predicate():
    x = torch.ones(1, 2, 2, 4)
    assert is_quantized_kv(kv_quantize(x))
    assert not is_quantized_kv(x)
    assert not is_quantized_kv((x, x))   # a full-precision pair is not one


def test_normalize_kv_dtype():
    assert normalize_kv_dtype(None) is None
    assert normalize_kv_dtype("none") is None
    assert normalize_kv_dtype("int8") == "int8"
    with pytest.raises(ValueError, match="unsupported kv_dtype"):
        normalize_kv_dtype("int4")


def test_cache_bytes_halved_and_equal_to_jax(gpt_pair):
    from paddle_tpu.models.generation import cache_nbytes as jax_nbytes
    from paddle_tpu.models.generation import init_cache as jax_init_cache

    jm, tm = gpt_pair
    full = cache_nbytes(init_cache(tm, 4, 64))
    quant = cache_nbytes(init_cache(tm, 4, 64, kv_dtype="int8"))
    assert quant <= full / 2, (
        f"int8 cache is {quant} bytes vs {full} full-precision")
    assert full == jax_nbytes(jax_init_cache(jm, 4, 64))
    assert quant == jax_nbytes(jax_init_cache(jm, 4, 64, kv_dtype="int8"))


def test_serving_slot_bytes_halved(gpt_pair):
    from paddle_tpu.serving.engine import ContinuousBatchingEngine as JaxEng
    from paddle_tpu_torch.serving.engine import ContinuousBatchingEngine

    jm, tm = gpt_pair
    full = ContinuousBatchingEngine(
        tm, slots=2, max_length=64).cache_bytes_per_slot()
    quant = ContinuousBatchingEngine(
        tm, slots=2, max_length=64, kv_dtype="int8").cache_bytes_per_slot()
    assert quant <= full / 2
    assert quant == JaxEng(jm, slots=2, max_length=64,
                           kv_dtype="int8").cache_bytes_per_slot()


def test_slice_and_scatter_rows_over_pairs(gpt_pair):
    """The slot primitives treat both leaves of an int8 entry alike."""
    _, tm = gpt_pair
    live = init_cache(tm, 3, 16, kv_dtype="int8")
    row = init_cache(tm, 1, 16, kv_dtype="int8")
    for (k, v) in row:
        for vals, scales in (k, v):
            vals.fill_(5)
            scales.fill_(0.25)
    scatter_cache_rows(live, row, 1)
    got = slice_cache_rows(live, 1)
    for (k, v), (lk, lv) in zip(got, live):
        assert k[0].shape[0] == 1 and (k[0] == 5).all()
        assert (v[1] == 0.25).all()
        assert (lk[0][0] == 0).all() and (lk[0][2] == 0).all()


def test_quantized_cache_logit_drift_bounded(gpt_pair):
    """Prefill logits bit-identical across kv_dtype; teacher-forced
    decode through the int8 cache within 5 % relative of the full cache
    (the reference's bound), and within 1e-4 absolute of the JAX
    package's int8 decode logits (float32, two summation orders)."""
    from paddle_tpu.models.generation import init_cache as jax_init_cache
    from paddle_tpu.nn.layer import buffer_state, functional_call, param_state

    jm, tm = gpt_pair
    ids = np.random.default_rng(3).integers(1, 1024, (2, 8))
    jparams, jbuffers = param_state(jm), buffer_state(jm)
    jcache = jax_init_cache(jm, 2, 32, kv_dtype="int8")
    (jl, jcache), _ = functional_call(jm, jparams, jbuffers,
                                      jnp.asarray(ids, jnp.int32),
                                      cache=jcache, position_offset=0)
    with torch.inference_mode():
        full = init_cache(tm, 2, 32)
        quant = init_cache(tm, 2, 32, kv_dtype="int8")
        t_ids = torch.as_tensor(ids)
        lf, full = tm(t_ids, cache=full, position_offset=0)
        lq, quant = tm(t_ids, cache=quant, position_offset=0)
        # prefill attends the un-quantized fresh block: bit-identical
        np.testing.assert_array_equal(lf[:, -1].numpy(), lq[:, -1].numpy())
        worst = 0.0
        tok = torch.argmax(lf[:, -1], dim=-1)
        for step in range(4):
            pos = torch.full((2,), 8 + step)
            lf, full = tm(tok[:, None], cache=full, position_offset=pos)
            lq, quant = tm(tok[:, None], cache=quant, position_offset=pos)
            (jl, jcache), _ = functional_call(
                jm, jparams, jbuffers,
                jnp.asarray(tok.numpy()[:, None], jnp.int32), cache=jcache,
                position_offset=jnp.full((2,), 8 + step, jnp.int32))
            a, b = lf[:, -1].numpy(), lq[:, -1].numpy()
            worst = max(worst, np.abs(a - b).max() / max(np.abs(a).max(),
                                                         1e-9))
            np.testing.assert_allclose(b, np.asarray(jl[:, -1]), atol=1e-4,
                                       rtol=0)
            tok = torch.argmax(lf[:, -1], dim=-1)
    assert worst < 0.05, f"int8 KV logit drift {worst} exceeds 5%"


def test_int8_greedy_generate_matches_jax(gpt_pair):
    jm, tm = gpt_pair
    ids = np.random.default_rng(11).integers(1, 1024, (2, 13))
    want = jm.generate(ids.astype(np.int32), max_new_tokens=10,
                       kv_dtype="int8", **GEO)
    got = tm.generate(ids, max_new_tokens=10, kv_dtype="int8", **GEO)
    np.testing.assert_array_equal(got, want)
    # one engine per (geometry, kv_dtype); compiles are always 0
    stats = tm._generation_engines[(64, (32,), "int8")].cache_stats()
    assert stats["prefill"]["compiles"] == 0
    assert stats["decode"]["calls"] >= 9


def test_llama_gqa_int8_cache_per_kv_head_matches_jax():
    """Llama's GQA cache (4 heads, 2 KV heads) is quantized per kv head:
    scales ``[B, S, 2, 1]``; greedy int8 tokens equal the reference's."""
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
    from paddle_tpu_torch.convert import llama_from_jax
    from paddle_tpu_torch.models.llama import llama_tiny

    over = dict(use_flash_attention=False)
    pt.seed(5)
    jm = JaxLlama(jax_llama_tiny(**over))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = llama_from_jax(state, llama_tiny(**over), device="cpu")
    cache = init_cache(tm, 2, 32, kv_dtype="int8")
    vals, scales = cache[0][0]
    assert vals.shape[2] == tm.cfg.num_kv_heads == 2
    assert tuple(scales.shape) == (2, 32, 2, 1)
    ids = np.random.default_rng(4).integers(1, tm.cfg.vocab_size, (2, 11))
    want = jm.generate(ids.astype(np.int32), max_new_tokens=8,
                       kv_dtype="int8", **GEO)
    got = tm.generate(ids, max_new_tokens=8, kv_dtype="int8", **GEO)
    np.testing.assert_array_equal(got, want)

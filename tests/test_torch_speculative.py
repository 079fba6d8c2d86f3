"""The port's draft-model speculative decoding
(paddle_tpu_torch/models/speculative.py) against the JAX package's.

Twins of ``tests/test_speculative.py``: greedy speculative output is
token-identical to solo greedy decoding (in both buckets, and with an
eos id), a fixed seed replays the same tokens and per-round acceptance
trace, a self-draft accepts everything, and the int8 cache replays. The
reference's ``test_compile_budget`` has no twin: the port runs eagerly
and compiles nothing (``cache_stats()`` reports 0 compiles). Parity with
the JAX package: ``build_draft_model`` copies the same weights, and
greedy speculative tokens equal the JAX ``SpeculativeEngine``'s.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu_torch.models import lm_utils
from paddle_tpu_torch.models.generation import GenerationEngine
from paddle_tpu_torch.models.speculative import (SpeculativeEngine,
                                                 build_draft_model)
from torch_threads import few_torch_threads  # noqa: F401

GEO = dict(max_length=64, prefill_buckets=(16, 32))


@pytest.fixture(scope="module")
def pair():
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


@pytest.fixture(scope="module")
def draft_model(pair):
    return build_draft_model(pair[1], num_layers=1)


@pytest.fixture(scope="module")
def engine(pair, draft_model):
    return SpeculativeEngine(pair[1], draft_model, k=4, **GEO)


@pytest.fixture(scope="module")
def solo(pair):
    return GenerationEngine(pair[1], **GEO)


def _prompt(rows=3, length=12, seed=7):
    return np.random.default_rng(seed).integers(
        1, 64, (rows, length)).astype(np.int32)


def test_greedy_parity_with_solo(engine, solo):
    ids = _prompt()
    np.testing.assert_array_equal(engine.generate(ids, max_new_tokens=20),
                                  solo.generate(ids, max_new_tokens=20))


def test_greedy_parity_second_bucket(engine, solo):
    ids = _prompt(rows=2, length=24, seed=3)   # falls in the 32 bucket
    np.testing.assert_array_equal(engine.generate(ids, max_new_tokens=16),
                                  solo.generate(ids, max_new_tokens=16))


def test_eos_parity_with_solo(engine, solo):
    ids = _prompt()
    free = solo.generate(ids, max_new_tokens=20)
    eos = int(free[0, 5])   # a token the free run actually emits
    np.testing.assert_array_equal(
        engine.generate(ids, max_new_tokens=20, eos_token_id=eos),
        solo.generate(ids, max_new_tokens=20, eos_token_id=eos))


def test_fixed_seed_replay_deterministic(engine):
    ids = _prompt()
    kw = dict(max_new_tokens=20, do_sample=True, temperature=0.9,
              top_k=20, seed=123, return_stats=True)
    o1, s1 = engine.generate(ids, **kw)
    o2, s2 = engine.generate(ids, **kw)
    np.testing.assert_array_equal(o1, o2)
    t1, t2 = s1["acceptance_trace"], s2["acceptance_trace"]
    assert len(t1) == len(t2) == s1["rounds"]
    np.testing.assert_array_equal(t1, t2)
    assert all(r.shape == (ids.shape[0],) for r in t1)
    assert all(0 <= int(v) <= engine.k + 1 for r in t1 for v in r)
    # another seed draws another stream
    o3 = engine.generate(ids, **dict(kw, seed=124, return_stats=False))
    assert not np.array_equal(o1, o3)


def test_sampled_first_token_equals_solo_generate(engine, solo):
    """The target prefill draws its first token as a solo generate()
    does, so the first column equals a solo run with the same seed."""
    ids = _prompt(seed=9)
    kw = dict(do_sample=True, temperature=0.7, seed=31)
    spec = engine.generate(ids, max_new_tokens=6, **kw)
    ref = solo.generate(ids, max_new_tokens=1, **kw)
    np.testing.assert_array_equal(spec[:, 0], ref[:, 0])


def test_self_draft_accepts_everything(pair):
    _, tm = pair
    eng = SpeculativeEngine(tm, tm, k=4, **GEO)
    _, stats = eng.generate(_prompt(), max_new_tokens=16, return_stats=True)
    assert stats["acceptance_rate"] == pytest.approx(1.0)
    assert stats["tokens_per_target_dispatch"] > eng.k
    assert stats["compile_stats"]["decode_round"]["compiles"] == 0


def test_int8_kv_replay_and_greedy(pair, draft_model, solo):
    _, tm = pair
    eng = SpeculativeEngine(tm, draft_model, k=4, kv_dtype="int8", **GEO)
    ids = _prompt()
    a = eng.generate(ids, max_new_tokens=16, do_sample=True, seed=5)
    b = eng.generate(ids, max_new_tokens=16, do_sample=True, seed=5)
    np.testing.assert_array_equal(a, b)
    int8_solo = GenerationEngine(tm, kv_dtype="int8", **GEO)
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=16),
                                  int8_solo.generate(ids, max_new_tokens=16))


def test_validation(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="k must be >= 1"):
        SpeculativeEngine(tm, tm, k=0, **GEO)
    eng = SpeculativeEngine(tm, tm, k=4, **GEO)
    with pytest.raises(ValueError, match="verify window must fit"):
        eng.generate(_prompt(length=30), max_new_tokens=31)


def test_draft_weights_equal_jax_draft(pair, draft_model):
    from paddle_tpu.models.speculative import build_draft_model as jax_draft

    jm, _ = pair
    jd = jax_draft(jm, num_layers=1)
    want = {k: np.asarray(v) for k, v in jd.state_dict().items()}
    got = {k: v.detach().numpy() for k, v in draft_model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert draft_model.cfg.num_layers == 1


@pytest.mark.parametrize("rows,length,new", [(3, 12, 20), (2, 24, 12)])
def test_greedy_equals_jax_speculative(pair, engine, rows, length, new):
    from paddle_tpu.models.speculative import SpeculativeEngine as JaxSpec
    from paddle_tpu.models.speculative import build_draft_model as jax_draft

    jm, _ = pair
    jeng = JaxSpec(jm, jax_draft(jm, num_layers=1), k=4, **GEO)
    ids = _prompt(rows, length, seed=rows + length)
    want, jstats = jeng.generate(ids, max_new_tokens=new, return_stats=True)
    got, stats = engine.generate(ids, max_new_tokens=new, return_stats=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(stats["acceptance_trace"],
                                  jstats["acceptance_trace"])


def test_rounds_never_take_causal_attention(pair, draft_model, monkeypatch):
    """Only the two prefills attend through causal_attention (the flash
    kernels on the card), with Lq == Lk; the draft chain's pair window
    and the [B, K+1] verify run cached_attention at per-row offsets."""
    _, tm = pair
    calls = []
    real = lm_utils.causal_attention

    def spy(q, k, *a, **kw):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, *a, **kw)

    monkeypatch.setattr(lm_utils, "causal_attention", spy)
    eng = SpeculativeEngine(tm, draft_model, k=4, **GEO)
    _, stats = eng.generate(_prompt(), max_new_tokens=12, return_stats=True)
    assert stats["rounds"] > 0
    layers = tm.cfg.num_layers + draft_model.cfg.num_layers
    assert calls == [(16, 16)] * layers


# ------------------------------------------------- GQA (llama_tiny) twins
@pytest.fixture(scope="module")
def llama_pair():
    """llama_tiny (4 heads, 2 kv heads) seeded in JAX and converted by
    name into the port."""
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
    from paddle_tpu_torch.convert import llama_from_jax
    from paddle_tpu_torch.models.llama import llama_tiny

    pt.seed(7)
    jm = JaxLlama(jax_llama_tiny(use_flash_attention=False))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = llama_from_jax(state, llama_tiny(use_flash_attention=False),
                        device="cpu")
    assert tm.cfg.num_kv_heads < tm.cfg.num_heads
    return jm, tm


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_llama_gqa_speculative_equals_jax(llama_pair, kv_dtype):
    """test_greedy_equals_jax_speculative with grouped-query attention,
    on the bf16 and the int8 cache: greedy tokens and the per-round
    acceptance trace equal the JAX SpeculativeEngine's, and the greedy
    output equals solo greedy decoding."""
    from paddle_tpu.models.speculative import SpeculativeEngine as JaxSpec
    from paddle_tpu.models.speculative import build_draft_model as jax_draft

    jm, tm = llama_pair
    opts = dict(k=4, kv_dtype=kv_dtype, **GEO)
    jeng = JaxSpec(jm, jax_draft(jm, num_layers=1), **opts)
    teng = SpeculativeEngine(tm, build_draft_model(tm, num_layers=1), **opts)
    ids = _prompt(2, 12, seed=31)
    want, jstats = jeng.generate(ids, max_new_tokens=16, return_stats=True)
    got, stats = teng.generate(ids, max_new_tokens=16, return_stats=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(stats["acceptance_trace"],
                                  jstats["acceptance_trace"])
    solo = GenerationEngine(tm, kv_dtype=kv_dtype, **GEO)
    np.testing.assert_array_equal(got, solo.generate(ids, max_new_tokens=16))

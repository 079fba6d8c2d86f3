"""The port's paged prefix block pool and pooled admit
(paddle_tpu_torch/serving/prefix_cache.py and serving/engine.py) against
the JAX package's.

Twins of ``tests/test_fleet_serving.py``'s block-pool tests, plus the
port's own parity: the digest chain is the reference's bytes, the same
traffic gives the same hit tokens and evictions, greedy streams served
with the pool, the int8 cache or both equal the JAX server's, and a
pooled admit never takes ``causal_attention`` (so it never launches a
flash forward on the card, and the kernels' top-left causal mask never
meets an ``Lq != Lk`` shape).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.serving import InferenceServer as JaxServer
from paddle_tpu.serving.prefix_cache import BlockPool as JaxPool
from paddle_tpu.serving.prefix_cache import chain_digests as jax_digests
from paddle_tpu_torch.models import lm_utils
from paddle_tpu_torch.models.generation import (gather_cache_blocks,
                                                scatter_cache_blocks)
from paddle_tpu_torch.serving import (BlockPool, InferenceServer,
                                      ServingMetrics, chain_digests)
from paddle_tpu_torch.serving.engine import ContinuousBatchingEngine
from torch_threads import few_torch_threads  # noqa: F401

GEO = dict(max_length=64, prefill_buckets=(32,))
POOL = dict(block_tokens=8, max_bytes=1 << 20)


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


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 1024, (n,)).astype(np.int32)


# --------------------------------------------------------------- the chain
@pytest.mark.parametrize("length,bs,salt", [(14, 4, b""), (33, 8, b""),
                                            (40, 16, b"tenant-a")])
def test_chain_digests_equal_jax_bytes(length, bs, salt):
    toks = _prompt(length, length)
    got = chain_digests(toks, bs, salt)
    assert got == jax_digests(toks, bs, salt)
    assert len(got) == (length - 1) // bs


# ------------------------------------------------------------- block pool
class _SpecModel:
    device = torch.device("cpu")

    def cache_spec(self):
        return {"num_layers": 2, "num_kv_heads": 2, "head_dim": 4,
                "max_length": 64, "dtype": "float32"}


def _commit_tokens(pool, toks, matched=None):
    """Host-side store of a prompt's full blocks (the engine does this
    around its admit)."""
    hit = pool.lookup(toks)
    m = hit.tokens if matched is None else matched
    if m != hit.tokens:
        hit = pool.trim(hit, m)
    plan = pool.plan_store(toks, m)
    pool.commit(hit, plan, pool.tensors)
    return hit, plan


def test_block_pool_hash_chain_match():
    pool = BlockPool(_SpecModel(), block_tokens=4, max_bytes=1 << 20)
    toks = np.arange(14, dtype=np.int32)     # 3 full blocks + tail of 2
    assert pool.match(toks) == 0
    _commit_tokens(pool, toks)
    assert pool.match(toks) == 12
    other = toks.copy()
    other[9] = 99                            # divergent third block
    assert pool.match(other) == 8
    exact = np.arange(12, dtype=np.int32)    # never the whole prompt
    assert pool.match(exact) == 8
    hit = pool.lookup(toks)
    assert hit.tokens == 12
    assert (hit.read_idx[:3] > 0).all() and (hit.read_idx[3:] == 0).all()
    plan = pool.plan_store(toks, hit.tokens)
    assert not plan.pending
    pool.commit(hit, plan, pool.tensors)
    s = pool.stats()
    assert s["blocks_in_use"] == 3 and s["hit_tokens"] >= 12
    assert 0 < s["occupancy"] <= 1 and s["hit_rate"] > 0


def test_block_pool_lru_eviction_and_pinning():
    spec = _SpecModel()
    probe = BlockPool(spec, block_tokens=4, max_bytes=1 << 20)
    pool = BlockPool(spec, block_tokens=4,
                     max_bytes=4 * probe.block_bytes)   # 4 usable rows
    assert pool.num_blocks == 5              # + reserved dump row
    a = np.arange(0, 9, dtype=np.int32)
    b = np.arange(100, 109, dtype=np.int32)
    _commit_tokens(pool, a)
    _commit_tokens(pool, b)
    assert pool.stats()["blocks_in_use"] == 4
    c = np.arange(200, 209, dtype=np.int32)
    _commit_tokens(pool, c)                  # forces eviction, LRU = a
    s = pool.stats()
    assert s["blocks_evicted"] == 2 and s["blocks_in_use"] == 4
    assert pool.match(a) == 0 and pool.match(b) == 8 and pool.match(c) == 8
    hit_b = pool.lookup(b)                   # pinned: survives pressure
    d = np.arange(300, 309, dtype=np.int32)
    hit_d = pool.lookup(d)
    plan_d = pool.plan_store(d, 0)
    assert len(plan_d.pending) <= 2
    pool.commit(hit_d, plan_d, pool.tensors)
    assert pool.match(b) == 8
    pool.commit(hit_b, pool.plan_store(b, hit_b.tokens), pool.tensors)


def test_block_pool_child_blocks_protect_parents():
    spec = _SpecModel()
    probe = BlockPool(spec, block_tokens=4, max_bytes=1 << 20)
    pool = BlockPool(spec, block_tokens=4, max_bytes=3 * probe.block_bytes)
    chain = np.arange(13, dtype=np.int32)    # 3 full blocks, one chain
    _commit_tokens(pool, chain)
    x = np.arange(500, 505, dtype=np.int32)  # 1 block, needs 1 eviction
    _commit_tokens(pool, x)
    assert pool.match(chain) == 8            # the leaf went, not a parent
    assert pool.match(x) == 4


def test_block_pool_reset_and_abort():
    pool = BlockPool(_SpecModel(), block_tokens=4, max_bytes=1 << 20)
    toks = np.arange(9, dtype=np.int32)
    hit = pool.lookup(toks)
    plan = pool.plan_store(toks, 0)
    assert len(plan.pending) == 2
    free_before = len(pool._free)
    pool.abort(hit, plan)
    assert len(pool._free) == free_before + 2
    assert pool.match(toks) == 0
    _commit_tokens(pool, toks)
    assert pool.match(toks) == 8
    pool.reset()
    assert pool.match(toks) == 0
    assert pool.stats()["blocks_in_use"] == 0
    assert pool.stats()["blocks_stored"] == 2   # cumulative survives


def test_block_pool_abort_without_plan_releases_pins():
    pool = BlockPool(_SpecModel(), block_tokens=4, max_bytes=1 << 20)
    toks = np.arange(14, dtype=np.int32)
    _commit_tokens(pool, toks)
    hit = pool.lookup(toks)
    assert hit.tokens == 12
    assert pool.stats()["blocks_pinned"] == 3
    pool.abort(hit)
    assert pool.stats()["blocks_pinned"] == 0


def test_plan_hit_failure_path_releases_pins(monkeypatch):
    from types import SimpleNamespace

    pool = BlockPool(_SpecModel(), block_tokens=4, max_bytes=1 << 20)
    toks = np.arange(14, dtype=np.int32)
    _commit_tokens(pool, toks)

    def boom(*a, **k):
        raise RuntimeError("planner down")

    monkeypatch.setattr(pool, "plan_store", boom)
    fake = SimpleNamespace(pool=pool, max_length=64,
                           bucket_for_prompt=lambda n: 32)
    with pytest.raises(RuntimeError, match="planner down"):
        ContinuousBatchingEngine._plan_hit(fake, toks, int(toks.shape[0]))
    assert pool.stats()["blocks_pinned"] == 0


def test_hits_and_evictions_equal_jax_pool():
    """One traffic sequence through both pools (8 usable rows, prompts
    sharing prefixes, eviction pressure): the same hit tokens per lookup
    and the same cumulative stats."""
    rng = np.random.default_rng(2)
    base = [rng.integers(0, 1024, 24).astype(np.int32) for _ in range(3)]
    traffic = []
    for i in range(12):
        head = base[i % 3][:8 * (1 + i % 3)]
        traffic.append(np.concatenate([head, rng.integers(0, 1024, 5 + i)]))
    probe = BlockPool(_SpecModel(), block_tokens=4, max_bytes=1 << 20)
    mine = BlockPool(_SpecModel(), block_tokens=4,
                     max_bytes=8 * probe.block_bytes)
    ref = JaxPool(_SpecModel(), block_tokens=4,
                  max_bytes=8 * probe.block_bytes)
    for toks in traffic:
        a, _ = _commit_tokens(mine, toks)
        b, _ = _commit_tokens(ref, toks)
        assert a.tokens == b.tokens
        np.testing.assert_array_equal(a.read_idx, b.read_idx)
    assert mine.stats() == ref.stats()
    assert mine.stats()["blocks_evicted"] > 0
    assert sorted(mine.digests()) == sorted(ref.digests())


def test_pool_wire_export_waits_for_router_slice():
    """The wire export and import are ported now: a pool with nothing
    matched exports nothing, and a payload without the wire version is
    refused as the reference refuses it (the round trips are in
    tests/test_torch_disagg.py)."""
    pool = BlockPool(_SpecModel(), block_tokens=4, max_bytes=1 << 20)
    ref = JaxPool(_SpecModel(), block_tokens=4, max_bytes=1 << 20)
    assert pool.export_payload(np.arange(9)) is None
    assert ref.export_payload(np.arange(9)) is None
    for p in (pool, ref):
        with pytest.raises(ValueError, match="version"):
            p.inject_payload({})


@pytest.mark.parametrize("int8", [False, True])
def test_gather_scatter_cache_blocks_roundtrip(int8):
    """Scatter a cache row into pool blocks, gather it back at the same
    indices: identical; dump-row writes never touch real blocks. Both
    leaves of an int8 entry move alike."""
    rng = np.random.default_rng(0)

    def leaf(shape):
        if int8:
            return (torch.as_tensor(rng.integers(-127, 128, shape),
                                    dtype=torch.int8),
                    torch.as_tensor(rng.random(shape[:-1] + (1,)),
                                    dtype=torch.float32))
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)

    pool = tuple((leaf((6, 4, 2, 3)), leaf((6, 4, 2, 3))) for _ in range(2))
    before = [[[t.clone() for t in (e if int8 else (e,))] for e in kv]
              for kv in pool]
    row = tuple((leaf((1, 16, 2, 3)), leaf((1, 16, 2, 3))) for _ in range(2))
    idx = np.asarray([2, 5, 0, 0])           # blocks 3 and 4 -> dump row
    stored = scatter_cache_blocks(pool, row, idx)
    back = gather_cache_blocks(stored, idx, 16)

    def parts(e):
        return e if int8 else (e,)

    for (bk, bv), (rk, rv) in zip(back, row):
        for b, r in zip(parts(bk) + parts(bv), parts(rk) + parts(rv)):
            assert torch.equal(b[0, :8], r[0, :8])
    for li in (0, 1):
        for kv in (0, 1):
            for t, old in zip(parts(stored[li][kv]), before[li][kv]):
                for j in (1, 3, 4):
                    assert torch.equal(t[j], old[j])
    short = gather_cache_blocks(stored, idx, 20)   # padded past n * bs
    first = parts(short[0][0])[0]
    assert tuple(first.shape[:2]) == (1, 20) and (first[0, 16:] == 0).all()


# ------------------------------------------------------------- the server
def test_prefix_cache_zero_budget_means_off(pair):
    _, tm = pair
    srv = InferenceServer(tm, slots=1, prefix_cache=0, device="cpu", **GEO)
    assert srv.engine.pool is None
    srv2 = InferenceServer(tm, slots=1, prefix_cache=0.0, device="cpu", **GEO)
    assert srv2.engine.pool is None
    with pytest.raises(TypeError, match="AdapterStore"):
        InferenceServer(tm, slots=1, adapter_store=object(), device="cpu",
                        **GEO)


def test_metrics_snapshot_prefix_fields():
    m = ServingMetrics(slots=2)
    m.inc("prefix_hit_tokens", 30)
    m.inc("prefix_miss_tokens", 10)
    snap = m.snapshot(prefix_cache={"blocks_in_use": 3, "occupancy": 0.5})
    assert snap["prefix_hit_tokens"] == 30
    assert snap["prefix_miss_tokens"] == 10
    assert snap["prefix_hit_rate"] == 0.75
    assert snap["prefix_cache"]["blocks_in_use"] == 3
    assert "prefix_cache" not in ServingMetrics(slots=1).snapshot()


def test_prefix_hit_stream_matches_cold_solo(pair):
    """A cold admit fills the pool; two requests sharing its 16-token
    prefix admit as hits (only the suffix prefilled) and equal their
    cold solo generate(), greedy and seeded-sampled."""
    _, tm = pair
    prefix = _prompt(16, 100)
    p1 = np.concatenate([prefix, _prompt(5, 101)])
    p2 = np.concatenate([prefix, _prompt(6, 102)])
    p3 = np.concatenate([prefix, _prompt(4, 103)])
    solo1 = tm.generate(p1[None], max_new_tokens=6, **GEO)[0]
    solo2 = tm.generate(p2[None], max_new_tokens=5, **GEO)[0]
    solo3 = tm.generate(p3[None], max_new_tokens=6, do_sample=True,
                        temperature=0.8, seed=9, **GEO)[0]
    srv = InferenceServer(tm, slots=2, prefix_cache=dict(POOL), device="cpu",
                          **GEO)
    try:
        h1 = srv.submit(p1, max_new_tokens=6)
        np.testing.assert_array_equal(h1.result(timeout=120), solo1)
        assert h1.cache_hit_tokens == 0      # cold: the pool was empty
        h2 = srv.submit(p2, max_new_tokens=5)
        h3 = srv.submit(p3, max_new_tokens=6, do_sample=True,
                        temperature=0.8, seed=9)
        np.testing.assert_array_equal(h2.result(timeout=120), solo2)
        np.testing.assert_array_equal(h3.result(timeout=120), solo3)
        assert h2.cache_hit_tokens == 16 and h3.cache_hit_tokens == 16
    finally:
        srv.shutdown(timeout=60)
    snap = srv.snapshot()
    assert snap["prefix_hit_tokens"] >= 32
    assert snap["prefix_cache"]["blocks_in_use"] >= 2
    assert snap["prefix_cache"]["hit_rate"] > 0
    assert snap["compile_stats"]["prefill"] == {"compiles": 0, "calls": 3}


@pytest.mark.parametrize("kv_dtype,pooled", [(None, True), ("int8", False),
                                             ("int8", True)])
def test_greedy_streams_match_jax_server(pair, kv_dtype, pooled):
    """Shared-prefix traffic served by the JAX server and the port with
    the same options: greedy streams token for token, and the same hit
    tokens per request."""
    jm, tm = pair
    prefix = _prompt(16, 200)
    prompts = [np.concatenate([prefix, _prompt(n, 201 + n)])
               for n in (5, 3, 9)] + [_prompt(11, 209)]
    opts = dict(kv_dtype=kv_dtype,
                prefix_cache=dict(POOL) if pooled else None)
    jsrv = JaxServer(jm, slots=2, **opts, **GEO)
    tsrv = InferenceServer(tm, slots=2, device="cpu", **opts, **GEO)
    try:
        for p in prompts:   # one at a time: hits follow the first store
            jh = jsrv.submit(p, max_new_tokens=7)
            th = tsrv.submit(p, max_new_tokens=7)
            np.testing.assert_array_equal(th.result(timeout=300),
                                          jh.result(timeout=300))
            assert th.cache_hit_tokens == jh.cache_hit_tokens
    finally:
        jsrv.shutdown(drain=False, timeout=60)
        tsrv.shutdown(drain=False, timeout=60)
    if pooled:
        assert tsrv.snapshot()["prefix_hit_tokens"] == 32


def test_pooled_admit_never_takes_causal_attention(pair, monkeypatch):
    """Every pooled admit, a cold miss at offset 0 included, runs the
    chunked continuation (cached_attention), as the reference's traced
    offset does: causal_attention (the flash kernels on the card) is
    never called. The pool-less admit of the same prompt does call it."""
    _, tm = pair
    calls = []
    real = lm_utils.causal_attention

    def spy(q, k, *a, **kw):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, *a, **kw)

    monkeypatch.setattr(lm_utils, "causal_attention", spy)
    prefix = _prompt(16, 300)
    for kv_dtype in (None, "int8"):
        eng = ContinuousBatchingEngine(tm, slots=2, prefix_cache=dict(POOL),
                                       kv_dtype=kv_dtype, **GEO)
        from paddle_tpu_torch.serving.scheduler import Request
        for slot, n in enumerate((5, 7)):
            p = np.concatenate([prefix, _prompt(n, 301 + n)])
            _, _, hit = eng.admit(Request(prompt=p, max_new_tokens=4), slot)
            assert hit == (0 if slot == 0 else 16)
        assert calls == []
    plain = ContinuousBatchingEngine(tm, slots=1, **GEO)
    plain.admit(Request(prompt=_prompt(9, 302), max_new_tokens=4), 0)
    assert calls and all(lq == lk for lq, lk in calls)


def test_warmup_resets_pool_and_reports_zero_compiles(pair):
    _, tm = pair
    eng = ContinuousBatchingEngine(tm, slots=2, prefix_cache=dict(POOL),
                                   max_length=64, prefill_buckets=(16, 32))
    out = eng.warmup()
    assert out == {"buckets": [16, 32], "prefill_compiles": 0,
                   "decode_compiles": 0}
    assert eng.pool.stats()["blocks_in_use"] == 0
    assert eng.active_count == 0 and eng.occupancy() == 0.0
    eng.sync_weights()


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


@pytest.mark.parametrize("kv_dtype,pooled", [(None, True), ("int8", False),
                                             ("int8", True)])
def test_llama_gqa_greedy_streams_match_jax_server(llama_pair, kv_dtype,
                                                   pooled):
    """test_greedy_streams_match_jax_server with grouped-query attention:
    the pool's blocks and the int8 cache hold 2 kv heads for 4 query
    heads; streams and hit tokens equal the JAX server's."""
    jm, tm = llama_pair
    prefix = _prompt(16, 300)
    prompts = [np.concatenate([prefix, _prompt(n, 301 + n)])
               for n in (5, 3, 9)] + [_prompt(11, 309)]
    opts = dict(kv_dtype=kv_dtype,
                prefix_cache=dict(POOL) if pooled else None)
    jsrv = JaxServer(jm, slots=2, **opts, **GEO)
    tsrv = InferenceServer(tm, slots=2, device="cpu", **opts, **GEO)
    try:
        for p in prompts:   # one at a time: hits follow the first store
            jh = jsrv.submit(p, max_new_tokens=7)
            th = tsrv.submit(p, max_new_tokens=7)
            np.testing.assert_array_equal(th.result(timeout=300),
                                          jh.result(timeout=300))
            assert th.cache_hit_tokens == jh.cache_hit_tokens
    finally:
        jsrv.shutdown(drain=False, timeout=60)
        tsrv.shutdown(drain=False, timeout=60)
    if pooled:
        assert tsrv.snapshot()["prefix_hit_tokens"] == 32

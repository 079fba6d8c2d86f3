"""The port's disaggregated prefill/decode (``paddle_tpu_torch.serving.
disagg``) and the pool's KV wire format against the JAX package's.

``BlockPool.export_payload`` / ``inject_payload`` speak the reference's
wire (``KV_WIRE_VERSION = 1``): the same tests run on both packages'
pools (``pk``), and payloads cross between the packages both ways with
real ``gpt_tiny`` models, for the full-precision, bfloat16 and int8
caches. A bfloat16 leaf crosses from the port as a float32 array of the
same values, and the reference's ``ml_dtypes`` leaves are read by their
bits; both land bit-exact. ``DisaggClient`` and ``PrefixIndex`` are
framework-free copies, held on stub replicas through both packages; the
port's client then runs over its own rpc (a world of one) end to end.
"""
import threading
import types

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.serving as jax_serving
import paddle_tpu.serving.prefix_cache as jax_pc
import paddle_tpu_torch.serving as torch_serving
import paddle_tpu_torch.serving.prefix_cache as torch_pc
from paddle_tpu.observability.slo import SloPolicy as JaxSloPolicy
from paddle_tpu.observability.slo import SloTracker as JaxSloTracker
from paddle_tpu_torch.observability.slo import (FLEET_TENANT, SloPolicy,
                                                SloTracker)
from torch_threads import few_torch_threads  # noqa: F401

BS = 4
GEO = dict(max_length=64, prefill_buckets=(32,))
POOL = dict(block_tokens=8, max_bytes=1 << 20)


class _SpecModel:
    device = torch.device("cpu")

    def cache_spec(self):
        return {"num_layers": 2, "num_kv_heads": 2, "head_dim": 4,
                "max_length": 64, "dtype": "float32"}


PKS = {"jax": (jax_serving, jax_pc), "torch": (torch_serving, torch_pc)}


@pytest.fixture(params=sorted(PKS))
def pk(request):
    serving, pc = PKS[request.param]
    return types.SimpleNamespace(name=request.param, serving=serving, pc=pc)


def _pool(pk, **kw):
    kw.setdefault("block_tokens", BS)
    kw.setdefault("max_bytes", 1 << 20)
    return pk.pc.BlockPool(_SpecModel(), **kw)


def _commit_tokens(pool, toks):
    hit = pool.lookup(toks)
    plan = pool.plan_store(toks, hit.tokens)
    pool.commit(hit, plan, pool.tensors)


def _paint(pool, value):
    """Fill every pool leaf with ``value`` (the port writes in place, the
    reference rebinds new arrays)."""
    if isinstance(pool, torch_pc.BlockPool):
        for k, v in pool.tensors:
            for t in (k, v):
                for x in (t if isinstance(t, tuple) else (t,)):
                    x.fill_(value)
        return
    import jax.numpy as jnp

    def fill(t):
        if isinstance(t, tuple):
            return tuple(jnp.full(x.shape, value, x.dtype) for x in t)
        return jnp.full(t.shape, value, t.dtype)

    pool.tensors = tuple((fill(k), fill(v)) for k, v in pool.tensors)


def _rows(pool, toks):
    """The pool's leaves at the rows ``toks`` matches, as numpy (bfloat16
    as its uint16 bits), in wire order."""
    hit = pool.lookup(toks)
    try:
        rows = hit.read_idx[:len(hit.entries)]
        out = []
        for k, v in pool.tensors:
            for t in (k, v):
                for x in (t if isinstance(t, tuple) else (t,)):
                    if isinstance(x, torch.Tensor):
                        x = x[torch.as_tensor(rows)]
                        out.append(x.view(torch.int16).numpy() if x.dtype
                                   == torch.bfloat16 else x.numpy())
                    else:
                        a = np.asarray(x)[rows]
                        out.append(a.view(np.int16) if a.dtype.name
                                   == "bfloat16" else a)
        return out
    finally:
        pool.abort(hit)


def _no_pins(pool):
    return all(e.refs == 0 for e in pool._entries.values())


# ------------------------------------------------------------- wire format
def test_export_import_roundtrip_moves_kv_content(pk):
    src, dst = _pool(pk), _pool(pk)
    toks = np.arange(2 * BS + 3, dtype=np.int32)
    _commit_tokens(src, toks)
    _paint(src, 7.0)
    payload = src.export_payload(toks)
    assert payload["version"] == pk.pc.KV_WIRE_VERSION == 1
    assert payload["n_blocks"] == 2 and payload["payload_bytes"] > 0
    np.testing.assert_array_equal(payload["tokens"], toks[:2 * BS])
    assert dst.match(toks) == 0
    assert dst.inject_payload(payload) == 2 * BS
    assert dst.match(toks) == 2 * BS
    for got in _rows(dst, toks):
        np.testing.assert_array_equal(got, np.full_like(got, 7.0))
    assert _no_pins(src) and _no_pins(dst)


def test_payload_layout_equals_the_reference():
    """Both packages' exports of the same committed, painted blocks: the
    same keys, header values, leaf structure, shapes, dtypes and bytes."""
    payloads = []
    for p in ("torch", "jax"):
        ns = types.SimpleNamespace(pc=PKS[p][1])
        pool = _pool(ns, kv_dtype="int8")
        toks = np.arange(3 * BS + 1, dtype=np.int32)
        _commit_tokens(pool, toks)
        _paint(pool, 3)
        payloads.append(pool.export_payload(toks))
    ours, ref = payloads
    assert sorted(ours) == sorted(ref)
    for key in ours:
        if key == "leaves":
            continue
        np.testing.assert_array_equal(ours[key], ref[key])
    for (ok, ov), (rk, rv) in zip(ours["leaves"], ref["leaves"]):
        for a, b in zip(ok + ov, rk + rv):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_export_import_roundtrip_int8_value_scale_pairs(pk):
    src, dst = _pool(pk, kv_dtype="int8"), _pool(pk, kv_dtype="int8")
    toks = np.arange(3 * BS + 1, dtype=np.int32)
    _commit_tokens(src, toks)
    payload = src.export_payload(toks)
    assert payload["kv_dtype"] == "int8"
    for k, v in payload["leaves"]:
        for vals, scales in (k, v):
            assert vals.dtype == np.int8 and scales.dtype == np.float32
    assert dst.inject_payload(payload) == 3 * BS
    assert dst.match(toks) == 3 * BS


def test_inject_rejects_cross_version_and_geometry(pk):
    src = _pool(pk)
    toks = np.arange(BS + 1, dtype=np.int32)
    _commit_tokens(src, toks)
    payload = src.export_payload(toks)
    with pytest.raises(ValueError, match="version"):
        _pool(pk).inject_payload(dict(payload, version=2))
    with pytest.raises(ValueError, match="block_tokens"):
        _pool(pk, block_tokens=8).inject_payload(payload)
    with pytest.raises(ValueError, match="kv_dtype"):
        _pool(pk, kv_dtype="int8").inject_payload(payload)
    with pytest.raises(ValueError, match="declares"):
        _pool(pk).inject_payload(dict(payload, n_blocks=2))
    assert _pool(pk).inject_payload(payload) == BS


def test_refusals_equal_the_references():
    """A wrong version or geometry is refused with the reference's own
    message."""
    msgs = []
    for p in ("torch", "jax"):
        ns = types.SimpleNamespace(pc=PKS[p][1])
        src = _pool(ns)
        toks = np.arange(BS + 1, dtype=np.int32)
        _commit_tokens(src, toks)
        payload = src.export_payload(toks)
        got = []
        for bad, pool in ((dict(payload, version=7), _pool(ns)),
                          (payload, _pool(ns, block_tokens=8)),
                          (dict(payload, head_dim=8), _pool(ns))):
            with pytest.raises(ValueError) as ei:
                pool.inject_payload(bad)
            got.append(str(ei.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_import_is_idempotent_by_digest(pk):
    src, dst = _pool(pk), _pool(pk)
    toks = np.arange(2 * BS + 1, dtype=np.int32)
    _commit_tokens(src, toks)
    payload = src.export_payload(toks)
    assert dst.inject_payload(payload) == 2 * BS
    before = pk.pc.last_migrate_stats()
    assert dst.inject_payload(payload) == 0
    after = pk.pc.last_migrate_stats()
    assert after["blocks_skipped"] - before["blocks_skipped"] == 2
    assert dst.stats()["blocks_in_use"] == 2


def test_tampered_tokens_cannot_alias_the_original_prompt(pk):
    src, dst = _pool(pk), _pool(pk)
    toks = np.arange(2 * BS + 1, dtype=np.int32)
    _commit_tokens(src, toks)
    payload = src.export_payload(toks)
    forged = dict(payload, tokens=payload["tokens"].copy())
    forged["tokens"][0] = 999
    dst.inject_payload(forged)
    assert dst.match(toks) == 0


def test_export_miss_returns_none_and_releases_pins(pk):
    pool = _pool(pk)
    assert pool.export_payload(np.arange(2 * BS, dtype=np.int32)) is None
    _commit_tokens(pool, np.arange(BS + 1, dtype=np.int32))
    pool.export_payload(np.arange(BS + 1, dtype=np.int32))
    assert _no_pins(pool)


def test_export_chunks_bound_host_staging(pk):
    pool = _pool(pk)
    toks = np.arange(4 * BS + 1, dtype=np.int32)
    _commit_tokens(pool, toks)
    pk.pc._reset_migrate_stats()
    payload = pool.export_payload(toks, max_chunk_bytes=pool.block_bytes)
    after = pk.pc.last_migrate_stats()
    assert payload["n_blocks"] == 4 and after["chunks"] == 4
    assert after["peak_chunk_bytes"] <= 2 * pool.block_bytes


def _fill_random(pool, seed):
    """Distinct seeded values in every row of every pool leaf."""
    rng = np.random.default_rng(seed)
    for k, v in pool.tensors:
        for t in (k, v):
            for x in (t if isinstance(t, tuple) else (t,)):
                vals = rng.integers(-100, 100, tuple(x.shape))
                x.copy_(torch.from_numpy(vals).to(x.dtype))


class _Bf16SpecModel(_SpecModel):
    def cache_spec(self):
        return dict(super().cache_spec(), dtype="bfloat16")


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("out_rows,in_rows", [(1, 3), (3, 2), (None, 1)])
def test_chunked_migration_lands_every_block_in_its_row(cache, out_rows,
                                                        in_rows):
    """The port's export and inject, each in chunks of its own size (the
    last chunk short), move every block's K/V to the importer's row for
    it bit-exact, in a pool whose other rows hold other values."""
    model = _Bf16SpecModel() if cache == "bfloat16" else _SpecModel()
    src, dst = (torch_pc.BlockPool(
        model, block_tokens=BS, max_bytes=1 << 20,
        kv_dtype="int8" if cache == "int8" else None) for _ in range(2))
    _fill_random(src, 0)
    _fill_random(dst, 1)
    _commit_tokens(dst, np.arange(100, 100 + 2 * BS + 1, dtype=np.int32))
    toks = np.arange(7 * BS + 1, dtype=np.int32)
    _commit_tokens(src, toks)
    payload = src.export_payload(
        toks, max_chunk_bytes=out_rows and out_rows * src.block_bytes)
    assert payload["n_blocks"] == 7
    kept = _rows(dst, np.arange(100, 100 + 2 * BS + 1, dtype=np.int32))
    assert dst.inject_payload(
        payload, max_chunk_bytes=in_rows * dst.block_bytes) == 7 * BS
    for got, want in zip(_rows(dst, toks), _rows(src, toks)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            _rows(dst, np.arange(100, 100 + 2 * BS + 1, dtype=np.int32)),
            kept):
        np.testing.assert_array_equal(got, want)


def test_saturated_importer_lands_the_chain_prefix(pk):
    src = _pool(pk)
    dst = _pool(pk, max_bytes=2 * _pool(pk).block_bytes)
    toks = np.arange(6 * BS + 1, dtype=np.int32)
    _commit_tokens(src, toks)
    added = dst.inject_payload(src.export_payload(toks))
    assert 0 < added < 6 * BS and added % BS == 0
    assert dst.match(toks) == added


def test_failed_import_returns_its_rows(pk):
    src, dst = _pool(pk), _pool(pk)
    toks = np.arange(2 * BS + 1, dtype=np.int32)
    _commit_tokens(src, toks)
    payload = src.export_payload(toks)
    free = len(dst._free)
    broken = dict(payload, leaves=payload["leaves"][:1])
    with pytest.raises(Exception):
        dst.inject_payload(broken)
    assert len(dst._free) == free and dst.match(toks) == 0


# --------------------------------------- cross-package with real models
def _models(dtype):
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from paddle_tpu_torch.convert import gpt_from_jax
    from paddle_tpu_torch.models.gpt import gpt_tiny

    pt.seed(23)
    kw = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
              dtype=dtype)
    jm = JaxGPT(jax_gpt_tiny(use_flash_attention=False, **kw))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, gpt_from_jax(state, gpt_tiny(**kw), device="cpu")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    return request.param, _models(request.param)


def _server(model, kv_dtype):
    if isinstance(model, torch.nn.Module):
        return torch_serving.InferenceServer(
            model, slots=2, prefix_cache=dict(POOL), kv_dtype=kv_dtype,
            device="cpu", **GEO)
    return jax_serving.InferenceServer(model, slots=2,
                                       prefix_cache=dict(POOL),
                                       kv_dtype=kv_dtype, **GEO)


PROMPTS = [np.random.default_rng(s).integers(0, 1024, 21 + 4 * s).astype(
    np.int32) for s in range(2)]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cross_package_payload_serves_like_a_local_prefix(models, kv_dtype,
                                                          direction):
    """A pool's payload from one package injected into the other's pool:
    the blocks land bit-exact (bfloat16 through its float32 or ml_dtypes
    encoding), the next admit hits all of them, and its stream equals the
    importing package's cold solo generate() (full-precision and bfloat16
    caches) or the same request served alone by a fresh pooled server of
    that package (int8: a pooled admit attends the dequantized cache)."""
    dtype, (jm, tm) = models
    src_m, dst_m = (jm, tm) if direction == "jax_to_torch" else (tm, jm)
    src, dst = _server(src_m, kv_dtype), _server(dst_m, kv_dtype)
    try:
        for p in PROMPTS:
            src.submit(p, max_new_tokens=2).result(timeout=300)
            payload = src.engine.pool.export_payload(p)
            leaf = payload["leaves"][0][0]
            leaf = leaf[0] if isinstance(leaf, tuple) else leaf
            if dtype == "bfloat16" and kv_dtype is None:
                assert leaf.dtype.name == ("float32" if src_m is tm
                                           else "bfloat16")
            n = (len(p) - 1) // 8 * 8
            assert dst.engine.pool.inject_payload(payload) == n
            for a, b in zip(_rows(src.engine.pool, p),
                            _rows(dst.engine.pool, p)):
                np.testing.assert_array_equal(a, b)
            h = dst.submit(p, max_new_tokens=6)
            got = h.result(timeout=300)
            assert h.cache_hit_tokens == n
            if kv_dtype is None:
                want = dst_m.generate(p[None], max_new_tokens=6, **GEO)[0]
            else:
                alone = _server(dst_m, kv_dtype)
                want = alone.submit(p, max_new_tokens=6).result(timeout=300)
                alone.shutdown(drain=False, timeout=60)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    finally:
        src.shutdown(drain=False, timeout=60)
        dst.shutdown(drain=False, timeout=60)


def test_export_under_concurrent_admits_reads_whole_blocks():
    """Exports on another thread while the serving worker admits pooled
    requests (writing the pool in place): every export of the committed
    prefix equals the export taken at rest."""
    _, tm = _models("float32")
    srv = _server(tm, None)
    try:
        prefix = np.random.default_rng(3).integers(0, 1024, 24).astype(
            np.int32)
        srv.submit(np.concatenate([prefix, [1]]), max_new_tokens=2).result(
            timeout=300)
        at_rest = srv.engine.pool.export_payload(prefix)
        stop = threading.Event()
        seen = []

        def exporter():
            while not stop.is_set():
                seen.append(srv.engine.pool.export_payload(prefix))

        t = threading.Thread(target=exporter)
        t.start()
        rng = np.random.default_rng(4)
        hs = [srv.submit(np.concatenate([prefix, rng.integers(
            0, 1024, 5 + i)]), max_new_tokens=3) for i in range(6)]
        for h in hs:
            h.result(timeout=300)
        stop.set()
        t.join(timeout=60)
        assert seen
        for got in seen:
            for (a, b), (c, d) in zip(got["leaves"], at_rest["leaves"]):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, d)
    finally:
        srv.shutdown(drain=False, timeout=60)


# ------------------------------------------------------------ prefix index
def test_prefix_index_consecutive_chain_match(pk):
    idx = pk.serving.PrefixIndex()
    digests = pk.pc.chain_digests(np.arange(4 * BS + 1, dtype=np.int32), BS)
    idx.publish("pre0", [d.hex() for d in digests[:3]])
    idx.publish("pre1", [digests[0].hex(), digests[2].hex()])
    assert idx.match(digests) == (3, "pre0")
    assert idx.match(digests, exclude="pre0") == (1, "pre1")
    idx.remove("pre0")
    assert idx.replicas() == ["pre1"]
    st = idx.statusz()
    assert st["replicas"]["pre1"]["blocks"] == 2 and st[
        "distinct_blocks"] == 2
    assert pk.serving.PrefixIndex().match(digests) == (0, None)


# ------------------------------------------------------------- coordinator
class _StubReplica:
    """The RemoteReplica duck type: submit + the migration surface."""

    def __init__(self, name, payload=None, fail=None, digests=(),
                 import_tokens=2 * BS):
        self.name = name
        self.payload = payload
        self.fail = fail
        self._digests = list(digests)
        self.import_tokens = import_tokens
        self.calls = []

    def submit(self, **kw):
        self.calls.append(("submit", kw))
        return "handle"

    def kv_prefill(self, prompt, timeout_s=None, correlation_id=None):
        self.calls.append(("kv_prefill", len(prompt)))
        if self.fail is not None:
            raise self.fail

    def kv_export(self, prompt, corr=None, max_chunk_bytes=None):
        self.calls.append(("kv_export", len(prompt)))
        if self.fail is not None:
            raise self.fail
        return self.payload

    def kv_import(self, payload, corr=None):
        self.calls.append(("kv_import", payload["payload_bytes"]))
        if self.fail is not None:
            raise self.fail
        return self.import_tokens

    def prefix_digests(self):
        if self.fail is not None:
            raise self.fail
        return {"block_tokens": BS, "digests": list(self._digests),
                "time": 0.0}

    def called(self, kind):
        return [c for c in self.calls if c[0] == kind]


def _payload(n_blocks=2):
    return {"payload_bytes": 4096 * n_blocks, "n_blocks": n_blocks}


def test_disagg_client_migrates_then_submits_to_decode(pk):
    pre = _StubReplica("pre0", payload=_payload())
    dec = _StubReplica("dec0")
    c = pk.serving.DisaggClient([pre], [dec], block_tokens=BS)
    assert c.submit(np.arange(3 * BS, dtype=np.int32),
                    max_new_tokens=4) == "handle"
    assert pre.called("kv_prefill") and pre.called("kv_export")
    assert dec.called("kv_import") and dec.called("submit")
    st = c.statusz()
    assert (st["migrations"], st["fallbacks"], st["migrated_bytes"],
            st["migrated_tokens"]) == (1, 0, 8192, 2 * BS)
    assert dec.called("submit")[0][1]["correlation_id"]


def test_disagg_client_falls_back_on_any_failed_leg(pk):
    pre = _StubReplica("pre0", fail=ConnectionError("replica gone"))
    dec = _StubReplica("dec0")
    c = pk.serving.DisaggClient([pre], [dec], block_tokens=BS)
    assert c.submit(np.arange(3 * BS, dtype=np.int32),
                    max_new_tokens=4) == "handle"
    assert dec.called("submit") and not dec.called("kv_import")
    assert (c.statusz()["fallbacks"], c.statusz()["migrations"]) == (1, 0)


def test_disagg_client_skips_short_and_adapter_requests(pk):
    pre = _StubReplica("pre0", payload=_payload())
    dec = _StubReplica("dec0")
    c = pk.serving.DisaggClient([pre], [dec], block_tokens=BS)
    assert c.min_migrate_tokens == BS + 1
    c.submit(np.arange(BS, dtype=np.int32), max_new_tokens=4)
    c.submit(np.arange(3 * BS, dtype=np.int32), max_new_tokens=4,
             adapter_id="tenant-a")
    assert not pre.calls and len(dec.called("submit")) == 2
    assert dec.called("submit")[1][1]["adapter_id"] == "tenant-a"


def test_disagg_client_prefers_warm_and_reprefills_stale(pk):
    toks = np.arange(3 * BS, dtype=np.int32)
    hexes = [d.hex() for d in pk.pc.chain_digests(toks, BS)]
    warm = _StubReplica("warm", payload=_payload())
    cold = _StubReplica("cold", payload=_payload())
    idx = pk.serving.PrefixIndex()
    idx.publish("warm", hexes)
    c = pk.serving.DisaggClient([cold, warm], [_StubReplica("dec0")],
                                block_tokens=BS, index=idx)
    c.submit(toks, max_new_tokens=4)
    assert warm.called("kv_export") and not warm.called("kv_prefill")
    assert not cold.calls and c.statusz()["remote_hits"] == 1
    stale = _StubReplica("stale", payload=None)

    def prefill(prompt, timeout_s=None, correlation_id=None):
        stale.calls.append(("kv_prefill", len(prompt)))
        stale.payload = _payload()

    stale.kv_prefill = prefill
    idx2 = pk.serving.PrefixIndex()
    idx2.publish("stale", hexes)
    dec = _StubReplica("dec0")
    c2 = pk.serving.DisaggClient([stale], [dec], block_tokens=BS,
                                 index=idx2)
    c2.submit(toks, max_new_tokens=4)
    assert stale.called("kv_prefill") and len(stale.called("kv_export")) == 2
    assert dec.called("kv_import") and c2.statusz()["migrations"] == 1


def test_scrape_index_publishes_and_drops_unreachable(pk):
    hexes = [d.hex() for d in pk.pc.chain_digests(
        np.arange(2 * BS + 1, dtype=np.int32), BS)]
    up, down = _StubReplica("up", digests=hexes), _StubReplica(
        "down", digests=hexes)
    idx = pk.serving.PrefixIndex()
    c = pk.serving.DisaggClient([up, down], [_StubReplica("dec0")],
                                block_tokens=BS, index=idx)
    assert c.scrape_index() == 2 and idx.replicas() == ["down", "up"]
    down.fail = ConnectionError("partitioned")
    assert c.scrape_index() == 1 and idx.replicas() == ["up"]
    with pytest.raises(ValueError, match="prefill"):
        pk.serving.DisaggClient([], [_StubReplica("d")])


def test_router_scores_fleet_remote_prefix_below_local(pk):
    from test_torch_fleet_serving import _StubServer

    toks = np.arange(3 * BS, dtype=np.int32)
    idx = pk.serving.PrefixIndex()
    idx.publish("pre0", [d.hex() for d in pk.pc.chain_digests(toks, BS)])
    router = pk.serving.ReplicaRouter(prefix_index=idx,
                                      remote_hit_weight=0.5)
    router.add_replica(_StubServer(), "a")
    router.submit(toks, max_new_tokens=2)
    assert router.prefix_remote_hits >= 1
    block = router.fleet_statusz()["prefix_index"]
    assert block["remote_hit_weight"] == 0.5 and "pre0" in block["replicas"]
    plain = pk.serving.ReplicaRouter()
    plain.add_replica(_StubServer(), "a")
    plain.submit(np.arange(8, dtype=np.int32), max_new_tokens=2)
    assert "prefix_index" not in plain.fleet_statusz()


def test_warm_boot_env_equals_the_references(tmp_path):
    assert torch_serving.warm_boot_env(str(tmp_path)) == \
        jax_serving.warm_boot_env(str(tmp_path))


# ------------------------------------------------------- per-signal burns
def _snap(total, ttft_ms=1.0, itl_ms=1.0):
    return {"requests_submitted": total, "requests_failed": 0,
            "requests_expired": 0, "requests_shed": 0,
            "ttft": {"count": total, "mean_ms": ttft_ms},
            "inter_token": {"count": 10 * total, "mean_ms": itl_ms}}


@pytest.mark.parametrize("signal", ["itl", "ttft"])
def test_slo_per_signal_burns_equal_the_reference(signal):
    reps = []
    for policy, tracker in ((SloPolicy, SloTracker),
                            (JaxSloPolicy, JaxSloTracker)):
        clock = [0.0]
        tr = tracker(policy(target_ttft_s=0.05, target_itl_s=0.02),
                     registry=False, dump_on_burn=False,
                     clock=lambda: clock[0])
        tr.ingest(_snap(0))
        clock[0] = 10.0
        reps.append(tr.ingest(_snap(20, ttft_ms=500.0 if signal == "ttft"
                                    else 1.0,
                                    itl_ms=50.0 if signal == "itl"
                                    else 1.0)))
    assert reps[0] == reps[1]
    ten = reps[0]["tenants"][FLEET_TENANT]
    assert ten[f"burn_slow_{signal}"] > 0
    assert (ten["burn_slow"] > 0) == (signal == "ttft")


# ---------------------------------------------- the port's client over rpc
@pytest.fixture(scope="module")
def rpc_self():
    import socket

    from paddle_tpu_torch.distributed import rpc

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        ep = f"127.0.0.1:{s.getsockname()[1]}"
    rpc.init_rpc("solo", rank=0, world_size=1, master_endpoint=ep)
    yield rpc
    rpc.shutdown(timeout=10.0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_disagg_client_over_rpc_migrates_and_serves(rpc_self, kv_dtype):
    """The port's DisaggClient over its own rpc: a pooled prefill replica
    and a pooled decode replica (hosted in this process, each with its own
    pool), every request migrated, the decode admit hitting every migrated
    block, streams equal to the same request served alone by a fresh
    pooled server, and the lane crossing both replicas."""
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.serving import (DisaggClient, RemoteReplica,
                                          remote)

    _, tm = _models("float32")
    pre_srv, dec_srv = _server(tm, kv_dtype), _server(tm, kv_dtype)
    tag = kv_dtype or "full"
    remote.host_server(pre_srv, f"prefill-{tag}")
    remote.host_server(dec_srv, f"decode-{tag}")
    try:
        pre = RemoteReplica("solo", f"prefill-{tag}", poll_interval=0.01)
        dec = RemoteReplica("solo", f"decode-{tag}", poll_interval=0.01)
        client = DisaggClient([pre], [dec], block_tokens=8)
        prefix = np.random.default_rng(8).integers(0, 1024, 24).astype(
            np.int32)
        prompts = [np.concatenate([prefix, np.random.default_rng(9 + i)
                                   .integers(0, 1024, 3 + i)]).astype(
                                       np.int32) for i in range(3)]
        hs = [client.submit(p, max_new_tokens=5) for p in prompts]
        outs = [h.result(timeout=300) for h in hs]
        st = client.statusz()
        assert (st["migrations"], st["fallbacks"]) == (3, 0)
        for p, h, got in zip(prompts, hs, outs):
            assert h.cache_hit_tokens == (len(p) - 1) // 8 * 8
            alone = _server(tm, kv_dtype)
            want = alone.submit(p, max_new_tokens=5).result(timeout=300)
            alone.shutdown(drain=False, timeout=60)
            np.testing.assert_array_equal(got, want)
        assert dec_srv.snapshot()["prefix_miss_tokens"] == sum(
            len(p) - (len(p) - 1) // 8 * 8 for p in prompts)
        names = {s["name"] for s in tracing.spans(corr=hs[0].correlation_id)}
        assert {"kv_migrate:send", "kv_migrate:recv", "kv_migrate:done",
                "prefill", "decode", "stream_end"} <= names
    finally:
        for name in (f"prefill-{tag}", f"decode-{tag}"):
            remote.unhost_server(name)
        pre_srv.shutdown(drain=False, timeout=60)
        dec_srv.shutdown(drain=False, timeout=60)

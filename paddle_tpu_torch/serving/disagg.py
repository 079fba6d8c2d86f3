"""Disaggregated prefill/decode serving: KV-block migration between
replicas, a fleet-wide prefix tier, and replica boot (port of
``paddle_tpu/serving/disagg.py``; framework-free, so copied).

A shared replica pays for long prompts twice — the prefill stalls every
in-flight decode stream on the same card, and the decode slots sit
idle while it runs. This module splits the fleet into two pools over
the rpc fabric (``serving.remote``):

- **prefill replicas** run admissions only (``max_new_tokens=1``):
  every prompt they serve leaves its full blocks COMMITTED in their
  :class:`~paddle_tpu_torch.serving.prefix_cache.BlockPool`;
- **decode replicas** receive those blocks via
  :meth:`BlockPool.inject_payload` and then serve the request through
  the engine's EXISTING pooled admit — a migrated prefix is
  indistinguishable from a locally cached one, so a stream equals the
  same request served alone by a fresh pooled server (the pooled admit
  attends the cache's dtype).

The wire format (:data:`~paddle_tpu_torch.serving.prefix_cache.KV_WIRE_VERSION`)
carries the covered TOKEN IDS, not digests: the importer re-derives the
content-hash chain itself, so a corrupt payload can only miss, never
alias another prompt's K/V. Import is idempotent by digest — a
duplicated or raced migration is a no-op — and every migration rpc is
Deadline-bounded, so a dead prefill replica costs one bounded fallback
(decode-local recompute), never a lost request.

:class:`PrefixIndex` is the fleet-wide prefix tier: replicas publish
their pools' committed digests (scraped over the same rpc surface) and
the router's affinity score consults it, so a prefix prefilled on ANY
host scores as reachable from every host, weighed against migration
cost.

Everything here defaults OFF: a fleet without a :class:`DisaggClient`
and without a router ``prefix_index`` behaves as a plain fleet.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..distributed.resilience import Deadline, fault_point
from ..observability import tracing as _tracing
from .prefix_cache import chain_digests

__all__ = ["DisaggClient", "PrefixIndex", "warm_boot_env",
           "host_kv_surface"]


def _registry():
    from ..observability import default_registry

    return default_registry()


# ---------------------------------------------------------------------------
# host side: the migration rpc surface (module-level, pickled by reference)
# ---------------------------------------------------------------------------
def _pool_of(name: str):
    from .remote import _get_server

    srv = _get_server(name)
    pool = srv.engine.pool
    if pool is None:
        raise ValueError(f"hosted replica {name!r} has no BlockPool; "
                         f"disaggregated serving needs prefix_cache=True "
                         f"on both pools' engines")
    return srv, pool


def _host_kv_prefill(name: str, prompt, opts: dict) -> dict:
    # (re-prefilling a prompt converges to the same pool state — the
    # chain is content-addressed and plan_store skips resident digests)
    """Run one admission-only request (``max_new_tokens=1``) on the
    hosted prefill replica and WAIT for it, leaving the prompt's full
    blocks committed in that replica's pool. Bounded by ``timeout_s``
    host-side (the caller's rpc Deadline bounds the wire)."""
    fault_point("disagg.kv_prefill")
    srv, pool = _pool_of(name)
    timeout_s = float(opts.get("timeout_s", 30.0))
    t0 = time.time()
    handle = srv.submit(prompt=np.asarray(prompt, np.int32).ravel(),
                        max_new_tokens=1,
                        correlation_id=opts.get("correlation_id"))
    handle.result(timeout=timeout_s)
    return {"hit_tokens": int(handle.cache_hit_tokens),
            "matched_tokens": pool.match(prompt),
            "prefill_s": round(time.time() - t0, 6)}


def _host_kv_export(name: str, prompt, corr: Optional[str] = None,
                    max_chunk_bytes: Optional[int] = None):
    """Serialize the hosted replica's matched blocks for ``prompt``
    (:meth:`BlockPool.export_payload`); ``None`` when nothing matches.
    Records the ``kv_migrate:send`` span in THIS host's trace ring
    under the request's correlation id."""
    fault_point("disagg.kv_export")
    _, pool = _pool_of(name)
    t0 = time.time()
    payload = pool.export_payload(prompt, max_chunk_bytes=max_chunk_bytes)
    if payload is None:
        return None
    _tracing.record_span(
        "kv_migrate:send", t0, time.time(), corr=corr,
        tags={"bytes": int(payload["payload_bytes"]),
              "blocks": int(payload["n_blocks"])})
    _registry().inc("fleet.kv_migrated_bytes",
                    float(payload["payload_bytes"]), direction="out")
    return payload


def _host_kv_import(name: str, payload: dict,
                    corr: Optional[str] = None) -> int:
    """Scatter a peer's payload into the hosted replica's pool
    (:meth:`BlockPool.inject_payload` — idempotent by digest); returns
    matchable tokens added. Records the ``kv_migrate:recv`` span on
    THIS host so a migrated request's trace lane crosses both hosts."""
    fault_point("disagg.kv_import")
    _, pool = _pool_of(name)
    t0 = time.time()
    added = pool.inject_payload(payload)
    _tracing.record_span(
        "kv_migrate:recv", t0, time.time(), corr=corr,
        tags={"bytes": int(payload.get("payload_bytes", 0)),
              "tokens_added": int(added)})
    _registry().inc("fleet.kv_migrated_bytes",
                    float(payload.get("payload_bytes", 0)), direction="in")
    return int(added)


def _host_prefix_digests(name: str) -> dict:
    """The hosted replica's committed block digests (hex) + geometry —
    the payload a :class:`PrefixIndex` scrape publishes."""
    _, pool = _pool_of(name)
    return {"block_tokens": int(pool.block_tokens),
            "digests": pool.digests(),
            "time": time.time()}


def host_kv_surface() -> Tuple:
    """The migration rpc surface, for peers that resolve functions by
    reference (every function is module-level and pickles by name)."""
    return (_host_kv_prefill, _host_kv_export, _host_kv_import,
            _host_prefix_digests)


# ---------------------------------------------------------------------------
# fleet-wide prefix tier
# ---------------------------------------------------------------------------
class PrefixIndex:
    """Content-hash-addressed index over every replica's committed
    blocks: digest hex -> which replicas hold it. The router consults it
    so a prefix prefilled on one host scores as a (migration-priced)
    hit on every host; :class:`DisaggClient` consults it to pick the
    richest prefill source. Entries are replaced wholesale per replica
    at each publish — the index is a scraped VIEW, never authoritative
    (a stale entry costs one failed export, which falls back to
    recompute)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_replica: Dict[str, frozenset] = {}
        self._published_at: Dict[str, float] = {}

    def publish(self, replica: str, digests_hex: Sequence[str]) -> None:
        with self._lock:
            self._by_replica[replica] = frozenset(digests_hex)
            self._published_at[replica] = time.time()

    def remove(self, replica: str) -> None:
        with self._lock:
            self._by_replica.pop(replica, None)
            self._published_at.pop(replica, None)

    def replicas(self) -> List[str]:
        with self._lock:
            return sorted(self._by_replica)

    def match(self, digests: Sequence[bytes],
              exclude: Optional[str] = None) -> Tuple[int, Optional[str]]:
        """Longest CONSECUTIVE chain prefix of ``digests`` resident on
        a single replica (the chain property makes any gap useless:
        block ``i`` cannot be admitted without ``0..i-1``). Returns
        ``(blocks, replica)`` — ``(0, None)`` on a fleet-wide miss.
        ``exclude`` skips the candidate being scored, so a replica
        never counts its own blocks as a remote hit."""
        hexes = [d.hex() if isinstance(d, (bytes, bytearray)) else str(d)
                 for d in digests]
        best, who = 0, None
        with self._lock:
            for name, held in self._by_replica.items():
                if name == exclude:
                    continue
                m = 0
                for h in hexes:
                    if h not in held:
                        break
                    m += 1
                if m > best:
                    best, who = m, name
        return best, who

    def statusz(self) -> dict:
        with self._lock:
            return {
                "replicas": {
                    name: {"blocks": len(held),
                           "age_s": round(
                               time.time() - self._published_at[name], 3)}
                    for name, held in self._by_replica.items()},
                "distinct_blocks": len(
                    set().union(*self._by_replica.values())
                    if self._by_replica else ()),
            }


# ---------------------------------------------------------------------------
# client side: the prefill -> migrate -> decode coordinator
# ---------------------------------------------------------------------------
class DisaggClient:
    """Routes one request through the disaggregated fleet: a prefill
    replica fills the KV blocks, the blocks migrate to a decode
    replica, and the decode replica serves the stream through its
    normal pool-admit path.

    Every step before the decode submit is BEST-EFFORT: any failure —
    prefill replica dead mid-migration, export timeout, version
    mismatch — falls back to submitting the request to the decode
    replica untouched, which recomputes the prefill locally. The
    request is never lost and the stream is token-identical either way
    (the pool-hit admit is exact, and the router-style seed rides in
    ``kwargs``). Adapter-salted requests skip migration entirely: their
    digest chains live in a per-tenant namespace whose salt is private
    to each replica's adapter store.

    ``replicas`` of both pools must wear the RemoteReplica duck type
    (``submit`` plus the ``kv_prefill``/``kv_export``/``kv_import``/
    ``prefix_digests`` migration surface)."""

    def __init__(self, prefill, decode, *, block_tokens: int = 16,
                 index: Optional[PrefixIndex] = None,
                 min_migrate_tokens: Optional[int] = None,
                 max_chunk_bytes: Optional[int] = None,
                 prefill_timeout_s: float = 30.0):
        if not prefill or not decode:
            raise ValueError("DisaggClient needs at least one prefill "
                             "and one decode replica")
        self.prefill = list(prefill)
        self.decode = list(decode)
        self.block_tokens = int(block_tokens)
        self.index = index
        # a prompt shorter than one full block can never migrate (the
        # last token always stays for the suffix forward) — and tiny
        # prompts are cheaper to recompute than to ship
        self.min_migrate_tokens = (self.block_tokens + 1
                                   if min_migrate_tokens is None
                                   else int(min_migrate_tokens))
        self.max_chunk_bytes = max_chunk_bytes
        self.prefill_timeout_s = float(prefill_timeout_s)
        self._rr_prefill = itertools.count()
        self._rr_decode = itertools.count()
        self._lock = threading.Lock()
        self.migrations = 0
        self.fallbacks = 0
        self.remote_hits = 0
        self.migrated_bytes = 0
        self.migrated_tokens = 0
        self.migrate_s = 0.0

    # ------------------------------------------------------- placement
    def _pick(self, pool: list, counter) -> Tuple[int, object]:
        i = next(counter) % len(pool)
        return i, pool[i]

    def _prefill_source(self, digests) -> Tuple[object, bool]:
        """Prefer the prefill replica the index says already holds the
        longest chain prefix (a warm source skips the prefill compute
        entirely); fall back to round-robin."""
        if self.index is not None:
            blocks, who = self.index.match(digests)
            if blocks > 0:
                for i, r in enumerate(self.prefill):
                    if getattr(r, "name", None) == who or \
                            getattr(r, "peer", None) == who:
                        return r, True
        return self._pick(self.prefill, self._rr_prefill)[1], False

    # ---------------------------------------------------------- submit
    def submit(self, prompt, **kwargs):
        """Admit one request. Returns the decode replica's handle —
        the same ``RequestHandle`` contract a direct ``submit`` gives.
        ``migrate=False`` in kwargs skips the prefill leg (decode-only
        placement, e.g. for short prompts)."""
        prompt = np.asarray(prompt, np.int32).ravel()
        corr = kwargs.get("correlation_id")
        if corr is None:
            corr = kwargs["correlation_id"] = \
                _tracing.new_correlation_id("disagg")
        migrate = bool(kwargs.pop("migrate", True))
        _, dec = self._pick(self.decode, self._rr_decode)
        if (migrate and kwargs.get("adapter_id") is None
                and int(prompt.shape[0]) >= self.min_migrate_tokens):
            self._migrate(prompt, dec, corr)
        return dec.submit(prompt=prompt, **kwargs)

    def _migrate(self, prompt: np.ndarray, dec, corr: str) -> int:
        """Best-effort prefill + block migration onto ``dec``; returns
        matchable tokens landed there (0 on fallback — the decode
        submit that follows recomputes locally either way)."""
        digests = chain_digests(prompt, self.block_tokens)
        t0 = time.time()
        pre, warm = self._prefill_source(digests)
        try:
            deadline = Deadline(self.prefill_timeout_s)
            if not warm:
                pre.kv_prefill(prompt, timeout_s=deadline.remaining(),
                               correlation_id=corr)
            payload = pre.kv_export(prompt, corr=corr,
                                    max_chunk_bytes=self.max_chunk_bytes)
            if payload is None and warm:
                # the index lied (scrape staleness / eviction): run the
                # prefill after all, then re-export
                pre.kv_prefill(prompt, timeout_s=deadline.remaining(),
                               correlation_id=corr)
                payload = pre.kv_export(
                    prompt, corr=corr,
                    max_chunk_bytes=self.max_chunk_bytes)
            if payload is None:
                raise ValueError("prefill replica exported no blocks")
            added = int(dec.kv_import(payload, corr=corr))
        except Exception as e:
            # ANY failed leg degrades to decode-local recompute: the
            # transport error (ReplicaUnreachable / RpcTransportError)
            # or app error is absorbed HERE because the request has a
            # second, always-available path — this is the fallback the
            # chaos drill SIGKILLs a prefill replica to exercise
            with self._lock:
                self.fallbacks += 1
            _tracing.record_event("kv_migrate:fallback", corr=corr,
                                  error=type(e).__name__)
            return 0
        with self._lock:
            self.migrations += 1
            self.migrated_bytes += int(payload["payload_bytes"])
            self.migrated_tokens += added
            self.migrate_s += time.time() - t0
            if warm:
                self.remote_hits += 1
        if warm:
            _registry().inc("fleet.prefix_remote_hits")
        _tracing.record_event(
            "kv_migrate:done", corr=corr,
            bytes=int(payload["payload_bytes"]), tokens=added,
            migrate_s=round(time.time() - t0, 6))
        return added

    # ----------------------------------------------------------- index
    def scrape_index(self) -> int:
        """Refresh :attr:`index` from every prefill replica's digest
        listing; returns how many replicas answered. Transport failures
        mark the replica absent (stale entries would only misroute the
        warm-source preference, but absent is cheaper than wrong)."""
        if self.index is None:
            return 0
        ok = 0
        for i, r in enumerate(self.prefill):
            name = getattr(r, "name", None) or getattr(r, "peer", f"p{i}")
            try:
                out = r.prefix_digests()
                self.index.publish(name, out["digests"])
                ok += 1
            except ConnectionError:
                self.index.remove(name)
        return ok

    def statusz(self) -> dict:
        with self._lock:
            out = {
                "prefill_replicas": len(self.prefill),
                "decode_replicas": len(self.decode),
                "migrations": self.migrations,
                "fallbacks": self.fallbacks,
                "remote_hits": self.remote_hits,
                "migrated_bytes": self.migrated_bytes,
                "migrated_tokens": self.migrated_tokens,
                "migrate_s": round(self.migrate_s, 6),
                "min_migrate_tokens": self.min_migrate_tokens,
            }
        if self.index is not None:
            out["index"] = self.index.statusz()
        return out


# ---------------------------------------------------------------------------
# warm boot
# ---------------------------------------------------------------------------
def warm_boot_env(cache_dir: str) -> Dict[str, str]:
    """Environment for a replica child process. The reference points the
    child's persistent compile cache at a shared ``cache_dir`` with these
    two flags, so later boots skip their compiles. The port traces and
    compiles no programs, so it has nothing to warm: its children read
    neither flag (the kernels they launch are content-hashed builds under
    ``build/kernels``, built once and loaded by every process). The
    reference's variables are returned unchanged, so a spawner written
    for either package starts the other's children too; pair with
    ``ContinuousBatchingEngine.warmup()`` in the child before it calls
    ``host_server``."""
    return {"FLAGS_persistent_compile_cache": "1",
            "FLAGS_compile_cache_dir": str(cache_dir)}

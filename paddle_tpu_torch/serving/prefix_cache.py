"""Paged prefix/KV-cache block pool: cross-request prompt reuse (port of
``paddle_tpu/serving/prefix_cache.py:86-439`` and ``:674``).

Requests that share a system prompt would each re-prefill tokens an
earlier request already pushed through the model. The pool keeps those
tokens' K/V:

- **storage** is preallocated on the engine's device, mirroring the
  cache: per layer ``(k, v)`` pairs of ``[num_blocks, block_tokens,
  n_kv_heads, head_dim]`` (int8 ``(values, scales)`` pairs under
  ``kv_dtype="int8"``). Row 0 is a reserved *dump* block: padded reads
  and discarded writes target it, so every gather and scatter of an
  admit has the same shape;
- **identity** is a content-hash chain: block ``i`` of a prompt hashes
  ``H(parent_digest, tokens[i*bs:(i+1)*bs])``, so a block's digest pins
  its whole left context, and the digests are the reference's bytes for
  the same tokens and salt. Lookup walks the chain over the prompt's
  full blocks and stops at the first miss;
- **sharing** is ref-counted: matched entries are pinned from lookup
  until the admit that copies them has run, so the evictor never hands
  their rows to a concurrent store. Entries with cached children are
  held too (evicting a middle link would break every descendant's
  chain); eviction takes LRU order over unpinned leaves only;
- **bounding** is a byte budget: ``num_blocks`` derives from
  ``max_bytes`` and the per-block K/V footprint.

The pool owns the metadata and the tensors; the engine's pooled admit
does the block copies with ``models.generation.gather_cache_blocks`` /
``scatter_cache_blocks``. The metadata methods are thread-safe.

Not ported yet: the KV wire export and import (``export_payload`` /
``inject_payload``), which belong to the router and disaggregated
serving slice (queue A6); they raise ``NotImplementedError``.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..models.generation import (cache_entries, normalize_kv_dtype,
                                 torch_dtype)

__all__ = ["BlockPool", "PrefixHit", "StorePlan", "chain_digests"]


_EMPTY = b"paddle_tpu.prefix_cache.root"


def chain_digests(tokens, block_tokens: int,
                  salt: bytes = b"") -> List[bytes]:
    """Digest chain over a prompt's MATCHABLE full blocks (never the
    whole prompt — the last token always stays for the suffix forward).
    Public so the router can hash a prompt ONCE per block size and probe
    every replica's pool with :meth:`BlockPool.match_digests`.

    ``salt`` namespaces the chain: identical prompts under different
    salts share NOTHING (the reference's multi-adapter engine salts with
    the tenant's adapter id)."""
    toks = np.asarray(tokens, np.int32).ravel()
    n = max(int(toks.shape[0]) - 1, 0) // int(block_tokens)
    return _chain_digests(toks, int(block_tokens), n, salt)


def _chain_digests(tokens: np.ndarray, block_tokens: int,
                   n_blocks: int, salt: bytes = b"") -> List[bytes]:
    """Digest of each of the first ``n_blocks`` full blocks, chained so
    a digest commits to the block's entire left context (and the
    namespace ``salt``, via the chain root)."""
    parent = _EMPTY + salt if salt else _EMPTY
    out = []
    toks = np.ascontiguousarray(tokens[:n_blocks * block_tokens], np.int32)
    for i in range(n_blocks):
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(toks[i * block_tokens:(i + 1) * block_tokens].tobytes())
        parent = h.digest()
        out.append(parent)
    return out


@dataclass
class _Entry:
    digest: bytes
    index: int                     # pool row holding this block's K/V
    parent: Optional[bytes]        # previous block in the chain (None=root)
    refs: int = 0                  # admissions currently pinning this block
    children: int = 0              # cached blocks chaining through this one
    last_use: int = 0              # LRU tick


@dataclass
class PrefixHit:
    """One lookup's outcome: ``tokens`` matched tokens (a multiple of
    ``block_tokens``), the padded read-index vector for the admit, the
    pinned entries to release at commit/abort, and the
    prompt's digest chain (so :meth:`BlockPool.plan_store` in the same
    admission does not re-hash the prompt)."""

    tokens: int
    read_idx: np.ndarray
    entries: List[_Entry] = field(default_factory=list)
    digests: List[bytes] = field(default_factory=list)


@dataclass
class StorePlan:
    """Blocks the admit should write back: ``write_idx`` is the
    padded per-block pool row (dump 0 where nothing is stored), and
    ``pending`` the not-yet-visible entries to publish at commit."""

    write_idx: np.ndarray
    pending: List[_Entry] = field(default_factory=list)


class BlockPool:
    """Ref-counted, LRU-evicted paged KV block pool for one model."""

    def __init__(self, model, block_tokens: int = 16,
                 max_bytes: int = 64 << 20,
                 max_length: Optional[int] = None,
                 max_blocks: int = 4096, kv_dtype=None, device=None):
        spec = model.cache_spec()
        self.spec = spec
        self.block_tokens = int(block_tokens)
        if self.block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        self.max_length = int(max_length or spec["max_length"])
        self.blocks_per_prompt = self.max_length // self.block_tokens
        if self.blocks_per_prompt < 1:
            raise ValueError(
                f"block_tokens {block_tokens} exceeds max_length "
                f"{self.max_length}: no prompt could ever cache a block")
        self._dtype = torch_dtype(spec["dtype"])
        self.kv_dtype = normalize_kv_dtype(kv_dtype)
        self.device = model.device if device is None else device
        itemsize = self._dtype.itemsize
        if self.kv_dtype == "int8":
            # int8 value + one float32 per-(position, head) scale: the
            # byte budget buys ~itemsize*D/(D+4) times more blocks
            per_pos_head = spec["head_dim"] + 4
        else:
            per_pos_head = spec["head_dim"] * itemsize
        self.block_bytes = (2 * spec["num_layers"] * self.block_tokens
                            * spec["num_kv_heads"] * per_pos_head)
        budget_blocks = max(1, int(max_bytes) // max(self.block_bytes, 1))
        # +1: row 0 is the reserved dump block, never allocated
        self.num_blocks = 1 + min(budget_blocks, int(max_blocks))
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # serializes TENSOR access: the engine holds it from plan to
        # commit, across the admit's in-place block writes. RLock: plan
        # and commit call back into pool methods. Lock order:
        # device_lock, then _lock.
        self.device_lock = threading.RLock()
        self._tick = 0
        # cumulative counters survive reset() — the operator's totals
        self.lookups = 0
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.blocks_stored = 0
        self.blocks_evicted = 0
        self._entries: Dict[bytes, _Entry] = {}
        self._free: List[int] = list(range(1, self.num_blocks))
        self.tensors = self._alloc_tensors()

    # ---------------------------------------------------------- storage
    def _alloc_tensors(self):
        return cache_entries(self.spec, self.num_blocks, self.block_tokens,
                             self._dtype, self.kv_dtype, self.device)

    def compatible_with(self, spec: dict, max_length: int,
                        kv_dtype=None) -> None:
        """Raise when this pool cannot serve an engine's geometry."""
        for k in ("num_layers", "num_kv_heads", "head_dim"):
            if self.spec[k] != spec[k]:
                raise ValueError(
                    f"prefix cache built for {k}={self.spec[k]} cannot "
                    f"serve a model with {k}={spec[k]}")
        if normalize_kv_dtype(kv_dtype) != self.kv_dtype:
            # gather_cache_blocks copies pool leaves into the slot cache
            # verbatim: a mismatch would fail on structure or reinterpret
            # int8 payload as values
            raise ValueError(
                f"prefix cache kv_dtype={self.kv_dtype!r} cannot serve "
                f"an engine with kv_dtype={normalize_kv_dtype(kv_dtype)!r}")
        if self.block_tokens > int(max_length):
            raise ValueError(
                f"prefix cache block_tokens {self.block_tokens} exceeds "
                f"the engine max_length {max_length}")
        if self.blocks_per_prompt * self.block_tokens > int(max_length):
            # the admit reshapes the slot row's first blocks_per_prompt*bs
            # positions into pool blocks: a pool built for a LONGER cache
            # would fail there
            raise ValueError(
                f"prefix cache covers {self.blocks_per_prompt * self.block_tokens} "
                f"cache positions (max_length {self.max_length}) but the "
                f"engine cache holds only {max_length}; build the pool "
                f"with max_length<={max_length}")

    def reset(self) -> None:
        """Drop every cached block and rebuild zeroed tensors (crash
        recovery: a fault mid-admit may leave pool rows half-written).
        Cumulative counters are preserved."""
        with self._lock:
            self._entries.clear()
            self._free = list(range(1, self.num_blocks))
        self.tensors = self._alloc_tensors()

    def adopt(self, tensors) -> None:
        """Rebind the pool's device tensors (the engine's admit writes
        them in place and hands back the same tensors)."""
        self.tensors = tensors

    # ----------------------------------------------------------- lookup
    def _matchable_blocks(self, n_tokens: int) -> int:
        """Full blocks eligible to match: never the whole prompt — the
        last token must be recomputed so the admit has a real
        suffix to prefill (its logits seed the first sampled token)."""
        return min((max(n_tokens - 1, 0)) // self.block_tokens,
                   self.blocks_per_prompt)

    def match(self, tokens, salt: bytes = b"") -> int:
        """Peek: how many prompt tokens the pool could serve right now
        (no pinning, no LRU effect). The router's affinity signal."""
        return self.match_digests(
            chain_digests(tokens, self.block_tokens, salt))

    def match_digests(self, digests: List[bytes]) -> int:
        """Peek by precomputed :func:`chain_digests` — the router hashes
        a prompt once per block size and walks every replica's table
        with it, instead of re-hashing per candidate."""
        with self._lock:
            m = 0
            for d in digests[:self.blocks_per_prompt]:
                if d not in self._entries:
                    break
                m += 1
        return m * self.block_tokens

    def lookup(self, tokens, salt: bytes = b"") -> PrefixHit:
        """Walk the prompt's hash chain, pin every matched entry
        (refs+1 until :meth:`commit`/:meth:`abort`) and return the
        padded read plan for the admit. ``salt`` namespaces the
        chain (per-adapter K/V isolation — see :func:`chain_digests`)."""
        toks = np.asarray(tokens, np.int32).ravel()
        n = self._matchable_blocks(toks.shape[0])
        digests = _chain_digests(toks, self.block_tokens, n, salt)
        read_idx = np.zeros(self.blocks_per_prompt, np.int32)
        hit = PrefixHit(tokens=0, read_idx=read_idx, digests=digests)
        with self._lock:
            self.lookups += 1
            self._tick += 1
            for i, d in enumerate(digests):
                e = self._entries.get(d)
                if e is None:
                    break
                e.refs += 1
                e.last_use = self._tick
                hit.entries.append(e)
                read_idx[i] = e.index
            hit.tokens = len(hit.entries) * self.block_tokens
            self.hit_tokens += hit.tokens
            self.miss_tokens += int(toks.shape[0]) - hit.tokens
        return hit

    def trim(self, hit: PrefixHit, tokens: int) -> PrefixHit:
        """Shrink a hit to ``tokens`` matched tokens (a multiple of the
        block size), releasing the pins past the cut. The engine uses
        this when the full match would push ``matched + suffix_bucket``
        past the cache length."""
        keep = int(tokens) // self.block_tokens
        if keep * self.block_tokens != int(tokens):
            raise ValueError(
                f"trim target {tokens} is not a multiple of "
                f"block_tokens {self.block_tokens}")
        with self._lock:
            over_hit = hit.tokens - keep * self.block_tokens
            for e in hit.entries[keep:]:
                e.refs -= 1
            if over_hit > 0:
                # accounting follows the trim: those tokens will be
                # re-prefilled after all
                self.hit_tokens -= over_hit
                self.miss_tokens += over_hit
        hit.entries = hit.entries[:keep]
        hit.tokens = keep * self.block_tokens
        hit.read_idx[keep:] = 0
        return hit

    # ------------------------------------------------------------ store
    def _evict_one_locked(self) -> Optional[int]:
        victim = None
        for e in self._entries.values():
            if e.refs > 0 or e.children > 0:
                continue
            if victim is None or e.last_use < victim.last_use:
                victim = e
        if victim is None:
            return None
        del self._entries[victim.digest]
        if victim.parent is not None:
            parent = self._entries.get(victim.parent)
            if parent is not None:
                parent.children -= 1
        self.blocks_evicted += 1
        return victim.index

    def plan_store(self, tokens, matched_tokens: int,
                   digests: Optional[List[bytes]] = None,
                   salt: bytes = b"") -> StorePlan:
        """Allocate pool rows for the prompt's not-yet-cached full
        blocks past ``matched_tokens``. Rows come from the free list,
        then from LRU eviction of unpinned leaves; when neither yields a
        row the chain stops there (a later identical prompt just
        re-misses the tail). Entries stay invisible to lookups until
        :meth:`commit` — their K/V exists only after the admit
        runs. Pass the :class:`PrefixHit`'s ``digests`` to skip
        re-hashing the prompt the same admission already hashed."""
        toks = np.asarray(tokens, np.int32).ravel()
        n = self._matchable_blocks(toks.shape[0])
        start = int(matched_tokens) // self.block_tokens
        if digests is None or len(digests) < n:
            digests = _chain_digests(toks, self.block_tokens, n, salt)
        write_idx = np.zeros(self.blocks_per_prompt, np.int32)
        plan = StorePlan(write_idx=write_idx)
        with self._lock:
            self._tick += 1
            for i in range(start, n):
                d = digests[i]
                existing = self._entries.get(d)
                if existing is not None:
                    # raced in by an earlier admission: refresh, no write
                    existing.last_use = self._tick
                    continue
                if self._free:
                    row = self._free.pop()
                else:
                    row = self._evict_one_locked()
                if row is None:
                    break      # pool saturated with pinned/linked blocks
                parent = digests[i - 1] if i > 0 else None
                e = _Entry(digest=d, index=row, parent=parent,
                           last_use=self._tick)
                write_idx[i] = row
                plan.pending.append(e)
        return plan

    def commit(self, hit: PrefixHit, plan: StorePlan, tensors) -> None:
        """Publish a successful admission: adopt the admit's pool
        tensors, make pending entries matchable, link child counts, and
        release the hit's pins."""
        self.adopt(tensors)
        with self._lock:
            for e in plan.pending:
                self._entries[e.digest] = e
                self.blocks_stored += 1
                if e.parent is not None:
                    parent = self._entries.get(e.parent)
                    if parent is not None:
                        parent.children += 1
            for e in hit.entries:
                e.refs -= 1

    def abort(self, hit: PrefixHit,
              plan: Optional[StorePlan] = None) -> None:
        """Roll back a failed admission (dispatch never ran or raised):
        release pins, return pending rows to the free list. ``plan`` is
        optional: a failure between :meth:`lookup` and :meth:`plan_store`
        has pins to release but no pending rows yet. Rows the failed
        admit may have half-written go back to the free list, where
        nothing reads them before a later store rewrites them."""
        with self._lock:
            for e in hit.entries:
                e.refs -= 1
            if plan is not None:
                for e in plan.pending:
                    self._free.append(e.index)


    # -------------------------------------------------------- migration
    def digests(self) -> List[str]:
        """Hex digests of every COMMITTED block (pending entries are
        invisible here exactly as they are to lookups)."""
        with self._lock:
            return [e.digest.hex() for e in self._entries.values()]

    def export_payload(self, tokens, salt: bytes = b"",
                       max_chunk_bytes: Optional[int] = None):
        """Not ported yet: the KV wire export belongs to the router and
        disaggregated-serving slice (queue A6)."""
        raise NotImplementedError(
            "BlockPool.export_payload is not ported yet; it comes with the "
            "router and disaggregated serving (queue A6)")

    def inject_payload(self, payload: dict,
                       max_chunk_bytes: Optional[int] = None) -> int:
        """Not ported yet: the KV wire import belongs to the router and
        disaggregated-serving slice (queue A6)."""
        raise NotImplementedError(
            "BlockPool.inject_payload is not ported yet; it comes with the "
            "router and disaggregated serving (queue A6)")

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            in_use = len(self._entries)
            pinned = sum(1 for e in self._entries.values() if e.refs > 0)
            seen = self.hit_tokens + self.miss_tokens
            return {
                "block_tokens": self.block_tokens,
                "kv_dtype": self.kv_dtype or "full",
                "blocks_total": self.num_blocks - 1,   # dump row excluded
                "blocks_in_use": in_use,
                "blocks_pinned": pinned,
                "bytes_in_use": in_use * self.block_bytes,
                "max_bytes": self.max_bytes,
                "occupancy": round(
                    in_use / max(self.num_blocks - 1, 1), 4),
                "lookups": self.lookups,
                "hit_tokens": self.hit_tokens,
                "miss_tokens": self.miss_tokens,
                "hit_rate": round(self.hit_tokens / seen, 4) if seen else 0.0,
                "blocks_stored": self.blocks_stored,
                "blocks_evicted": self.blocks_evicted,
            }

    def __repr__(self):
        s = self.stats()
        return (f"BlockPool(blocks={s['blocks_in_use']}/{s['blocks_total']}"
                f", bs={self.block_tokens}, hit_rate={s['hit_rate']})")

"""Paged prefix/KV-cache block pool: cross-request prompt reuse (port of
``paddle_tpu/serving/prefix_cache.py``).

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

**Migration** (disaggregated prefill/decode, ``serving.disagg``):
:meth:`BlockPool.export_payload` serializes a prompt's matched blocks
into a host-resident payload in the reference's wire format
(``KV_WIRE_VERSION = 1``) and :meth:`BlockPool.inject_payload` installs
one, so blocks cross between the port's and the reference's pools both
ways. Leaves cross as host numpy, never as device tensors. A bfloat16
leaf crosses as a float32 array of the same values (exact: every
bfloat16 is a float32); the reference writes an ``ml_dtypes`` array
there, which this pool reads too, by its bits, without importing
``ml_dtypes``. int8 leaves are ``(int8 values, float32 scales)`` pairs.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.generation import (cache_entries, normalize_kv_dtype,
                                 torch_dtype)

__all__ = ["BlockPool", "PrefixHit", "StorePlan", "chain_digests",
           "KV_WIRE_VERSION", "DEFAULT_MIGRATE_CHUNK_BYTES",
           "last_migrate_stats"]


_EMPTY = b"paddle_tpu.prefix_cache.root"

#: Version tag on every exported KV-block payload (the reference's). Bump
#: on ANY change to the payload layout — an importer rejects versions it
#: does not speak, so a mixed-version fleet degrades to recompute, never
#: to corrupt K/V.
KV_WIRE_VERSION = 1

#: Per-chunk ceiling for device->host (and host->device) staging during
#: block export/import: the full payload is bounded by one prompt's block
#: span, and the transfer working set on top of it is bounded by this.
DEFAULT_MIGRATE_CHUNK_BYTES = 8 << 20

# migration accounting: cumulative process-wide, read via
# last_migrate_stats() (tests + serve_bench)
_MIGRATE_STATS = {
    "exports": 0, "imports": 0,
    "bytes_out": 0, "bytes_in": 0,
    "blocks_out": 0, "blocks_in": 0,
    "blocks_skipped": 0,       # import found the digest already resident
    "chunks": 0,
    "peak_chunk_bytes": 0,     # largest single staging transfer
}


def last_migrate_stats() -> dict:
    return dict(_MIGRATE_STATS)


def _reset_migrate_stats() -> None:
    for k in _MIGRATE_STATS:
        _MIGRATE_STATS[k] = 0


def _leaf_nbytes(leaf) -> int:
    return (sum(x.nbytes for x in leaf) if isinstance(leaf, tuple)
            else leaf.nbytes)


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype holding a device leaf's bytes on the host (bfloat16
    as its uint16 bits)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _wire_array(bits: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Host bytes of a ``dtype`` leaf as its wire array: the same array,
    except bfloat16, which crosses as float32 of the same values (exact)."""
    if dtype == torch.bfloat16:
        return (bits.astype(np.uint32) << 16).view(np.float32)
    return bits


def _host_bits(leaf, dtype: torch.dtype) -> np.ndarray:
    """A wire array as host bytes of ``dtype``: for a bfloat16 pool a
    float32 (or float16) array, rounded to nearest, or the reference's
    ``ml_dtypes`` bfloat16 array, read by its bits; the pool's own dtype
    otherwise."""
    leaf = np.asarray(leaf)
    if dtype == torch.bfloat16:
        if leaf.dtype.name == "bfloat16":
            return np.ascontiguousarray(leaf).view(np.uint16)
        return (torch.from_numpy(np.ascontiguousarray(leaf, np.float32))
                .to(torch.bfloat16).view(torch.int16).numpy()
                .view(np.uint16))
    return np.ascontiguousarray(leaf, _host_dtype(dtype))


def _staging(layout) -> Tuple[np.ndarray, List[np.ndarray], List[int]]:
    """One host buffer for arrays of the given ``(shape, dtype)``s, each
    at a 16-byte aligned offset (so a device view of its slice may take
    any dtype); returns the buffer, a writable view of each array and
    their offsets."""
    sizes = [int(np.prod(shape)) * np.dtype(dtype).itemsize
             for shape, dtype in layout]
    offsets, off = [], 0
    for nbytes in sizes:
        offsets.append(off)
        off += -(-nbytes // 16) * 16
    buf = np.empty(off, np.uint8)
    views = [buf[o:o + nbytes].view(dtype).reshape(shape)
             for o, nbytes, (shape, dtype) in zip(offsets, sizes, layout)]
    return buf, views, offsets


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

    def _chunk_rows(self, max_chunk_bytes: Optional[int]) -> int:
        """Most pool rows a staging chunk of ``max_chunk_bytes`` holds
        during migration (the last chunk holds the rest)."""
        budget = int(max_chunk_bytes or DEFAULT_MIGRATE_CHUNK_BYTES)
        return max(1, min(self.blocks_per_prompt,
                          budget // max(self.block_bytes, 1)))

    def _flat_leaves(self, tensors) -> List[torch.Tensor]:
        """Every device leaf in wire order: layer, then k/v, then (int8)
        values/scales."""
        out = []
        for k, v in tensors:
            for t in (k, v):
                out.extend(t if isinstance(t, tuple) else (t,))
        return out

    def _nest(self, flat: list) -> list:
        """Inverse of :meth:`_flat_leaves` over a flat list of arrays."""
        per = 2 if self.kv_dtype == "int8" else 1
        it = iter(flat)
        leaves = []
        for _ in range(self.spec["num_layers"]):
            kv = []
            for _ in range(2):
                got = tuple(next(it) for _ in range(per))
                kv.append(got if per == 2 else got[0])
            leaves.append(tuple(kv))
        return leaves

    @torch.inference_mode()
    def export_payload(self, tokens, salt: bytes = b"",
                       max_chunk_bytes: Optional[int] = None):
        """Serialize this pool's matched blocks for ``tokens`` into a
        versioned, host-resident payload another pool (the port's or the
        reference's) can :meth:`inject_payload`. Returns ``None`` when
        nothing matches.

        The matched entries are PINNED (via :meth:`lookup`) for the whole
        device read and released in a ``finally``. Each staging chunk of
        at most ``max_chunk_bytes`` is one index gather per leaf into one
        device buffer and ONE copy to the host, taken under
        ``device_lock``, the lock the engine's pooled admit holds while
        it writes the pool. The gather is queued on the device's current
        stream, the stream the engine writes on, behind those writes. The
        payload carries the covered TOKEN IDS, not digests: the importer
        re-derives the chain, so a mismatched payload can only miss."""
        toks = np.asarray(tokens, np.int32).ravel()
        hit = self.lookup(toks, salt)
        try:
            n = len(hit.entries)
            if n == 0:
                return None
            rows = hit.read_idx[:n].astype(np.int64)
            chunk_rows = self._chunk_rows(max_chunk_bytes)
            parts: List[List[np.ndarray]] = []
            chunks = 0
            with self.device_lock:
                flat = self._flat_leaves(self.tensors)
                for s in range(0, n, chunk_rows):
                    idx_d = torch.as_tensor(rows[s:s + chunk_rows],
                                            device=self.device)
                    got = [t.index_select(0, idx_d) for t in flat]
                    host = torch.cat([g.reshape(-1).view(torch.uint8)
                                      for g in got]).cpu().numpy()
                    chunks += 1
                    _MIGRATE_STATS["peak_chunk_bytes"] = max(
                        _MIGRATE_STATS["peak_chunk_bytes"], host.nbytes)
                    views, off = [], 0
                    for g in got:
                        nb = g.numel() * g.element_size()
                        bits = (host[off:off + nb].view(_host_dtype(g.dtype))
                                .reshape(tuple(g.shape)))
                        views.append(_wire_array(bits, g.dtype))
                        off += nb
                    parts.append(views)
            flat_out = [np.concatenate([p[i] for p in parts])
                        for i in range(len(parts[0]))]
            leaves = self._nest(flat_out)
            payload_bytes = sum(_leaf_nbytes(x) for kv in leaves for x in kv)
            _MIGRATE_STATS["exports"] += 1
            _MIGRATE_STATS["bytes_out"] += payload_bytes
            _MIGRATE_STATS["blocks_out"] += n
            _MIGRATE_STATS["chunks"] += chunks
            return {
                "version": KV_WIRE_VERSION,
                "block_tokens": self.block_tokens,
                "kv_dtype": self.kv_dtype or "full",
                "num_layers": self.spec["num_layers"],
                "num_kv_heads": self.spec["num_kv_heads"],
                "head_dim": self.spec["head_dim"],
                "salt": salt.hex() if salt else "",
                "tokens": toks[:n * self.block_tokens],
                "n_blocks": n,
                "payload_bytes": payload_bytes,
                "leaves": leaves,
            }
        finally:
            self.abort(hit)

    @torch.inference_mode()
    def inject_payload(self, payload: dict,
                       max_chunk_bytes: Optional[int] = None) -> int:
        """Scatter a peer's :meth:`export_payload` (the port's or the
        reference's) into THIS pool and publish the blocks; returns
        matchable tokens added (0 when every block was already resident —
        import is idempotent by digest). Raises ``ValueError`` on a
        wire-version or geometry mismatch; on any failure past row
        allocation the pending rows go back to the free list before
        re-raising. Each chunk crosses to the device as ONE host buffer
        and is scattered per leaf under ``device_lock``."""
        if not isinstance(payload, dict) or \
                payload.get("version") != KV_WIRE_VERSION:
            version = (payload.get("version") if isinstance(payload, dict)
                       else None)
            raise ValueError(
                f"KV payload version {version!r} != "
                f"{KV_WIRE_VERSION}; refusing cross-version import")
        for k, want in (("block_tokens", self.block_tokens),
                        ("kv_dtype", self.kv_dtype or "full"),
                        ("num_layers", self.spec["num_layers"]),
                        ("num_kv_heads", self.spec["num_kv_heads"]),
                        ("head_dim", self.spec["head_dim"])):
            if payload.get(k) != want:
                raise ValueError(
                    f"KV payload {k}={payload.get(k)!r} does not match "
                    f"this pool's {k}={want!r}")
        salt = bytes.fromhex(payload.get("salt") or "")
        toks = np.asarray(payload["tokens"], np.int32).ravel()
        n = int(payload["n_blocks"])
        if toks.shape[0] != n * self.block_tokens:
            raise ValueError(
                f"KV payload covers {toks.shape[0]} tokens but declares "
                f"{n} blocks of {self.block_tokens}")
        n = min(n, self.blocks_per_prompt)
        # re-derive identity from the payload's own tokens: the chain
        # commits each block to its full left context + salt, so a
        # payload can only ever install blocks its tokens actually name
        digests = _chain_digests(toks, self.block_tokens, n, salt)
        pending: List[_Entry] = []
        write_rows: List[Tuple[int, int]] = []   # (payload block, pool row)
        with self._lock:
            self._tick += 1
            for i in range(n):
                d = digests[i]
                existing = self._entries.get(d)
                if existing is not None:
                    existing.last_use = self._tick
                    _MIGRATE_STATS["blocks_skipped"] += 1
                    continue
                row = self._free.pop() if self._free \
                    else self._evict_one_locked()
                if row is None:
                    break      # saturated: the chain prefix still lands
                parent = digests[i - 1] if i > 0 else None
                e = _Entry(digest=d, index=row, parent=parent,
                           last_use=self._tick)
                pending.append(e)
                write_rows.append((i, row))
        if not write_rows:
            _MIGRATE_STATS["imports"] += 1
            return 0
        try:
            chunk_rows = self._chunk_rows(max_chunk_bytes)
            chunks = 0
            src_flat = []
            for kv in payload["leaves"][:self.spec["num_layers"]]:
                for leaf in kv:
                    src_flat.extend(leaf if isinstance(leaf, tuple)
                                    else (leaf,))
            with self.device_lock:
                flat = self._flat_leaves(self.tensors)
                if len(src_flat) != len(flat):
                    raise ValueError(
                        f"KV payload has {len(src_flat)} leaves, this "
                        f"pool {len(flat)}")
                for s in range(0, len(write_rows), chunk_rows):
                    batch = write_rows[s:s + chunk_rows]
                    blocks = np.asarray([b for b, _ in batch], np.int64)
                    idx = np.asarray([r for _, r in batch], np.int64)
                    chunks += 1
                    buf, views, offsets = _staging(
                        [((len(batch),) + tuple(t.shape[1:]),
                          _host_dtype(t.dtype)) for t in flat])
                    for t, src, dst in zip(flat, src_flat, views):
                        src = np.asarray(src)
                        if src.dtype == dst.dtype:
                            np.take(src, blocks, axis=0, out=dst)
                        else:
                            dst[...] = _host_bits(src[blocks], t.dtype)
                    _MIGRATE_STATS["peak_chunk_bytes"] = max(
                        _MIGRATE_STATS["peak_chunk_bytes"], buf.nbytes)
                    dev = torch.from_numpy(buf).to(self.device)
                    idx_d = torch.as_tensor(idx, device=self.device)
                    for t, a, o in zip(flat, views, offsets):
                        rows_t = (dev[o:o + a.nbytes].view(t.dtype)
                                  .reshape(a.shape))
                        t.index_copy_(0, idx_d, rows_t)
        except BaseException:
            with self._lock:
                for e in pending:
                    self._free.append(e.index)
            raise
        with self._lock:
            for e in pending:
                self._entries[e.digest] = e
                self.blocks_stored += 1
                if e.parent is not None:
                    parent = self._entries.get(e.parent)
                    if parent is not None:
                        parent.children += 1
        _MIGRATE_STATS["imports"] += 1
        _MIGRATE_STATS["blocks_in"] += len(pending)
        _MIGRATE_STATS["chunks"] += chunks
        _MIGRATE_STATS["bytes_in"] += int(
            payload.get("payload_bytes")
            or sum(_leaf_nbytes(x) for kv in payload["leaves"] for x in kv))
        return len(pending) * self.block_tokens

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

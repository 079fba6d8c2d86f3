"""Slot-based continuous batcher: a fixed-shape decode batch under an
open request stream (port of ``paddle_tpu/serving/engine.py:71-690``).

The live KV cache keeps one shape, ``[B, max_length, n_kv_heads,
head_dim]`` per layer, and its batch dimension is ``B`` independent
*slots*:

- **admit** runs the bucketed batch-1 prefill (the flash kernel on the
  card) against a fresh zero single-slot cache, scatters that cache into
  the live batch at the request's slot, and samples the first token;
- **step** advances ALL slots one token with a vector of per-slot
  positions, per-slot generators, eos ids and sampling knobs, and a
  greedy mask.

Freed slots are reusable at once: stale cache rows are harmless because
the per-row position mask never lets a query see beyond its own
request's frontier, and every position is rewritten before it first
becomes visible.

Where the JAX engine donated the live cache to each compiled program
(``engine.py:139-152``) and got a new buffer back, this engine writes
into the one preallocated cache in place (slice assignment in the
prefill scatter, an indexed write per decode step), so one resident copy
serves the whole run.

Per-request sampled streams are placement-invariant: a slot's generator
at decode position ``p`` is ``per_row_generators(seed, 1, p)[0]``, the
same derivation a solo batch-1 ``generate()`` uses, so a request's
tokens do not depend on its slot or on who shares the batch.

With ``prefix_cache`` (a :class:`~paddle_tpu_torch.serving.prefix_cache.
BlockPool`), every admit is a *pooled* admit: the prompt's matched
blocks are gathered out of the pool into a slot cache, only the novel
suffix is prefilled at the matched offset, the prompt's new full blocks
are written back, and the slot cache is scattered into the live batch.
The suffix runs the chunked continuation (``cached_attention`` with
several queries against the full cache) at every matched length, a miss
at 0 included, exactly as the reference's traced offset does; a pooled
admit launches no flash forward. ``kv_dtype="int8"`` quantizes the live
cache and the pool.

With ``adapter_store`` (a :class:`~paddle_tpu_torch.lora.AdapterStore`
built on this engine's model), each slot carries a row of the store's
page stacks (0 = the zero adapter = the base model): admit pins the
request's row and takes its digest salt before any device work, and the
prefill, the pooled admit and the batched decode run under
:func:`~paddle_tpu_torch.lora.adapter_rows`, so one decode step serves a
batch that mixes tenants. With a pool, each tenant's blocks live under
its own digest namespace (adapter-modified projections make cross-tenant
reuse wrong).

Each admit runs inside a ``RecordEvent("serve:prefill")`` range and each
decode step inside ``RecordEvent("serve:decode")``, and they leave a
``prefill`` span in the request's trace lane and a batch-level
``decode_step`` span, as the reference does. Host timestamps mean
something only where the host waits for the card, so the prefill range
and span close after the first token is on the host, and the decode ones
after the step's read-back.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.batching import bucket_for
from ..lora import adapter_rows
from ..lora.store import AdapterStore, normalize_adapter_id
from ..models.generation import (DEFAULT_PREFILL_BUCKETS, cache_nbytes,
                                 fresh_seed, gather_cache_blocks,
                                 init_cache, normalize_kv_dtype,
                                 per_row_generators, sample_logits_rows,
                                 scatter_cache_blocks, scatter_cache_rows)
from ..observability import tracing as _tracing
from ..profiler import RecordEvent
from .prefix_cache import BlockPool

__all__ = ["ContinuousBatchingEngine", "SlotEvent"]


@dataclass
class SlotEvent:
    """One slot's outcome of a decode step (host-side)."""

    slot: int
    token: int
    done: bool


class ContinuousBatchingEngine:
    """The slot-scatter prefill + vector-position decode pair and the
    host-side slot table for one model.

    ``top_k`` is engine-wide; temperature, top_p, greedy-vs-sample, eos
    id and seed are per request. ``allow_top_p=False`` makes requests
    with ``top_p < 1`` an error at the server, as in the reference.

    ``prefix_cache`` (None | BlockPool | True | byte budget | kwargs
    dict) switches admission to the pooled admit (see the module
    docstring); ``kv_dtype="int8"`` stores the live cache (and a pool
    built here) quantized; ``adapter_store`` turns on batched
    multi-tenant LoRA decode (see the module docstring)."""

    def __init__(self, model, slots: int = 4,
                 max_length: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 top_k: int = 0, allow_top_p: bool = True,
                 prefix_cache=None, adapter_store=None, kv_dtype=None):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        self.model = model
        spec = model.cache_spec()
        self.spec = spec
        self.kv_dtype = normalize_kv_dtype(kv_dtype)
        self.slots = int(slots)
        self.max_length = int(max_length or spec["max_length"])
        if self.max_length > spec["max_length"]:
            raise ValueError(
                f"max_length {self.max_length} exceeds the model's position "
                f"table ({spec['max_length']} positions)")
        buckets = tuple(sorted(int(b) for b in
                               (prefill_buckets or DEFAULT_PREFILL_BUCKETS)
                               if int(b) <= self.max_length))
        self.prefill_buckets = buckets or (self.max_length,)
        self.top_k = int(top_k)
        self.allow_top_p = bool(allow_top_p)
        self.pool = self._normalize_pool(prefix_cache)
        self.store = self._normalize_store(adapter_store)
        self._calls = {"prefill": 0, "decode": 0}
        self.reset()

    def _normalize_pool(self, prefix_cache) -> Optional[BlockPool]:
        """Accept the serving layer's spellings of "give me a prefix
        cache": ``None``/``False``/``0`` (off), a ready
        :class:`BlockPool`, ``True`` (defaults), a positive int/float byte
        budget, or a kwargs dict for :class:`BlockPool`. A zero budget
        means OFF, not a one-block pool: configs spell "disabled" as 0."""
        if prefix_cache is None or prefix_cache is False:
            return None
        if isinstance(prefix_cache, (int, float)) and not isinstance(
                prefix_cache, bool) and prefix_cache <= 0:
            return None
        if isinstance(prefix_cache, BlockPool):
            prefix_cache.compatible_with(self.spec, self.max_length,
                                         kv_dtype=self.kv_dtype)
            owner = getattr(prefix_cache, "_owner", None)
            if owner is not None and owner is not self:
                # the engine writes the pool in place across plan and
                # commit; a second engine's admits would interleave
                raise ValueError(
                    "this BlockPool is already attached to another "
                    "engine; build one pool per replica")
            prefix_cache._owner = self
            return prefix_cache
        kwargs = {}
        if isinstance(prefix_cache, dict):
            kwargs = dict(prefix_cache)
        elif prefix_cache is not True:
            kwargs = {"max_bytes": int(prefix_cache)}
        kwargs.setdefault("max_length", self.max_length)
        kwargs.setdefault("kv_dtype", self.kv_dtype)
        pool = BlockPool(self.model, **kwargs)
        # the same geometry gate as a ready pool: an explicit max_length
        # larger than the engine cache would otherwise fail mid-admit
        pool.compatible_with(self.spec, self.max_length,
                             kv_dtype=self.kv_dtype)
        pool._owner = self
        return pool

    def _normalize_store(self, adapter_store) -> Optional[AdapterStore]:
        """An :class:`AdapterStore` must wrap this engine's model instance
        (the forwards reach the adapter hooks through that model's
        injected layers) and serve no other engine."""
        if adapter_store is None:
            return None
        if not isinstance(adapter_store, AdapterStore):
            raise TypeError(
                f"adapter_store must be a paddle_tpu_torch.lora."
                f"AdapterStore, got {type(adapter_store).__name__}")
        if adapter_store.model is not self.model:
            raise ValueError(
                "this AdapterStore was built for a different model "
                "instance; build the store on the engine's model "
                "(AdapterStore(model, ...))")
        owner = getattr(adapter_store, "_owner", None)
        if owner is not None and owner is not self:
            # pins are engine-lifecycle state: a shared store would let one
            # replica's crash-recovery release_all() void another's live
            # pins, making its rows evictable mid-stream
            raise ValueError(
                "this AdapterStore is already attached to another "
                "engine; build one store per replica")
        adapter_store._owner = self
        return adapter_store

    def _adapter_ctx(self, rows):
        """The per-row adapter context for a forward over ``rows`` (no-op
        without a store)."""
        if self.store is None:
            return contextlib.nullcontext()
        return adapter_rows(self.store.tensors, rows)

    # ------------------------------------------------------------- state
    @torch.inference_mode()
    def reset(self) -> None:
        """(Re)build the live batch: fresh cache, all slots free, and a
        wiped pool. Also the crash-recovery path — a fault mid-step may
        leave the cache or pool rows half-written, so recovery starts
        clean."""
        self.live_cache = init_cache(self.model, self.slots, self.max_length,
                                     kv_dtype=self.kv_dtype)
        if self.pool is not None:
            self.pool.reset()
        if self.store is not None:
            # every live request is about to be requeued: the pins this
            # engine held are void (the pages themselves stay)
            self.store.release_all()
        B = self.slots
        self._adapter_slots = np.zeros(B, np.int64)
        self._positions = np.zeros(B, np.int64)
        self._tokens = np.zeros(B, np.int64)
        self._done = np.ones(B, bool)          # free slots sit "done"
        self._seeds = np.zeros(B, np.int64)
        self._eos = np.full(B, -1, np.int64)
        self._temp = np.ones(B, np.float32)
        self._top_p = np.ones(B, np.float32)
        self._greedy = np.ones(B, bool)
        self.requests: List[Optional[object]] = [None] * B

    def sync_weights(self) -> None:
        """The reference re-snapshots parameters for its compiled
        programs here. The port's forwards read the model's live
        parameters at every call, so there is nothing to refresh; kept
        for the reference's API."""

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.requests) if r is None]

    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self.requests)

    def occupancy(self) -> float:
        return self.active_count / self.slots

    def cache_bytes_per_slot(self) -> int:
        """Device bytes one slot's KV occupies in the live batch — the
        number the ``kv_dtype="int8"`` halving is held to."""
        return cache_nbytes(self.live_cache) // self.slots

    def cache_stats(self) -> dict:
        """The reference's ``{"prefill": {...}, "decode": {...}}``
        counters. The port traces and compiles nothing, so ``compiles``
        is always 0; ``calls`` counts admits and decode steps."""
        return {kind: {"compiles": 0, "calls": n}
                for kind, n in self._calls.items()}

    @contextlib.contextmanager
    def _eval_mode(self):
        """Serving runs the eval graph (dropout off) even when the model
        is mid-fit; the mode is restored afterwards."""
        was_training = self.model.training
        self.model.eval()
        try:
            yield
        finally:
            if was_training:
                self.model.train()

    # -------------------------------------------------------- host API
    def bucket_for_prompt(self, prompt_len: int) -> int:
        return min(bucket_for(prompt_len, self.prefill_buckets),
                   self.max_length)

    def validate(self, prompt_len: int, max_new_tokens: int) -> None:
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt_len + max_new_tokens > self.max_length:
            raise ValueError(
                f"prompt_len {prompt_len} + max_new_tokens {max_new_tokens} "
                f"exceeds the engine's max_length {self.max_length}")

    def warmup(self, max_new_tokens: int = 2) -> dict:
        """Push one dummy greedy request per prefill bucket through
        :meth:`admit` (and one :meth:`step` unless ``max_new_tokens`` is
        1) on an idle engine, then reset the pool so the dummy prompts'
        blocks never match real traffic. On the card this builds the
        kernels and the library handles before the first real request.
        Returns the reference's keys; the compile counts are 0 because
        the port traces and compiles nothing."""
        from .scheduler import Request

        if self.requests[0] is not None:
            raise RuntimeError("warmup() needs an idle engine — run it "
                               "before admitting traffic")
        mnt = max(1, int(max_new_tokens))
        seen = set()
        for b in self.prefill_buckets:
            L = max(1, min(int(b), self.max_length - mnt))
            bucket = self.bucket_for_prompt(L)
            if bucket in seen:
                continue
            seen.add(bucket)
            prompt = (np.arange(L, dtype=np.int64) % 97) + 1
            self.admit(Request(prompt=prompt, max_new_tokens=mnt,
                               greedy=True, seed=0), 0)
            if mnt > 1:
                self.step()
            self.release(0)
        if self.pool is not None:
            self.pool.reset()
        return {"buckets": sorted(seen), "prefill_compiles": 0,
                "decode_compiles": 0}

    def _plan_hit(self, prompt: np.ndarray, L: int, salt: bytes = b""):
        """Pin the longest usable pool match for ``prompt`` and plan the
        block writes. The match shrinks (block granularity) until
        ``matched + suffix_bucket`` fits the cache — the suffix write
        window must never clamp against the cache end."""
        hit = self.pool.lookup(prompt, salt=salt)
        # everything between the lookup (which PINS the matched blocks)
        # and handing (hit, plan) to the caller runs under an abort
        # guard: a raise out of trim/plan_store would otherwise leak the
        # pins forever (the pool would become unevictable)
        try:
            matched = hit.tokens
            while (matched > 0
                   and matched + self.bucket_for_prompt(L - matched)
                   > self.max_length):
                matched -= self.pool.block_tokens
            if matched != hit.tokens:
                hit = self.pool.trim(hit, matched)
            plan = self.pool.plan_store(prompt, matched,
                                        digests=hit.digests, salt=salt)
        except Exception:
            self.pool.abort(hit)
            raise
        return hit, plan

    def _first_token(self, logits, request, seed: int):
        """The request's first token from its prefill logits ``[1, 1,
        V]``: row 0's prefill generator, as a solo ``generate()``."""
        gens = [None if request.greedy else
                per_row_generators(seed, 1, None, self.model.device)[0]]
        return sample_logits_rows(
            logits[:, 0, :], gens, request.temperature, self.top_k,
            request.top_p, greedy_mask=[request.greedy])

    def _padded(self, tokens: np.ndarray, bucket: int):
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :tokens.shape[0]] = tokens
        return torch.as_tensor(ids, device=self.model.device)

    def _admit_pooled(self, prompt: np.ndarray, L: int, request,
                      seed: int, slot: int, salt: bytes = b""):
        """The pooled admit: gather the matched blocks into a slot cache,
        prefill only the suffix at the matched offset, write the prompt's
        new full blocks back, scatter the slot. The offset goes in as a
        ``[1]`` tensor, never the int 0, so every pooled admit (a miss at
        0 included) runs the chunked continuation through
        ``cached_attention``, as the reference's traced offset does, and
        launches no flash forward. ``salt`` namespaces the digest chain
        per adapter. Returns ``(token, matched tokens, suffix bucket)``."""
        pool = self.pool
        with pool.device_lock:
            hit, plan = self._plan_hit(prompt, L, salt=salt)
            # the abort guard starts right after the pins land: a raise
            # anywhere before the commit must release them and free the
            # plan's rows
            try:
                matched = hit.tokens
                suffix = L - matched
                bucket = self.bucket_for_prompt(suffix)
                ids = self._padded(prompt[matched:], bucket)
                slot_cache = gather_cache_blocks(pool.tensors, hit.read_idx,
                                                 self.max_length)
                offset = torch.tensor([matched], device=self.model.device)
                logits, slot_cache = self.model(
                    ids, cache=slot_cache, position_offset=offset,
                    gather_last=suffix - 1)
                tok = self._first_token(logits, request, seed)
                scatter_cache_blocks(pool.tensors, slot_cache,
                                     plan.write_idx)
                scatter_cache_rows(self.live_cache, slot_cache, slot)
            except Exception:
                pool.abort(hit, plan)
                raise
            pool.commit(hit, plan, pool.tensors)
        return tok, matched, bucket

    @torch.inference_mode()
    def admit(self, request, slot: int) -> Tuple[int, bool, int]:
        """Prefill ``request`` into free ``slot``; returns the first
        token, whether the request finished at prefill (eos first), and
        how many prompt tokens the prefix cache served (0 without a
        pool)."""
        if self.requests[slot] is not None:
            raise RuntimeError(f"slot {slot} is occupied")
        prompt = np.asarray(request.prompt, np.int64).ravel()
        L = int(prompt.shape[0])
        self.validate(L, int(request.max_new_tokens))
        seed = fresh_seed() if request.seed is None else int(request.seed)
        eos = -1 if request.eos_token_id is None else int(request.eos_token_id)
        adapter_id = normalize_adapter_id(
            getattr(request, "adapter_id", None))
        if adapter_id is not None and self.store is None:
            raise ValueError(
                f"request names adapter {adapter_id!r} but this engine "
                f"has no adapter_store")
        a_row, a_salt = 0, b""
        if self.store is not None:
            # resolved on the host before any device work: an unknown
            # adapter or a fully pinned store fails only this request
            # (AdapterError; the server fails it without an engine
            # reset). The salt comes with the pin, under one lock hold,
            # so a concurrent adapter update cannot stamp these pages'
            # K/V into the new version's namespace
            a_row, a_salt = self.store.acquire(adapter_id, with_salt=True)
        hit_tokens = 0
        bucket = 0
        self._calls["prefill"] += 1
        t_span = time.time()
        try:
            # serving runs the eval graph (dropout off); the range closes
            # after the first token's read-back
            with RecordEvent("serve:prefill"), self._eval_mode(), \
                    self._adapter_ctx([a_row]):
                if self.pool is None:
                    bucket = self.bucket_for_prompt(L)
                    slot_cache = init_cache(self.model, 1, self.max_length,
                                            kv_dtype=self.kv_dtype)
                    logits, slot_cache = self.model(
                        self._padded(prompt, bucket),
                        cache=slot_cache, position_offset=0,
                        gather_last=L - 1)
                    tok = self._first_token(logits, request, seed)
                    scatter_cache_rows(self.live_cache, slot_cache, slot)
                else:
                    tok, hit_tokens, bucket = self._admit_pooled(
                        prompt, L, request, seed, slot, salt=a_salt)
                first = int(tok[0])  # the admission's one device read
        except Exception:
            if self.store is not None:
                # the request never reached a slot: its pin is void
                self.store.release(a_row)
            raise
        # host side of the admission's one sync point: the prefill span
        # (bucket, prefix-hit and adapter tags) lands in the request's
        # trace lane with no extra device round-trip
        tags = {"bucket": int(bucket), "prompt_len": L, "slot": int(slot)}
        if self.pool is not None:
            tags["prefix_hit_tokens"] = int(hit_tokens)
        if adapter_id is not None:
            tags["adapter"] = adapter_id
        _tracing.record_span("prefill", t_span, time.time(),
                             corr=getattr(request, "corr_id", None),
                             tags=tags)
        fin = first == eos
        self.requests[slot] = request
        self._adapter_slots[slot] = a_row
        self._positions[slot] = L
        self._tokens[slot] = first
        self._done[slot] = fin
        self._seeds[slot] = seed
        self._eos[slot] = eos
        self._temp[slot] = request.temperature
        self._top_p[slot] = request.top_p
        self._greedy[slot] = request.greedy
        return first, fin, hit_tokens

    @torch.inference_mode()
    def step(self) -> List[SlotEvent]:
        """One decode iteration over the WHOLE live batch. Returns one
        event per occupied, not-yet-done slot (its new token and done
        flag); free slots decode as masked filler."""
        device = self.model.device
        gens = [None if (req is None or self._done[i] or self._greedy[i])
                else per_row_generators(int(self._seeds[i]), 1,
                                        int(self._positions[i]), device)[0]
                for i, req in enumerate(self.requests)]
        self._calls["decode"] += 1
        t_span = time.time()
        with RecordEvent("serve:decode"), self._eval_mode(), \
                self._adapter_ctx(self._adapter_slots):
            logits, self.live_cache = self.model(
                torch.as_tensor(self._tokens[:, None], device=device),
                cache=self.live_cache,
                position_offset=torch.as_tensor(self._positions,
                                                device=device))
            nxt = sample_logits_rows(logits[:, -1, :], gens, self._temp,
                                     self.top_k, self._top_p,
                                     greedy_mask=self._greedy)
            # the per-step [B] read-back IS the streaming output
            toks = nxt.cpu().numpy()
        # batch-level decode-step span (uncorrelated lane): the compute
        # timeline behind every live request's per-token spans
        _tracing.record_span("decode_step", t_span, time.time(), corr=None,
                             tags={"active": int(self.active_count)})
        toks = np.where(self._done, np.maximum(self._eos, 0), toks)
        dns = self._done | (toks == self._eos)
        events: List[SlotEvent] = []
        for i, req in enumerate(self.requests):
            if req is None or self._done[i]:
                continue
            events.append(SlotEvent(i, int(toks[i]), bool(dns[i])))
            self._positions[i] += 1
        self._tokens = toks
        self._done = dns | np.asarray([r is None for r in self.requests])
        return events

    def release(self, slot: int) -> None:
        """Free ``slot`` immediately — no batch drain. The stale cache
        rows stay; the position mask keeps them invisible to whoever is
        admitted next. The slot's adapter pin drops with it (the freed
        slot decodes as the zero adapter)."""
        self.requests[slot] = None
        self._done[slot] = True
        self._positions[slot] = 0
        self._tokens[slot] = 0
        if self.store is not None:
            self.store.release(int(self._adapter_slots[slot]))
            self._adapter_slots[slot] = 0

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

Not ported yet: the prefix cache (``BlockPool``), LoRA adapter stores
and the int8 KV cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.batching import bucket_for
from ..models.generation import (DEFAULT_PREFILL_BUCKETS, fresh_seed,
                                 init_cache, per_row_generators,
                                 sample_logits_rows, scatter_cache_rows)

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
    with ``top_p < 1`` an error at the server, as in the reference."""

    def __init__(self, model, slots: int = 4,
                 max_length: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 top_k: int = 0, allow_top_p: bool = True):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        self.model = model
        spec = model.cache_spec()
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
        self.reset()

    # ------------------------------------------------------------- state
    @torch.inference_mode()
    def reset(self) -> None:
        """(Re)build the live batch: fresh cache, all slots free. Also the
        crash-recovery path — a fault mid-step may leave the cache
        half-written, so recovery starts clean."""
        self.live_cache = init_cache(self.model, self.slots, self.max_length)
        B = self.slots
        self._positions = np.zeros(B, np.int64)
        self._tokens = np.zeros(B, np.int64)
        self._done = np.ones(B, bool)          # free slots sit "done"
        self._seeds = np.zeros(B, np.int64)
        self._eos = np.full(B, -1, np.int64)
        self._temp = np.ones(B, np.float32)
        self._top_p = np.ones(B, np.float32)
        self._greedy = np.ones(B, bool)
        self.requests: List[Optional[object]] = [None] * B

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.requests) if r is None]

    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self.requests)

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

    @torch.inference_mode()
    def admit(self, request, slot: int) -> Tuple[int, bool]:
        """Prefill ``request`` into free ``slot``; returns the first token
        and whether the request finished at prefill (eos first)."""
        if self.requests[slot] is not None:
            raise RuntimeError(f"slot {slot} is occupied")
        prompt = np.asarray(request.prompt, np.int64).ravel()
        L = int(prompt.shape[0])
        self.validate(L, int(request.max_new_tokens))
        seed = fresh_seed() if request.seed is None else int(request.seed)
        eos = -1 if request.eos_token_id is None else int(request.eos_token_id)
        device = self.model.device
        bucket = self.bucket_for_prompt(L)
        ids_p = np.zeros((1, bucket), np.int64)
        ids_p[0, :L] = prompt
        was_training = self.model.training
        self.model.eval()  # serving runs the eval graph (dropout off)
        try:
            slot_cache = init_cache(self.model, 1, self.max_length)
            logits, slot_cache = self.model(
                torch.as_tensor(ids_p, device=device), cache=slot_cache,
                position_offset=0, gather_last=L - 1)
            gens = [None if request.greedy else
                    per_row_generators(seed, 1, None, device)[0]]
            tok = sample_logits_rows(
                logits[:, 0, :], gens, request.temperature, self.top_k,
                request.top_p, greedy_mask=[request.greedy])
            scatter_cache_rows(self.live_cache, slot_cache, slot)
        finally:
            if was_training:
                self.model.train()
        first = int(tok[0])  # the admission's one device read
        fin = first == eos
        self.requests[slot] = request
        self._positions[slot] = L
        self._tokens[slot] = first
        self._done[slot] = fin
        self._seeds[slot] = seed
        self._eos[slot] = eos
        self._temp[slot] = request.temperature
        self._top_p[slot] = request.top_p
        self._greedy[slot] = request.greedy
        return first, fin

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
        was_training = self.model.training
        self.model.eval()
        try:
            logits, self.live_cache = self.model(
                torch.as_tensor(self._tokens[:, None], device=device),
                cache=self.live_cache,
                position_offset=torch.as_tensor(self._positions,
                                                device=device))
            nxt = sample_logits_rows(logits[:, -1, :], gens, self._temp,
                                     self.top_k, self._top_p,
                                     greedy_mask=self._greedy)
        finally:
            if was_training:
                self.model.train()
        # the per-step [B] read-back IS the streaming output
        toks = nxt.cpu().numpy()
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
        admitted next."""
        self.requests[slot] = None
        self._done[slot] = True
        self._positions[slot] = 0
        self._tokens[slot] = 0

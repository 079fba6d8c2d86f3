"""Draft-model speculative decoding: up to ``K + 1`` tokens per target
forward (port of ``paddle_tpu/models/speculative.py``).

A small DRAFT model proposes ``K`` tokens autoregressively, the TARGET
model scores all ``K`` (plus the pending token) in ONE forward over a
``[B, K+1]`` window, and exact rejection sampling (Leviathan et al.,
arXiv:2211.17192) keeps the emitted stream distributed as solo target
decoding:

- accept draft token ``d_i`` with probability ``min(1, p(d_i)/q(d_i))``
  (``p`` the target's filtered sampling distribution, ``q`` the draft's);
- on the first rejection, resample from the residual ``max(p - q, 0)``,
  renormalized;
- when all ``K`` survive, draw a bonus token from the target's
  ``K+1``-th distribution.

Under greedy decoding the rule is ``d_i == argmax(p_i)``, and the output
is token-identical to solo greedy target decoding. Sampled streams
cannot equal the JAX package's (``torch.Generator`` is not
``jax.random``); the port keeps the reference's invariant on its own:
every random decision (draft proposal, accept, resample, bonus) draws
from its own named stream, seeded by (stream, absolute position, row),
so a fixed seed replays the same tokens and acceptance trace.

Rows accept different counts per round, so every row sits at its own
position: the draft chain's first window is the pair ``[prev, pending]``
at per-row ``pos - 1`` (so the draft cache never misses ``prev``'s K/V,
in particular ``d_K``'s after an all-accept round), later draft steps
feed one token each, and the verify window runs at per-row ``pos``.
Every one of these forwards passes its offset as a ``[B]`` tensor, so
it attends through ``cached_attention`` (the chunked continuation) and
never the flash kernels; only the two prefills (target and draft, at the
int offset 0) launch the flash forward on the card. PyTorch runs
eagerly, so a round is a sequence of forwards with one host read of the
round's tokens (two when sampling: the accept counts, then the
resampled tokens), not one compiled program.

:func:`build_draft_model` gives the training-free default draft: the
first ``n`` decoder blocks of the target with its embeddings and final
norm (and the tied head riding them), copied.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..io.batching import bucket_for
from .generation import (DEFAULT_PREFILL_BUCKETS, _gumbel_argmax, _row_seed,
                         _splitmix64, filter_logits, fresh_seed,
                         init_cache, normalize_kv_dtype, per_row_generators,
                         sample_logits)

__all__ = ["SpeculativeEngine", "build_draft_model"]

# named random streams: every random decision draws at (stream, position,
# row)
_STREAM_DRAFT = 101
_STREAM_ACCEPT = 102
_STREAM_RESAMPLE = 103
_STREAM_BONUS = 104


def _generator_at(seed: int, stream: int, position: int, row: int,
                  device) -> torch.Generator:
    """The generator of one random decision: fold the stream tag into
    the request seed, then the decision's absolute position and row (the
    speculative extension of ``per_row_generators``)."""
    base = _splitmix64((int(seed) ^ _splitmix64(int(stream) << 40))
                       & ((1 << 64) - 1))
    g = torch.Generator(device=device)
    g.manual_seed(_row_seed(base, row, position))
    return g


def build_draft_model(model, num_layers: int = 1):
    """Weight-copied truncated draft for a ``GPTForCausalLM``-family
    target: the same config with only the first ``num_layers`` decoder
    blocks; every parameter the truncated model keeps (blocks
    ``0..num_layers-1``, embeddings, final norm) is a copy of the
    target's, in the target's dtype, on the target's device."""
    cfg = dataclasses.replace(model.cfg, num_layers=int(num_layers))
    draft = type(model)(cfg, device=model.device)
    source = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in draft.named_parameters():
            p.data = source[name].detach().clone()
    draft.eval()
    return draft


class SpeculativeEngine:
    """Draft/verify decode loop over a (target, draft) model pair, with
    :class:`~paddle_tpu_torch.models.generation.GenerationEngine`'s
    construction contract (max_length validation, prefill buckets,
    ``kv_dtype``) plus ``k``, the draft proposals per verify forward.
    ``draft_kv_dtype`` defaults to ``kv_dtype``."""

    def __init__(self, model, draft_model, k: int = 4,
                 max_length: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 kv_dtype=None, draft_kv_dtype=None):
        if int(k) < 1:
            raise ValueError("speculative k must be >= 1")
        self.model = model
        self.draft_model = draft_model
        self.k = int(k)
        spec = model.cache_spec()
        dspec = draft_model.cache_spec()
        self.kv_dtype = normalize_kv_dtype(kv_dtype)
        self.draft_kv_dtype = normalize_kv_dtype(
            kv_dtype if draft_kv_dtype is None else draft_kv_dtype)
        self.max_length = int(max_length or spec["max_length"])
        if self.max_length > spec["max_length"]:
            raise ValueError(
                f"max_length {self.max_length} exceeds the target's "
                f"position table ({spec['max_length']} positions)")
        if self.max_length > dspec["max_length"]:
            raise ValueError(
                f"max_length {self.max_length} exceeds the DRAFT's "
                f"position table ({dspec['max_length']} positions)")
        buckets = tuple(sorted(int(b) for b in
                               (prefill_buckets or DEFAULT_PREFILL_BUCKETS)
                               if int(b) <= self.max_length))
        self.prefill_buckets = buckets or (self.max_length,)
        self._calls = {"target_prefill": 0, "draft_prefill": 0,
                       "decode_round": 0}

    def cache_stats(self) -> dict:
        """The reference's per-family counters: ``compiles`` is always 0
        (the port traces nothing), ``calls`` counts each family."""
        return {kind: {"compiles": 0, "calls": n}
                for kind, n in self._calls.items()}

    # ------------------------------------------------------------ a round
    def _draft_chain(self, dcache, prev, pend, pos, seed, greedy,
                     temperature, top_k, top_p):
        """Propose ``K`` draft tokens: the first window is ``[prev,
        pend]`` at per-row ``pos - 1``, each later step feeds the newest
        draft token at ``pos + j``; step ``j`` draws the token at
        position ``pos + j + 1`` from the draft stream. Returns ``(D [B,
        K] int64, Q [B, K, V] float32 or None under greedy, dcache)``."""
        device = self.draft_model.device
        pos_t = torch.as_tensor(pos, device=device)
        D: List[torch.Tensor] = []
        Q: List[torch.Tensor] = []
        cur = pend
        for j in range(self.k):
            if j == 0:
                toks, offset = torch.stack([prev, pend], dim=1), pos_t - 1
            else:
                toks, offset = cur[:, None], pos_t + j
            logits, dcache = self.draft_model(toks, cache=dcache,
                                              position_offset=offset)
            logits = logits[:, -1, :]
            if greedy:
                d = torch.argmax(logits, dim=-1)
            else:
                f = filter_logits(logits, temperature, top_k, top_p)
                Q.append(torch.softmax(f, dim=-1))
                d = torch.stack([
                    _gumbel_argmax(f[b], _generator_at(
                        seed, _STREAM_DRAFT, int(pos[b]) + j + 1, b, device))
                    for b in range(f.shape[0])])
            D.append(d)
            cur = d
        return torch.stack(D, dim=1), (torch.stack(Q, dim=1) if Q else None), dcache

    def _verify(self, cache, pend, pos, D, Q, seed, greedy, temperature,
                top_k, top_p):
        """Score the ``[B, K+1]`` window ``[pending, d_1..d_K]`` in one
        target forward at per-row ``pos`` and run the accept / resample /
        bonus rule. Returns ``(n_acc [B] host ints, next_tok [B] host
        ints, D [B, K] host ints, window [B, K+1] host ints, cache)``."""
        K = self.k
        device = self.model.device
        toks = torch.cat([pend[:, None], D], dim=1)
        logits, cache = self.model(toks, cache=cache,
                                   position_offset=torch.as_tensor(
                                       pos, device=device))
        B = D.shape[0]
        if greedy:
            tgt = torch.argmax(logits, dim=-1)                   # [B, K+1]
            host = torch.cat([toks, tgt], dim=1).cpu().numpy()
            window, tgt_h = host[:, :K + 1], host[:, K + 1:]
            accept = window[:, 1:] == tgt_h[:, :K]
            n_acc = np.cumprod(accept, axis=1).sum(axis=1)
            r = np.minimum(n_acc, K - 1)
            rows = np.arange(B)
            next_tok = np.where(n_acc == K, tgt_h[:, K], tgt_h[rows, r])
            return n_acc, next_tok, window, cache
        f = filter_logits(logits, temperature, top_k, top_p)     # [B, K+1, V]
        p = torch.softmax(f, dim=-1)
        p_d = torch.gather(p[:, :K], 2, D[..., None])[..., 0]    # [B, K]
        q_d = torch.gather(Q, 2, D[..., None])[..., 0]
        # u < p/q, one draw per (position, row) from the accept stream
        u = torch.stack([torch.stack([
            torch.rand((), generator=_generator_at(
                seed, _STREAM_ACCEPT, int(pos[b]) + 1 + i, b, device),
                device=device) for i in range(K)]) for b in range(B)])
        accept = u * q_d < p_d
        host = torch.cat([toks, accept.long()], dim=1).cpu().numpy()
        window, accept_h = host[:, :K + 1], host[:, K + 1:].astype(bool)
        n_acc = np.cumprod(accept_h, axis=1).sum(axis=1)
        next_tok = []
        for b in range(B):
            a = int(n_acc[b])
            if a == K:   # every draft survived: the bonus token
                tok = _gumbel_argmax(f[b, K], _generator_at(
                    seed, _STREAM_BONUS, int(pos[b]) + K + 1, b, device))
            else:        # the first rejection: the residual max(p - q, 0)
                res = torch.clamp(p[b, a] - Q[b, a], min=0.0)
                if bool((res.sum() > 0).item()):
                    l = torch.where(res > 0,
                                    torch.log(torch.clamp(res, min=1e-38)),
                                    torch.full_like(res, float("-inf")))
                else:
                    # no residual mass means p == q here: resampling from
                    # the filtered target logits is then exact
                    l = f[b, a]
                tok = _gumbel_argmax(l, _generator_at(
                    seed, _STREAM_RESAMPLE, int(pos[b]) + 1 + a, b, device))
            next_tok.append(tok)
        next_tok = torch.stack(next_tok).cpu().numpy()
        return n_acc, next_tok, window, cache

    # ------------------------------------------------------------ decoding
    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 seed: Optional[int] = None,
                 return_stats: bool = False):
        """Speculatively extend ``input_ids`` [B, prompt_len]; the return
        contract of ``GenerationEngine.generate`` (an int32 ``[B, n]``
        array). With ``return_stats`` the stats also carry
        ``acceptance_rate``, ``tokens_per_target_dispatch``, ``rounds``,
        ``dispatches`` and the per-round ``acceptance_trace`` (a
        ``[rounds, B]`` emit-count array, the fixed-seed replay
        artifact)."""
        K = self.k
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        B, prompt_len = ids.shape
        if prompt_len < 1:
            raise ValueError("generate needs a non-empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt_len + max_new_tokens + K > self.max_length:
            raise ValueError(
                f"prompt_len {prompt_len} + max_new_tokens "
                f"{max_new_tokens} + k {K} exceeds max_length "
                f"{self.max_length}: the last verify window must fit in "
                f"the cache; build the engine with a larger max_length "
                f"or smaller k")
        bucket = min(bucket_for(prompt_len, self.prefill_buckets),
                     self.max_length)
        ids_p = np.zeros((B, bucket), np.int64)
        ids_p[:, :prompt_len] = ids
        greedy = not do_sample
        if do_sample and seed is None:
            seed = fresh_seed()
        seed = 0 if seed is None else int(seed)
        eos_id = -1 if eos_token_id is None else int(eos_token_id)
        device = self.model.device

        was_training = (self.model.training, self.draft_model.training)
        self.model.eval()
        self.draft_model.eval()
        try:
            cache = init_cache(self.model, B, self.max_length,
                               kv_dtype=self.kv_dtype)
            dcache = init_cache(self.draft_model, B, self.max_length,
                                kv_dtype=self.draft_kv_dtype)
            emitted = [[] for _ in range(B)]
            trace = []
            proposed = accepted = 0
            rounds = 0
            t0 = time.perf_counter()
            ids_t = torch.as_tensor(ids_p, device=device)
            # the target prefill draws its first token as a solo
            # generate() does, so it equals a solo run with the same seed
            self._calls["target_prefill"] += 1
            logits, cache = self.model(ids_t, cache=cache, position_offset=0,
                                       gather_last=prompt_len - 1)
            gens = (None if greedy else
                    per_row_generators(seed, B, None, device))
            tok = sample_logits(logits[:, 0, :], gens, temperature, top_k,
                                top_p, greedy=greedy)
            self._calls["draft_prefill"] += 1
            _, dcache = self.draft_model(ids_t, cache=dcache,
                                         position_offset=0,
                                         gather_last=prompt_len - 1)
            first = tok.cpu().numpy()  # the first token is READY
            ttft = time.perf_counter() - t0
            done = (first == eos_id) | (max_new_tokens == 1)
            for i in range(B):
                emitted[i].append(int(first[i]))
            # round state: the previous and pending tokens and each row's
            # position (prev: the last prompt token at prompt_len - 1,
            # pending: at prompt_len)
            prev = torch.as_tensor(ids[:, -1].astype(np.int64), device=device)
            pend = tok
            pos = np.full(B, prompt_len, np.int64)
            while not done.all():
                self._calls["decode_round"] += 1
                D, Q, dcache = self._draft_chain(
                    dcache, prev, pend, pos, seed, greedy, temperature,
                    top_k, top_p)
                n_acc, next_tok, window, cache = self._verify(
                    cache, pend, pos, D, Q, seed, greedy, temperature,
                    top_k, top_p)
                rounds += 1
                # the emitted tokens: d_1..d_n_acc then the next token
                out = np.concatenate([window[:, 1:], np.zeros((B, 1),
                                                              np.int64)], 1)
                out[np.arange(B), n_acc] = next_tok
                n_emit = n_acc + 1
                cols = np.arange(K + 1)
                # eos inside the emitted prefix ends the row there
                is_eos = (out == eos_id) & (cols[None, :] < n_emit[:, None])
                any_eos = is_eos.any(axis=1)
                n_emit = np.where(any_eos, is_eos.argmax(axis=1) + 1, n_emit)
                n_emit = np.where(done, 0, n_emit)
                trace.append(n_emit.copy())
                for i in range(B):
                    if done[i]:
                        continue
                    room = max_new_tokens - len(emitted[i])
                    take = min(int(n_emit[i]), room)
                    emitted[i].extend(int(t) for t in out[i, :take])
                    proposed += K
                    accepted += min(int(n_emit[i]) - 1, take)
                new_done = done | any_eos
                # done rows freeze: their window rewrites the same cache
                # positions each round, never visible past their frontier
                new_prev = window[np.arange(B), n_acc]
                pos = np.where(new_done, pos, pos + n_acc + 1)
                prev = torch.as_tensor(new_prev, device=device)
                pend = torch.as_tensor(next_tok.astype(np.int64),
                                       device=device)
                done = new_done | np.array([len(e) >= max_new_tokens
                                            for e in emitted])
            total = time.perf_counter() - t0
        finally:
            if was_training[0]:
                self.model.train()
            if was_training[1]:
                self.draft_model.train()
        fill = max(eos_id, 0)
        n = max(len(e) for e in emitted)
        out_arr = np.full((B, n), fill, np.int32)
        for i, e in enumerate(emitted):
            out_arr[i, :len(e)] = e
        if not return_stats:
            return out_arr
        new_tokens = sum(len(e) for e in emitted)
        return out_arr, {
            "ttft_s": ttft,
            "total_s": total,
            "new_tokens": n,
            "tokens_per_sec": new_tokens / max(total, 1e-9),
            "decode_tokens_per_sec": ((new_tokens - B) /
                                      max(total - ttft, 1e-9)
                                      if n > 1 else 0.0),
            "prefill_bucket": bucket,
            "rounds": rounds,
            "dispatches": 2 + rounds,
            "k": K,
            "acceptance_rate": accepted / max(proposed, 1),
            "tokens_per_target_dispatch": new_tokens / max(rounds + 1, 1),
            "acceptance_trace": (np.stack(trace, axis=0) if trace
                                 else np.zeros((0, B), np.int64)),
            "compile_stats": self.cache_stats(),
        }

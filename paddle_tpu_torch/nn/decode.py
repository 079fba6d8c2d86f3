"""Beam search over a cell: ``BeamSearchDecoder`` and ``dynamic_decode``
(port of ``paddle_tpu/nn/decode.py``).

Each step is dense ``[B, beam, vocab]`` arithmetic: the beams' running
log-probabilities plus the step's log-softmax, the best ``beam`` of the
``beam * vocab`` candidates, the cell's states reordered to follow their
parents. The driver is a Python loop of at most ``max_step_num`` steps
that stops early once every beam has finished, and ``gather_tree``
backtraces the surviving beams at the end, as in the reference.

Ties in the top-k break toward the lower flat index of ``beam * vocab``,
as ``jax.lax.top_k`` breaks them; ``torch.topk`` promises no order for
equal values, so the selection ranks a key that holds the value and the
index together (:func:`_top_k_lower_index_first`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import functional as F

__all__ = ["BeamSearchDecoder", "dynamic_decode"]

# the log-probability that keeps a beam out of the running (the start
# beams but the first; every token but the end for a finished beam)
_NEG = -1e9


def _tree_map(fn, tree):
    """``fn`` over the tensors of ``tree`` (nested tuples, lists and
    dicts; anything else is kept)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _first_leaf(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for t in items:
        leaf = _first_leaf(t)
        if leaf is not None:
            return leaf
    return None


def _top_k_lower_index_first(values, k: int):
    """``(top values, their indices)`` of the last axis of float32
    ``values``, largest first, ties to the lower index. The float's bits,
    mapped to an int32 that orders as the float does, fill the high half
    of an int64 key and the complement of the index its low half, so no
    two keys are equal and ``topk`` over them is exact."""
    bits = values.contiguous().view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).long()
    index = torch.arange(values.shape[-1], device=values.device)
    key = ordered * (1 << 32) + ((1 << 32) - 1 - index)
    idx = key.topk(k, dim=-1).indices
    return values.gather(-1, idx), idx


class BeamSearchDecoder:
    """Beam search over a cell: ``cell(inputs [B * beam, emb], states)``
    returns ``(output, new_states)``; ``embedding_fn`` maps token ids to
    the cell's inputs and ``output_fn`` the cell's output to vocabulary
    logits (both the identity when not given)."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn: Optional[Callable] = None,
                 output_fn: Optional[Callable] = None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn or (lambda ids: ids)
        self.output_fn = output_fn or (lambda x: x)

    def _device(self, states):
        leaf = _first_leaf(states)
        if leaf is not None:
            return leaf.device
        if isinstance(self.cell, torch.nn.Module):
            return next(self.cell.parameters()).device
        from .. import default_device

        return default_device(None)

    def initialize(self, initial_states, batch_size: int):
        """The start tokens, the beams' log-probabilities (0 for beam 0,
        -1e9 for the others, so the first top-k does not keep ``beam``
        copies of one hypothesis), no beam finished, and every state
        repeated ``beam`` times along its batch axis."""
        K = self.beam_size
        dev = self._device(initial_states)
        tok = torch.full((batch_size, K), self.start_token,
                         dtype=torch.int64, device=dev)
        log_probs = torch.full((batch_size, K), _NEG, dtype=torch.float32,
                               device=dev)
        log_probs[:, 0] = 0.0
        finished = torch.zeros((batch_size, K), dtype=torch.bool, device=dev)
        states = _tree_map(lambda s: s.repeat_interleave(K, dim=0),
                           initial_states)
        return tok, log_probs, finished, states

    def step(self, tok, log_probs, finished, states):
        """One step: ``(tokens, log_probs, finished, states, parents)``,
        each ``[B, beam]`` but the states. A finished beam extends only
        with ``end_token``, at no cost."""
        B, K = tok.shape
        out, new_states = self.cell(self.embedding_fn(tok.reshape(B * K)),
                                    states)
        logits = self.output_fn(out)
        V = logits.shape[-1]
        step_lp = torch.log_softmax(logits.float(), -1).reshape(B, K, V)
        fin = torch.full((V,), _NEG, dtype=torch.float32, device=tok.device)
        fin[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], fin, step_lp)
        total = (log_probs[..., None] + step_lp).reshape(B, K * V)
        top_lp, top_idx = _top_k_lower_index_first(total, K)
        parent = top_idx // V
        token = top_idx % V
        rows = torch.arange(B, device=tok.device)[:, None]
        new_finished = finished[rows, parent] | (token == self.end_token)
        flat_parent = (rows * K + parent).reshape(-1)
        new_states = _tree_map(lambda s: s[flat_parent], new_states)
        return token, top_lp, new_finished, new_states, parent


def dynamic_decode(decoder: BeamSearchDecoder, inits=None,
                   max_step_num: int = 100, batch_size: Optional[int] = None,
                   **kwargs):
    """Run ``decoder`` until every beam has finished or ``max_step_num``
    steps. Returns ``(sequences [B, beam, T], final log-probabilities [B,
    beam])``, each sequence backtraced through its parents."""
    if batch_size is None:
        batch_size = _first_leaf(inits).shape[0]
    tok, log_probs, finished, states = decoder.initialize(inits, batch_size)
    tokens, parents = [], []
    for _ in range(max_step_num):
        tok, log_probs, finished, states, parent = decoder.step(
            tok, log_probs, finished, states)
        tokens.append(tok)
        parents.append(parent)
        if bool(finished.all()):
            break
    seqs = F.gather_tree(torch.stack(tokens), torch.stack(parents))
    return seqs.permute(1, 2, 0), log_probs

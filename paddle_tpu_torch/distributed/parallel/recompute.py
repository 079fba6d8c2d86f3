"""Activation recompute (port of
``paddle_tpu/distributed/parallel/recompute.py``).

The reference wraps a function in ``jax.checkpoint``; randomness replays
there because keys are inputs. The port uses
``torch.utils.checkpoint(use_reentrant=False)``, which keeps no activation
of the wrapped function and runs it again in the backward pass. Its own
RNG handling restores torch's global CPU/CUDA state only, so the wrapper
replays the port's counter-based streams itself: it snapshots the open
:class:`~paddle_tpu_torch.nn.layer.RNGContext` (or, outside one, a context
seeded once from the global generator), runs the forward on a copy of the
snapshot, advances the live context as an unwrapped call would, and runs
the recompute on a fresh copy of the same snapshot, so every dropout seed
it draws equals the forward's.

The reference's named ``jax.checkpoint_policies`` map onto torch's
selective checkpointing (a policy per aten op, ``create_selective_
checkpoint_contexts``):

- ``None`` / ``"full"`` / ``"save_nothing"`` (``nothing_saveable``): keep
  nothing, recompute everything;
- ``"save_dots"`` (``checkpoint_dots``): keep the outputs of the matrix
  products (``mm``, ``addmm``, ``bmm``, ``baddbmm``: every ``matmul`` and
  ``einsum`` lowers to them), recompute the rest;
- ``"save_dots_no_batch"`` (``checkpoint_dots_with_no_batch_dims``): keep
  only the products without batch dimensions (``mm``, ``addmm``: the
  linear layers, whose ``[B, L, in] @ [in, out]`` folds into one 2-D
  product), recompute the attention products (``bmm``) too;
- ``"save_anything"`` (``everything_saveable``): keep everything, which
  is the function run as it is.

A flash-attention call is one autograd function, not an aten product, so
every policy but ``save_anything`` runs its forward kernel again in the
backward pass, as ``jax.checkpoint``'s dot policies rerun a Pallas call.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...framework import random as framework_random
from ...nn.layer import RNGContext, current_rng_context, rng_context

__all__ = ["POLICIES", "recompute", "recompute_wrap", "recompute_sequential",
           "RecomputeLayer"]

POLICIES = (None, "full", "save_dots", "save_dots_no_batch", "save_nothing",
            "save_anything")

# streams a context opened by the wrapper itself provides
_STREAMS = ("dropout", "default")


def _saved_ops(policy: Optional[str]):
    """The aten products whose outputs ``policy`` keeps (None: keep no
    op's output, through plain checkpointing)."""
    aten = torch.ops.aten
    if policy == "save_dots":
        return (aten.mm.default, aten.addmm.default, aten.bmm.default,
                aten.baddbmm.default)
    if policy == "save_dots_no_batch":
        return (aten.mm.default, aten.addmm.default)
    return None


def _context_fn(saved):
    """``checkpoint``'s ``context_fn`` keeping the outputs of ``saved``."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy_fn(ctx, op, *args, **kwargs):
        del ctx, args, kwargs
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _check_policy(policy: Optional[str]) -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown recompute policy {policy!r}; one of "
                         f"{POLICIES}")


def recompute_wrap(function: Callable,
                   policy: Optional[str] = None) -> Callable:
    """``function`` with its activations recomputed in the backward pass
    as ``policy`` says, and its random draws replayed there. Under
    ``torch.no_grad`` (no backward to come), and with ``"save_anything"``,
    it simply runs ``function``."""
    _check_policy(policy)
    if policy == "save_anything":
        return function
    saved = _saved_ops(policy)
    extra = {} if saved is None else {"context_fn": _context_fn(saved)}

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return function(*args, **kwargs)
        live = current_rng_context()
        if live is None:
            live = RNGContext(framework_random.split_streams(
                framework_random.next_seed(), _STREAMS))
        snapshot = live.fork()
        forward_done = False

        def run(*a, **kw):
            nonlocal forward_done
            replay = snapshot.fork()
            with rng_context(replay):
                out = function(*a, **kw)
            if not forward_done:
                forward_done = True
                live.advance_to(replay)
            return out

        return checkpoint(run, *args, use_reentrant=False, **extra, **kwargs)

    return wrapped


def recompute(function: Callable, *args, policy: Optional[str] = None,
              preserve_rng_state: bool = True, use_reentrant: bool = True,
              **kwargs):
    """``paddle.distributed.fleet.utils.recompute``: call ``function`` on
    ``args`` under :func:`recompute_wrap`. ``preserve_rng_state`` and
    ``use_reentrant`` are accepted for the signature: the port's streams
    always replay, and the checkpoint is never reentrant."""
    del preserve_rng_state, use_reentrant
    return recompute_wrap(function, policy)(*args, **kwargs)


def recompute_sequential(ctx: dict, functions, *args):
    """Segmented sequential recompute (reference ``recompute_sequential``,
    ``recompute.py:44``): ``functions`` (a ``Sequential`` or a list of
    callables) split into ``ctx["segments"]`` chunks of
    ``len // segments`` (the last ones shorter), each recomputed as a
    whole; a tuple output feeds the next callable as its arguments."""
    segments = int(ctx.get("segments", 1))
    layers = list(functions)
    seg_size = max(len(layers) // max(segments, 1), 1)
    out = args
    for start in range(0, len(layers), seg_size):
        chunk = tuple(layers[start:start + seg_size])

        def run_chunk(*xs, _chunk=chunk):
            y = xs
            for f in _chunk:
                y = f(*y) if isinstance(y, tuple) else f(y)
                if not isinstance(y, tuple):
                    y = (y,)
            return y[0] if len(y) == 1 else y

        out = recompute(run_chunk, *(out if isinstance(out, tuple)
                                     else (out,)))
        if not isinstance(out, tuple):
            out = (out,)
    return out[0] if isinstance(out, tuple) and len(out) == 1 else out


class RecomputeLayer(nn.Module):
    """``inner`` with its forward recomputed in the backward pass under
    ``policy``; its parameters keep their paths under ``inner.``."""

    def __init__(self, inner: nn.Module, policy: Optional[str] = None):
        super().__init__()
        _check_policy(policy)
        self.inner = inner
        self._policy = policy

    def forward(self, *args, **kwargs):
        return recompute_wrap(self.inner, self._policy)(*args, **kwargs)

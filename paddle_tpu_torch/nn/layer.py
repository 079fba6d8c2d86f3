"""Named random streams for stochastic layers (port of the RNG half of
``paddle_tpu/nn/layer.py:27-77``).

A :class:`RNGContext` holds one base seed per stream name ("dropout",
...). Each :meth:`RNGContext.next` folds the stream's call counter into
its base, so a forward is deterministic given the base seeds: the
training step opens one context per step from (base seed, step count).
The draws are counter-based on purpose. ``torch.utils.checkpoint``
restores only torch's global CPU/CUDA RNG state, never an explicit
generator; the recompute wrapper instead replays a copy of the context
(:meth:`RNGContext.fork`) with the counters as they were, so a dropout
inside a recomputed block draws the same seed twice
(:mod:`paddle_tpu_torch.distributed.parallel.recompute`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Union

from ..framework import random as framework_random

__all__ = ["RNGContext", "rng_context", "current_rng_context",
           "take_rng_key"]


class RNGContext:
    """Named deterministic seed streams: ``next(name)`` is
    ``fold_in(base[name], counter[name]++)`` (the analogue of the
    reference's ``RNGStatesTracker``). Streams without a base of their own
    draw from the "default" base."""

    def __init__(self, seeds: Mapping[str, int],
                 counters: Optional[Dict[str, int]] = None):
        self._base = {k: int(v) for k, v in seeds.items()}
        self._counters: Dict[str, int] = dict(counters or {})

    def next(self, name: str = "dropout") -> Optional[int]:
        base = self._base.get(name, self._base.get("default"))
        if base is None:
            return None
        c = self._counters.get(name, 0)
        self._counters[name] = c + 1
        return framework_random.fold_in(base, c)

    def fork(self) -> "RNGContext":
        """A copy with the same bases and counters: it draws what this
        context would draw next, without advancing it."""
        return RNGContext(self._base, self._counters)

    def advance_to(self, other: "RNGContext") -> None:
        """Take ``other``'s counters (a fork that ran on ahead)."""
        self._counters = dict(other._counters)


_local = threading.local()


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


@contextlib.contextmanager
def rng_context(rngs: Union[Mapping[str, int], RNGContext]):
    """Make ``rngs`` (seeds by stream name, or a context) the streams that
    :func:`take_rng_key` draws from inside the block (per thread)."""
    ctx = rngs if isinstance(rngs, RNGContext) else RNGContext(rngs)
    stack = _stack()
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


def current_rng_context() -> Optional[RNGContext]:
    stack = _stack()
    return stack[-1] if stack else None


def take_rng_key(name: str = "dropout") -> int:
    """A seed for a stochastic layer: the innermost context's stream when
    one is open, the global generator otherwise (eager use)."""
    ctx = current_rng_context()
    if ctx is not None:
        key = ctx.next(name)
        if key is not None:
            return key
        raise RuntimeError(
            f"layer requested rng stream {name!r} inside an rng context "
            f"that has neither that stream nor a 'default' one")
    return framework_random.next_seed()

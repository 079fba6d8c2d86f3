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

Only the full policy (``None`` / ``"full"``: keep nothing, recompute
everything) is ported. The reference's named ``jax.checkpoint_policies``
("save_dots", ...) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ...framework import random as framework_random
from ...nn.layer import RNGContext, current_rng_context, rng_context

__all__ = ["POLICIES", "recompute_wrap"]

POLICIES = (None, "full")

# streams a context opened by the wrapper itself provides
_STREAMS = ("dropout", "default")


def _check_policy(policy: Optional[str]) -> None:
    if policy not in POLICIES:
        raise NotImplementedError(
            f"recompute policy {policy!r} is not ported; only None / 'full' "
            f"(recompute everything) are")


def recompute_wrap(function: Callable,
                   policy: Optional[str] = None) -> Callable:
    """``function`` with its activations recomputed in the backward pass
    and its random draws replayed there. Under ``torch.no_grad`` (no
    backward to come) it simply runs ``function``."""
    _check_policy(policy)

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

        return checkpoint(run, *args, use_reentrant=False, **kwargs)

    return wrapped


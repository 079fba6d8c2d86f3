"""Global seed and counter-based random streams (port of
``paddle_tpu/framework/random.py``).

The JAX package splits and folds PRNG keys; the port keeps the same
structure with plain 63-bit integer seeds. A seed is derived from another
by :func:`fold_in` (splitmix64 of the pair, the counterpart of
``jax.random.fold_in``), so every draw is a pure function of a base seed
and a counter: replaying the counter replays the draw, which is what
recompute and a resumed :class:`~paddle_tpu_torch.framework.jit.TrainStep`
rely on. The seeds never carry torch's global RNG state.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable

__all__ = ["fold_in", "split_streams", "Generator", "seed", "next_seed"]

_M64 = 2 ** 64 - 1


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and the integer ``data``."""
    return _splitmix64(_splitmix64(int(seed) & _M64) ^ (int(data) & _M64)) >> 1


def split_streams(seed: int, names: Iterable[str]) -> Dict[str, int]:
    """One independent seed per named stream (the counterpart of
    ``split_rng_streams``, ``paddle_tpu/framework/jit.py:66``)."""
    return {name: fold_in(seed, i) for i, name in enumerate(names)}


class Generator:
    """A stateful seed source: ``next_seed()`` is ``fold_in(seed, n)``
    for n = 0, 1, 2, ... (``paddle.seed`` semantics)."""

    def __init__(self, seed_value: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed_value)

    def manual_seed(self, seed_value: int) -> "Generator":
        with self._lock:
            self._seed, self._count = int(seed_value), 0
        return self

    def next_seed(self) -> int:
        with self._lock:
            n, self._count = self._count, self._count + 1
        return fold_in(self._seed, n)


_default_generator = Generator(0)


def seed(value: int) -> Generator:
    """Set the global seed (``paddle.seed`` analogue)."""
    return _default_generator.manual_seed(value)


def next_seed() -> int:
    """A fresh seed from the global generator (eager-mode randomness)."""
    return _default_generator.next_seed()


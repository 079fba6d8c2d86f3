"""Length bucketing (port of ``paddle_tpu/io/batching.py:30``).

Prompts are padded up to a fixed set of lengths so the serving path runs a
bounded set of prefill shapes.
"""
from __future__ import annotations

from typing import Sequence

__all__ = ["bucket_for"]


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Deterministic bucket assignment: the smallest bucket >= ``length``.

    Beyond the largest bucket, lengths round up to the next multiple of it
    (a bounded overflow ladder rather than an error or an unbounded shape
    set). Buckets are sorted internally, so declaration order is free.
    """
    if not buckets:
        return length
    srt = sorted(int(b) for b in buckets)
    if srt[0] <= 0:
        raise ValueError(f"length_buckets must be positive, got {buckets}")
    for b in srt:
        if length <= b:
            return b
    top = srt[-1]
    return ((length + top - 1) // top) * top

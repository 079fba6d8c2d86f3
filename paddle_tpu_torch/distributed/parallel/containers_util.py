"""Helpers for pipeline model surgery (port of
``paddle_tpu/distributed/parallel/containers_util.py``; host-only)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

__all__ = ["split_uniform_blocks"]


def split_uniform_blocks(layers: Sequence) -> Tuple[List[int], List[int], List[int]]:
    """Find the longest run of same-class layers (the pipelined blocks);
    everything before runs pre-pipeline, everything after runs post."""
    if not layers:
        return [], [], []
    best_start, best_len = 0, 1
    i = 0
    n = len(layers)
    while i < n:
        j = i
        while j + 1 < n and type(layers[j + 1]) is type(layers[i]):
            j += 1
        if j - i + 1 > best_len:
            best_start, best_len = i, j - i + 1
        i = j + 1
    if best_len < 2:
        return list(range(n)), [], []
    head = list(range(best_start))
    blocks = list(range(best_start, best_start + best_len))
    tail = list(range(best_start + best_len, n))
    return head, blocks, tail

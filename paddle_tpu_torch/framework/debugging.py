"""NaN/Inf detection for ``FLAGS_check_nan_inf`` (port of
``tree_all_finite`` in ``paddle_tpu/framework/debugging.py``).

Finiteness is reduced on the device to one bool tensor per checked tree
and read at the step boundary, never per tensor on the host.
"""
from __future__ import annotations

from typing import Any, List

import torch

__all__ = ["tree_all_finite"]


def _leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts, lists and tuples (None dropped)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def tree_all_finite(tree: Any) -> torch.Tensor:
    """A 0-d bool tensor, True iff every floating tensor of ``tree`` is
    finite (True for a tree without one), on the first tensor's device."""
    leaves = [x for x in _leaves(tree)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    oks = [torch.isfinite(x).all() for x in leaves]
    return torch.stack(oks).all()

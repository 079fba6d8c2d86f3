"""NaN/Inf detection for ``FLAGS_check_nan_inf`` (port of
``paddle_tpu/framework/debugging.py``).

Finiteness is reduced on the device to one bool tensor per checked tree
and read at the step boundary, never per tensor on the host.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from .tree import tree_leaves

__all__ = ["tree_all_finite", "find_nonfinite", "check_numerics"]


def tree_all_finite(tree: Any) -> torch.Tensor:
    """A 0-d bool tensor, True iff every floating tensor of ``tree`` is
    finite (True for a tree without one), on the first tensor's device."""
    leaves = [x for x in tree_leaves(tree)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    oks = [torch.isfinite(x).all() for x in leaves]
    return torch.stack(oks).all()


def _leaves_with_paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{path}[{i}]")
    else:
        yield path, tree


def find_nonfinite(tree: Any) -> List[Tuple[str, int, int]]:
    """Host-side: ``(path, n_nan, n_inf)`` of each floating leaf that is
    not finite (the companion of :func:`tree_all_finite`)."""
    bad = []
    for path, leaf in _leaves_with_paths(tree):
        t = getattr(leaf, "_data", leaf)
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t)
        if not t.is_floating_point():
            continue
        n_nan = int(torch.isnan(t).sum())
        n_inf = int(torch.isinf(t).sum())
        if n_nan or n_inf:
            bad.append((path, n_nan, n_inf))
    return bad


def check_numerics(tree: Any, name: str = "tensor") -> None:
    """Raise ``FloatingPointError`` naming the leaves that are not
    finite."""
    bad = find_nonfinite(tree)
    if bad:
        detail = ", ".join(f"{p} (nan={n}, inf={i})" for p, n, i in bad)
        raise FloatingPointError(f"NaN/Inf detected in {name}: {detail}")

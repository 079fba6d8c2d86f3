"""The one walk over nested containers that the port's batches, outputs,
caches and saved objects share: tuples, lists and dicts are the structure,
everything else is a leaf."""
from __future__ import annotations

from typing import Any, Callable, Optional

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` (and the corresponding leaves of
    each of ``rest``, shaped alike), in a tree of the same structure: each
    tuple, list and dict keeps its type. ``is_leaf(node)`` True makes a
    container a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest),
                                       is_leaf=is_leaf))
                          for k, v in tree.items())
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree``, in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out

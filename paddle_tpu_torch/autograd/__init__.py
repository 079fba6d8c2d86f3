"""``paddle.autograd`` (port of ``paddle_tpu/autograd/__init__.py``):
``PyLayer``, ``PyLayerContext``, ``saved_tensors_hooks``, ``no_grad``,
``grad`` and ``backward`` over the eager tape, which is torch's autograd
graph."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..eager import (PyLayer, PyLayerContext, Tensor, grad,  # noqa: F401
                     no_grad, run_backward, saved_tensors_hooks)

__all__ = ["PyLayer", "PyLayerContext", "saved_tensors_hooks", "backward",
           "no_grad", "grad"]


def backward(tensors: Sequence, grad_tensors: Optional[Sequence] = None,
             retain_graph: bool = False) -> None:
    """One joint backward from several roots: a tensor reached from
    several of them sees its whole gradient at once (its hooks fire
    once)."""
    tensors = list(tensors)
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    grad_tensors = list(grad_tensors)
    if len(grad_tensors) != len(tensors):
        raise ValueError("grad_tensors must match tensors in length")
    roots = []
    for t, g in zip(tensors, grad_tensors):
        if not isinstance(t, Tensor):
            raise TypeError("backward() roots must be eager Tensors")
        if not t._data.requires_grad:
            raise RuntimeError("backward() on a tensor with no grad history")
        roots.append((t, torch.ones_like(t._data) if g is None else g))
    run_backward(roots, retain_graph=retain_graph)

"""User-defined autograd ops for the eager tape: ``PyLayer`` (port of
``paddle_tpu/eager/py_layer.py``).

``PyLayer.apply`` runs as one ``torch.autograd.Function``: the user's
``forward(ctx, ...)`` runs without recording (its ops are replaced by the
user's backward), and the user's ``backward(ctx, *grads)`` is the
function's backward, called once with the gradients of all outputs.
``ctx.save_for_backward`` saves through torch, so that
:class:`saved_tensors_hooks` (torch's) pack and unpack what it saves.
"""
from __future__ import annotations

from typing import Any, List

import torch

from . import Tensor, _unwrap, _wrap_tree

__all__ = ["PyLayer", "PyLayerContext", "saved_tensors_hooks"]


class saved_tensors_hooks(torch.autograd.graph.saved_tensors_hooks):
    """``pack_hook(tensor) -> anything`` where a tensor is saved for the
    backward, ``unpack_hook(packed) -> tensor`` where the backward reads
    it back (``paddle.autograd.saved_tensors_hooks``), for every tensor
    saved while the context is open: a PyLayer's and torch's own. The
    hooks see eager Tensors."""

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook
        super().__init__(lambda t: pack_hook(Tensor(t)),
                         lambda p: _unwrap(unpack_hook(p)))


class PyLayerContext:
    """The forward-to-backward bridge: saved tensors, marks, and any
    attribute the user sets."""

    def __init__(self):
        self._saved: List[Any] = []
        self._fctx = None
        self._non_differentiable: List[int] = []
        self._materialize_grads = True

    def save_for_backward(self, *tensors) -> None:
        self._saved.extend(tensors)

    def saved_tensor(self):
        """The saved tensors, as a list (unpack hooks run here)."""
        saved = iter(self._fctx.saved_tensors)
        return [Tensor(next(saved)) if isinstance(s, (Tensor, torch.Tensor))
                else s for s in self._saved]

    def mark_non_differentiable(self, *tensors) -> None:
        """Outputs whose gradient ``backward`` receives as None."""
        self._non_differentiable.extend(id(_unwrap(t)) for t in tensors)

    def set_materialize_grads(self, value: bool) -> None:
        """False: an output that got no gradient passes None to
        ``backward`` instead of zeros."""
        self._materialize_grads = bool(value)


class _Function(torch.autograd.Function):
    @staticmethod
    def forward(fctx, spec, *datas):
        cls, ctx, args, kwargs, positions = spec
        args = list(args)
        for i, d in zip(positions, datas):
            args[i] = Tensor(d)
        out = cls.forward(ctx, *args, **kwargs)
        multi = isinstance(out, (tuple, list))
        outs = [_unwrap(o) for o in (out if multi else [out])]
        spec.append(multi)
        spec.append([id(o) in ctx._non_differentiable for o in outs])
        saved = [_unwrap(s) for s in ctx._saved
                 if isinstance(s, (Tensor, torch.Tensor))]
        fctx.save_for_backward(*saved)
        ctx._fctx = fctx
        fctx.spec = spec
        fctx.set_materialize_grads(ctx._materialize_grads)
        nondiff = [o for o, nd in zip(outs, spec[-1]) if nd]
        if nondiff:
            fctx.mark_non_differentiable(*nondiff)
        return tuple(outs) if multi else outs[0]

    @staticmethod
    def backward(fctx, *grads):
        cls, ctx, args, _, positions, _, nondiff = fctx.spec
        grads_in = [None if (g is None or nd) else Tensor(g)
                    for g, nd in zip(grads, nondiff)]
        with torch.no_grad():
            res = cls.backward(ctx, *grads_in)
        res = res if isinstance(res, (tuple, list)) else (res,)
        if len(res) != len(positions):
            raise RuntimeError(
                f"PyLayer backward returned {len(res)} gradients but "
                f"forward has {len(positions)} Tensor inputs")
        return (None,) + tuple(None if r is None else _unwrap(r)
                               for r in res)


class PyLayer:
    """Custom autograd op: subclass, define ``forward(ctx, *args)`` and
    ``backward(ctx, *grads)`` staticmethods, call ``YourOp.apply(...)``.

    ``backward`` returns one gradient per eager-Tensor positional input of
    ``forward``, in order (None for an input that needs none)."""

    @staticmethod
    def forward(ctx: PyLayerContext, *args, **kwargs):
        raise NotImplementedError(
            "PyLayer subclasses must implement forward(ctx, ...)")

    @staticmethod
    def backward(ctx: PyLayerContext, *grads):
        raise NotImplementedError(
            "PyLayer subclasses must implement backward(ctx, ...)")

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        positions = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
        spec = [cls, ctx, args, kwargs, positions]
        out = _Function.apply(spec, *[args[i]._data for i in positions])
        return _wrap_tree(out)

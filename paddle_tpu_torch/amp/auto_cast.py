"""Autocast (O1) and ``decorate`` (O2) (port of
``paddle_tpu/amp/auto_cast.py``).

O1: matmul-class ops run in low precision (the white list), numerically
sensitive ops in float32 (the black list). As in the reference this is
done by casting the *inputs* at the compute layers, which consult a
thread-local autocast state through :func:`autocast_call` (``F.linear``
does); it is not ``torch.autocast``.

O2 ("pure" low precision, :func:`decorate`) casts every floating parameter
of the models to ``dtype`` and turns on the optimizers'
``multi_precision``, so they keep float32 master weights. Parameters change
type in place (``param.data``), so a module keeps its ``nn.Parameter``
objects. Like the reference, ``decorate`` never reads ``level`` (an "O1"
call casts as O2 does) and ignores ``save_dtype``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

__all__ = ["WHITE_OPS", "BLACK_OPS", "is_autocast_enabled",
           "get_autocast_dtype", "auto_cast", "amp_guard", "autocast_call",
           "decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

# ops that benefit from low precision (tensor-core bound): the O1 white list
WHITE_OPS = {"matmul", "linear", "conv", "einsum", "attention"}
# numerically sensitive, always float32: the O1 black list
BLACK_OPS = {"softmax", "log_softmax", "layer_norm", "batch_norm", "reduce",
             "cross_entropy", "exp", "log", "norm"}


def _dtype(d) -> torch.dtype:
    return _DTYPES[d] if isinstance(d, str) else d


class _AutocastState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"


_state = _AutocastState()


def is_autocast_enabled() -> bool:
    return _state.enabled


def get_autocast_dtype() -> torch.dtype:
    return _state.dtype


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16"):
    """Within the block, :func:`autocast_call` casts the inputs of
    white-listed ops to ``dtype`` and of black-listed ops to float32. The
    custom lists are accepted and, as in the reference, not read."""
    prev = (_state.enabled, _state.dtype, _state.level)
    _state.enabled = enable
    _state.dtype = _dtype(dtype)
    _state.level = level
    try:
        yield
    finally:
        _state.enabled, _state.dtype, _state.level = prev


amp_guard = auto_cast  # legacy alias (fluid.dygraph.amp.amp_guard)


def autocast_call(op_kind: str, *tensors):
    """``tensors`` cast per the active autocast policy, for the compute
    layers: to the autocast dtype when ``op_kind`` is white-listed, to
    float32 when black-listed, unchanged otherwise (and outside
    :func:`auto_cast`). Only floating tensors are cast; None passes."""
    if not _state.enabled:
        return tensors
    if op_kind in WHITE_OPS:
        tgt = _state.dtype
    elif op_kind in BLACK_OPS:
        tgt = torch.float32
    else:
        return tensors
    return tuple(t.to(tgt) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() else t for t in tensors)


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight: Optional[bool] = None,
             save_dtype=None):
    """Cast ``models``' floating parameters to ``dtype`` and give
    ``optimizers`` master weights (unless ``master_weight=False``).
    ``level`` and ``save_dtype`` are accepted and not read, as in the
    reference. Returns what was passed: ``model``, or ``(model,
    optimizer)``, with lists where lists were given."""
    del level, save_dtype
    d = _dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    with torch.no_grad():
        for m in model_list:
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(d)
    if optimizers is None:
        return model_list[0] if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for opt in opt_list:
        if master_weight is not False:
            opt.multi_precision = True
    return (model_list[0] if single else model_list,
            opt_list[0] if opt_single else opt_list)

"""Tensor creation ops (port of ``paddle_tpu/ops/creation.py``).

A created tensor lies on the current device
(:func:`paddle_tpu_torch.framework.compat.set_device`, ``cuda`` unless
set otherwise) or on ``place=`` where the op takes one; an op given a
tensor follows it. ``to_tensor(..., stop_gradient=False)`` returns an
eager :class:`paddle_tpu_torch.eager.Tensor`, the default a plain
``torch.Tensor``, as the reference returns a plain array.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.compat import current_device, resolve_place
from ..framework.dtype import convert_dtype, get_default_dtype
from ._common import t

__all__ = [
    "to_tensor", "full", "full_like", "zeros", "zeros_like", "ones",
    "ones_like", "empty", "empty_like", "arange", "linspace", "logspace",
    "eye", "diag", "diagflat", "tril", "triu", "meshgrid", "assign", "clone",
    "complex", "tril_indices", "triu_indices", "vander", "gaussian",
    "set_printoptions",
]


def _float_or(dtype):
    return get_default_dtype() if dtype is None else convert_dtype(dtype)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a copy of ``data`` on ``place`` (the current
    device by default). Python floats take the default float dtype.
    ``stop_gradient=False`` returns an eager Tensor that requires grad."""
    device = resolve_place(place)
    dtype = convert_dtype(dtype)
    data = getattr(data, "_data", data)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=device, dtype=dtype, copy=True)
    else:
        if dtype is None and isinstance(data, (list, tuple, int, float)) \
                and np.asarray(data).dtype == np.float64:
            dtype = get_default_dtype()
        out = t(np.asarray(data), dtype=dtype).to(device)
    if not stop_gradient:
        from ..eager import Tensor

        return Tensor(out, stop_gradient=False)
    return out


def full(shape, fill_value, dtype=None):
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = torch.bool
        elif isinstance(fill_value, int):
            dtype = torch.int64
        else:
            dtype = get_default_dtype()
    return torch.full(tuple(shape), fill_value, dtype=convert_dtype(dtype),
                      device=current_device())


def full_like(x, fill_value, dtype=None):
    return torch.full_like(t(x), fill_value, dtype=convert_dtype(dtype))


def zeros(shape, dtype=None):
    return torch.zeros(tuple(shape), dtype=_float_or(dtype),
                       device=current_device())


def zeros_like(x, dtype=None):
    return torch.zeros_like(t(x), dtype=convert_dtype(dtype))


def ones(shape, dtype=None):
    return torch.ones(tuple(shape), dtype=_float_or(dtype),
                      device=current_device())


def ones_like(x, dtype=None):
    return torch.ones_like(t(x), dtype=convert_dtype(dtype))


def empty(shape, dtype=None):
    # zero-filled, as the reference's: an uninitialised read is a bug
    # either way, and zeros keep runs reproducible
    return zeros(shape, dtype)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    dtype = convert_dtype(dtype)
    if dtype is None and any(isinstance(v, float) for v in (start, end, step)):
        dtype = get_default_dtype()
    return torch.arange(start, end, step, dtype=dtype,
                        device=current_device())


def linspace(start, stop, num, dtype=None):
    return torch.linspace(start, stop, int(num), dtype=_float_or(dtype),
                          device=current_device())


def logspace(start, stop, num, base=10.0, dtype=None):
    return torch.logspace(start, stop, int(num), base=base,
                          dtype=_float_or(dtype), device=current_device())


def eye(num_rows, num_columns=None, dtype=None):
    cols = num_rows if num_columns is None else num_columns
    return torch.eye(num_rows, cols, dtype=_float_or(dtype),
                     device=current_device())


def diag(x, offset=0, padding_value=0):
    x = t(x)
    out = torch.diag(x, offset)
    if x.ndim == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(mask, out, torch.as_tensor(
            padding_value, dtype=out.dtype, device=out.device))
    return out


def diagflat(x, offset=0):
    return torch.diagflat(t(x), offset)


def tril(x, diagonal=0):
    return torch.tril(t(x), diagonal)


def triu(x, diagonal=0):
    return torch.triu(t(x), diagonal)


def meshgrid(*args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(torch.meshgrid(*[t(a) for a in args], indexing="ij"))


def assign(x, output=None):
    del output
    return t(x).clone()


def clone(x):
    return t(x).clone()


def complex(real, imag):  # noqa: A001 - paddle name
    return torch.complex(t(real), t(imag))


def tril_indices(row, col, offset=0):
    return torch.tril_indices(row, col, offset, device=current_device())


def triu_indices(row, col=None, offset=0):
    return torch.triu_indices(row, row if col is None else col, offset,
                              device=current_device())


def vander(x, n=None, increasing=False, name=None):
    x = t(x)
    powers = torch.arange(x.shape[0] if n is None else n, device=x.device)
    out = x[:, None] ** powers
    return out if increasing else torch.flip(out, (1,))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    """Gaussian-filled tensor; ``seed`` 0 draws from the global generator,
    any other seed from a generator of its own."""
    from . import random as _random

    key = None
    if seed != 0:
        key = torch.Generator(device=current_device())
        key.manual_seed(int(seed))
    out = _random.normal(mean=mean, std=std, shape=shape, key=key)
    if dtype is not None:
        out = out.to(convert_dtype(dtype))
    return out


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Configure how tensors print (``torch.set_printoptions``)."""
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)

"""Argument handling the op modules share: array-likes as tensors on the
right device, paddle's axis arguments as torch's."""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..framework.compat import current_device
from ..framework.dtype import convert_dtype, get_default_dtype

__all__ = []


def device_of(*xs) -> torch.device:
    """The device of the first tensor among ``xs``; else the current
    device."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, (list, tuple)):
            for y in x:
                if isinstance(y, torch.Tensor):
                    return y.device
    return current_device()


def t(x, like=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays as it is (cast to ``dtype`` when
    given); anything array-like is copied to ``like``'s device (or the
    current device). Python floats (and lists of them) take the default
    float dtype, as the reference's weakly typed scalars do."""
    dtype = convert_dtype(dtype)
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    device = like.device if isinstance(like, torch.Tensor) else \
        device_of(x)
    if isinstance(x, (list, tuple)) and any(isinstance(y, torch.Tensor)
                                            for y in x):
        out = torch.stack([t(y, like=like) for y in x])
        return out if dtype is None else out.to(dtype)
    arr = np.asarray(x)
    if dtype is None and arr.dtype == np.float64 and \
            not isinstance(x, np.ndarray):
        dtype = get_default_dtype()
    out = torch.tensor(arr, device=device)
    return out if dtype is None else out.to(dtype)


def pair(x, y):
    """Binary-op operands: Python scalars stay scalars (torch promotes
    them as weakly typed, as JAX does); the rest become tensors on the
    device of whichever operand is one."""
    like = x if isinstance(x, torch.Tensor) else \
        y if isinstance(y, torch.Tensor) else None
    if not isinstance(x, numbers.Number) or isinstance(x, bool):
        x = t(x, like=like)
    if not isinstance(y, numbers.Number) or isinstance(y, bool):
        y = t(y, like=like if like is not None else x)
    if isinstance(x, numbers.Number) and isinstance(y, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.result_type(y, x),
                            device=y.device)
    return x, y


def axis(a):
    """A paddle axis argument (int, list, tuple or None) as torch's."""
    if isinstance(a, (list, tuple)):
        return tuple(int(i) for i in a)
    return a


def float_of(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the default float dtype when it is not floating (numpy's
    and JAX's promotion for mean, var and the like)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(get_default_dtype())

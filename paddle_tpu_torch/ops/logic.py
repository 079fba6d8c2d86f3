"""Comparison and logical ops (port of ``paddle_tpu/ops/logic.py``)."""
from __future__ import annotations

import torch

from ._common import pair, t

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "allclose", "isclose", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "bitwise_left_shift", "bitwise_right_shift",
    "is_empty", "is_tensor", "is_complex", "is_floating_point", "is_integer",
    "union1d", "intersect1d", "setdiff1d",
]


def _binary(fn):
    def op(x, y, out=None, name=None):
        return fn(*pair(x, y))

    return op


equal = _binary(torch.eq)
not_equal = _binary(torch.ne)
greater_than = _binary(torch.gt)
greater_equal = _binary(torch.ge)
less_than = _binary(torch.lt)
less_equal = _binary(torch.le)
logical_and = _binary(torch.logical_and)
logical_or = _binary(torch.logical_or)
logical_xor = _binary(torch.logical_xor)
bitwise_and = _binary(torch.bitwise_and)
bitwise_or = _binary(torch.bitwise_or)
bitwise_xor = _binary(torch.bitwise_xor)
bitwise_left_shift = _binary(torch.bitwise_left_shift)
bitwise_right_shift = _binary(torch.bitwise_right_shift)


def logical_not(x, out=None, name=None):
    return torch.logical_not(t(x))


def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(t(x))


def _scalar(value: bool, like) -> torch.Tensor:
    return torch.tensor(value, device=like.device)


def equal_all(x, y, name=None):
    x, y = pair(x, y)
    return _scalar(x.shape == y.shape and bool(torch.equal(x, y)), x)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = pair(x, y)
    return _scalar(torch.allclose(x, y, rtol=rtol, atol=atol,
                                  equal_nan=equal_nan), x)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(*pair(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def is_empty(x, name=None):
    x = t(x)
    return _scalar(x.numel() == 0, x)


def is_tensor(x):
    from ..eager import Tensor

    return isinstance(x, (torch.Tensor, Tensor))


def is_complex(x, name=None):
    return bool(t(x).is_complex())


def is_floating_point(x, name=None):
    return bool(t(x).is_floating_point())


def is_integer(x, name=None):
    x = t(x)
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def _sized(out, size, fill):
    """``out`` cut or padded to ``size`` (None: as it is) with ``fill``."""
    if size is None:
        return out
    if out.shape[0] >= size:
        return out[:size]
    pad = out.new_full((size - out.shape[0],), fill)
    return torch.cat([out, pad])


def union1d(x, y, size=None, name=None):
    """The sorted union; ``size`` pads with the smallest element, as
    ``jnp.union1d`` does."""
    x, y = pair(x, y)
    out = torch.unique(torch.cat([x.reshape(-1), y.reshape(-1)]))
    return _sized(out, size, out.min() if out.numel() else 0)


def intersect1d(x, y, assume_unique=False, size=None, name=None):
    x, y = pair(x, y)
    ux, uy = torch.unique(x), torch.unique(y)
    out = ux[torch.isin(ux, uy)]
    return _sized(out, size, 0)


def setdiff1d(x, y, assume_unique=False, size=None, name=None):
    x, y = pair(x, y)
    ux = torch.unique(x)
    out = ux[~torch.isin(ux, y.reshape(-1))]
    return _sized(out, size, 0)

"""Statistics ops (port of ``paddle_tpu/ops/stat.py``)."""
from __future__ import annotations

import torch

from ._common import axis as _axis
from ._common import float_of, t

__all__ = ["var", "std", "median", "nanmedian", "quantile", "nanquantile",
           "histogramdd"]


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(float_of(t(x)), dim=None if axis is None else _axis(axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(float_of(t(x)), dim=None if axis is None else _axis(axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim):
    """``fn`` (torch's ``quantile``/``nanquantile``, linear interpolation)
    over ``axis``: None for all dims, an int, or a tuple of dims (moved to
    the end and flattened, as torch takes one dim)."""
    x = float_of(t(x))
    qt = q if isinstance(q, float) else t(q, like=x).to(x.dtype)
    if axis is None:
        out = fn(x.reshape(-1), qt, dim=0)
        return out.reshape(out.shape + (1,) * x.ndim) if keepdim else out
    dims = _axis(axis)
    if isinstance(dims, int):
        return fn(x, qt, dim=dims, keepdim=keepdim)
    dims = tuple(d % x.ndim for d in dims)
    rest = [d for d in range(x.ndim) if d not in dims]
    moved = x.permute(rest + list(dims)).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = fn(moved, qt, dim=-1)
    if keepdim:
        shape = list(out.shape[:out.ndim - len(rest)])
        full = list(x.shape)
        for d in dims:
            full[d] = 1
        out = out.reshape(shape + full)
    return out


def median(x, axis=None, keepdim=False, name=None):
    """The middle value; the mean of the two middle ones for an even
    count, as ``jnp.median`` (torch's ``median`` takes the lower one)."""
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """N-dimensional histogram of the rows of ``x`` ``[N, D]``: ``(hist,
    edges)``. torch computes it on the CPU only, so a card tensor goes
    there and back."""
    x = float_of(t(x))
    device = x.device
    flat = None if ranges is None else [float(v) for r in ranges for v in r]
    w = None if weights is None else t(weights, like=x).to(x.dtype).cpu()
    hist, edges = torch.histogramdd(x.cpu(), bins=bins, range=flat,
                                    weight=w, density=density)
    return hist.to(device), [e.to(device) for e in edges]

"""Search and sort ops (port of ``paddle_tpu/ops/search.py``).

Indices come back int64, the width the reference's code asks for (its
int32 results come from JAX running without 64-bit types).
"""
from __future__ import annotations

import torch

from ..framework.dtype import convert_dtype
from ._common import t

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
    "searchsorted", "bucketize", "index_add", "index_put", "isin",
    "digitize",
]


def _arg(fn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        x = t(x)
        if axis is None:
            out = fn(x.reshape(-1), dim=0)
            if keepdim:
                out = out.reshape([1] * x.ndim)
        else:
            out = fn(x, dim=axis, keepdim=keepdim)
        return out.to(convert_dtype(dtype))

    return op


argmax = _arg(torch.argmax)
argmin = _arg(torch.argmin)


def argsort(x, axis=-1, descending=False, name=None):
    return torch.argsort(t(x), dim=axis, descending=descending, stable=True)


def sort(x, axis=-1, descending=False, name=None):
    return torch.sort(t(x), dim=axis, descending=descending,
                      stable=True).values


def topk(x, k, axis=None, largest=True, sorted=True, name=None):  # noqa: A002
    res = torch.topk(t(x), k, dim=-1 if axis is None else axis,
                     largest=largest, sorted=sorted)
    return res.values, res.indices


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = t(x)
    s = torch.sort(x, dim=axis, stable=True)
    vals = s.values.select(axis, k - 1)
    idx = s.indices.select(axis, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest among equally
    frequent ones) and the last index where it occurs."""
    x = t(x)
    axis = axis % x.ndim
    moved = torch.movedim(x, axis, -1)
    s = torch.sort(moved, dim=-1).values
    n = s.shape[-1]
    counts = (s[..., :, None] == s[..., None, :]).sum(-1)
    best = torch.argmax(counts, dim=-1)
    vals = torch.take_along_dim(s, best[..., None], dim=-1)[..., 0]
    match = moved == vals[..., None]
    pos = torch.arange(n, device=x.device)
    idx = torch.amax(torch.where(match, pos, -1), dim=-1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    ss = t(sorted_sequence)
    v = t(values, like=ss)
    return torch.searchsorted(ss, v, out_int32=out_int32, right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def index_add(x, index, axis, value, name=None):
    x = t(x)
    return x.index_add(axis % x.ndim, t(index, like=x).long(),
                       t(value, like=x).to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    x = t(x)
    idx = tuple(t(i, like=x) for i in indices)
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
    return x.index_put(idx, t(value, like=x).to(x.dtype),
                       accumulate=accumulate)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    x = t(x)
    return torch.isin(x, t(test_x, like=x), assume_unique=assume_unique,
                      invert=invert)


def digitize(x, bins, right=False, name=None):
    """numpy's ``digitize`` for increasing ``bins``."""
    x = t(x)
    return torch.searchsorted(t(bins, like=x), x, right=not right)

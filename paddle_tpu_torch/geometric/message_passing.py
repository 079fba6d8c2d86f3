"""Message-passing aggregation primitives (port of
``paddle_tpu/geometric/message_passing.py``).

Reference parity: ``python/paddle/geometric/message_passing/send_recv.py``
(``send_u_recv``/``send_ue_recv``/``send_uv``) whose CUDA kernels are
``paddle/phi/kernels/gpu/graph_send_recv_kernel.cu`` (atomic
scatter-reduce). Here the reduction is ``index_add`` / ``scatter_reduce``
on the device of the ids, differentiable through autograd.

Each function runs on ``device`` when it is given, else on the device of
its first tensor argument (the ids first); with no tensor among them (numpy
ids and features, as the samplers return) ``device=None`` means ``cuda``,
and it raises without one unless ``device="cpu"``.

The JAX reference's index rules are kept: a gather index is wrapped once
if negative and clamped into range (XLA's gather), a segment id outside
``[0, num_segments)`` is dropped (XLA's scatter), an empty segment gives 0
for max, min and mean, and mean divides by ``max(count, 1)``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import default_device

__all__ = ["send_u_recv", "send_ue_recv", "send_uv", "segment_pool",
           "segment_sum", "segment_mean", "segment_min", "segment_max"]

_COMBINE = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
}


def _device_of(device, *vals) -> torch.device:
    """``device`` if given, else the device of the first tensor among
    ``vals`` (the ids first), else the default device (``cuda``)."""
    if device is None:
        for v in vals:
            if isinstance(v, torch.Tensor):
                return v.device
    return default_device(device)


def _tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.ascontiguousarray(v), device=device)


def _gather(x, idx):
    """``x[idx]`` with XLA's bounds rule: negative indices wrap once, then
    every index is clamped into ``[0, len(x) - 1]``."""
    n = x.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return x[idx]


def _segment_ids(ids, n):
    """Segment ids with every id outside ``[0, n)`` sent to segment ``n``,
    a spare row that the caller drops (XLA's scatter drops them)."""
    ids = ids.long().reshape(-1)
    return torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))


def _segment_sum(msg, ids, n):
    out = msg.new_zeros((n + 1,) + tuple(msg.shape[1:]))
    return out.index_add(0, _segment_ids(ids, n), msg)[:n]


def _segment_reduce(msg, dst, num_segments, pool_type):
    n = int(num_segments)
    if pool_type in ("sum", "add"):
        return _segment_sum(msg, dst, n)
    if pool_type not in ("mean", "max", "min"):
        raise ValueError(f"unknown pool_type {pool_type!r}")
    # count per segment to mask empties
    cnt = _segment_sum(torch.ones(msg.shape[0], dtype=torch.float32,
                                  device=msg.device), dst, n)
    nonempty = (cnt > 0).reshape((-1,) + (1,) * (msg.ndim - 1))
    if pool_type == "mean":
        tot = _segment_sum(msg, dst, n)
        denom = torch.clamp(cnt, min=1.0).reshape(nonempty.shape).to(
            tot.dtype)
        return tot / denom
    ids = _segment_ids(dst, n).reshape((-1,) + (1,) * (msg.ndim - 1))
    out = msg.new_zeros((n + 1,) + tuple(msg.shape[1:])).scatter_reduce(
        0, ids.expand(msg.shape), msg,
        "amax" if pool_type == "max" else "amin", include_self=False)[:n]
    return torch.where(nonempty, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))


def send_u_recv(x, src_index, dst_index, reduce_op: str = "sum",
                out_size=None, device=None):
    """Gather ``x[src]``, scatter-reduce onto ``dst``: one GNN hop.

    Empty destination segments yield 0 (the reference's ``graph_send_recv``
    semantics, for max and min too)."""
    device = _device_of(device, dst_index, src_index, x)
    x = _tensor(x, device)
    src_index = _tensor(src_index, device)
    dst_index = _tensor(dst_index, device)
    n = int(out_size) if out_size is not None else x.shape[0]
    return _segment_reduce(_gather(x, src_index), dst_index, n, reduce_op)


def send_ue_recv(x, e, src_index, dst_index, message_op: str = "add",
                 reduce_op: str = "sum", out_size=None, device=None):
    """Like :func:`send_u_recv` but combines node features with edge
    features first: ``combine(x[src], e)`` then reduce onto dst."""
    device = _device_of(device, dst_index, src_index, x, e)
    x = _tensor(x, device)
    e = _tensor(e, device)
    src_index = _tensor(src_index, device)
    dst_index = _tensor(dst_index, device)
    if message_op not in _COMBINE:
        raise ValueError(f"unknown message_op {message_op!r}")
    msg = _COMBINE[message_op](_gather(x, src_index), e)
    n = int(out_size) if out_size is not None else x.shape[0]
    return _segment_reduce(msg, dst_index, n, reduce_op)


def send_uv(x, y, src_index, dst_index, message_op: str = "add",
            device=None):
    """Edge-wise message ``combine(x[src], y[dst])`` (no reduction):
    reference ``paddle.geometric.send_uv``."""
    device = _device_of(device, src_index, dst_index, x, y)
    x = _tensor(x, device)
    y = _tensor(y, device)
    if message_op not in _COMBINE:
        raise ValueError(f"unknown message_op {message_op!r}")
    return _COMBINE[message_op](_gather(x, _tensor(src_index, device)),
                                _gather(y, _tensor(dst_index, device)))


def segment_pool(x, segment_ids, pool_type: str = "sum", num_segments=None,
                 device=None):
    """Segment reduction over already-grouped rows (reference
    ``paddle.incubate.segment_sum``/``segment_mean``/...). Without
    ``num_segments`` the result has ``max(segment_ids) + 1`` rows."""
    device = _device_of(device, segment_ids, x)
    x = _tensor(x, device)
    segment_ids = _tensor(segment_ids, device)
    if num_segments is not None:
        n = int(num_segments)
    else:
        n = int(segment_ids.max()) + 1
    return _segment_reduce(x, segment_ids, n, pool_type)


def segment_sum(data, segment_ids, name=None, device=None):
    """``paddle.geometric.segment_sum`` (reference ``geometric/math.py:23``):
    out[i] = sum of rows whose segment id == i; result length is
    ``max(segment_ids) + 1``."""
    return segment_pool(data, segment_ids, "sum", device=device)


def segment_mean(data, segment_ids, name=None, device=None):
    """``paddle.geometric.segment_mean``; empty segments yield 0."""
    return segment_pool(data, segment_ids, "mean", device=device)


def segment_min(data, segment_ids, name=None, device=None):
    """``paddle.geometric.segment_min``; empty segments yield 0."""
    return segment_pool(data, segment_ids, "min", device=device)


def segment_max(data, segment_ids, name=None, device=None):
    """``paddle.geometric.segment_max``; empty segments yield 0."""
    return segment_pool(data, segment_ids, "max", device=device)

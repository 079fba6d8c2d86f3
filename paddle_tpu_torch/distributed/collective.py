"""Collective communication over mesh axes (port of
``paddle_tpu/distributed/collective.py``).

A group is a mesh axis name (or a tuple of names, or None for "dp"), as in
the reference (``_axis``). Each function takes this rank's local tensor and
returns what the reference's function returns for one shard inside
``shard_map``: ``all_gather``/``reduce_scatter``/``alltoall`` are tiled, a
``src`` or a permutation is an index along the axis. The functions return
new tensors, detached from autograd (the tensor-parallel layers wrap them
in ``autograd.Function``s of their own, ``parallel/mp_layers.py``).

Backends. On NCCL every collective is the library's own. gloo (the CPU
worlds of the tests, and two ranks on one card, where NCCL refuses a
second rank on a device) runs ``all_reduce`` and ``broadcast`` on CUDA
tensors itself; every other collective on a CUDA tensor is staged through
pinned host memory in :func:`_gloo_staged` and the staged bytes are
counted (``stats()["staged_bytes"]``). Nothing here ever changes backend.
``stats()`` also counts the payload bytes each collective moved, by name.
"""
from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, get_mesh, require_mesh

__all__ = ["ReduceOp", "all_reduce", "all_gather", "reduce_scatter",
           "broadcast", "alltoall", "ppermute", "shift_right", "shift_left",
           "all_reduce_buckets", "axis_index", "axis_size_of",
           "eager_all_reduce", "all_reduce_async", "reduce_scatter_async",
           "all_gather_async", "stats", "reset_stats"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_DIST_OPS = {ReduceOp.SUM: "SUM", ReduceOp.AVG: "SUM", ReduceOp.MAX: "MAX",
             ReduceOp.MIN: "MIN", ReduceOp.PROD: "PRODUCT"}

_stats = {"bytes": defaultdict(int), "calls": defaultdict(int),
          "staged_bytes": 0}


def stats() -> dict:
    """``{"bytes": {collective: payload bytes}, "calls": {...},
    "staged_bytes": n}`` since the last :func:`reset_stats`."""
    return {"bytes": dict(_stats["bytes"]), "calls": dict(_stats["calls"]),
            "staged_bytes": _stats["staged_bytes"]}


def reset_stats() -> None:
    _stats["bytes"].clear()
    _stats["calls"].clear()
    _stats["staged_bytes"] = 0


def _count(name: str, t: torch.Tensor) -> None:
    _stats["bytes"][name] += t.numel() * t.element_size()
    _stats["calls"][name] += 1


def _axis(group):
    """Accept an axis name, tuple of names, an object carrying ``axis``,
    or None (-> 'dp')."""
    if group is None:
        return "dp"
    ax = getattr(group, "axis", None)
    if ax is not None:
        return ax
    if hasattr(group, "ranks"):
        raise ValueError(
            "this Group carries no mesh-axis mapping; create it with "
            "new_group(..., axis=<mesh axis name>) to use it in "
            "collectives")
    return group


def _resolve(group, mesh: Optional[Mesh]):
    """``(mesh, axes, process group or None)``; None when the axis has
    size 1 (or no mesh is installed): nothing to communicate."""
    m = mesh or get_mesh()
    axes = _axis(group)
    if m is None:
        return None, axes, None
    return m, axes, m.group(axes)


def _staging(t: torch.Tensor) -> bool:
    """True where gloo lacks the collective for ``t``: every collective
    but ``all_reduce`` and ``broadcast`` on a CUDA tensor."""
    return t.is_cuda and dist.get_backend() == "gloo"


class _Staged:
    """A gloo collective on CUDA tensors run on pinned host copies: the
    inputs are copied to pinned host memory, the collective runs there and
    ``wait()`` copies the outputs back into the CUDA tensors."""

    def __init__(self, outputs: Sequence[torch.Tensor]):
        self.outputs = list(outputs)
        self.host_out = [torch.empty(o.shape, dtype=o.dtype,
                                     pin_memory=True) for o in self.outputs]
        self.work = None

    @staticmethod
    def host(t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        _stats["staged_bytes"] += t.numel() * t.element_size()
        return h

    def wait(self):
        if self.work is not None:
            self.work.wait()
        for o, h in zip(self.outputs, self.host_out):
            o.copy_(h, non_blocking=True)
            _stats["staged_bytes"] += h.numel() * h.element_size()
        return True


def _gloo_staged(fn, outputs, inputs, async_op):
    """Run ``fn(host outputs, host inputs, async_op)`` on pinned host
    copies (see :class:`_Staged`)."""
    staged = _Staged(outputs)
    hin = [staged.host(t) for t in inputs]
    staged.work = fn(staged.host_out, hin, async_op)
    if async_op:
        return staged
    staged.wait()
    return None


# ------------------------------------------------------------ primitives
def all_reduce_async(tensor: torch.Tensor, op=ReduceOp.SUM, group=None,
                     mesh: Optional[Mesh] = None):
    """In-place asynchronous all-reduce of ``tensor`` over the axis: a
    work handle (``wait()``), or None when there is nothing to do. AVG
    divides after the wait of :func:`all_reduce`, so it is refused here."""
    if op == ReduceOp.AVG:
        raise ValueError("all_reduce_async: reduce with SUM and divide")
    _, _, pg = _resolve(group, mesh)
    if pg is None:
        return None
    _count("all_reduce", tensor)
    return dist.all_reduce(tensor, op=getattr(dist.ReduceOp, _DIST_OPS[op]),
                           group=pg, async_op=True)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, mesh=None):
    """Reduce ``tensor`` over the axis; every rank gets the result."""
    out = tensor.detach().clone()
    m, axes, pg = _resolve(group, mesh)
    if pg is None:
        return out
    work = all_reduce_async(out, ReduceOp.SUM if op == ReduceOp.AVG else op,
                            axes, m)
    work.wait()
    if op == ReduceOp.AVG:
        out /= m.axis_size(axes)
    return out


def all_gather_async(out: torch.Tensor, tensor: torch.Tensor, group=None,
                     mesh: Optional[Mesh] = None):
    """Gather the axis's ``tensor``s into ``out`` (dim 0, rank order)."""
    _, _, pg = _resolve(group, mesh)
    if pg is None:
        out.copy_(tensor)
        return None
    _count("all_gather", out)
    if _staging(tensor):
        return _gloo_staged(
            lambda o, i, a: dist.all_gather_into_tensor(o[0], i[0], group=pg,
                                                        async_op=a),
            [out], [tensor], True)
    return dist.all_gather_into_tensor(out, tensor.contiguous(), group=pg,
                                       async_op=True)


def all_gather(tensor, group=None, axis: int = 0, mesh=None):
    """Concatenate the axis's shards along ``axis`` (tiled)."""
    m, axes, pg = _resolve(group, mesh)
    if pg is None:
        return tensor.detach().clone()
    n = m.axis_size(axes)
    src = tensor.detach().movedim(axis, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    work = all_gather_async(out, src, axes, m)
    if work is not None:
        work.wait()
    return out.movedim(0, axis).contiguous()


def reduce_scatter_async(out: torch.Tensor, tensor: torch.Tensor,
                         group=None, mesh: Optional[Mesh] = None):
    """Sum ``tensor`` over the axis and keep this rank's dim-0 block in
    ``out``."""
    _, _, pg = _resolve(group, mesh)
    if pg is None:
        out.copy_(tensor)
        return None
    _count("reduce_scatter", tensor)
    if _staging(tensor):
        return _gloo_staged(
            lambda o, i, a: dist.reduce_scatter_tensor(o[0], i[0], group=pg,
                                                       async_op=a),
            [out], [tensor], True)
    return dist.reduce_scatter_tensor(out, tensor.contiguous(), group=pg,
                                      async_op=True)


def reduce_scatter(tensor, op=ReduceOp.SUM, group=None, scatter_axis=0,
                   mesh=None):
    """Sum (or average) over the axis, each rank keeping its block of
    ``scatter_axis`` (tiled)."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError("reduce_scatter supports sum/avg")
    m, axes, pg = _resolve(group, mesh)
    if pg is None:
        return tensor.detach().clone()
    n = m.axis_size(axes)
    src = tensor.detach().movedim(scatter_axis, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    work = reduce_scatter_async(out, src, axes, m)
    if work is not None:
        work.wait()
    if op == ReduceOp.AVG:
        out /= n
    return out.movedim(0, scatter_axis).contiguous()


def broadcast(tensor, src=0, group=None, mesh=None):
    """Rank ``src`` (an index along the axis)'s value on every rank."""
    out = tensor.detach().clone()
    m, axes, pg = _resolve(group, mesh)
    if pg is None:
        return out
    _count("broadcast", out)
    dist.broadcast(out, src=m.group_ranks(axes)[src], group=pg)
    return out


def alltoall(tensor, group=None, split_axis=0, concat_axis=0, mesh=None):
    """Split ``split_axis`` into one block per rank, send block j to rank
    j, and concatenate what arrives along ``concat_axis`` (tiled)."""
    m, axes, pg = _resolve(group, mesh)
    if pg is None:
        return tensor.detach().clone()
    n = m.axis_size(axes)
    src = torch.stack(tensor.detach().chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(src)
    _count("alltoall", src)
    if _staging(src):
        _gloo_staged(lambda o, i, a: dist.all_to_all_single(
            o[0], i[0], group=pg), [out], [src], False)
    else:
        dist.all_to_all_single(out, src, group=pg)
    return torch.cat(list(out.unbind(0)), dim=concat_axis)


def ppermute(tensor, perm, group=None, mesh=None):
    """Point-to-point shift: ``perm`` is a list of ``(source, dest)`` axis
    indices; a rank no pair sends to gets zeros (as ``lax.ppermute``)."""
    m, axes, pg = _resolve(group, mesh)
    if pg is None:
        return tensor.detach().clone()
    me = m.axis_index(axes)
    ranks = m.group_ranks(axes)
    src = tensor.detach().contiguous()
    out = torch.zeros_like(src)
    staged = _staging(src)
    send_buf = _Staged.host(src) if staged else src
    recv_buf = (torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                if staged else out)
    ops = []
    for s, d in perm:
        if s == me:
            ops.append(dist.P2POp(dist.isend, send_buf, ranks[d], group=pg))
        if d == me:
            ops.append(dist.P2POp(dist.irecv, recv_buf, ranks[s], group=pg))
    _count("ppermute", src)
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if staged and any(d == me for _, d in perm):
        out.copy_(recv_buf)
        _stats["staged_bytes"] += recv_buf.numel() * recv_buf.element_size()
    return out


def shift_right(tensor, group=None, mesh=None):
    m, axes, _ = _resolve(group, mesh)
    n = m.axis_size(axes) if m is not None else 1
    return ppermute(tensor, [(i, (i + 1) % n) for i in range(n)], axes, m)


def shift_left(tensor, group=None, mesh=None):
    m, axes, _ = _resolve(group, mesh)
    n = m.axis_size(axes) if m is not None else 1
    return ppermute(tensor, [(i, (i - 1) % n) for i in range(n)], axes, m)


def all_reduce_buckets(tensors: Sequence, op=ReduceOp.SUM, group=None,
                       mesh=None) -> List[torch.Tensor]:
    """Bucketed list all-reduce: one asynchronous collective per tensor,
    issued in list order (reverse-backward order when the caller follows
    ``overlap.bucket_order``), all waited for at the end. Values are those
    of mapping :func:`all_reduce` over the list."""
    m, axes, _ = _resolve(group, mesh)
    outs = [t.detach().clone() for t in tensors]
    sum_op = ReduceOp.SUM if op == ReduceOp.AVG else op
    works = [all_reduce_async(o, sum_op, axes, m) for o in outs]
    for w in works:
        if w is not None:
            w.wait()
    if op == ReduceOp.AVG and m is not None:
        for o in outs:
            o /= m.axis_size(axes)
    return outs


def axis_index(group=None, mesh=None) -> int:
    m = mesh or require_mesh()
    return m.axis_index(_axis(group))


def axis_size_of(group=None, mesh=None) -> int:
    m = mesh or require_mesh()
    return m.axis_size(_axis(group))


def eager_all_reduce(tensor, op=ReduceOp.SUM, group=None, mesh=None):
    """Paddle-style eager collective over a mesh axis (metric aggregation,
    tests): this rank's tensor reduced over the axis."""
    return all_reduce(tensor, op=op, group=group, mesh=mesh or require_mesh())

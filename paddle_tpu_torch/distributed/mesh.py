"""Device mesh and hybrid-parallel topology (port of
``paddle_tpu/distributed/mesh.py``).

The reference's topology is a ``jax.sharding.Mesh`` whose axes are named;
a collective names its axis. The port keeps the names, the axis order
and ``init_mesh``'s rules (``-1`` takes the rest, a mesh may use the
first ``n`` ranks of a larger world when the sizes divide it) over a
``torch.distributed.DeviceMesh`` with the same named axes: each axis is
one process group per slice, and :meth:`Mesh.group` hands a collective
this rank's group. Without a world (one process, no
``init_parallel_env``) the mesh is a single rank and every axis has size
1, so every collective is the identity.

Canonical axis names:
  "dp"   data parallel            "pp"  pipeline stage
  "sdp"  sharded data parallel    "mp"  tensor (model) parallel
  (ZeRO / sharding axis)          "sp"  sequence/context parallel
                                  "ep"  expert parallel
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from . import env

__all__ = ["AXIS_ORDER", "P", "PartitionSpec", "Mesh", "init_mesh",
           "get_mesh", "set_mesh", "require_mesh", "mesh_scope",
           "axis_size", "HybridCommunicateGroup"]

# standard axis order: outermost (slowest-varying) first. pp outermost,
# then dp/sdp, then mp/sp innermost (latency-critical -> NVLink peers).
AXIS_ORDER = ("pp", "dp", "sdp", "ep", "mp", "sp")

_current_mesh: List[Optional["Mesh"]] = [None]

Axes = Union[str, Sequence[str]]


class PartitionSpec(tuple):
    """Per dimension of a tensor, the mesh axis (or tuple of axes, outer
    first, or None) it is split over, as ``jax.sharding.PartitionSpec``.

    ``blocks`` > 1 marks a fused layout: the "mp"-split dimension is
    ``blocks`` equal parts laid end to end (GPT's ``qkv_proj`` is q, k and
    v), and each rank takes its slice of every part, so that rank r holds
    heads ``[r·H/mp, (r+1)·H/mp)`` of each of q, k and v. Equality ignores
    ``blocks``."""

    def __new__(cls, *dims, blocks: int = 1):
        self = super().__new__(cls, dims)
        self.blocks = int(blocks)
        return self

    def __repr__(self) -> str:
        extra = f", blocks={self.blocks}" if self.blocks > 1 else ""
        return f"PartitionSpec({', '.join(map(repr, self))}{extra})"

    def __reduce__(self):
        return (_make_spec, (tuple(self), self.blocks))

    def axes(self) -> Tuple[str, ...]:
        """Every axis the spec uses."""
        out = []
        for s in self:
            if isinstance(s, (tuple, list)):
                out.extend(s)
            elif s is not None:
                out.append(s)
        return tuple(out)


def _make_spec(dims, blocks):
    return PartitionSpec(*dims, blocks=blocks)


P = PartitionSpec


class Mesh:
    """A named grid of ranks: ``shape`` (``{axis: size}`` in mesh order),
    ``axis_names``, ``size``, this rank's ``coordinate`` per axis and one
    process group per axis (``group``). ``ranks`` is the grid of global
    ranks; a rank outside it (a mesh on the first ranks of a larger world)
    has ``member`` False and takes part in nothing."""

    def __init__(self, names: Sequence[str], sizes: Sequence[int],
                 device_mesh=None):
        self.axis_names: Tuple[str, ...] = tuple(names)
        self.shape: Dict[str, int] = dict(zip(names, (int(s) for s in sizes)))
        self.size = int(math.prod(self.shape.values()))
        self.device_mesh = device_mesh
        self.ranks = torch.arange(self.size).reshape(
            *[self.shape[n] for n in names])
        rank = env.get_rank()
        self.member = rank < self.size
        coords = ((self.ranks == rank).nonzero()[0].tolist()
                  if self.member else [None] * len(names))
        self.coordinate: Dict[str, Optional[int]] = dict(zip(names, coords))
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def axis_size(self, axes: Axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(math.prod(self.shape.get(a, 1) for a in axes))

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (several axes count as one,
        outer first, as a tuple of names shards one dimension)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in self.axis_names:    # outer first, as the groups order ranks
            if a in axes:
                idx = idx * self.shape[a] + self.coordinate[a]
        return idx

    def group(self, axes: Axes):
        """This rank's process group over ``axes`` (None when their size
        is 1: nothing to communicate). A single axis is the
        ``DeviceMesh``'s group; the group of a tuple of axes is made
        with the mesh."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in self.axis_names if a in axes)
        if self.axis_size(axes) == 1 or not self.member:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]

    def _make_groups(self) -> None:
        """Make the group of every set of two or more axes (every rank of
        the world takes part, in the same order, so it runs in
        ``init_mesh``)."""
        from itertools import combinations

        rank = env.get_rank()
        names = self.axis_names
        for k in range(2, len(names) + 1):
            for axes in combinations(names, k):
                if self.axis_size(axes) == 1:
                    continue
                keep = [names.index(a) for a in axes]
                other = [i for i in range(len(names)) if i not in keep]
                grid = self.ranks.permute(*other, *keep).reshape(
                    -1, self.axis_size(axes))
                for row in grid.tolist():
                    g = dist.new_group(ranks=row)
                    if rank in row:
                        self._groups[axes] = g

    def group_ranks(self, axes: Axes) -> List[int]:
        """The global ranks of this rank's group over ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        sel = tuple(slice(None) if n in axes else self.coordinate[n]
                    for n in self.axis_names)
        return self.ranks[sel].reshape(-1).tolist()


def init_mesh(shape: Dict[str, int] = None, devices=None, **axes) -> Mesh:
    """Create and install a named mesh over the world's ranks.

    ``init_mesh({"dp": 2, "mp": 2})`` or ``init_mesh(dp=2, mp=2)``. Axis
    sizes must multiply to a divisor of the world size (use -1 for "the
    rest"); the mesh takes the first ranks. Every rank of the world must
    call it (the groups of the axes, and of every set of axes, are made
    here, collectively)."""
    shape = dict(shape or {})
    shape.update(axes)
    n = len(devices) if devices is not None else env.get_world_size()
    names, sizes = [], []
    for name in AXIS_ORDER:
        if name in shape:
            names.append(name)
            sizes.append(shape.pop(name))
    for name, size in shape.items():  # non-standard axis names, appended
        names.append(name)
        sizes.append(size)
    if not names:
        names, sizes = ["dp"], [n]
    if -1 in sizes:
        known = int(math.prod(s for s in sizes if s != -1))
        sizes[sizes.index(-1)] = n // known
    total = int(math.prod(sizes))
    if total > n or n % total != 0:
        raise ValueError(f"mesh {dict(zip(names, sizes))} does not fit {n} devices")
    device_mesh = None
    if dist.is_initialized() and total > 1:
        from torch.distributed.device_mesh import DeviceMesh

        dev = env.device()
        device_type = ("cuda" if dist.get_backend() == "nccl"
                       and dev is not None and dev.type == "cuda" else "cpu")
        device_mesh = DeviceMesh(device_type,
                                 torch.arange(total).reshape(*sizes),
                                 mesh_dim_names=tuple(names))
    mesh = Mesh(names, sizes, device_mesh)
    if device_mesh is not None:
        mesh._make_groups()
    _current_mesh[0] = mesh
    return mesh


def get_mesh() -> Optional[Mesh]:
    return _current_mesh[0]


def set_mesh(mesh: Optional[Mesh]):
    _current_mesh[0] = mesh


def require_mesh() -> Mesh:
    m = get_mesh()
    if m is None:
        raise RuntimeError("no device mesh installed; call init_mesh(...) first")
    return m


@contextlib.contextmanager
def mesh_scope(mesh: Mesh):
    prev = _current_mesh[0]
    _current_mesh[0] = mesh
    try:
        yield mesh
    finally:
        _current_mesh[0] = prev


def axis_size(name: str, mesh: Optional[Mesh] = None) -> int:
    m = mesh or get_mesh()
    if m is None or name not in m.shape:
        return 1
    return m.shape[name]


class HybridCommunicateGroup:
    """Fleet topology facade over a :class:`Mesh` (reference
    ``topology.py:137``): sizes, this rank's index and the group per
    axis. A "group" is the axis name, as in the reference
    (``Mesh.group`` gives the process group)."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh or require_mesh()

    def _size(self, axis):
        return self.mesh.shape.get(axis, 1)

    def _rank(self, axis):
        return self.mesh.coordinate.get(axis) or 0

    # sizes ----------------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._size("dp")

    def get_model_parallel_world_size(self):
        return self._size("mp")

    def get_pipe_parallel_world_size(self):
        return self._size("pp")

    def get_sharding_parallel_world_size(self):
        return self._size("sdp")

    def get_expert_parallel_world_size(self):
        return self._size("ep")

    def get_sequence_parallel_world_size(self):
        return self._size("sp")

    # this rank's index along each axis ---------------------------------
    def get_data_parallel_rank(self):
        return self._rank("dp")

    def get_model_parallel_rank(self):
        return self._rank("mp")

    # axis names (the "group" handle in this framework) --------------------
    def get_data_parallel_group(self):
        return "dp"

    def get_model_parallel_group(self):
        return "mp"

    def get_pipe_parallel_group(self):
        return "pp"

    def get_sharding_parallel_group(self):
        return "sdp"

    def topology(self):
        return dict(self.mesh.shape)

    def nranks(self):
        return self.mesh.size

"""The distributed API's long tail (port of
``paddle_tpu/distributed/api_compat.py``): process groups by rank list,
point-to-point transfers, ``ParallelEnv``/``ParallelMode``, the extra
collectives (``reduce``, ``scatter``, ``alltoall_single``,
``all_gather_object``), the public ZeRO entry
(``group_sharded_parallel``, ``save_group_sharded_model``), ``split``
and the parameter-server entry configs.

Where torch's contracts differ from the reference's, the reference's are
kept:

- **Groups are real.** A :class:`Group` made by :func:`new_group` holds a
  ``torch.distributed`` process group over its ranks. Torch makes a group
  collectively: EVERY rank of the world calls :func:`new_group`, in the
  same order, members or not (the reference's is bookkeeping). Without a
  world (one process) a group is bookkeeping only. ``get_group(0)`` is the
  world.
- **P2P over the world's backend** (gloo, or NCCL on several cards; the
  reference ships host arrays through an rpc mailbox). A send carries a
  header with the shape and dtype first, so :func:`recv` works without a
  buffer and returns the tensor; given one, it fills it in place. ``tag``
  separates streams, and every wait is bounded by ``timeout``: a dead or
  silent peer fails the caller at its own deadline. ``src``/``dst`` are
  global ranks. On gloo a CUDA tensor travels through pinned host memory.
- **Collectives.** ``group`` is a :class:`Group` (its ranks), a mesh axis
  name (or a Group made with ``axis=``: the axis of the installed mesh,
  as in ``collective``), or None: the mesh's "dp" axis when a mesh is
  installed, else the world. :func:`reduce` leaves zeros on every rank
  but ``dst`` (an index into the group); :func:`scatter` returns this
  rank's chunk; :func:`alltoall_single` refuses uneven splits;
  :func:`all_gather_object` is the identity in a world of one.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "Group", "new_group", "get_group", "destroy_process_group",
    "ParallelEnv", "ParallelMode", "send", "recv", "isend", "irecv",
    "P2POp", "batch_isend_irecv", "wait", "reduce", "scatter",
    "alltoall_single", "all_gather_object", "group_sharded_parallel",
    "save_group_sharded_model", "split", "CountFilterEntry",
    "ShowClickEntry", "ProbabilityEntry",
]


# ----------------------------------------------------------------- groups
@dataclass
class Group:
    """A process group (reference ``communication/group.py``): its global
    ``ranks``, an optional mesh ``axis`` it stands for in ``collective``'s
    functions, and the ``torch.distributed`` group (``pg``; None in a
    world of one, ``dist.group.WORLD`` for group 0)."""

    id: int
    ranks: List[int]
    axis: Optional[str] = None
    pg: Any = None

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    @property
    def world_size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This process's index in the group (-1 outside it)."""
        from . import env

        me = env.get_rank()
        return self.ranks.index(me) if me in self.ranks else -1

    def is_member(self) -> bool:
        return self.rank >= 0

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank)


_groups = {}
_next_gid = [1]


def new_group(ranks: Optional[Sequence[int]] = None,
              backend: Optional[str] = None,
              timeout: Optional[float] = None,
              axis: Optional[str] = None) -> Group:
    """A group over ``ranks`` (default: the world). Collective in a world
    of several processes: every rank calls it, in the same order, with the
    same ``ranks``, as ``torch.distributed.new_group`` demands. ``axis``
    names the mesh axis the group stands for in ``collective``'s
    functions; ``backend`` and ``timeout`` (seconds) go to torch."""
    from . import env

    ranks = list(range(env.get_world_size())) if ranks is None else [
        int(r) for r in ranks]
    pg = None
    if dist.is_initialized() and env.get_world_size() > 1:
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=float(timeout))
        pg = dist.new_group(ranks=ranks, backend=backend, **kw)
    g = Group(_next_gid[0], ranks, axis=axis, pg=pg)
    _groups[g.id] = g
    _next_gid[0] += 1
    return g


def get_group(id: int = 0) -> Optional[Group]:  # noqa: A002
    """The group of ``id``; 0 is the world (on the "dp" axis, as the
    reference's)."""
    if id == 0 and 0 not in _groups:
        from . import env

        _groups[0] = Group(0, list(range(env.get_world_size())), axis="dp",
                           pg=dist.group.WORLD if dist.is_initialized()
                           else None)
    return _groups.get(id)


def destroy_process_group(group: Optional[Group] = None) -> None:
    """Forget ``group`` (all groups when None). The world itself stays
    joined: ``torch.distributed.destroy_process_group`` leaves it."""
    if group is None:
        _groups.clear()
        return
    _groups.pop(group.id, None)
    if group.pg is not None and group.id != 0 and group.is_member():
        dist.destroy_process_group(group.pg)


class ParallelEnv:
    """The launch environment of this process (reference
    ``parallel.ParallelEnv``): its rank and the world's size, its local
    rank on the node (``PADDLE_LOCAL_RANK`` / ``LOCAL_RANK``, which the
    launcher sets; else the rank) and its card's index."""

    @property
    def rank(self) -> int:
        from . import env

        return env.get_rank()

    @property
    def world_size(self) -> int:
        from . import env

        return env.get_world_size()

    nranks = world_size

    @property
    def local_rank(self) -> int:
        from . import env

        return env._env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK",
                            default=self.rank)

    @property
    def device_id(self) -> int:
        from . import env

        dev = env.device()
        if dev is None or dev.type != "cuda":
            return 0
        return dev.index or 0


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


def _where(group):
    """``(torch group or None for the world, global ranks, this rank's
    index)`` of a collective's ``group`` argument (see the module
    docstring); None when the group has one rank."""
    from . import env
    from .mesh import get_mesh

    mesh = get_mesh()
    if isinstance(group, Group) and (group.axis is None or mesh is None):
        if group.pg is None or group.nranks == 1:
            return None
        return group.pg, list(group.ranks), group.rank
    if mesh is None:
        if group is not None:
            raise RuntimeError(f"group {group!r} names a mesh axis and no "
                               f"mesh is installed (init_mesh)")
        n = env.get_world_size()
        return None if n == 1 else (None, list(range(n)), env.get_rank())
    from .collective import _axis

    axes = _axis(group)
    pg = mesh.group(axes)
    if pg is None:
        return None
    return pg, mesh.group_ranks(axes), mesh.axis_index(axes)


def _host_stage(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


# -------------------------------------------------------------------- P2P
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
           torch.bool, torch.complex64, torch.complex128)
_HEADER = 16  # int64 words: ndim, dtype index, then up to 14 dims


def _header_device() -> torch.device:
    from . import env

    dev = env.device()
    if dist.get_backend() == "nccl" and dev is not None:
        return dev
    return torch.device("cpu")


def _tags(tag: int):
    """The header's and the payload's tag of user tag ``tag``."""
    return 2 * int(tag), 2 * int(tag) + 1


def _wait(work, timeout: float, what: str) -> None:
    if work is None:
        return
    try:
        ok = work.wait(datetime.timedelta(seconds=float(timeout)))
    except RuntimeError as e:
        raise TimeoutError(f"{what}: no completion within {timeout}s "
                           f"({e})") from e
    if ok is False:
        raise TimeoutError(f"{what}: no completion within {timeout}s")


class _Req:
    """An asynchronous transfer: ``wait()`` completes it (bounded by its
    ``timeout``) and returns the tensor (a receive's result)."""

    def __init__(self, finish):
        self._finish = finish
        self._done = False
        self._value = None

    def wait(self):
        if not self._done:
            self._value = self._finish()
            self._done = True
        return self._value

    def is_completed(self) -> bool:
        return self._done


def _check_world(what: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a world of several processes "
                           f"(init_parallel_env)")


def isend(tensor, dst=0, group=None, tag: int = 0,
          timeout: float = 120.0) -> _Req:
    """Start sending ``tensor`` to global rank ``dst``: a header (shape,
    dtype) and then the data, on ``tag``'s stream."""
    _check_world("isend")
    t = tensor.detach().contiguous()
    if t.ndim > _HEADER - 2 or t.dtype not in _DTYPES:
        raise ValueError(f"send: unsupported tensor {tuple(t.shape)} "
                         f"{t.dtype}")
    head = torch.zeros(_HEADER, dtype=torch.int64)
    head[0], head[1] = t.ndim, _DTYPES.index(t.dtype)
    head[2:2 + t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
    head = head.to(_header_device())
    data = t.cpu().pin_memory() if _host_stage(t) else t
    h_tag, d_tag = _tags(tag)
    pg = group.pg if isinstance(group, Group) else None
    works = [dist.isend(head, int(dst), group=pg, tag=h_tag),
             dist.isend(data, int(dst), group=pg, tag=d_tag)]

    def finish():
        # the closure keeps ``head`` and ``data`` alive until the wait
        for w in works:
            _wait(w, timeout, f"send to rank {dst} (tag {tag})")
        return None

    return _Req(finish)


def send(tensor, dst=0, group=None, sync_op=True, tag: int = 0,
         timeout: float = 120.0):
    """Send ``tensor`` to global rank ``dst`` (blocking unless
    ``sync_op`` is False, then a handle with ``wait()``)."""
    req = isend(tensor, dst, group, tag=tag, timeout=timeout)
    if not sync_op:
        return req
    req.wait()
    return None


def irecv(tensor=None, src=0, group=None, tag: int = 0,
          timeout: float = 120.0) -> _Req:
    """Start receiving from global rank ``src``; ``wait()`` returns the
    tensor (``tensor`` filled in place when given)."""
    _check_world("irecv")
    h_tag, d_tag = _tags(tag)
    pg = group.pg if isinstance(group, Group) else None
    head = torch.empty(_HEADER, dtype=torch.int64, device=_header_device())
    hw = dist.irecv(head, int(src), group=pg, tag=h_tag)
    what = f"recv from rank {src} (tag {tag})"

    def finish():
        _wait(hw, timeout, what)
        h = head.cpu()
        ndim, dtype = int(h[0]), _DTYPES[int(h[1])]
        shape = tuple(int(s) for s in h[2:2 + ndim])
        if tensor is not None:
            if tuple(tensor.shape) != shape or tensor.dtype != dtype:
                raise ValueError(f"{what}: the buffer is "
                                 f"{tuple(tensor.shape)} {tensor.dtype}, "
                                 f"the peer sent {shape} {dtype}")
            dev = tensor.device
        else:
            from . import env

            dev = env.device() or torch.device("cpu")
        staged = dev.type == "cuda" and dist.get_backend() == "gloo"
        buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if staged
               else tensor if tensor is not None and tensor.is_contiguous()
               else torch.empty(shape, dtype=dtype, device=dev))
        _wait(dist.irecv(buf, int(src), group=pg, tag=d_tag), timeout, what)
        if tensor is None:
            return buf.to(dev) if staged else buf
        if buf is not tensor:
            with torch.no_grad():
                tensor.copy_(buf)
        return tensor

    return _Req(finish)


def recv(tensor=None, src=0, group=None, sync_op=True, tag: int = 0,
         timeout: float = 120.0):
    """Receive a tensor from global rank ``src`` and return it. Without a
    buffer it lands on this rank's device (``env.device()``, the CPU
    without one); given ``tensor`` it is also filled in place."""
    req = irecv(tensor, src, group, tag=tag, timeout=timeout)
    return req if not sync_op else req.wait()


@dataclass
class P2POp:
    op: Any              # isend or irecv
    tensor: Any
    peer: int
    group: Optional[Group] = None
    tag: int = 0


def batch_isend_irecv(p2p_op_list: Sequence[P2POp]) -> List[_Req]:
    """Start a batch of :func:`isend`/:func:`irecv` (reference
    ``batch_isend_irecv``, the pipeline handshake): the sends first, so
    no peer waits on a receive whose send is queued behind it. The
    handles come back in the order of the list."""
    order = sorted(range(len(p2p_op_list)),
                   key=lambda i: p2p_op_list[i].op is not isend)
    reqs = [None] * len(p2p_op_list)
    for i in order:
        o = p2p_op_list[i]
        if o.op not in (isend, irecv):
            raise ValueError(f"P2POp.op must be isend or irecv, got {o.op}")
        reqs[i] = o.op(o.tensor, o.peer, o.group, tag=o.tag)
    return reqs


def wait(tensor, group=None, use_calc_stream: bool = True):
    """Reference ``wait`` orders the compute stream behind the
    communication stream; the port's collectives run on the current
    stream, so there is nothing to order: the identity."""
    return tensor


# ---------------------------------------------------- collectives (extra)
def _op(op):
    from .collective import _DIST_OPS, ReduceOp

    op = op or ReduceOp.SUM
    if isinstance(op, str):
        return getattr(dist.ReduceOp, _DIST_OPS[op]), op == ReduceOp.AVG
    return op, False


def reduce(tensor, dst=0, op=None, group=None):
    """Reduce ``tensor`` over the group; the result stays on the group's
    rank ``dst`` (an index into the group) and every other rank gets zeros
    (the reference's explicit form of torch's "undefined")."""
    out = tensor.detach().clone()
    where = _where(group)
    if where is None:
        return out
    pg, ranks, me = where
    dop, avg = _op(op)
    dist.all_reduce(out, op=dop, group=pg)
    if avg:
        out /= len(ranks)
    if me != dst:
        out.zero_()
    return out


def scatter(tensor, tensor_list=None, src=0, group=None, axis=0):
    """This rank's chunk of the group's rank ``src``'s input: the
    concatenation of ``tensor_list`` along ``axis`` (one chunk per rank,
    paddle's form), or with ``tensor_list=None`` ``tensor`` itself cut
    along ``axis`` (torch's). Every rank passes the same form and shapes
    (only ``src``'s values matter). The chunk is returned; in paddle's
    form ``tensor`` (a buffer of the chunk's shape) is also filled."""
    if tensor_list is not None:
        full = torch.cat([t.detach() for t in tensor_list], dim=axis)
    else:
        full = tensor.detach().clone()
    where = _where(group)
    if where is None:
        n, me = 1, 0
    else:
        pg, ranks, me = where
        n = len(ranks)
        full = full.contiguous()
        dist.broadcast(full, src=ranks[src], group=pg)
    chunk = full.shape[axis] // n
    out = full.narrow(axis, me * chunk, chunk).clone()
    if tensor_list is not None and tensor is not None \
            and tuple(tensor.shape) == tuple(out.shape):
        with torch.no_grad():
            tensor.copy_(out)
    return out


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Split ``in_tensor``'s dim 0 into one block per rank, send block j
    to rank j and concatenate what arrives (rank order). Uneven splits
    are refused, as the reference refuses them; ``out_tensor`` is filled
    in place when given."""
    for sizes in (in_split_sizes, out_split_sizes):
        if sizes and len(set(int(s) for s in sizes)) > 1:
            raise NotImplementedError(
                "alltoall_single: uneven splits are not supported; pad "
                "to equal splits")
    src = in_tensor.detach().contiguous()
    where = _where(group)
    if where is None:
        out = src.clone()
    else:
        pg, ranks, _ = where
        if src.shape[0] % len(ranks):
            raise ValueError(f"alltoall_single: dim 0 ({src.shape[0]}) "
                             f"does not split over {len(ranks)} ranks")
        out = torch.empty_like(src)
        if _host_stage(src):
            from .collective import _gloo_staged

            _gloo_staged(lambda o, i, a: dist.all_to_all_single(
                o[0], i[0], group=pg), [out], [src], False)
        else:
            dist.all_to_all_single(out, src, group=pg)
    if out_tensor is not None:
        with torch.no_grad():
            out_tensor.copy_(out)
    return out


def all_gather_object(object_list, obj, group=None,
                      timeout: Optional[float] = None):
    """Append every rank's ``obj`` to ``object_list`` in rank order (a
    collective: every rank of the group calls it). In a world of one it
    appends ``obj``. The wait is bounded by the group's timeout
    (``init_parallel_env(timeout=)``); ``timeout`` is accepted for the
    reference's signature."""
    del timeout
    where = _where(group)
    if where is None:
        object_list.append(obj)
        return object_list
    pg, ranks, _ = where
    out = [None] * len(ranks)
    dist.all_gather_object(out, obj, group=pg)
    object_list.extend(out)
    return object_list


# ------------------------------------------------------- sharding API
_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=None, segment_size=None,
                           sync_comm=False):
    """The public ZeRO entry (reference ``sharding/group_sharded.py``):
    tags the optimizer with the stage, 1, 2 or 3 for ``"os"``,
    ``"os_g"`` and ``"p_g_os"``; the stage engages when the pair reaches
    ``DistributedTrainStep`` / ``fleet.distributed_model``. Returns
    ``(model, optimizer, scaler)``."""
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {sorted(_LEVELS)}")
    optimizer._group_sharded_stage = _LEVELS[level]
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None) -> None:
    """Write ``output/model.pdparams`` (and ``model.pdopt`` with an
    optimizer) as the reference's ``framework.io.save`` does. When a
    ``DistributedTrainStep`` trains the pair, the parameters (ZeRO-3's
    shards and the mp blocks) and the optimizer state are gathered first
    (a collective: every rank of the step calls it); rank 0 writes."""
    import os

    from ..framework.io import save
    from . import env
    from .shard import step_of

    step = step_of(optimizer) if optimizer is not None else None
    if step is not None:
        sd = step.state_dict()
        params, opt_state = sd["params"], sd["opt_state"]
    else:
        params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        opt_state = None
    if env.get_rank() != 0:
        return
    os.makedirs(output, exist_ok=True)
    save(params, os.path.join(output, "model.pdparams"))
    if optimizer is not None:
        state = ({"state": opt_state} if opt_state is not None
                 else optimizer.state_dict())
        save(state, os.path.join(output, "model.pdopt"))


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Reference ``paddle.distributed.split`` creates a parallel layer in
    the static global scope on the fly. That pattern has no functional
    analogue — use the layer library directly:
    ``distributed.parallel.mp_layers.ColumnParallelLinear`` /
    ``RowParallelLinear`` / ``VocabParallelEmbedding``."""
    raise NotImplementedError(split.__doc__)


# ------------------------------------------------------- PS entry configs
@dataclass
class CountFilterEntry:
    """Admit a sparse feature only after ``count`` shows (reference
    ``entry_attr.h`` CountFilterEntry); consumed by the PS accessor's
    show-threshold."""

    count: int = 1

    def accessor_kwargs(self) -> dict:
        return {"min_show_to_keep": float(self.count)}


@dataclass
class ShowClickEntry:
    """Names the show/click input slots driving the CTR accessor's
    show/click statistics (reference ShowClickEntry)."""

    show_name: str = "show"
    click_name: str = "click"

    def accessor_kwargs(self) -> dict:
        return {"show_name": self.show_name, "click_name": self.click_name}


@dataclass
class ProbabilityEntry:
    """Admit new features with the given probability (reference
    ProbabilityEntry)."""

    probability: float = 1.0

    def accessor_kwargs(self) -> dict:
        return {"admit_probability": float(self.probability)}

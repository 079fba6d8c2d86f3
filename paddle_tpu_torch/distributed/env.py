"""Process bootstrap and environment (port of
``paddle_tpu/distributed/env.py``).

The reference joins every host into one JAX runtime. The port joins every
rank into one ``torch.distributed`` world: ``init_parallel_env`` reads the
variables ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or the ``PADDLE_*``
names the port's launcher (``distributed.launch``) sets, and calls
``init_process_group`` with an explicit backend: NCCL on the card (the
default), gloo with ``device="cpu"``. A backend that fails to initialise
raises; it is never swapped for another. A world of one needs no call at
all: every collective over an axis of size 1 is the identity.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_parallel_env", "get_rank", "get_world_size",
           "device_count", "local_device_count", "is_initialized",
           "barrier", "backend", "device"]

_state = {"device": None}


def _env_int(*names: str, default: Optional[int] = None) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None, *,
                      backend: Optional[str] = None, device=None,
                      timeout: float = 600.0) -> None:
    """Join this process to the world (idempotent).

    - ``coordinator_address`` (``host:port``), else ``PADDLE_MASTER``,
      else ``MASTER_ADDR:MASTER_PORT``: the rendezvous store;
    - ``num_processes``, else ``PADDLE_TRAINERS_NUM`` / ``WORLD_SIZE``;
    - ``process_id``, else ``PADDLE_TRAINER_ID`` / ``RANK``;
    - ``backend``: ``"nccl"`` unless ``device="cpu"`` (then ``"gloo"``).
      ``backend="gloo"`` with the card is allowed (two ranks on one card,
      where NCCL refuses): the collectives then stage what gloo cannot do
      on CUDA tensors through pinned host memory (``collective.py``).

    On the card the rank's device is ``cuda:LOCAL % device_count``, LOCAL
    being ``PADDLE_LOCAL_RANK`` (the launcher's), else ``LOCAL_RANK``
    (``torch.distributed.run``'s), else the rank.
    NCCL without a card, or a failed rendezvous, raises."""
    if dist.is_initialized():
        return
    device = torch.device(device if device is not None else "cuda")
    if backend is None:
        backend = "gloo" if device.type == "cpu" else "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_parallel_env: the NCCL backend needs a CUDA device and "
            "none is available; pass device='cpu' (gloo) to run on the "
            "CPU")
    coord = coordinator_address or os.environ.get("PADDLE_MASTER")
    if coord is None and os.environ.get("MASTER_ADDR"):
        coord = (f"{os.environ['MASTER_ADDR']}:"
                 f"{os.environ.get('MASTER_PORT', '29500')}")
    nproc = num_processes or _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE",
                                      default=1)
    pid = process_id if process_id is not None else _env_int(
        "PADDLE_TRAINER_ID", "RANK", default=0)
    if coord is None and nproc > 1:
        raise RuntimeError(
            f"init_parallel_env: a world of {nproc} needs a coordinator "
            f"address (MASTER_ADDR/MASTER_PORT)")
    if device.type == "cuda":
        local = _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=pid)
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    # a world of one rendezvouses with itself in memory
    where = (dict(store=dist.HashStore()) if coord is None
             else dict(init_method=f"tcp://{coord}"))
    dist.init_process_group(
        backend=backend, rank=pid, world_size=nproc,
        timeout=datetime.timedelta(seconds=timeout), **where)
    if dist.get_backend() != backend:
        raise RuntimeError(f"init_parallel_env: asked for {backend!r}, got "
                           f"{dist.get_backend()!r}")
    if backend == "nccl":
        # NCCL builds its communicator lazily: one all-reduce here makes a
        # refusal (e.g. two ranks on one device) raise from this call
        probe = torch.zeros(1, device=device)
        dist.all_reduce(probe)
        torch.cuda.synchronize(device)
    _state["device"] = device


def backend() -> Optional[str]:
    """The world's backend (``"nccl"``/``"gloo"``), None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def device() -> Optional[torch.device]:
    """The device ``init_parallel_env`` bound this rank to."""
    return _state["device"]


def get_rank() -> int:
    """This process's rank (0 without a world)."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def device_count() -> int:
    """Devices of the world: one per rank."""
    return get_world_size()


def local_device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def is_initialized() -> bool:
    return dist.is_initialized()


def barrier(group=None):
    """Host barrier over the world (or a process group)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    dist.barrier(group=group)

"""paddle_tpu_torch.distributed.rpc — worker-to-worker remote procedure
calls (port of ``paddle_tpu/distributed/rpc``; framework-free, so copied).

Reference parity: ``python/paddle/distributed/rpc/rpc.py`` (``init_rpc``
over a TCP master store, ``rpc_sync``/``rpc_async`` executing pickled
python callables on named workers, ``WorkerInfo`` registry, barriered
``shutdown``).
"""
from .rpc import (RpcTransportError, WorkerInfo, get_all_worker_infos,
                  get_current_worker_info, get_worker_info, init_rpc,
                  rpc_async, rpc_sync, shutdown)

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown", "get_worker_info",
           "get_all_worker_infos", "get_current_worker_info", "WorkerInfo",
           "RpcTransportError"]

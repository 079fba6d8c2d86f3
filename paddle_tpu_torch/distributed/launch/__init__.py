"""paddle_tpu_torch.distributed.launch — the multi-process job launcher
(port of ``paddle_tpu/distributed/launch``).

Reference parity: ``python/paddle/distributed/launch/`` — ``main.py:18``
CLI, ``CollectiveController`` (``controllers/collective.py``), ``Master``
rendezvous with its builtin HTTP ``KVServer``
(``controllers/master.py:27``, ``utils/kv_server.py``), ``Job/Pod/
Container`` supervision (``job/``), ``Watcher`` (``controllers/
watcher.py``), and the etcd-backed ``ElasticManager``
(``fleet/elastic/manager.py:127``).

``python -m paddle_tpu_torch.distributed.launch [flags] script.py`` starts
``--nproc_per_node`` workers (one per card) with the rank variables
``env.init_parallel_env`` reads, restarts them on failure (``--max_restarts``)
or preemption, and with ``--nnodes min:max`` keeps leased membership in
the KV store and resizes the world when a node is lost or joins.
"""
from .job import Container, Pod
from .kv_server import KVClient, KVServer
from .main import launch, main

__all__ = ["main", "launch", "KVServer", "KVClient", "Pod", "Container"]

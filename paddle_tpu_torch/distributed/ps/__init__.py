"""Parameter-server subsystem, "the one PS" (port of
``paddle_tpu/distributed/ps/__init__.py``).

Reference parity: ``paddle/fluid/distributed/ps/`` (brpc tables/services,
``ps/README.md``), ``python/paddle/distributed/ps/the_one_ps.py`` (table
construction from strategy), and the in-process ``PsLocalClient``
(``ps/service/ps_local_client.h``) that the GPU-PS path uses.

Tables are host-RAM C++ (:mod:`.table`). Two deployments:

- *Local client* (single host): one process owns all shards in-proc, zero
  RPC — the PsLocalClient trick the reference uses for GpuPS.
- *Service* (multi-host): each host runs a :class:`PsServer` process (C++
  TCP service over its table shard, ``native/src/ps_service.cc``);
  :class:`PsClient` partitions keys by hash across servers and presents the
  same table interface, so :class:`SparseEmbedding` works over the network
  unchanged. :class:`Communicator` adds the reference's sync/async/geo send
  modes (``ps/service/communicator/communicator.h``).
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional

from .embedding import (SparseEmbedding, StagedPull, callbacks_supported,
                        make_lookup)
from .coordinator import (ClientInfoAttr, Coordinator, FLClient, FLStrategy)
from .graph import (DistGraphClient, GraphDataGenerator, GraphServer,
                    GraphTable, launch_graph_servers)
from .pass_builder import PipelinedPassBuilder
from .service import (Communicator, PsClient, PsRpcError, PsServer,
                      launch_servers, shard_of)
from .table import (MemoryDenseTable, MemorySparseTable, SSDSparseTable,
                    SparseAccessorConfig)

__all__ = [
    "SparseAccessorConfig", "MemorySparseTable", "MemoryDenseTable",
    "SSDSparseTable", "PsRpcError",
    "SparseEmbedding", "StagedPull", "callbacks_supported", "make_lookup",
    "PsServer", "PsClient", "Communicator", "launch_servers", "shard_of",
    "ClientInfoAttr", "Coordinator", "FLClient", "FLStrategy",
    "GraphTable", "GraphServer", "DistGraphClient", "GraphDataGenerator",
    "launch_graph_servers", "PipelinedPassBuilder",
    "PSContext", "get_ps_context",
]


class PSContext:
    """Table registry + lifecycle — the ``the_one_ps.py`` analogue.

    ``init_server``/``init_worker`` mirror ``fleet.init_server()`` /
    ``init_worker()``; with the local client they only manage the registry
    (no network to bring up).

    ``configure_mode`` consumes ``DistributedStrategy.a_sync`` /
    ``a_sync_configs`` (reference ``the_one_ps.py`` sync/async/geo mode
    selection): tables served over a :class:`PsClient` get a
    :class:`Communicator` in the matching send mode, and
    :meth:`communicator_for` hands it out for the training loop's pushes.
    """

    def __init__(self):
        self._tables: Dict[str, MemorySparseTable] = {}
        self._running = False
        self._mode = "sync"
        self._geo_k = 4
        # live communicators as weakrefs (for flush-on-reconfigure); the
        # communicator itself is cached ON its client, so its lifetime is
        # the client's — no registry entry can outlive or pin either one
        self._comm_refs: list = []
        self._comm_gen = 0

    def configure_mode(self, strategy) -> str:
        """Derive the communicator mode from a DistributedStrategy
        (``a_sync=False`` -> sync; ``a_sync=True`` -> async; with
        ``a_sync_configs["k_steps"] > 0`` -> geo with that period).

        Reconfiguring flushes and drops any cached communicators — they
        carry the OLD mode/k_steps and must not be handed out again."""
        cfg = getattr(strategy, "a_sync_configs", None) or {}
        if getattr(strategy, "a_sync", False):
            k = int(cfg.get("k_steps", 0))
            mode = "geo" if k > 0 or cfg.get("geo") else "async"
            geo_k = max(k, 1) if mode == "geo" else 4
        else:
            mode, geo_k = "sync", 4
        if (mode, geo_k) != (self._mode, self._geo_k):
            self._drop_communicators()
        self._mode, self._geo_k = mode, geo_k
        return self._mode

    @property
    def mode(self) -> str:
        return self._mode

    def communicator_for(self, client) -> "Communicator":
        """A (cached) Communicator over ``client`` in the configured mode.

        Cached on the client object itself (not an id-keyed registry:
        CPython reuses ids after garbage collection, and a recycled id must
        never hand out a Communicator bound to a dead client's sockets).
        A generation counter invalidates caches when the mode changes."""
        cached = getattr(client, "_ps_communicator", None)
        if cached is not None:
            comm, gen = cached
            if gen == self._comm_gen:
                return comm
        comm = Communicator(client, mode=self._mode, k_steps=self._geo_k)
        client._ps_communicator = (comm, self._comm_gen)
        self._comm_refs.append(weakref.ref(comm))
        return comm

    def create_table(self, name: str,
                     accessor: Optional[SparseAccessorConfig] = None,
                     ssd_spill_dir: Optional[str] = None,
                     **accessor_kw) -> MemorySparseTable:
        if name in self._tables:
            raise ValueError(f"table {name!r} already exists")
        accessor = accessor or SparseAccessorConfig(**accessor_kw)
        if ssd_spill_dir:
            table = SSDSparseTable(ssd_spill_dir, accessor)
        else:
            table = MemorySparseTable(accessor)
        self._tables[name] = table
        return table

    def create_slot_tables(self, slot_dims: Dict[str, int],
                           **accessor_kw) -> Dict[str, MemorySparseTable]:
        """One table per feature slot with its own embedding dim — the
        per-slot-dimension capability of the reference's ``CtrDymfAccessor``
        (dynamic-dim embeddings), expressed as table-per-slot: each slot
        keeps its own accessor, LR, and shrink policy."""
        return {name: self.create_table(name, embed_dim=dim, **accessor_kw)
                for name, dim in slot_dims.items()}

    def get_table(self, name: str) -> MemorySparseTable:
        return self._tables[name]

    @property
    def tables(self) -> Dict[str, MemorySparseTable]:
        return dict(self._tables)

    def init_server(self) -> None:
        self._running = True

    def init_worker(self) -> None:
        self._running = True

    def _drop_communicators(self) -> None:
        """Flush and invalidate cached communicators; the FIRST flush
        failure re-raises — a dead drain thread means pushes were lost, and
        swallowing that would report a clean shutdown over lost gradients."""
        refs, self._comm_refs = self._comm_refs, []
        self._comm_gen += 1  # invalidate every client-side cache entry
        first_err = None
        for ref in refs:
            comm = ref()
            if comm is None:
                continue
            try:
                comm.stop()  # flush pending async/geo pushes
            except BaseException as e:
                first_err = first_err or e
        if first_err is not None:
            raise first_err

    def stop_server(self) -> None:
        try:
            self._drop_communicators()
        finally:
            self._running = False

    def save_persistables(self, dirname: str) -> None:
        """``fleet.save_persistables`` analogue: one snapshot per table."""
        import os

        os.makedirs(dirname, exist_ok=True)
        for name, table in self._tables.items():
            table.save(os.path.join(dirname, f"{name}.table"))

    def load_persistables(self, dirname: str) -> None:
        import os

        for name, table in self._tables.items():
            path = os.path.join(dirname, f"{name}.table")
            if os.path.exists(path):
                table.load(path)


_ctx = PSContext()


def get_ps_context() -> PSContext:
    return _ctx

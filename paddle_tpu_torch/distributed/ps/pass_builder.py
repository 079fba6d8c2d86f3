"""Pipelined pass building: prefetch the next pass's embedding working set
while the current pass trains (port of
``paddle_tpu/distributed/ps/pass_builder.py``).

Reference parity: ``PSGPUWrapper::BuildGPUTask`` driven by
``pre_build_thread`` (``paddle/fluid/framework/fleet/ps_gpu_wrapper.h:191,
198``): pass N trains on device-resident tables while pass N+1's feature
set is pulled from the CPU/SSD table in the background, hiding the
build latency entirely. Restated over :class:`StagedPull`: the "GPU
hashtable" is the dense ``rows`` tensor a step consumes, so building a
pass = dedup + pull; this overlaps it with training on a host thread.

Usage::

    builder = PipelinedPassBuilder(table, device="cuda")
    builder.prefetch(0, ids_of_pass(0))
    for p in range(num_passes):
        builder.prefetch(p + 1, ids_of_pass(p + 1))   # overlaps training
        rows, inv, uniq = builder.get(p)              # ready or joins
        ... train pass p with rows/inv (StagedPull.lookup) ...
        builder.push(p, row_grads)                    # table update
        builder.end_pass(p)
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from .embedding import StagedPull
from .table import MemorySparseTable

__all__ = ["PipelinedPassBuilder"]


class PipelinedPassBuilder:
    """One background build at a time (the reference also serializes its
    pre-build thread); results are cached until consumed."""

    def __init__(self, table: MemorySparseTable, device=None):
        self.table = table
        self.staged = StagedPull(table, device=device)
        self._built: Dict[int, Tuple] = {}
        self._threads: Dict[int, threading.Thread] = {}
        self._errors: Dict[int, BaseException] = {}
        self._uniq: Dict[int, np.ndarray] = {}
        self._lock = threading.Lock()
        # serializes table *lifecycle* transitions (begin_pass warm-reload
        # inside a build vs end_pass spill+evict in the foreground): either
        # order is correct because begin_pass is a merge-load that never
        # rolls back live rows, but interleaving halves of them is not
        self._table_lock = threading.Lock()

    def prefetch(self, pass_id: int, ids) -> None:
        """Start building ``pass_id`` in the background (idempotent)."""
        with self._lock:
            if pass_id in self._built or pass_id in self._threads:
                return

            ids = np.asarray(ids)

            def build():
                try:
                    with self._table_lock:
                        # warm evicted keys from the spill snapshot first —
                        # without this, an SSD table would re-initialize
                        # evicted keys fresh and silently lose training
                        if hasattr(self.table, "begin_pass"):
                            self.table.begin_pass()
                        rows, inv, uniq = self.staged.pull(ids)
                    with self._lock:
                        self._built[pass_id] = (rows, inv, uniq)
                        self._uniq[pass_id] = uniq
                except BaseException as e:
                    with self._lock:
                        self._errors[pass_id] = e

            t = threading.Thread(target=build, daemon=True)
            self._threads[pass_id] = t
            t.start()

    def get(self, pass_id: int, timeout: Optional[float] = None):
        """The built pass (joins the build thread if still running)."""
        t = self._threads.get(pass_id)
        if t is None and pass_id not in self._built:
            raise KeyError(f"pass {pass_id} was never prefetched")
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                raise TimeoutError(f"pass {pass_id} build did not finish")
        with self._lock:
            self._threads.pop(pass_id, None)
            if pass_id in self._errors:
                raise self._errors.pop(pass_id)
            return self._built.pop(pass_id)

    def push(self, pass_id: int, row_grads) -> None:
        """Push the pass's deduped row gradients back (the EndPass flush of
        trained embeddings, ``ps_gpu_wrapper.h`` EndPass)."""
        uniq = self._uniq.get(pass_id)
        if uniq is None:
            raise KeyError(f"pass {pass_id} has no pulled key set")
        with self._table_lock:
            # warm-reload first: in the pipelined order an intervening
            # end_pass may have evicted this pass's keys, and pushing into
            # FindOrInit-re-initialized rows would permanently lose their
            # trained snapshot values
            if hasattr(self.table, "begin_pass"):
                self.table.begin_pass()
            self.staged.push(uniq, row_grads)

    def end_pass(self, pass_id: int) -> None:
        with self._lock:
            self._uniq.pop(pass_id, None)
        if hasattr(self.table, "end_pass"):
            with self._table_lock:
                self.table.end_pass()

"""DataLoader worker-process machinery (port of ``paddle_tpu/io/worker.py``;
framework-free, so copied and adapted).

Batches cross process boundaries as pickled numpy; the queues are
``multiprocessing`` primitives. A worker runs only dataset and collate
code on numpy and never touches CUDA: workers are forked by default, and
a forked child of a process that has initialised CUDA cannot use it.
Tensors reach the card in the parent (the training step) or in the device
prefetch thread (``io/device_prefetch.py``).
"""
from __future__ import annotations

import dataclasses
import traceback
from typing import Any, Callable, Optional

_worker_info: Optional["WorkerInfo"] = None


@dataclasses.dataclass
class WorkerInfo:
    """Visible to dataset code inside a worker (reference ``WorkerInfo``):
    shard an IterableDataset by ``id``/``num_workers``."""

    id: int
    num_workers: int
    seed: int
    dataset: Any = None


def get_worker_info() -> Optional[WorkerInfo]:
    """Inside a worker process, the worker's info; None in the main process
    (reference ``paddle.io.get_worker_info``)."""
    return _worker_info


class _ExceptionWrapper:
    """Carry a worker exception (with its traceback text) to the parent.

    Stores only strings: pickling the exception *class* would make the
    queue's feeder thread fail silently on locally-defined exception types,
    losing the reply and hanging the parent."""

    def __init__(self, exc: BaseException):
        self.exc_type_name = type(exc).__name__
        self.msg = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))

    def reraise(self):
        raise RuntimeError(
            f"DataLoader worker raised {self.exc_type_name}:\n{self.msg}")


class _ShardDone:
    """Reply payload: this worker's shard is exhausted (carries no batch).
    The credit that got this reply yields nothing; the parent stops
    crediting the worker."""

    def __init__(self, worker_id: int):
        self.worker_id = worker_id


def worker_loop(dataset, collate_fn: Callable, index_queue, data_queue,
                worker_id: int, num_workers: int, seed: int,
                worker_init_fn: Optional[Callable], iterable_mode: bool,
                batch_size: int, drop_last: bool) -> None:
    """Worker main. Both modes are credit-driven: the parent enqueues jobs
    and the worker replies ``(task_id, payload)`` with the id echoed
    opaquely (the parent tags ids with the epoch so stale replies from an
    abandoned iterator are discardable). Map-style jobs carry sample
    indices; iterable-style jobs are bare credits, each worth one batch off
    this worker's shard iterator — bounding queued data to the outstanding
    credit count even for infinite streams."""
    global _worker_info
    _worker_info = WorkerInfo(id=worker_id, num_workers=num_workers,
                              seed=seed + worker_id, dataset=dataset)
    # a fork inherits the parent's Python signal handlers: under a
    # supervised fit that is the preemption handler, which only sets a
    # flag, so SIGTERM (the pool's terminate(), the interpreter's exit
    # sweep over daemonic children) would no longer end the worker
    import signal

    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    try:
        import random

        import numpy as np

        # reseed BOTH RNGs: fork hands every worker the parent's identical
        # stdlib-random state, and the base seed varies per pool so
        # restarted workers don't replay the same augmentation stream
        np.random.seed((seed + worker_id) % (2 ** 32))
        random.seed(seed + worker_id)
        if worker_init_fn is not None:
            worker_init_fn(worker_id)

        import pickle

        def put_batch(task_id, batch):
            # pre-pickle the batch OURSELVES: mp.Queue pickles in a feeder
            # thread where errors are swallowed and the reply silently
            # lost — the parent would hang forever. Pickling here makes an
            # unpicklable batch a catchable, reportable exception. (The
            # bytes payload re-pickles as a cheap memcpy.)
            try:
                data_queue.put((task_id, pickle.dumps(batch)))
            except BaseException as e:
                data_queue.put((task_id, _ExceptionWrapper(e)))

        it = iter(dataset) if iterable_mode else None
        exhausted = False
        while True:
            job = index_queue.get()
            if job is None:
                break
            if iterable_mode:
                task_id = job
                if exhausted:
                    data_queue.put((task_id, _ShardDone(worker_id)))
                    continue
                batch = []
                try:
                    while len(batch) < batch_size:
                        batch.append(next(it))
                except StopIteration:
                    exhausted = True
                except BaseException as e:
                    data_queue.put((task_id, _ExceptionWrapper(e)))
                    exhausted = True
                    continue
                if batch and (len(batch) == batch_size or not drop_last):
                    try:
                        put_batch(task_id, collate_fn(batch))
                    except BaseException as e:
                        data_queue.put((task_id, _ExceptionWrapper(e)))
                else:
                    data_queue.put((task_id, _ShardDone(worker_id)))
            else:
                task_id, indices = job
                try:
                    batch = collate_fn([dataset[i] for i in indices])
                except BaseException as e:
                    data_queue.put((task_id, _ExceptionWrapper(e)))
                    continue
                put_batch(task_id, batch)
    except KeyboardInterrupt:
        pass

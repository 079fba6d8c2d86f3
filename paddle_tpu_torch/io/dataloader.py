"""DataLoader (port of ``paddle_tpu/io/dataloader.py``; framework-free, so
copied and adapted).

- ``num_workers=0``: a background thread produces numpy batches
  (``_PrefetchIterator``).
- ``num_workers>0``: real worker *processes* (GIL-free transforms), forked
  by default (``mp_context``); batches return as pickled numpy, in sampler
  order. Workers never touch CUDA (``io/worker.py``).

The loader stops at numpy, as the reference's does. The host-to-device
hop is the training step's, or ``io/device_prefetch.py``'s: pinned host
memory and a side CUDA stream, overlapped with the step.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Iterable

import numpy as np

from .dataset import BatchSampler, Dataset, IterableDataset
from .worker import _ExceptionWrapper, _ShardDone, worker_loop


def default_collate_fn(batch):
    """Stack samples into batch arrays, mirroring paddle's default collate."""
    if len(batch) == 0:
        raise ValueError(
            "default_collate_fn got an empty batch; check the dataset / "
            "sampler (a batch must contain at least one sample)")
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return type(sample)(default_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (bool, np.bool_)):
        # before the int branch: bool IS an int subclass and would upcast
        return np.asarray(batch, np.bool_)
    if isinstance(sample, np.generic):
        # numpy scalar: preserve its dtype instead of python-number rules
        return np.asarray(batch, sample.dtype)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    return np.stack([np.asarray(s) for s in batch])


_PUT_POLL_S = 0.05


class _PrefetchState:
    """State shared between a prefetch iterator and its producer thread.

    Split out so the THREAD never holds a reference to the iterator: an
    abandoned iterator then actually becomes garbage, its ``__del__`` runs
    ``close()``, and the thread (referencing only this state) unblocks.
    """

    __slots__ = ("err", "producer_busy_s", "closed")

    def __init__(self):
        self.err = None
        self.producer_busy_s = 0.0   # producer time in next()+transform
        self.closed = threading.Event()


def _prefetch_worker(producer, q, sentinel, transform, state):
    import time as _time

    def put(item) -> bool:
        # bounded put that aborts instead of blocking forever once the
        # consumer has walked away (the close() handshake)
        while not state.closed.is_set():
            try:
                q.put(item, timeout=_PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    try:
        it = iter(producer)
        while not state.closed.is_set():
            t0 = _time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                break
            if transform is not None:
                item = transform(item)
            state.producer_busy_s += _time.perf_counter() - t0
            if not put(item):
                return
    except BaseException as e:  # propagate into consumer
        state.err = e
    finally:
        put(sentinel)


class _PrefetchIterator:
    """Bounded background-thread prefetch.

    - ``transform`` (optional) runs in the producer thread — the hook
      :class:`paddle_tpu_torch.io.device_prefetch.DevicePrefetchIterator` uses to
      overlap host->device transfer with consumer compute. It must not
      close over this iterator (see :class:`_PrefetchState`).
    - A producer exception is delivered on the consumer's NEXT ``__next__``
      (already-queued good batches are dropped), not after the queue drains.
    - ``close()`` unblocks and joins the thread; it runs from ``__del__``
      and on exhaustion/error, so an abandoned iterator cannot leak a
      thread parked on the bounded queue.
    """

    def __init__(self, producer: Iterable, depth: int, transform=None):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._sentinel = object()
        self._state = _PrefetchState()
        self._done = False
        self._batches = 0
        self._stall_s = 0.0          # consumer time blocked waiting for data
        self._thread = threading.Thread(
            target=_prefetch_worker,
            args=(producer, self._queue, self._sentinel, transform,
                  self._state),
            daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        import time as _time

        if self._done:
            raise StopIteration
        if self._state.err is not None:
            # prompt delivery: don't make the consumer chew through queued
            # batches before learning the epoch already failed
            err, self._state.err = self._state.err, None
            self.close()
            raise err
        t0 = _time.perf_counter()
        item = self._queue.get()
        self._stall_s += _time.perf_counter() - t0
        if item is self._sentinel:
            if self._state.err is not None:
                err, self._state.err = self._state.err, None
                self.close()
                raise err
            self.close()
            raise StopIteration
        self._batches += 1
        return item

    def stats(self) -> dict:
        """Pipeline health counters: batches delivered, consumer stall
        seconds (input-bound time), producer busy seconds."""
        return {"batches": self._batches,
                "consumer_stall_s": self._stall_s,
                "producer_busy_s": self._state.producer_busy_s}

    def close(self):
        """Unblock and join the producer thread (idempotent)."""
        self._done = True
        if self._state.closed.is_set():
            return
        self._state.closed.set()
        # drain so a producer blocked mid-put observes the close flag
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=_PUT_POLL_S)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _Hole:
    """Reorder-buffer slot for a credit that produced no batch."""


_HOLE = _Hole()


class _WorkerPool:
    """A set of worker processes plus their queues. Owned by exactly one
    live iterator at a time (its ``epoch`` tag disambiguates stale replies
    left behind by an abandoned predecessor on a persistent pool)."""

    def __init__(self, loader: "DataLoader", base_seed: int):
        import warnings

        ctx = loader._mp_ctx()
        self.num_workers = loader.num_workers
        self.index_queues = [ctx.Queue() for _ in range(self.num_workers)]
        self.data_queue = ctx.Queue()
        self.epoch_counter = 0
        self.workers = []
        for wid in range(self.num_workers):
            p = ctx.Process(
                target=worker_loop,
                args=(loader.dataset, loader.collate_fn,
                      self.index_queues[wid], self.data_queue, wid,
                      self.num_workers, base_seed, loader.worker_init_fn,
                      loader._iterable_mode,
                      loader.batch_size if loader._iterable_mode else 0,
                      loader.drop_last if loader._iterable_mode else False),
                daemon=True)
            with warnings.catch_warnings():
                # Python warns on fork in a multi-threaded process (CUDA's
                # and the prefetch threads): the workers run only numpy and
                # dataset code and never enter the CUDA runtime. Users who
                # need full isolation can pass mp_context="spawn" or
                # "forkserver".
                warnings.filterwarnings(
                    "ignore", message=".*fork.*", category=RuntimeWarning)
                warnings.filterwarnings(
                    "ignore", message=".*fork.*", category=DeprecationWarning)
                p.start()
            self.workers.append(p)

    def shutdown(self):
        if self.workers is None:
            return
        for q in self.index_queues:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for w in self.workers:
            w.join(timeout=5.0)
            if w.is_alive():
                w.terminate()
        for q in self.index_queues + [self.data_queue]:
            q.close()
        self.workers = None

    @property
    def alive(self):
        return self.workers is not None


class _MultiprocessIterator:
    """Worker-pool iterator (reference ``_DataLoaderIterMultiProcess``).

    Credit-driven in both modes: at most ``prefetch_factor * num_workers``
    tasks are outstanding, bounding queued batches even for infinite
    iterable datasets. Task ids are ``(epoch, idx)`` so replies from an
    abandoned predecessor on a reused persistent pool are recognizably
    stale and dropped. Map-style results reassemble in sampler order
    through the reorder buffer — output order is identical to the
    single-process loader. Iterable-style workers answer each credit with
    the next batch of their own shard (shard by :func:`get_worker_info`
    inside the dataset), interleaving round-robin.

    Pool ownership: each iterator owns its pool exclusively. Non-persistent
    loaders build a fresh pool per iterator (concurrent iterators work,
    like the single-process path). A persistent loader caches one pool and
    hands it to the newest iterator — creating a new iterator *invalidates*
    the previous one (iterating it raises), because two consumers of one
    data queue would silently eat each other's replies.
    """

    def __init__(self, loader: "DataLoader", pool: _WorkerPool,
                 owns_pool: bool):
        self._loader = loader
        self._pool = pool
        self._owns_pool = owns_pool
        self._num_workers = loader.num_workers
        self._timeout = loader.timeout or None
        self._iterable = loader._iterable_mode
        self._invalidated = False
        self._exhausted = False
        self._epoch = pool.epoch_counter
        pool.epoch_counter += 1
        self._send_idx = 0       # next credit to issue
        self._rcvd_idx = 0       # next slot to yield
        self._reorder = {}       # idx -> batch | _HOLE | _ExceptionWrapper
        self._active = set(range(self._num_workers))  # accepting credits
        self._rr = 0
        self._sampler_iter = (None if self._iterable
                              else iter(loader.batch_sampler))
        for _ in range(loader.prefetch_factor * self._num_workers):
            if not self._enqueue_next():
                break

    def _enqueue_next(self) -> bool:
        if self._iterable:
            if not self._active:
                return False
            order = sorted(self._active)
            wid = order[self._rr % len(order)]
            self._rr += 1
            self._pool.index_queues[wid].put((self._epoch, self._send_idx))
        else:
            try:
                indices = next(self._sampler_iter)
            except StopIteration:
                return False
            wid = self._send_idx % self._num_workers
            self._pool.index_queues[wid].put(
                ((self._epoch, self._send_idx), list(indices)))
        self._send_idx += 1
        return True

    def __iter__(self):
        return self

    def _get(self):
        while True:
            dead = [w for w in self._pool.workers if not w.is_alive()]
            try:
                return self._pool.data_queue.get(
                    timeout=self._timeout if self._timeout else 5.0)
            except queue.Empty:
                if dead:
                    raise RuntimeError(
                        f"DataLoader worker(s) died unexpectedly "
                        f"(pids {[w.pid for w in dead]})")
                if self._timeout:
                    raise RuntimeError(
                        f"DataLoader timed out after {self._timeout}s")

    def _finish(self):
        self._exhausted = True
        if self._owns_pool:
            self._pool.shutdown()
        elif self._loader._active_iter is self:
            self._loader._active_iter = None

    def __next__(self):
        if self._invalidated:
            raise RuntimeError(
                "this DataLoader iterator was invalidated because a newer "
                "iterator took over the persistent worker pool; do not "
                "interleave two iterators of a persistent_workers loader")
        if self._exhausted:
            raise StopIteration
        while True:
            if self._rcvd_idx in self._reorder:
                payload = self._reorder.pop(self._rcvd_idx)
                self._rcvd_idx += 1
                self._enqueue_next()
                if payload is _HOLE:
                    continue
                if isinstance(payload, _ExceptionWrapper):
                    payload.reraise()
                return payload
            if self._rcvd_idx >= self._send_idx:
                # nothing outstanding, nothing more to issue
                self._finish()
                raise StopIteration
            tag, payload = self._get()
            epoch, idx = tag
            if epoch != self._epoch:
                continue  # stale reply from an abandoned predecessor
            if isinstance(payload, _ShardDone):
                self._active.discard(payload.worker_id)
                payload = _HOLE
            elif isinstance(payload, bytes):
                # batches arrive pre-pickled (see worker.put_batch)
                import pickle

                payload = pickle.loads(payload)
            self._reorder[idx] = payload

    def close(self):
        """Stop early: an owned pool's workers are shut down now rather
        than when the iterator is collected (a generator delegating to
        this iterator closes it too)."""
        if not self._exhausted:
            self._finish()

    def __del__(self):
        try:
            if self._owns_pool and not self._exhausted:
                self._pool.shutdown()
        except Exception:
            pass


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=0, worker_init_fn=None,
                 persistent_workers=False, mp_context=None, seed=0,
                 pad_batches=False, length_buckets=None, length_fields=None,
                 pad_value=0):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)
        self.use_buffer_reader = use_buffer_reader
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self.seed = seed
        self._mp_context_name = mp_context
        self._mp = None
        self._pool = None          # persistent pool cache
        self._active_iter = None   # newest iterator on the persistent pool
        self._epoch_seed = 0
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
            self.drop_last = getattr(batch_sampler, "drop_last", drop_last)
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size, drop_last=drop_last)
            self.batch_size = batch_size
            self.drop_last = drop_last
        self.pad_batches = bool(pad_batches)
        self.length_buckets = tuple(length_buckets) if length_buckets else None
        if self.pad_batches or self.length_buckets:
            from .batching import PaddedBatcher

            # shape-stable stream: the wrapper is picklable, so worker
            # processes pad/bucket on their side of the queue too
            self.collate_fn = PaddedBatcher(
                self.collate_fn, batch_size=self.batch_size,
                pad_batches=self.pad_batches,
                length_buckets=self.length_buckets,
                length_fields=length_fields, pad_value=pad_value)

    # ------------------------------------------------- worker lifecycle
    def _mp_ctx(self):
        # lazy: num_workers=0 loaders must construct on platforms without
        # fork; "fork" matches the reference's Linux default — workers run
        # only numpy/dataset code, never the parent's CUDA runtime
        if self._mp is None:
            self._mp = mp.get_context(self._mp_context_name or "fork")
        return self._mp

    def _next_base_seed(self) -> int:
        # vary per pool so restarted (non-persistent) workers don't replay
        # identical augmentation streams every epoch; persistent workers get
        # epoch diversity for free from their continuing RNG state
        base = self.seed + self._epoch_seed * 1000003
        self._epoch_seed += 1
        return base

    def _shutdown_workers(self):
        """Tear down the persistent pool (no-op for non-persistent loaders,
        whose pools die with their iterators)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        self._active_iter = None

    def __del__(self):
        try:
            self._shutdown_workers()
        except Exception:
            pass

    # ------------------------------------------------------- iteration
    def _produce(self):
        if self._iterable_mode:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        if self.num_workers > 0:
            persistent = self.persistent_workers and not self._iterable_mode
            if not persistent:
                # fresh pool per iterator: concurrent iterators each get
                # their own queues (iterable workers also hold per-epoch
                # stream state, so they always restart)
                return _MultiprocessIterator(
                    self, _WorkerPool(self, self._next_base_seed()),
                    owns_pool=True)
            if self._pool is None or not self._pool.alive:
                self._pool = _WorkerPool(self, self._next_base_seed())
            if self._active_iter is not None:
                # newest iterator takes the pool; the predecessor would eat
                # its replies off the shared data queue, so invalidate it
                self._active_iter._invalidated = True
            it = _MultiprocessIterator(self, self._pool, owns_pool=False)
            self._active_iter = it
            return it
        if self.use_buffer_reader:
            return _PrefetchIterator(self._produce(),
                                     depth=self.prefetch_factor * max(self.num_workers, 1))
        return iter(self._produce())

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

"""Async host-to-device prefetch: overlap the H2D copy with the step (port
of ``paddle_tpu/io/device_prefetch.py``).

The step consumes batch N while a background thread already copies batch
N+1. Where the reference issues an (asynchronous) ``jax.device_put``, the
producer thread here copies each array leaf into pinned host memory,
issues ``.to(device, non_blocking=True)`` on a dedicated CUDA stream and
records an event after the batch's last copy. It then waits for that
event before it queues the batch, so a pinned buffer is never released
while its copy still reads it (the thread blocks, the consumer does not).
The consumer makes its current stream wait on the event and marks every
tensor of the batch as used on that stream (``record_stream``), so the
caching allocator does not hand a batch's memory to the side stream again
while the step still reads it.

Usage::

    it = prefetch_to_device(loader, depth=2)          # the card
    it = prefetch_to_device(loader, device="cpu")     # the tests' path
    for batch in it:
        loss = step(batch)
    it.close()   # also runs on exhaustion / GC

Each copy runs under the producer thread's ``h2d_prefetch`` profiler
range. ``it.stats()`` reports consumer stall seconds — the direct measure of an
input-bound pipeline — and the batches delivered, with the reference's
keys. Sharded landing: with ``sharding=`` (a
``distributed.checkpoint.Sharding``, the mesh and a ``PartitionSpec``) or
``mesh=`` with ``spec=``, each batch is the GLOBAL batch and every rank
lands only its slice of each leaf (the spec clipped to the leaf's rank,
e.g. ``P(("dp", "sdp"))`` splits dim 0 over the data axes) on its own
device, as the reference's ``make_array_from_process_local_data`` lands
each host's part.

    it = prefetch_to_device(loader, mesh=mesh, spec=P(("dp", "sdp")))
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from .. import default_device
from ..framework.tree import tree_leaves, tree_map
from ..profiler import RecordEvent
from .dataloader import _PrefetchIterator

__all__ = ["DevicePrefetchIterator", "prefetch_to_device"]


def _tensors(batch) -> list:
    return [x for x in tree_leaves(batch) if isinstance(x, torch.Tensor)]


def _as_host_tensor(x):
    """An array leaf as a CPU tensor (numpy arrays and scalars, tensors);
    None for any other leaf, which rides through as it is."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x))
    return None


def _to_cpu(x):
    t = _as_host_tensor(x)
    return x if t is None else t


def _cuda_transform(device: torch.device):
    """The producer thread's H2D copy: ``batch -> (device batch, event)``.
    A plain closure, not a bound method: the producer thread must not hold
    a reference to the iterator (see dataloader._PrefetchState)."""
    stream = torch.cuda.Stream(device=device)

    def to_device(batch):
        pinned = []

        def copy(x):
            t = _as_host_tensor(x)
            if t is None:
                return x
            if t.device.type == "cuda":
                return t
            host = t.pin_memory()
            pinned.append(host)
            return host.to(device, non_blocking=True)

        with torch.cuda.stream(stream):
            out = tree_map(copy, batch)
            event = torch.cuda.Event()
            event.record(stream)
        # hold the pinned buffers until their copies are done; only this
        # thread waits
        event.synchronize()
        del pinned
        return out, event

    return to_device


def _slice_transform(sharding):
    """``batch -> this rank's slice of each array leaf`` under
    ``sharding`` (its spec clipped to each leaf's rank): host tensors, so
    only the slice is copied to the device."""
    from ..convert import shard_tensor
    from ..distributed.mesh import PartitionSpec

    mesh, spec = sharding.mesh, sharding.spec

    def leaf(x):
        t = _as_host_tensor(x)
        if t is None or t.ndim == 0:
            return x if t is None else t
        clipped = PartitionSpec(*list(spec)[:t.ndim],
                                blocks=getattr(spec, "blocks", 1))
        return shard_tensor(t, clipped, mesh).contiguous()

    return lambda batch: tree_map(leaf, batch)


class DevicePrefetchIterator(_PrefetchIterator):
    """Double-buffered device prefetch over any host-batch iterable.

    ``depth`` bounds the number of batches copied ahead of the consumer
    (2 = classic double buffering). ``device=None`` means ``cuda``, as at
    every entry point of the port; ``device="cpu"`` turns the leaves into
    CPU tensors in the producer thread (the tests' plain path).
    ``close()`` (also called on exhaustion, error delivery, and GC)
    unblocks and joins the thread. ``sharding`` (or ``mesh`` with
    ``spec``) lands each rank's slice of the global batch only (see the
    module docstring).
    """

    def __init__(self, producer: Iterable, depth: int = 2, sharding=None,
                 mesh=None, device=None, spec=None):
        if sharding is None and mesh is not None:
            if spec is None:
                raise ValueError(
                    "DevicePrefetchIterator(mesh=...) needs spec= (e.g. "
                    "P(('dp', 'sdp')) for the batch axis), or pass "
                    "sharding= directly")
            from ..distributed.checkpoint import Sharding

            sharding = Sharding(mesh, spec)
        self._sharding = sharding
        self._device = default_device(device)
        self._on_cuda = self._device.type == "cuda"
        if self._on_cuda:
            copy = _cuda_transform(self._device)
        else:
            def copy(batch):
                return tree_map(_to_cpu, batch)
        slicer = _slice_transform(sharding) if sharding is not None else None

        # a plain closure, not a bound method (see _cuda_transform); each
        # copy runs under the producer thread's ``h2d_prefetch`` range
        def transform(batch):
            with RecordEvent("h2d_prefetch"):
                if slicer is not None:
                    batch = slicer(batch)
                return copy(batch)

        super().__init__(producer, depth=depth, transform=transform)

    def __next__(self):
        item = super().__next__()
        if not self._on_cuda:
            return item
        batch, event = item
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(event)
        for t in _tensors(batch):
            if t.device.type == "cuda":
                t.record_stream(consumer)
        return batch


def prefetch_to_device(data: Iterable, depth: int = 2, sharding=None,
                       mesh=None, device=None,
                       spec=None) -> DevicePrefetchIterator:
    """Wrap an iterable of host batches in a :class:`DevicePrefetchIterator`."""
    return DevicePrefetchIterator(data, depth=depth, sharding=sharding,
                                  mesh=mesh, device=device, spec=spec)

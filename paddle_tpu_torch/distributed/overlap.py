"""Bucketed gradient reduction and ZeRO weight-update sharding (port of
``paddle_tpu/distributed/overlap.py:47-182``).

The host-side schedule is the reference's, kept as it is:

- **Bucketing**: parameters grouped into size-targeted buckets in
  *reverse-backward order* (the order their gradients are produced), so
  the last declared parameter's bucket is ready first
  (:func:`bucket_order`, :func:`build_buckets`);
- **Weight-update sharding**: under ZeRO the update of each parameter
  runs on one "sdp" shard of it, on the first dimension the axis divides
  (:func:`shard_first_free_dim`, shared with ``shard.opt_state_specs`` so
  a parameter's update shard and its moment shards land on the same
  dimension; :func:`weight_update_specs`).

Where the reference pins each bucket's reduction as a schedulable unit of
one XLA program, the port issues real asynchronous collectives:
:class:`BucketedReduce` receives each gradient as autograd produces it
(from a hook on the parameter), issues a bucket's collectives as soon as
the bucket is complete (buckets strictly in order, so every rank issues
the same collectives in the same order), and ``finish()`` waits for all
of them before the update. :func:`bucketed_reduce` runs the same schedule
on gradients that already exist.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import PartitionSpec

__all__ = ["GradBucket", "build_buckets", "bucket_order",
           "shard_first_free_dim", "weight_update_specs",
           "BucketedReduce", "bucketed_reduce"]


@dataclass(frozen=True)
class GradBucket:
    """One schedulable reduction unit: ``names`` in reverse-backward
    order, ``bytes`` the summed grad payload."""

    index: int
    names: Tuple[str, ...]
    bytes: int = 0

    def to_dict(self) -> dict:
        return {"bucket": self.index, "params": list(self.names),
                "bytes": int(self.bytes)}


def bucket_order(names: Sequence[str]) -> List[str]:
    """Reverse-backward order: grads are produced roughly in reverse
    declaration order during the backward pass, so the LAST declared
    parameter's bucket is ready (and its collective issuable) first."""
    return list(reversed(list(names)))


def build_buckets(sizes: Dict[str, int], bucket_bytes: int,
                  bucket_count: Optional[int] = None) -> List[GradBucket]:
    """Deterministic size-targeted bucket assignment.

    ``sizes`` maps parameter path -> grad payload bytes, in declaration
    order (a plain dict preserves it); buckets are cut greedily over
    :func:`bucket_order` with ``bucket_bytes`` as a CAP (the DDP Reducer
    semantic): a bucket closes before an item would push it past the
    target, so only a single oversized param ever exceeds it.
    ``bucket_count`` overrides the size target: the target becomes
    ``ceil(total / N)``.
    """
    order = bucket_order(list(sizes))
    if not order:
        return []
    total = sum(int(sizes[n]) for n in order)
    if bucket_count is not None and bucket_count > 0:
        bucket_bytes = max(1, -(-total // int(bucket_count)))
    bucket_bytes = max(1, int(bucket_bytes))
    buckets: List[GradBucket] = []
    names: List[str] = []
    acc = 0
    for name in order:
        size = int(sizes[name])
        if names and acc + size > bucket_bytes:
            buckets.append(GradBucket(len(buckets), tuple(names), acc))
            names, acc = [], 0
        names.append(name)
        acc += size
    if names:
        buckets.append(GradBucket(len(buckets), tuple(names), acc))
    return buckets


def shard_first_free_dim(spec: Sequence, shape: Sequence[int], axis: str,
                         mesh) -> Tuple[PartitionSpec, bool]:
    """THE weight-update dim rule (shared by ``shard.opt_state_specs``
    and :func:`weight_update_specs`, so moments and params shard the
    same dim): add ``axis`` on the first unsharded dim it divides.
    Returns ``(spec, True)`` on success or when the spec already uses
    ``axis``, and ``(spec unchanged, False)`` when no divisible dim
    exists."""
    blocks = getattr(spec, "blocks", 1)
    spec = list(spec) + [None] * (len(shape) - len(list(spec)))
    used = set()
    for s in spec:
        if isinstance(s, (tuple, list)):
            used.update(s)
        elif s is not None:
            used.add(s)
    if axis in used:
        return PartitionSpec(*spec, blocks=blocks), True
    ax = mesh.shape[axis]
    for i in range(len(shape)):
        if spec[i] is None and shape[i] % ax == 0 and shape[i] >= ax:
            spec[i] = axis
            return PartitionSpec(*spec, blocks=blocks), True
    return PartitionSpec(*spec, blocks=blocks), False


def weight_update_specs(param_specs: Dict[str, PartitionSpec],
                        shapes: Dict[str, Sequence[int]], axis: Optional[str],
                        mesh,
                        on_fallback: Optional[Callable[[str], None]] = None
                        ) -> Dict[str, PartitionSpec]:
    """Per-param spec of the SHARDED region of the step — grads after
    reduce-scatter, params during ``optimizer.update`` — i.e. the param
    spec with ``axis`` added on the first divisible dim (``shapes`` are
    the full shapes). A param with no divisible dim stays at its base spec
    (replicated update for that leaf) and is reported through
    ``on_fallback``."""
    if not axis or axis not in mesh.shape:
        return dict(param_specs)
    out = {}
    for name, base in param_specs.items():
        shape = shapes[name]
        if len(shape) == 0:
            out[name] = base
            continue
        spec, ok = shard_first_free_dim(base, shape, axis, mesh)
        out[name] = spec
        if not ok and on_fallback is not None:
            on_fallback(name)
    return out


class BucketedReduce:
    """The reduction schedule of one step.

    ``issue(names, grads)`` starts the collectives of one bucket (``grads``
    ``{name: tensor}``) and returns a handle whose ``wait()`` gives the
    reduced ``{name: tensor}``. :meth:`arrive` takes each gradient as it is
    produced; a bucket is issued when all its gradients are there and
    every bucket before it was issued. :meth:`finish` issues what is left
    (a parameter that took no gradient reduces zeros, from ``zeros(name)``)
    and waits for every bucket."""

    def __init__(self, buckets: Sequence[GradBucket],
                 issue: Callable[[Tuple[str, ...], Dict[str, torch.Tensor]],
                                 object],
                 zeros: Callable[[str], torch.Tensor]):
        self.buckets = list(buckets)
        self._issue = issue
        self._zeros = zeros
        self._ready: Dict[str, torch.Tensor] = {}
        self._next = 0
        self._handles: List[object] = []

    def arrive(self, name: str, grad: torch.Tensor) -> None:
        self._ready[name] = grad
        while (self._next < len(self.buckets)
               and all(n in self._ready
                       for n in self.buckets[self._next].names)):
            self._issue_next()

    def _issue_next(self) -> None:
        bucket = self.buckets[self._next]
        grads = {n: self._ready.pop(n) if n in self._ready
                 else self._zeros(n) for n in bucket.names}
        self._handles.append(self._issue(bucket.names, grads))
        self._next += 1

    @property
    def issued(self) -> int:
        """Buckets issued so far."""
        return self._next

    def finish(self) -> Dict[str, torch.Tensor]:
        while self._next < len(self.buckets):
            self._issue_next()
        out: Dict[str, torch.Tensor] = {}
        for h in self._handles:
            out.update(h.wait())
        self._handles = []
        return out


def bucketed_reduce(grads: Dict[str, torch.Tensor],
                    buckets: Sequence[GradBucket],
                    issue) -> Dict[str, torch.Tensor]:
    """Reduce existing gradients bucket by bucket (reverse-backward
    order), every bucket issued before the first wait: the schedule of
    :class:`BucketedReduce` without the hooks."""
    red = BucketedReduce(buckets, issue, lambda n: torch.zeros_like(grads[n]))
    for b in buckets:
        for n in b.names:
            red.arrive(n, grads[n])
    return red.finish()

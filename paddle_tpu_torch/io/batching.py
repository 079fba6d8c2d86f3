"""Shape stabilization: tail-batch padding and length bucketing (port of
``paddle_tpu/io/batching.py``; framework-free, so copied and adapted).

The reference pads to a bounded set of shapes because every novel batch
shape recompiles its XLA step; the port keeps the same stream, so a padded
fit sees the same batches, masks and losses as the reference's, and the
serving path runs a bounded set of prefill shapes.

- **tail padding** — a short final batch is padded up to ``batch_size`` by
  repeating its last sample (real data, so losses/metrics stay finite) and
  a boolean validity mask is appended so consumers can discard the filler;
- **length bucketing** — each sample's leading (sequence) axis is rounded
  up to the smallest of a fixed set of ``length_buckets``. Sequences
  longer than the largest bucket round up to the next multiple of it,
  keeping the shape set bounded either way.

The batcher wraps any collate_fn and is picklable, so it rides into
DataLoader worker processes unchanged. It is wired up as
``DataLoader(pad_batches=..., length_buckets=...)`` and surfaced through
``hapi.Model.fit``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["PaddedBatcher", "bucket_for", "pad_to_length"]


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Deterministic bucket assignment: the smallest bucket >= ``length``.

    Beyond the largest bucket, lengths round up to the next multiple of it
    (a bounded overflow ladder rather than an error or an unbounded shape
    set). Buckets are sorted internally, so declaration order is free.
    """
    if not buckets:
        return length
    srt = sorted(int(b) for b in buckets)
    if srt[0] <= 0:
        raise ValueError(f"length_buckets must be positive, got {buckets}")
    for b in srt:
        if length <= b:
            return b
    top = srt[-1]
    return ((length + top - 1) // top) * top


def pad_to_length(arr: np.ndarray, length: int, pad_value=0) -> np.ndarray:
    """Pad ``arr`` along axis 0 up to ``length`` with ``pad_value``."""
    arr = np.asarray(arr)
    if arr.ndim == 0 or arr.shape[0] >= length:
        return arr
    widths = [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=pad_value)


def _sample_arrays(sample):
    """Flatten one sample into its ndarray leaves (tuple/list/dict aware)."""
    if isinstance(sample, (tuple, list)):
        out = []
        for s in sample:
            out.extend(_sample_arrays(s))
        return out
    if isinstance(sample, dict):
        out = []
        for k in sorted(sample):
            out.extend(_sample_arrays(sample[k]))
        return out
    return [np.asarray(sample)]


def _map_sample(sample, fn):
    """Apply ``fn`` to each ndarray leaf of a sample, preserving structure."""
    if isinstance(sample, (tuple, list)):
        return type(sample)(_map_sample(s, fn) for s in sample)
    if isinstance(sample, dict):
        return {k: _map_sample(v, fn) for k, v in sample.items()}
    return fn(np.asarray(sample))


class PaddedBatcher:
    """Collate wrapper that emits shape-stable batches.

    Parameters
    ----------
    collate_fn : the underlying collate (``default_collate_fn`` by default;
        resolved lazily to avoid an import cycle with dataloader.py).
    batch_size : target batch size; short batches are padded up to it.
    pad_batches : pad the tail batch and append a bool validity mask of
        shape ``(batch_size,)`` as the LAST element of the batch tuple
        (``emit_mask=False`` pads silently without the mask).
    length_buckets : fixed set of lengths the samples' leading axis is
        rounded up to (see :func:`bucket_for`). ``None`` disables.
    length_fields : which top-level elements of a tuple/list sample carry
        the variable-length sequence axis (e.g. ``(0,)`` for
        ``(ids, soft_label)``). ``None`` buckets every rank>=1 array leaf —
        right for ``(ids, labels)``-style LM samples, wrong for samples
        mixing sequences with fixed-size vectors/images, which would be
        padded too; name the sequence fields explicitly there.
    pad_value : fill for bucketed sequence positions (default 0).
    emit_mask : append the validity mask (only meaningful with
        ``pad_batches``).
    """

    def __init__(self, collate_fn: Optional[Callable] = None,
                 batch_size: Optional[int] = None, pad_batches: bool = True,
                 length_buckets: Optional[Sequence[int]] = None,
                 length_fields: Optional[Sequence[int]] = None,
                 pad_value=0, emit_mask: bool = True):
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.pad_batches = bool(pad_batches)
        self.length_buckets = (tuple(sorted(int(b) for b in length_buckets))
                               if length_buckets else None)
        self.length_fields = (tuple(length_fields)
                              if length_fields is not None else None)
        self.pad_value = pad_value
        self.emit_mask = emit_mask

    def _collate(self, batch):
        if self.collate_fn is not None:
            return self.collate_fn(batch)
        from .dataloader import default_collate_fn

        return default_collate_fn(batch)

    def _seq_parts(self, sample):
        """The sub-structure(s) of a sample that carry the sequence axis."""
        if (self.length_fields is not None
                and isinstance(sample, (tuple, list))):
            return [sample[i] for i in self.length_fields]
        return [sample]

    def _bucket_samples(self, batch):
        # batch-level bucket: every sample in the batch lands on the bucket
        # of the LONGEST sample, so one batch yields one shape
        max_len = 0
        for sample in batch:
            for part in self._seq_parts(sample):
                for arr in _sample_arrays(part):
                    if arr.ndim >= 1:
                        max_len = max(max_len, arr.shape[0])
        target = bucket_for(max_len, self.length_buckets)

        def pad(arr):
            if arr.ndim >= 1:
                return pad_to_length(arr, target, self.pad_value)
            return arr

        def bucket_sample(s):
            if self.length_fields is None or not isinstance(s, (tuple, list)):
                return _map_sample(s, pad)
            fields = set(self.length_fields)
            return type(s)(_map_sample(part, pad) if i in fields else part
                           for i, part in enumerate(s))

        return [bucket_sample(s) for s in batch]

    def __call__(self, batch):
        if not batch:
            raise ValueError("PaddedBatcher got an empty batch")
        batch = list(batch)
        if self.length_buckets:
            batch = self._bucket_samples(batch)
        n_real = len(batch)
        target = self.batch_size
        if self.pad_batches and target and n_real < target:
            # repeat the last sample: filler is drawn from the data
            # distribution, so an unmasked loss stays finite and sane
            batch = batch + [batch[-1]] * (target - n_real)
        out = self._collate(batch)
        if self.pad_batches and self.emit_mask:
            mask = np.zeros(len(batch), np.bool_)
            mask[:n_real] = True
            if isinstance(out, tuple):
                out = out + (mask,)
            elif isinstance(out, list):
                out = out + [mask]
            elif isinstance(out, dict):
                out = dict(out)
                out["valid_mask"] = mask
            else:
                out = (out, mask)
        return out

"""InMemoryDataset — the industrial slot-record training feed (port of
``paddle_tpu/io/slot_dataset.py``).

Reference parity: ``python/paddle/distributed/fleet/dataset/dataset.py:349``
(``InMemoryDataset``: ``load_into_memory``/``local_shuffle``/
``global_shuffle``/``release_memory``) over the C++
``MultiSlotDataset``/``SlotRecordInMemoryDataFeed``
(``data_set.h:350``, ``data_feed.h:1615``). Parsing/shuffle/batching run
in the native C++ store (:mod:`paddle_tpu_torch.native`); batches come
out padded to static [batch, max_per_slot] shapes, feature signs as int64
numpy arrays throughout.

Text format per line (tab separated)::

    <label>\\t<slot_id>:<sign>[,<sign>...]\\t...
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native

__all__ = ["InMemoryDataset", "QueueDataset", "BoxPSDataset"]


class InMemoryDataset:
    def __init__(self, slots: Sequence[int], batch_size: int = 256,
                 max_per_slot: int = 16, pad_value: int = -1,
                 drop_last: bool = True):
        self.slots = [int(s) for s in slots]
        self.batch_size = batch_size
        self.max_per_slot = max_per_slot
        self.pad_value = pad_value
        self.drop_last = drop_last
        self._lib = native.get_lib()
        arr = np.asarray(self.slots, np.int64)
        self._h = self._lib.pt_feed_create(native.as_i64_ptr(arr), arr.size)
        self._epoch = 0

    # ----------------------------------------------------------- lifecycle
    def set_batch_size(self, batch_size: int) -> None:
        self.batch_size = batch_size

    def load_into_memory(self, filelist: Sequence[str]) -> int:
        """Parse files into the in-memory store (thread-parallel in C++).
        Returns total records resident."""
        for path in filelist:
            rc = self._lib.pt_feed_load_file(self._h, str(path).encode())
            if rc == -1:
                raise IOError(f"cannot read {path}")
            if rc == -2:
                raise ValueError(f"malformed slot-record line in {path}")
        return len(self)

    def local_shuffle(self, seed: Optional[int] = None) -> None:
        if seed is None:
            seed = np.random.randint(0, 2 ** 62)
        self._lib.pt_feed_shuffle(self._h, int(seed))

    def global_shuffle(self, fleet=None, seed: Optional[int] = None) -> None:
        """Single-host deployment: every record is already visible to this
        process, so a local shuffle IS the global shuffle (the reference
        shuffles across trainers over RPC, ``data_set.h`` global_shuffle)."""
        self.local_shuffle(seed)

    def release_memory(self) -> None:
        self._lib.pt_feed_clear(self._h)

    def __len__(self) -> int:
        return int(self._lib.pt_feed_num_records(self._h))

    # ------------------------------------------------------------ batching
    def _batch(self, start: int, bs: int) -> Tuple[Dict[int, np.ndarray],
                                                   Dict[int, np.ndarray],
                                                   np.ndarray]:
        slot_signs: Dict[int, np.ndarray] = {}
        slot_counts: Dict[int, np.ndarray] = {}
        for idx, slot in enumerate(self.slots):
            out = np.empty((bs, self.max_per_slot), np.int64)
            cnt = np.empty(bs, np.int32)
            self._lib.pt_feed_batch_slot(
                self._h, start, bs, idx, self.max_per_slot, self.pad_value,
                native.as_i64_ptr(out), native.as_i32_ptr(cnt))
            slot_signs[slot] = out
            slot_counts[slot] = cnt
        labels = np.empty(bs, np.float32)
        self._lib.pt_feed_batch_labels(self._h, start, bs,
                                       native.as_f32_ptr(labels))
        return slot_signs, slot_counts, labels

    def __iter__(self) -> Iterator[Tuple[Dict[int, np.ndarray],
                                         Dict[int, np.ndarray], np.ndarray]]:
        """Yields (signs {slot: [B, K] int64 padded}, counts {slot: [B]},
        labels [B] float32)."""
        n = len(self)
        bs = self.batch_size
        full = n // bs
        for b in range(full):
            yield self._batch(b * bs, bs)
        rem = n - full * bs
        if rem and not self.drop_last:
            yield self._batch(full * bs, rem)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and native is not None:
            try:
                self._lib.pt_feed_destroy(h)
            except Exception:
                pass


class QueueDataset(InMemoryDataset):
    """Streaming slot dataset (reference ``QueueDataset``): feeds files in
    order without the in-memory global shuffle pass — the reference skips
    its shuffle channels; here the collapse is ``shuffle=False`` on the
    same C++ slot feed."""

    def local_shuffle(self, seed=None):
        # reference QueueDataset raises here too: streaming mode cannot
        # shuffle, and a silent no-op would train on file-ordered data
        raise NotImplementedError(
            "QueueDataset streams files in order; use InMemoryDataset for "
            "shuffled training")

    def global_shuffle(self, fleet=None, seed=None):
        raise NotImplementedError(
            "QueueDataset streams files in order; use InMemoryDataset for "
            "shuffled training")


class BoxPSDataset(QueueDataset):
    """Reference ``BoxPSDataset`` targets the BoxPS ads engine
    (``paddle/fluid/framework/fleet/box_wrapper.h``); its data path is the
    streaming slot feed, which is what this collapse keeps."""

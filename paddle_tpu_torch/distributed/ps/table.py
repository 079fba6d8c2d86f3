"""Sparse embedding tables over the native C++ runtime (port of
``paddle_tpu/distributed/ps/table.py``).

Reference parity: ``paddle/fluid/distributed/ps/table/memory_sparse_table.cc``
(sharded hash of embeddings), ``ssd_sparse_table.cc`` (beyond-RAM spill),
``sparse_sgd_rule.cc`` (per-table optimizer rules). The table lives in
host RAM in C++ (:mod:`paddle_tpu_torch.native`, the same sources as the
JAX package's, so saved files and rows are the same bytes); the card sees
only the gathered rows of a minibatch (:mod:`.embedding`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ... import native

_OPTIMIZERS = {"sgd": 0, "adagrad": 1, "adam": 2}

# A saved sparse table (MemorySparseTable.save; native/src/ps_table.cc
# Save): a header of the magic, the value width and the row count, then one
# record a row: the key and its value_width floats (embedding, optimizer
# state, show, click).
_FILE_MAGIC = 0x5054424C45303246
_FILE_HEAD = np.dtype([("magic", "<u8"), ("width", "<i4"), ("count", "<u8")])


def read_table_file(path: str) -> np.ndarray:
    """The rows of a saved table as a record array sorted by key: ``key``
    and ``v``, each row's whole value. Unlike a pull, reading counts no
    show."""
    head = np.fromfile(path, _FILE_HEAD, count=1)
    if head.size != 1 or head[0]["magic"] != _FILE_MAGIC:
        raise IOError(f"not a saved sparse table: {path}")
    width, count = int(head[0]["width"]), int(head[0]["count"])
    rec = np.fromfile(path, np.dtype([("key", "<i8"), ("v", "<f4", (width,))]),
                      offset=_FILE_HEAD.itemsize)
    if rec.size != count:
        raise IOError(f"saved table {path}: {rec.size} rows, header says "
                      f"{count}")
    return rec[np.argsort(rec["key"], kind="stable")]


def _rows_at(rec: np.ndarray, keys) -> np.ndarray:
    keys = np.asarray(keys, np.int64).reshape(-1)
    at = np.minimum(np.searchsorted(rec["key"], keys), max(rec.size - 1, 0))
    if rec.size == 0 or not (rec["key"][at] == keys).all():
        raise KeyError("a key is not in the saved table")
    return at


def read_table_rows(path: str, keys) -> np.ndarray:
    """The whole values of ``keys`` (each present) in the saved table
    ``path``, in the keys' order: ``[len(keys), value_width]`` float32."""
    rec = read_table_file(path)
    return rec["v"][_rows_at(rec, keys)]


def write_table_subset(path: str, keys, out: str) -> None:
    """Save the rows of ``keys`` (each present, unique) of the saved table
    ``path`` as a table of their own in ``out``: the whole state a run over
    those keys reads, loadable without loading every key."""
    rec = read_table_file(path)
    sub = rec[_rows_at(rec, keys)]
    head = np.array([(_FILE_MAGIC, sub.dtype["v"].shape[0], sub.size)],
                    _FILE_HEAD)
    with open(out, "wb") as f:
        f.write(head.tobytes())
        f.write(sub.tobytes())


@dataclass
class SparseAccessorConfig:
    """Accessor = value layout + update rule, cf. ``CtrCommonAccessor``
    (``table/ctr_common_accessor.h``) reduced to the functional fields."""

    embed_dim: int = 8
    optimizer: str = "adagrad"
    learning_rate: float = 0.05
    initial_range: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    seed: int = 0
    num_shards: int = 16
    # ShowClickScore coefficients: shrink evicts keys whose decayed
    # show_coeff*show + click_coeff*click falls below threshold
    # (CtrCommonAccessor show_coeff/click_coeff).
    show_coeff: float = 1.0
    click_coeff: float = 1.0

    def __post_init__(self):
        if self.optimizer not in _OPTIMIZERS:
            raise ValueError(
                f"optimizer must be one of {sorted(_OPTIMIZERS)}, "
                f"got {self.optimizer!r}")


class MemorySparseTable:
    """Thread-sharded in-memory embedding table with C++ update rules.

    ``pull`` auto-initializes missing keys (deterministic per (seed, key));
    ``push`` applies the accessor's optimizer rule server-side — gradients
    never materialize as a dense [vocab, dim] array, which is the whole
    point of the PS design for >HBM vocabularies.
    """

    def __init__(self, accessor: Optional[SparseAccessorConfig] = None, **kw):
        self.accessor = accessor or SparseAccessorConfig(**kw)
        a = self.accessor
        self._lib = native.get_lib()
        self._h = self._lib.pt_table_create(
            a.embed_dim, _OPTIMIZERS[a.optimizer], a.learning_rate,
            a.initial_range, a.beta1, a.beta2, a.epsilon, a.seed,
            a.num_shards)
        if (a.show_coeff, a.click_coeff) != (1.0, 1.0):
            self._lib.pt_table_set_score_coeffs(
                self._h, a.show_coeff, a.click_coeff)

    @property
    def embed_dim(self) -> int:
        return self.accessor.embed_dim

    def pull(self, keys) -> np.ndarray:
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1), np.int64)
        out = np.empty((keys.size, self.embed_dim), np.float32)
        self._lib.pt_table_pull(self._h, native.as_i64_ptr(keys), keys.size,
                                native.as_f32_ptr(out))
        return out

    def push(self, keys, grads) -> None:
        """Apply the optimizer rule once per key occurrence, duplicates in
        batch order (the C++ push applies each shard's keys on one thread,
        in order)."""
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1), np.int64)
        grads = np.ascontiguousarray(
            np.asarray(grads, np.float32).reshape(keys.size, self.embed_dim))
        self._lib.pt_table_push(self._h, native.as_i64_ptr(keys),
                                native.as_f32_ptr(grads), keys.size)

    def push_raw(self, keys, deltas) -> None:
        """Add raw deltas to embeddings, bypassing the optimizer rule — the
        geo communicator's additive delta merge (GeoCommunicator)."""
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1), np.int64)
        deltas = np.ascontiguousarray(
            np.asarray(deltas, np.float32).reshape(keys.size, self.embed_dim))
        self._lib.pt_table_push_raw(self._h, native.as_i64_ptr(keys),
                                    native.as_f32_ptr(deltas), keys.size)

    def push_show_click(self, keys, shows, clicks) -> None:
        """Accumulate CTR usage stats per key (CtrCommonAccessor shows the
        reference pushing these alongside gradients)."""
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1), np.int64)
        sc = np.empty((keys.size, 2), np.float32)
        sc[:, 0] = np.asarray(shows, np.float32).reshape(-1)
        sc[:, 1] = np.asarray(clicks, np.float32).reshape(-1)
        self._lib.pt_table_push_show_click(
            self._h, native.as_i64_ptr(keys),
            native.as_f32_ptr(np.ascontiguousarray(sc)), keys.size)

    def set_learning_rate(self, lr: float) -> None:
        self._lib.pt_table_set_lr(self._h, float(lr))

    def __len__(self) -> int:
        return int(self._lib.pt_table_size(self._h))

    def keys(self) -> np.ndarray:
        n = len(self)
        out = np.empty(n, np.int64)
        w = self._lib.pt_table_keys(self._h, native.as_i64_ptr(out), n)
        return out[:w]

    def shrink(self, threshold: float = 1.0) -> int:
        """Evict keys with usage counter below ``threshold`` (counters decay
        by half each call), cf. ``MemorySparseTable::Shrink``."""
        return int(self._lib.pt_table_shrink(self._h, float(threshold)))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        rc = self._lib.pt_table_save(self._h, path.encode())
        if rc != 0:
            raise IOError(f"table save failed ({rc}): {path}")

    def load(self, path: str, merge: bool = False) -> None:
        """Load a snapshot. ``merge=True`` inserts only keys missing from
        RAM — live rows win over snapshot rows (begin_pass semantics)."""
        fn = self._lib.pt_table_load_merge if merge else self._lib.pt_table_load
        rc = fn(self._h, path.encode())
        if rc != 0:
            raise IOError(f"table load failed ({rc}): {path}")

    def clear(self) -> None:
        self._lib.pt_table_clear(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and native is not None:  # interpreter teardown safety
            try:
                self._lib.pt_table_destroy(h)
            except Exception:
                pass


_DENSE_OPTIMIZERS = {"sgd": 0, "adagrad": 1, "sum": 3}


class MemoryDenseTable:
    """Dense parameter vector with a server-side update rule — the
    reference's ``MemoryDenseTable`` (``table/memory_dense_table.cc``),
    which holds the model's dense weights on PS servers in async/geo
    modes. Optimizers: ``sgd``, ``adagrad``, ``sum`` (raw accumulate)."""

    def __init__(self, length: int, optimizer: str = "sgd",
                 learning_rate: float = 0.05, epsilon: float = 1e-8):
        if optimizer not in _DENSE_OPTIMIZERS:
            raise ValueError(
                f"optimizer must be one of {sorted(_DENSE_OPTIMIZERS)}")
        self.optimizer = optimizer
        self._lib = native.get_lib()
        self._h = self._lib.pt_dense_create(
            int(length), _DENSE_OPTIMIZERS[optimizer], learning_rate, epsilon)

    def __len__(self) -> int:
        return int(self._lib.pt_dense_len(self._h))

    def pull(self, offset: int = 0, length: int = -1) -> np.ndarray:
        n = len(self) - offset if length < 0 else length
        out = np.empty(n, np.float32)
        rc = self._lib.pt_dense_get(self._h, int(offset), n,
                                    native.as_f32_ptr(out))
        if rc != 0:
            raise IndexError(f"dense pull out of range ({rc})")
        return out

    def set(self, values, offset: int = 0) -> None:
        values = np.ascontiguousarray(
            np.asarray(values, np.float32).reshape(-1))
        rc = self._lib.pt_dense_set(self._h, int(offset), values.size,
                                    native.as_f32_ptr(values))
        if rc != 0:
            raise IndexError(f"dense set out of range ({rc})")

    def push(self, grads, offset: int = 0) -> None:
        grads = np.ascontiguousarray(np.asarray(grads, np.float32).reshape(-1))
        rc = self._lib.pt_dense_push(self._h, int(offset), grads.size,
                                     native.as_f32_ptr(grads))
        if rc != 0:
            raise IndexError(f"dense push out of range ({rc})")

    def set_learning_rate(self, lr: float) -> None:
        self._lib.pt_dense_set_lr(self._h, float(lr))

    def save(self, path: str) -> None:
        rc = self._lib.pt_dense_save(self._h, path.encode())
        if rc != 0:
            raise IOError(f"dense save failed ({rc})")

    def load(self, path: str) -> None:
        rc = self._lib.pt_dense_load(self._h, path.encode())
        if rc != 0:
            raise IOError(f"dense load failed ({rc})")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and native is not None:
            try:
                self._lib.pt_dense_destroy(h)
            except Exception:
                pass


class SSDSparseTable(MemorySparseTable):
    """Beyond-RAM table with pass-based spill, cf. ``SSDSparseTable``
    (``table/ssd_sparse_table.cc``: hot keys in RAM, cold on SSD).

    The lifecycle mirrors the reference's *pass* structure
    (``PSGPUWrapper::BuildGPUTask`` / ``EndPass``,
    ``ps_gpu_wrapper.h:191``): train on the in-RAM working set, then
    ``end_pass()`` persists everything to the spill file and evicts cold
    keys; a later pass touching an evicted key transparently reloads from
    the snapshot on construction/``begin_pass``.
    """

    def __init__(self, spill_dir: str,
                 accessor: Optional[SparseAccessorConfig] = None,
                 cache_threshold: float = 1.0, **kw):
        super().__init__(accessor, **kw)
        self.spill_dir = spill_dir
        self.cache_threshold = cache_threshold
        os.makedirs(spill_dir, exist_ok=True)
        self._snapshot = os.path.join(spill_dir, "table.bin")
        if os.path.exists(self._snapshot):
            self.load(self._snapshot)

    def end_pass(self) -> int:
        """Persist the full table, then evict cold keys from RAM."""
        self.save(self._snapshot)
        return self.shrink(self.cache_threshold)

    def begin_pass(self) -> None:
        """Reload the snapshot so previously evicted keys are warm again.

        Merge-mode: only keys absent from RAM are inserted, so rows updated
        since the last ``end_pass`` are never rolled back to snapshot values
        (and shrink's counter decay is not undone) even when passes are not
        strictly paired."""
        if os.path.exists(self._snapshot):
            self.load(self._snapshot, merge=True)

"""Crash-safe checkpoints (port of ``paddle_tpu/distributed/checkpoint.py``).

A checkpoint is a directory of raw ``.npy`` files, one per array leaf of a
state tree, and one ``metadata.json`` describing the tree (shape, dtype and
each file's start offsets, byte length and crc32). The port writes the
same files and the same metadata as the reference for the same tree, so a
checkpoint written by either loads in the other:

- the tree flattens as ``jax.tree_util`` flattens it: dict keys in sorted
  order, list and tuple items by index, ``None`` a subtree with no leaves;
  keys join with ``/`` and the files are named
  ``L{index:04d}_{safe key}__{start}.npy`` in that order;
- the metadata records numpy dtype names as the reference's ``jnp.asarray``
  gives them with 64-bit types off (an ``int64`` leaf is recorded
  ``int32``, a ``float64`` leaf ``float32``; the file keeps the leaf's own
  bytes, and a load casts it to the recorded dtype, as the reference does);
  Python scalars and strings are recorded inline;
- a bfloat16 leaf is written as its bits with the ``.npy`` header
  ``'descr': '<V2'``, the bytes ``np.save`` writes for an ``ml_dtypes``
  bfloat16 array, and recorded ``"dtype": "bfloat16"``; on load the ``V2``
  bytes and the recorded dtype give a ``torch.bfloat16`` tensor.

:func:`load_state` returns arrays as CPU tensors (bfloat16 has no numpy
dtype without ``ml_dtypes``).

Sharded state. The reference's leaves carry their sharding; the port's
tensors are each rank's local slice, so ``save_state`` and ``load_state``
take ``shardings``: ``{flat key: Sharding(mesh, spec)}``, the mesh and the
per-leaf ``PartitionSpec`` a ``DistributedTrainStep`` keeps
(``DistributedTrainStep.sharded_state_dict()`` gives both). A save records
each leaf at its global shape, each rank writing the boxes of its slice
(one rank of each set holding the same box writes it); a load returns,
for each sharded key, only the slice the rank's NEW layout needs, read
box by box with bounded host memory — a checkpoint written by 2
processes restores on 1, and one written by 1 restores on 2. The mesh
the save was written on goes into ``metadata.json`` (``mesh_info``).

Crash safety: a checkpoint directory is either COMPLETE or INVISIBLE. A
save stages everything in a ``<dir>.tmp-pt<pid>`` sibling (shards fsync'd,
every shard crc32-checksummed into ``metadata.json``, the metadata fsync'd
last) and publishes with one ``os.replace``; a SIGKILL at any point leaves
only the staging dir, which :class:`AutoCheckpoint` sweeps on startup.
:func:`load_state` verifies checksums (raising
:class:`CheckpointCorruptError` on torn/corrupt data) and
:func:`latest_checkpoint` validates candidates, silently skipping
incomplete or corrupt step dirs so restore falls back to the newest GOOD
checkpoint.

Several processes (a ``torch.distributed`` world of more than one) write
one checkpoint together: process 0 makes a fresh staging directory, every
process writes its shard files and its own metadata
(``metadata.json`` for 0, ``metadata.<rank>.json`` otherwise, each with
``process_count``) into it, and a publish barrier lets process 0 rename
the directory into place only when every peer has written. The barrier
runs over the world's rendezvous store (safe from the async save's IO
thread while the training thread runs collectives). A directory published
by the reference's per-file protocol whose peer never committed is named
by :func:`validate_checkpoint` (the missing rank) and skipped by
:func:`latest_checkpoint`.
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .resilience import fault_point

__all__ = [
    "save_state", "load_state", "AsyncSaver", "AutoCheckpoint",
    "latest_checkpoint", "validate_checkpoint", "CheckpointCorruptError",
    "mesh_info", "last_load_stats", "Sharding",
]

_METADATA = "metadata.json"
_TMP_MARK = ".tmp-pt"  # staging dirs: <target>.tmp-pt<pid>


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (missing metadata,
    missing shard file, size mismatch, or crc32 mismatch). The message
    names the offending file and what differed."""


def _flatten(tree):
    """``({slash/key: leaf}, tree)``: the leaves in ``jax.tree_util``'s
    order (dict keys sorted, sequences by index, ``None`` no leaf). The
    tree itself is the structure :func:`_unflatten` refills."""
    flat: Dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif node is not None:
            flat["/".join(path)] = node

    walk(tree, ())
    return flat, tree


def _unflatten(template, flat: Dict[str, Any]):
    """``template``'s structure with each leaf replaced by ``flat``'s value
    at its key."""
    def build(node, path):
        if isinstance(node, dict):
            return type(node)((k, build(node[k], path + (str(k),)))
                              for k in node)
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (str(i),))
                              for i, v in enumerate(node))
        if node is None:
            return None
        return flat["/".join(path)]

    return build(template, ())


def _safe(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)


# the reference records ``str(jnp.asarray(leaf).dtype)``, and jax without
# 64-bit types narrows these
_NARROWED = {"int64": "int32", "uint64": "uint32", "float64": "float32",
             "complex128": "complex64"}


def _dtype_name(arr) -> str:
    if isinstance(arr, torch.Tensor):
        name = str(arr.dtype).replace("torch.", "")
    else:
        name = np.asarray(arr).dtype.name
    return _NARROWED.get(name, name)


def _leaf_record(key: str, arr) -> Dict[str, Any]:
    if isinstance(arr, (int, float, bool)):
        return {"kind": "scalar", "value": arr}
    if isinstance(arr, str):
        return {"kind": "str", "value": arr}
    return {"kind": "array", "shape": list(np.shape(arr) if not isinstance(
        arr, torch.Tensor) else arr.shape), "dtype": _dtype_name(arr)}


def _host_copy(leaf):
    """A host snapshot of one array leaf, as the bytes the reference's
    ``np.array(leaf, copy=True)`` gives: numpy, or for bfloat16 the uint16
    bits (the caller writes them under a ``V2`` header). A copy, so an
    async write never sees a later in-place update."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), True
        return t.numpy(), False
    return np.array(leaf, copy=True), False


def _npy_bytes(data: np.ndarray, bf16: bool) -> bytes:
    buf = io.BytesIO()
    if bf16:
        # np.save of an ml_dtypes bfloat16 array: a '<V2' header, then the
        # little-endian 16-bit words
        np.lib.format.write_array_header_1_0(
            buf, {"descr": "<V2", "fortran_order": False,
                  "shape": tuple(data.shape)})
        buf.write(data.astype("<u2").tobytes())
    else:
        np.save(buf, data)
    return buf.getvalue()


def _process_count() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


class Sharding:
    """A rank's slice of a leaf: ``spec`` (a ``distributed.mesh.
    PartitionSpec``, ``blocks`` included) over ``mesh``, as
    ``convert.shard_tensor`` cuts it. :meth:`boxes` gives the slice as
    boxes of the global array (several when a fused dimension is split
    block by block; the local tensor is their concatenation along that
    dimension), :attr:`writer` whether this rank writes them."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:
        return f"Sharding({self.mesh}, {self.spec!r})"

    def _dims(self, ndim: int):
        from ..convert import _dim_axes

        spec = list(self.spec) + [None] * (ndim - len(self.spec))
        for entry in spec[:ndim]:
            axes = _dim_axes(entry)
            n = self.mesh.axis_size(axes)
            blocks = getattr(self.spec, "blocks", 1) if "mp" in axes else 1
            yield (n, self.mesh.axis_index(axes) if n > 1 else 0,
                   blocks if n > 1 else 1)

    def global_shape(self, local_shape) -> tuple:
        return tuple(int(d) * n for d, (n, _, _) in
                     zip(local_shape, self._dims(len(local_shape))))

    def boxes(self, shape):
        """``(blocked dim or None, [(start, size) per box])`` of this
        rank's slice of a leaf of global ``shape``."""
        ranges, blocked = [], None
        for d, (size, (n, i, blocks)) in enumerate(
                zip(shape, self._dims(len(shape)))):
            if size % (n * blocks):
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split into {n} x {blocks} blocks")
            part = size // blocks // n
            ranges.append([(b * (size // blocks) + i * part, part)
                           for b in range(blocks)])
            if blocks > 1:
                blocked = d
        boxes = [((), ())]
        for rs in ranges:
            boxes = [(st + (a,), sz + (b,)) for st, sz in boxes
                     for a, b in rs]
        return blocked, boxes

    @property
    def writer(self) -> bool:
        """True on the one rank of each set that holds the same slice
        (coordinate 0 on every axis the spec does not split)."""
        if not self.mesh.member:
            return False
        used = set(self.spec.axes())
        return all(self.mesh.coordinate[a] == 0
                   for a in self.mesh.axis_names
                   if a not in used and self.mesh.shape[a] > 1)


def _mesh_record(mesh) -> Dict[str, Any]:
    return {"axes": {str(k): int(v) for k, v in dict(mesh.shape).items()},
            "devices": int(mesh.size)}


# ----------------------------------------------- the multi-process barrier
_SAVE_SEQ = [0]
# seconds each wait of a multi-process save's publish barrier may take
_PUBLISH_TIMEOUT_S = 600.0


def _world_store():
    """The world's rendezvous store (thread-safe; independent of the
    collectives the training thread runs)."""
    from torch.distributed import distributed_c10d

    return distributed_c10d._get_default_store()


class _PublishBarrier:
    """The protocol of one multi-process save (every process of the world
    saves, in the same order): process 0 announces a fresh staging
    directory, every process reports its files written, process 0
    publishes and announces it. Each wait is bounded by
    ``_PUBLISH_TIMEOUT_S``."""

    def __init__(self, directory: str):
        self.seq = _SAVE_SEQ[0]
        _SAVE_SEQ[0] += 1
        self.key = f"ckpt/{self.seq}"
        self.timeout = _PUBLISH_TIMEOUT_S
        self.store = _world_store()
        self.nprocs = _process_count()
        self.proc = _process_index()
        self.directory = directory

    def _get(self, name: str) -> str:
        import datetime

        key = f"{self.key}/{name}"
        try:
            self.store.wait([key], datetime.timedelta(seconds=self.timeout))
        except RuntimeError as e:
            raise TimeoutError(
                f"checkpoint {self.directory}: no {name!r} from process 0 "
                f"within {self.timeout}s (a peer lost?)") from e
        return self.store.get(key).decode()

    def staging(self) -> str:
        """The shared staging directory (process 0 makes it fresh)."""
        if self.proc == 0:
            stage = f"{self.directory}{_TMP_MARK}{os.getpid()}"
            if os.path.exists(stage):
                shutil.rmtree(stage)
            os.makedirs(stage)
            self.store.set(f"{self.key}/stage", stage)
            return stage
        return self._get("stage")

    def written(self) -> None:
        """Report this process's files written; process 0 waits for every
        process's report."""
        self.store.add(f"{self.key}/written", 1)
        if self.proc != 0:
            return
        deadline = time.monotonic() + self.timeout
        while self.store.add(f"{self.key}/written", 0) < self.nprocs:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint {self.directory}: only "
                    f"{self.store.add(f'{self.key}/written', 0)} of "
                    f"{self.nprocs} processes wrote within {self.timeout}s; "
                    f"not published")
            time.sleep(0.02)

    def published(self, ok: bool = True) -> None:
        if self.proc == 0:
            self.store.set(f"{self.key}/published", "1" if ok else "0")
        elif self._get("published") != "1":
            raise RuntimeError(f"checkpoint {self.directory}: process 0 "
                               f"failed to publish it")


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse dir fsync; best effort
    finally:
        os.close(fd)


def _write_file_durable(path: str, raw: bytes) -> None:
    """Write and fsync ``raw`` (into the staging directory, which the
    publish renames as a whole)."""
    with open(path, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())


def save_state(state: Any, directory: str, *, async_=False,
               io_threads: int = 8,
               extra_meta: Optional[Dict[str, Any]] = None,
               extra_files: Optional[Dict[str, bytes]] = None,
               shardings: Optional[Dict[str, Sharding]] = None,
               mesh=None) -> Optional["_PendingSave"]:
    """Save a tree of tensors, arrays, scalars and strings as a checkpoint
    directory.

    Each array leaf becomes one ``.npy`` file (a unique per-leaf index
    prefixes the name, so distinct keys never collide after sanitisation);
    ``metadata.json`` records the tree plus each file's byte length and
    crc32. With ``async_=True`` the device->host copies happen on the
    caller thread and the file IO on ``io_threads`` background threads;
    the returned handle's ``.wait()`` joins the IO and reports/raises any
    IO error.

    Publication is crash-safe: the save stages in a ``.tmp-pt<pid>``
    sibling directory and appears atomically via ``os.replace`` (an
    existing directory of the same name is moved aside to
    ``.old-pt<pid>`` first). A process killed mid-save never leaves a
    directory that :func:`latest_checkpoint`/:func:`load_state` would
    accept.

    ``extra_meta`` merges additional records into ``metadata.json`` —
    including overriding ``format``. The structural keys
    (``leaves``/``process_count``/``mesh``) cannot be overridden.
    ``extra_files`` are sidecar records (name -> raw bytes) written by
    process 0 inside the staging directory before the metadata, so they
    appear atomically with the checkpoint.

    ``shardings`` (flat key -> :class:`Sharding`) marks leaves that are
    this rank's slice of a larger array (see the module docstring);
    ``mesh`` (or the shardings' mesh) is recorded as the topology the
    checkpoint was written on. In a world of several processes every
    process calls ``save_state`` for the same directory, in the same
    order: a leaf without a sharding is written by process 0, and the
    checkpoint is published (on every process, by the time the call or
    the handle's ``wait()`` returns) once all have written; each wait of
    that barrier is bounded by ``_PUBLISH_TIMEOUT_S`` seconds.
    """
    nprocs = _process_count()
    proc = _process_index()
    shardings = shardings or {}
    flat, _ = _flatten(state)
    directory = directory.rstrip(os.sep)
    barrier = _PublishBarrier(directory) if nprocs > 1 else None
    if barrier is None:
        stage_dir = f"{directory}{_TMP_MARK}{os.getpid()}"
        if os.path.exists(stage_dir):
            shutil.rmtree(stage_dir)
        os.makedirs(stage_dir, exist_ok=True)
    else:
        stage_dir = barrier.staging()
    meta: Dict[str, Any] = {"format": "paddle_tpu.ckpt.v1",
                            "process_count": nprocs, "leaves": {}}
    if extra_meta:
        reserved = {"leaves", "process_count", "mesh"}
        bad = reserved & set(extra_meta)
        if bad:
            raise ValueError(
                f"extra_meta may not override structural metadata keys "
                f"{sorted(bad)}")
        meta.update(extra_meta)
    written_on = mesh if mesh is not None else next(
        (sh.mesh for sh in shardings.values()), None)
    if written_on is not None:
        meta["mesh"] = _mesh_record(written_on)
    unknown = set(shardings) - set(flat)
    if unknown:
        raise KeyError(f"save_state: shardings name leaves the state lacks: "
                       f"{sorted(unknown)[:4]}")
    jobs = []  # (filename, host copy, is bf16, shard record to patch)
    for leaf_i, (key, leaf) in enumerate(flat.items()):
        rec = _leaf_record(key, leaf)
        meta["leaves"][key] = rec
        if rec["kind"] != "array":
            continue
        sh = shardings.get(key)
        prefix = f"L{leaf_i:04d}_{_safe(key)}__"
        rec["shards"] = []
        if sh is None:
            if proc != 0:
                continue   # a whole leaf: process 0 writes it
            data, bf16 = _host_copy(leaf)
            boxes, parts = [((0,) * data.ndim, data.shape)], [data]
        else:
            rec["shape"] = list(sh.global_shape(tuple(leaf.shape)))
            if not sh.writer:
                continue
            data, bf16 = _host_copy(leaf)
            blocked, boxes = sh.boxes(rec["shape"])
            parts = ([data] if blocked is None
                     else np.split(data, len(boxes), axis=blocked))
        for (start, _), part in zip(boxes, parts):
            fname = prefix + "_".join(map(str, start)) + ".npy"
            srec = {"file": fname, "start": list(start),
                    "shape": list(part.shape), "process": proc}
            rec["shards"].append(srec)
            jobs.append((fname, np.require(part, requirements="C"), bf16,
                         srec))
    meta_name = _METADATA if proc == 0 else f"metadata.{proc}.json"

    def do_io():
        import concurrent.futures as cf

        def write(job):
            fname, data, bf16, srec = job
            raw = _npy_bytes(data, bf16)
            srec["bytes"] = len(raw)
            srec["crc32"] = zlib.crc32(raw) & 0xFFFFFFFF
            fault_point("ckpt.shard_write")
            _write_file_durable(os.path.join(stage_dir, fname), raw)

        if len(jobs) > 1 and io_threads > 1:
            with cf.ThreadPoolExecutor(max_workers=io_threads) as pool:
                for _ in pool.map(write, jobs):
                    pass
        else:
            for job in jobs:
                write(job)
        if proc == 0:
            for name, raw in (extra_files or {}).items():
                _write_file_durable(os.path.join(stage_dir, name),
                                    bytes(raw))
        # metadata written last (this process's commit), then the barrier
        # and the directory rename: the publish
        fault_point("ckpt.publish")
        _write_file_durable(os.path.join(stage_dir, meta_name),
                            json.dumps(meta, indent=1).encode())
        _fsync_dir(stage_dir)
        if barrier is None:
            publish()
            return
        barrier.written()
        if proc == 0:
            try:
                publish()
            except BaseException:
                barrier.published(False)
                raise
        barrier.published()

    def publish():
        trash = None
        if os.path.exists(directory):
            # same-name overwrite: POSIX replaces only EMPTY target dirs,
            # so move the old checkpoint ASIDE first — a crash between the
            # two renames leaves the old data recoverable under .old-pt
            # rather than a window with nothing at all
            trash = f"{directory}.old-pt{os.getpid()}"
            if os.path.exists(trash):
                shutil.rmtree(trash)
            os.replace(directory, trash)
        os.replace(stage_dir, directory)
        _fsync_dir(os.path.dirname(os.path.abspath(directory)))
        if trash is not None:
            shutil.rmtree(trash, ignore_errors=True)

    if async_:
        pending = _PendingSave(directory)
        t = threading.Thread(target=pending._run, args=(do_io,), daemon=True)
        pending._thread = t
        t.start()
        return pending
    do_io()
    return None


class _PendingSave:
    def __init__(self, directory):
        self._thread: Optional[threading.Thread] = None
        self.directory = directory
        self.error: Optional[BaseException] = None

    def _run(self, fn):
        try:
            fn()
        except BaseException as e:  # surfaced via wait()
            self.error = e

    def wait(self, timeout=None):
        """Join the IO. Returns False on timeout; raises if the save failed."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            return False
        if self.error is not None:
            raise RuntimeError(
                f"async checkpoint save to {self.directory} failed") from self.error
        return True

    @property
    def done(self):
        return not self._thread.is_alive()


def _read_shard_file(directory: str, shard: Dict[str, Any],
                     verify: bool = True) -> np.ndarray:
    """Read one shard ``.npy``, verifying recorded size/crc32 when present
    (older checkpoints without checksums load unverified). Verification
    streams the file (1 MB chunks) so peak memory stays ~1x the decoded
    array, not raw-bytes + array."""
    path = os.path.join(directory, shard["file"])
    rank = shard.get("process")
    whose = f" (written by rank {rank})" if rank is not None else ""
    try:
        if verify:
            want_len = shard.get("bytes")
            if want_len is not None:
                size = os.path.getsize(path)
                if size != want_len:
                    raise CheckpointCorruptError(
                        f"checkpoint shard {path}: {size} bytes on disk, "
                        f"metadata records {want_len} (truncated/torn "
                        f"write)")
            want_crc = shard.get("crc32")
            if want_crc is not None:
                got = _file_crc32(path)
                if got != want_crc:
                    raise CheckpointCorruptError(
                        f"checkpoint shard {path}: crc32 {got:#010x} != "
                        f"recorded {want_crc:#010x} (bit rot or torn write)")
        return np.load(path)
    except FileNotFoundError:
        raise CheckpointCorruptError(
            f"checkpoint shard missing: {path}{whose} (torn save or lost "
            f"host?)") from None
    except ValueError as e:
        raise CheckpointCorruptError(
            f"checkpoint shard {path}: undecodable npy: {e}") from e


# default per-leaf shard-cache bound for streaming (re-sliced) loads: big
# enough that small/medium checkpoints never evict, small enough that a
# multi-GB param tree restored onto a reshaped mesh stays bounded on host
DEFAULT_SHARD_CACHE_BYTES = 1 << 28  # 256 MiB

# accounting for the most recent load_state call (single-threaded loads;
# see last_load_stats)
_LOAD_STATS = {"peak_resident_bytes": 0, "bytes_read": 0,
               "shard_reads": 0, "evictions": 0, "leaves": 0}


def last_load_stats() -> Dict[str, int]:
    """Host-memory accounting of the most recent :func:`load_state`:
    ``peak_resident_bytes`` is the maximum decoded shard bytes any single
    leaf's reader held at once — the restore path's working set, which a
    bounded-memory (elastic reshard) restore asserts stays far below the
    full tree size. ``bytes_read``/``shard_reads`` count shard file
    decodes (a shard evicted under the cache bound and needed again is
    re-read — memory is the bounded resource, IO the price)."""
    return dict(_LOAD_STATS)


def _reset_load_stats() -> None:
    for k in _LOAD_STATS:
        _LOAD_STATS[k] = 0


class _LeafReader:
    """Assembles arbitrary slices of one leaf from its shard files,
    holding at most ``max_cache_bytes`` of decoded shards at a time (LRU;
    the shard being served is never evicted)."""

    def __init__(self, directory: str, rec: Dict[str, Any],
                 verify: bool = True,
                 max_cache_bytes: Optional[int] = DEFAULT_SHARD_CACHE_BYTES):
        self.directory = directory
        self.rec = rec
        self.verify = verify
        self.shape = tuple(rec["shape"])
        self.max_cache_bytes = max_cache_bytes
        self._cache: Dict[str, np.ndarray] = {}
        self._resident = 0

    def _shard_data(self, shard) -> np.ndarray:
        f = shard["file"]
        if f in self._cache:
            self._cache[f] = self._cache.pop(f)  # LRU: move to back
            return self._cache[f]
        raw = _read_shard_file(self.directory, shard, self.verify)
        # bfloat16 round-trips npy as void: kept as its uint16 bits here,
        # a bfloat16 tensor once the leaf is assembled
        want = (np.dtype(np.uint16) if self.rec["dtype"] == "bfloat16"
                else np.dtype(self.rec["dtype"]))
        if raw.dtype != want:
            raw = raw.view(want) if raw.dtype.itemsize == want.itemsize \
                else raw.astype(want)
        self._cache[f] = raw
        self._resident += raw.nbytes
        _LOAD_STATS["shard_reads"] += 1
        _LOAD_STATS["bytes_read"] += raw.nbytes
        # peak is taken BEFORE eviction: at the decode moment the new
        # shard and the full cache coexist — that transient is the true
        # working set the bound must be judged against
        _LOAD_STATS["peak_resident_bytes"] = max(
            _LOAD_STATS["peak_resident_bytes"], self._resident)
        while (self.max_cache_bytes is not None
               and self._resident > self.max_cache_bytes
               and len(self._cache) > 1):
            oldest = next(iter(self._cache))
            self._resident -= self._cache.pop(oldest).nbytes
            _LOAD_STATS["evictions"] += 1
        return self._cache[f]

    def read(self, index) -> np.ndarray:
        """index: tuple of slices into the global shape."""
        want_start = tuple(0 if s.start is None else int(s.start) for s in index)
        want_stop = tuple(dim if s.stop is None else int(s.stop)
                          for s, dim in zip(index, self.shape))
        out_shape = tuple(b - a for a, b in zip(want_start, want_stop))
        out = None
        covered = 0
        want_elems = int(np.prod(out_shape)) if out_shape else 1
        for shard in self.rec["shards"]:
            s_start = tuple(shard["start"])
            s_stop = tuple(a + b for a, b in zip(s_start, shard["shape"]))
            inter_start = tuple(max(a, b) for a, b in zip(want_start, s_start))
            inter_stop = tuple(min(a, b) for a, b in zip(want_stop, s_stop))
            if any(a >= b for a, b in zip(inter_start, inter_stop)):
                continue  # no overlap (vacuously false for 0-d leaves)
            data = self._shard_data(shard)
            if out is None:
                out = np.empty(out_shape, data.dtype)
            src = tuple(slice(a - o, b - o) for a, b, o in
                        zip(inter_start, inter_stop, s_start))
            dst = tuple(slice(a - o, b - o) for a, b, o in
                        zip(inter_start, inter_stop, want_start))
            out[dst] = data[src]
            covered += int(np.prod([b - a for a, b in
                                    zip(inter_start, inter_stop)])) if out_shape else 1
        # shards never overlap each other (distinct start offsets of one
        # sharding), so covered elements == requested elements iff complete
        if out is None or covered < want_elems:
            raise ValueError(
                f"checkpoint shards cover only {covered}/{want_elems} elements "
                f"of requested slice {index} — incomplete checkpoint?")
        return out


def load_state(directory: str, shardings: Optional[Dict[str, Any]] = None,
               template: Any = None,
               verify: Union[bool, str] = True,
               max_shard_cache_bytes: Optional[int] =
               DEFAULT_SHARD_CACHE_BYTES) -> Dict[str, Any]:
    """Load a checkpoint directory.

    - plain load: returns a flat ``{key: value}`` dict, arrays as CPU
      tensors (bfloat16 included), scalars and strings as recorded.
    - with ``template`` (a tree): the result is unflattened into that
      structure.
    - with ``shardings`` (flat ``{key: Sharding}``): each of those leaves
      comes back as this rank's slice under its sharding (the local
      tensor a ``DistributedTrainStep`` on that mesh holds), read box by
      box from the shard files it overlaps, whatever topology wrote them
      — the elastic shrink/grow restore. Host memory per leaf is bounded
      by ``max_shard_cache_bytes`` of decoded source shards (LRU; an
      evicted shard needed again is re-read) plus the slice itself.

    With ``verify`` (default), every shard file read is checked against the
    byte length and crc32 recorded at save time; a missing/truncated/
    corrupted shard or missing metadata raises
    :class:`CheckpointCorruptError` naming the file, the writer rank, and
    the mismatch. ``verify="proactive"`` runs a full
    :func:`validate_checkpoint` crc pass over EVERY recorded shard up
    front, before any leaf is materialised — the mode supervisor restores
    use; each byte is then read+checked once (per-read re-verification is
    skipped after the proactive pass). ``max_shard_cache_bytes`` bounds
    the decoded shards a leaf's reader holds at once (see
    :func:`last_load_stats`).
    """
    shardings = shardings or {}
    _reset_load_stats()
    try:
        with open(os.path.join(directory, _METADATA)) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise CheckpointCorruptError(
            f"{directory}: no {_METADATA} — not a (complete) checkpoint "
            "directory; the save may have been killed before publishing"
        ) from None
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            f"{directory}/{_METADATA}: undecodable metadata: {e}") from e
    # a LoRA adapter checkpoint holds ONLY lora_A/lora_B leaves: fed to a
    # full-model restore (a template expecting base weights) it would
    # otherwise die on a confusing missing-leaves error deep below —
    # name the real problem instead
    if meta.get("format") == "lora_adapter" and template is not None:
        flat_t, _ = _flatten(template)
        non_lora = [k for k in flat_t
                    if k.rsplit("/", 1)[-1].rsplit(".", 1)[-1]
                    not in ("lora_A", "lora_B")]
        if non_lora:
            raise ValueError(
                f"{directory} is a LoRA ADAPTER checkpoint (format="
                f"'lora_adapter'): it carries only adapter leaves and "
                f"cannot restore a full model (template expects e.g. "
                f"{non_lora[0]!r}). Load the base model first, then "
                f"attach the adapter via paddle_tpu_torch.lora."
                f"load_adapter / AdapterStore.load")
    # merge shard lists from other processes' metadata (multi-host save);
    # files at or beyond process_count are STALE leftovers from an earlier
    # larger-world save into the same path — merging them would mix shards
    # from a different training trajectory into the restored state
    nprocs = meta.get("process_count")
    seen_procs = {0}
    for name in sorted(os.listdir(directory)):
        proc_i = _meta_proc(name)
        if proc_i is not None and (nprocs is None or proc_i < nprocs):
            seen_procs.add(proc_i)
            with open(os.path.join(directory, name)) as f:
                other = json.load(f)
            for key, rec in other.get("leaves", {}).items():
                mine = meta["leaves"].setdefault(key, rec)
                if rec.get("kind") == "array" and mine is not rec:
                    mine.setdefault("shards", []).extend(rec.get("shards", []))
    if verify and nprocs is not None:
        absent = set(range(nprocs)) - seen_procs
        if absent:
            raise CheckpointCorruptError(
                f"{directory}: metadata missing for process(es) "
                f"{sorted(absent)} — a peer was killed before committing; "
                f"its shards are not recoverable from this directory")
    read_verify = bool(verify)
    if verify == "proactive":
        problem = validate_checkpoint(directory, checksums=True)
        if problem is not None:
            raise CheckpointCorruptError(problem)
        read_verify = False  # every shard just passed a full crc pass
    flat_out: Dict[str, Any] = {}
    for key, rec in meta["leaves"].items():
        if rec["kind"] == "scalar":
            flat_out[key] = rec["value"]
            continue
        if rec["kind"] == "str":
            flat_out[key] = rec["value"]
            continue
        reader = _LeafReader(directory, rec, verify=read_verify,
                             max_cache_bytes=max_shard_cache_bytes)
        _LOAD_STATS["leaves"] += 1
        shape = tuple(rec["shape"])
        sh = shardings.get(key)
        if sh is None:
            arr = reader.read(tuple(slice(0, d) for d in shape))
        else:
            blocked, boxes = sh.boxes(shape)
            parts = [reader.read(tuple(slice(a, a + n)
                                       for a, n in zip(start, size)))
                     for start, size in boxes]
            arr = (parts[0] if blocked is None
                   else np.concatenate(parts, axis=blocked))
        t = torch.from_numpy(np.require(arr, requirements="C"))
        flat_out[key] = (t.view(torch.bfloat16)
                         if rec["dtype"] == "bfloat16" else t)
    absent = [k for k in shardings if k not in flat_out]
    if absent:
        raise CheckpointCorruptError(
            f"{directory}: checkpoint lacks {len(absent)} sharded leaf/"
            f"leaves (first: {absent[0]!r})")
    if template is not None:
        flat_t, _ = _flatten(template)
        missing = [k for k in flat_t if k not in flat_out]
        if missing:
            raise CheckpointCorruptError(
                f"{directory}: checkpoint lacks {len(missing)} leaf/leaves "
                f"the template expects (first: {missing[0]!r}). A checkpoint "
                f"written before the state tree gained new leaves (e.g. "
                f"base_seed/scaler_state) loads fine WITHOUT a template, or "
                f"through TrainingSupervisor.restore(), which treats those "
                f"leaves as optional.")
        return _unflatten(template, flat_out)
    return flat_out


# --------------------------------------------------------------------------
# auto checkpoint: periodic snapshots + resume (reference auto_checkpoint.py)
# --------------------------------------------------------------------------

_STEP_DIR = re.compile(r"^step_(\d+)$")


def _meta_proc(name: str) -> Optional[int]:
    """Process index of a ``metadata.N.json`` file name (None for the
    primary ``metadata.json``)."""
    m = re.match(r"^metadata\.(\d+)\.json$", name)
    return int(m.group(1)) if m else None


def _file_crc32(path: str, chunk: int = 1 << 20) -> int:
    """Streaming crc32 — never materialises the file (crc32 is
    incremental), so validating multi-GB shards costs one buffer."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def validate_checkpoint(directory: str,
                        checksums: bool = True) -> Optional[str]:
    """Integrity-check a checkpoint directory WITHOUT materialising arrays.

    Returns ``None`` when every metadata file parses and every recorded
    shard exists with matching byte length and (with ``checksums``) crc32;
    otherwise a string describing the problem. Missing shard files and
    missing per-process commit markers are AGGREGATED and attributed to
    writer ranks — after a host loss the report says exactly which ranks'
    shards are gone (and names example keys) rather than the first missing
    file. ``checksums=False`` is the cheap stat-only mode for housekeeping
    paths (retention GC) that must not re-read every shard byte.
    Pre-checksum checkpoints (no recorded crc) validate on existence/size
    only. Completeness is topology-agnostic: a directory that validates
    restores onto ANY target mesh (the re-slice plans itself from the
    recorded offsets), so ``latest_checkpoint`` falling back to the newest
    valid candidate is exactly "newest complete for the target topology".
    """
    metas: List[str] = []
    try:
        for name in sorted(os.listdir(directory)):
            if name == _METADATA or re.match(r"^metadata\.\d+\.json$", name):
                metas.append(name)
    except OSError as e:
        return f"{directory}: unreadable: {e}"
    if _METADATA not in metas:
        return f"{directory}: no {_METADATA} (unpublished/torn save)"
    try:
        with open(os.path.join(directory, _METADATA)) as f:
            nprocs = json.load(f).get("process_count")
    except (OSError, json.JSONDecodeError) as e:
        return f"{directory}/{_METADATA}: undecodable metadata: {e}"
    if nprocs is not None:
        # every process's commit marker must exist — a peer killed before
        # its metadata write means its shards are silently absent
        lost = [p for p in range(1, nprocs)
                if f"metadata.{p}.json" not in metas]
        if lost:
            names = ", ".join(f"metadata.{p}.json" for p in lost)
            return (f"{directory}: missing {names} — rank(s) {lost} of a "
                    f"{nprocs}-process save never committed (killed "
                    f"pre-commit or host lost); their shards are not "
                    f"recoverable from this directory")
        # ...and markers BEYOND process_count are stale leftovers from an
        # earlier larger-world save into this path: skip them, exactly as
        # load_state does (pre-process_count checkpoints check everything)
        metas = [n for n in metas
                 if _meta_proc(n) is None or _meta_proc(n) < nprocs]
    gone: List[tuple] = []  # (rank-or-None, key, file) of missing shards
    bad: List[str] = []     # size/crc/readability problems
    for name in metas:
        try:
            with open(os.path.join(directory, name)) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return f"{directory}/{name}: undecodable metadata: {e}"
        for key, rec in meta.get("leaves", {}).items():
            for shard in rec.get("shards", []):
                path = os.path.join(directory, shard["file"])
                try:
                    size = os.path.getsize(path)
                except OSError:
                    gone.append((shard.get("process"), key, shard["file"]))
                    continue
                want_len = shard.get("bytes")
                if want_len is not None and size != want_len:
                    bad.append(f"{path}: {size} bytes, metadata records "
                               f"{want_len}")
                    continue
                want_crc = shard.get("crc32")
                # the first corruption settles the verdict — keep scanning
                # for MISSING files (cheap stats, they drive the rank
                # postmortem) but don't re-read further shard bytes
                if checksums and want_crc is not None and not bad:
                    try:
                        got = _file_crc32(path)
                    except OSError:
                        bad.append(f"{path}: shard unreadable "
                                   f"(leaf {key!r})")
                        continue
                    if got != want_crc:
                        bad.append(f"{path}: crc32 mismatch")
    if gone:
        # dedup by FILE: a replicated leaf is recorded by every rank's
        # metadata under the same filename, and one lost file must not
        # read as "every host died"
        by_file: Dict[str, set] = {}
        keys_set = set()
        for r, k, f in gone:
            by_file.setdefault(f, set()).add(r)
            keys_set.add(k)
        # attribute a rank only when the file belongs to exactly one
        # (a multi-rank file is replicated — no single host to blame)
        ranks = sorted({next(iter(rs)) for rs in by_file.values()
                        if len(rs) == 1 and None not in rs})
        keys = sorted(keys_set)
        return (f"{directory}: {len(by_file)} shard file(s) missing"
                + (f" from rank(s) {ranks}" if ranks else "")
                + f" — lost host? affected leaves: "
                + ", ".join(repr(k) for k in keys[:4])
                + (f" (+{len(keys) - 4} more)" if len(keys) > 4 else "")
                + (f"; also {bad[0]}" if bad else ""))
    if bad:
        return bad[0]
    return None


def mesh_info(directory: str) -> Optional[Dict[str, Any]]:
    """Topology a checkpoint was WRITTEN on: ``{"axes": {name: size},
    "devices": N, "process_count": M}``, as the reference records it for a
    sharded save (the port records it for a save given ``shardings`` or
    ``mesh``). ``None`` for unreadable directories, host-only state, or
    checkpoints predating the elastic metadata."""
    if directory is None:
        # empty checkpoint root (no checkpoint yet) — the fresh-start path
        return None
    try:
        with open(os.path.join(directory, _METADATA)) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    mesh = meta.get("mesh")
    if mesh is None:
        return None
    out = dict(mesh)
    if meta.get("process_count") is not None:
        out["process_count"] = int(meta["process_count"])
    return out


def latest_checkpoint(root: str, verify: bool = True,
                      exclude: Sequence[str] = (),
                      on_invalid: Optional[Callable[[str], None]] = None,
                      ) -> Optional[str]:
    """Newest VALID ``step_*`` checkpoint under ``root`` (or ``None``).

    With ``verify`` (default), candidates failing
    :func:`validate_checkpoint` — torn saves, truncated or bit-flipped
    shards, a lost host's missing rank shards — are skipped, so restore
    falls back to the newest checkpoint that is complete (and completeness
    is topology-agnostic: a complete directory restores onto any target
    mesh). This reads every shard of the chosen candidate once (crc32); a
    subsequent :func:`load_state` reads them again — the double pass is
    deliberate: fallback must reject a bit-rotted-but-right-sized newest
    checkpoint BEFORE restore commits to it. Pass ``verify=False`` to pick
    by metadata presence only. ``exclude`` paths are skipped outright —
    the restore loop's "this one failed to LOAD, give me the next" hook.
    ``on_invalid`` is called with each path that FAILED validation; a
    retry loop that feeds those back into ``exclude`` avoids re-reading
    every shard byte of already-rejected candidates on each iteration.
    """
    if not os.path.isdir(root):
        return None
    excluded = {os.path.abspath(p) for p in exclude}
    steps = sorted(
        ((int(m.group(1)), name) for m, name in
         ((_STEP_DIR.match(n), n) for n in os.listdir(root)) if m),
        reverse=True)
    for step, name in steps:
        path = os.path.join(root, name)
        if os.path.abspath(path) in excluded:
            continue
        if not os.path.exists(os.path.join(path, _METADATA)):
            continue
        if verify:
            problem = validate_checkpoint(path)
            if problem is not None:
                print(f"[checkpoint] skipping {path}: {problem}",
                      flush=True)
                if on_invalid is not None:
                    on_invalid(path)
                continue
        return path
    return None


class AutoCheckpoint:
    """Periodic snapshot + resume-on-restart manager.

    ``maybe_save(step, state)`` saves every ``save_interval_steps`` (or
    seconds); completed saves rotate down to ``keep_max`` directories.
    ``restore()`` returns ``(step, state_dict)`` of the newest complete
    snapshot, or ``(0, None)``.
    """

    def __init__(self, root: str, save_interval_steps: int = 100,
                 save_interval_seconds: Optional[float] = None,
                 keep_max: int = 3, async_save: bool = True,
                 staging_ttl_seconds: float = 3600.0):
        self.root = root
        self.save_interval_steps = save_interval_steps
        self.save_interval_seconds = save_interval_seconds
        self.keep_max = keep_max
        self.async_save = async_save
        self.staging_ttl_seconds = float(staging_ttl_seconds)
        self._last_save_time = time.monotonic()
        self._last_step = -1
        self._pending: Optional[_PendingSave] = None
        os.makedirs(root, exist_ok=True)
        self._sweep_orphans()

    _ORPHAN = re.compile(r"^step_\d+\.tmp(-pt\d+)?$")
    _TRASH = re.compile(r"^(step_\d+)\.old-pt\d+$")
    _TMPFILE = re.compile(r"\.tmp\d+$")

    def _sweep_orphans(self, ttl: float = 0.0) -> None:
        """Clean up after a killed process: ``step_N.tmp*`` staging dirs are
        never valid restore targets (publish renames them away before they
        count) and are deleted; a ``step_N.old-pt<pid>`` overwrite trash
        copy whose ``step_N`` is MISSING is the old checkpoint caught
        between save_state's two renames — restore it rather than lose the
        only copy. Inside step dirs, ``*.tmp<pid>`` FILES are a
        multi-process writer SIGKILLed between staging a shard and its
        ``os.replace`` publish — each crashed incarnation leaves a
        uniquely-named file that no later save overwrites, so they are
        reaped here too.

        ``ttl`` > 0 reaps only staging dirs whose mtime is older than that
        many seconds. The startup sweep runs with ttl=0 (the restarting
        process owns the root); the PERIODIC sweep (from ``_gc``, so a
        long-lived trainer also heals) uses ``staging_ttl_seconds`` — a
        sibling process SIGKILLed mid-save must not leak its staging dir
        until the next restart, while a live peer's in-flight save (fresh
        mtime) is left alone. In a world of several processes only
        process 0 sweeps: it alone makes staging directories, and a peer
        starting late must not reap one in flight."""
        if _process_index() != 0:
            return
        now = time.time()

        def fresh(path: str, ttl: float = ttl) -> bool:
            # under a TTL, anything recently touched may belong to a LIVE
            # sibling mid-save (including the window between save_state's
            # two overwrite renames) — leave it alone
            if ttl <= 0.0:
                return False
            try:
                return now - os.path.getmtime(path) < ttl
            except OSError:
                return True  # raced with its publish rename: not stale

        # in-step-dir staging FILES sit in a root SHARED with multi-process
        # peers, and peers do not restart atomically: a straggler rank's
        # startup sweep (ttl=0) must not reap an earlier-restarted peer's
        # in-flight shard, so the FILE reap keeps the staging TTL whenever
        # other writer processes may be live.
        file_ttl = ttl
        if _process_count() > 1:
            file_ttl = max(ttl, self.staging_ttl_seconds)

        for name in os.listdir(self.root):
            path = os.path.join(self.root, name)
            m = self._TRASH.match(name)
            if m:
                if fresh(path):
                    continue
                target = os.path.join(self.root, m.group(1))
                if not os.path.exists(target):
                    os.replace(path, target)
                else:
                    shutil.rmtree(path, ignore_errors=True)
            elif self._ORPHAN.match(name):
                if fresh(path):
                    continue
                shutil.rmtree(path, ignore_errors=True)
            elif _STEP_DIR.match(name) and os.path.isdir(path):
                try:
                    members = os.listdir(path)
                except OSError:
                    continue  # raced with retention GC
                for fn in members:
                    if not self._TMPFILE.search(fn):
                        continue
                    fpath = os.path.join(path, fn)
                    if fresh(fpath, file_ttl):
                        continue
                    try:
                        os.remove(fpath)
                    except OSError:
                        pass  # raced with its publish rename

    def _due(self, step):
        if self.save_interval_seconds is not None:
            return time.monotonic() - self._last_save_time >= self.save_interval_seconds
        return step % self.save_interval_steps == 0 and step != self._last_step

    def maybe_save(self, step: int, state: Any, shardings=None,
                   mesh=None) -> bool:
        if not self._due(step):
            return False
        self.save(step, state, shardings=shardings, mesh=mesh)
        return True

    def save(self, step: int, state: Any,
             extra_files: Optional[Dict[str, bytes]] = None,
             shardings: Optional[Dict[str, Sharding]] = None, mesh=None):
        """Snapshot ``state`` as ``step_<step>`` (``shardings`` and
        ``mesh`` as :func:`save_state` takes them; in a world of several
        processes every process calls it with its own slices)."""
        if self._pending is not None:
            self._pending.wait()
        directory = os.path.join(self.root, f"step_{step}")
        # save_state publishes atomically (staging dir + os.replace), so a
        # kill mid-save leaves only a .tmp-pt orphan — never a half dir
        pending = save_state(state, directory, async_=self.async_save,
                             extra_files=extra_files, shardings=shardings,
                             mesh=mesh)

        if pending is None:
            self._gc()
        else:
            orig_wait = pending.wait

            def wait_and_gc(timeout=None):
                ok = orig_wait(timeout)
                if ok:
                    self._gc()
                return ok
            pending.wait = wait_and_gc
            self._pending = pending
        self._last_save_time = time.monotonic()
        self._last_step = step

    def wait(self):
        if self._pending is not None:
            self._pending.wait()
            self._pending = None

    def _gc(self):
        """Retain the newest ``keep_max`` VALID checkpoints. Invalid dirs
        (torn multi-host saves, corruption) never count toward the quota —
        else they could push out the only loadable fallback — and invalid
        dirs NEWER than the kept set are left alone (a peer may still be
        committing its metadata). Cheap stat-only validation: _gc runs
        after every save, so it must not re-read every shard byte. In a
        world of several processes only process 0 deletes."""
        if _process_index() != 0:
            return
        steps = sorted(
            (int(m.group(1)) for m in map(_STEP_DIR.match, os.listdir(self.root)) if m),
            reverse=True)
        kept_valid = 0
        for step in steps:
            path = os.path.join(self.root, f"step_{step}")
            if kept_valid < self.keep_max:
                if validate_checkpoint(path, checksums=False) is None:
                    kept_valid += 1
                continue
            shutil.rmtree(path, ignore_errors=True)
        # periodic staging sweep: a SIGKILLed sibling's .tmp-pt dir would
        # otherwise leak until the next process restart
        self._sweep_orphans(ttl=self.staging_ttl_seconds)

    def restore(self, shardings=None, template=None):
        self.wait()
        path = latest_checkpoint(self.root)
        if path is None:
            return 0, None
        step = int(_STEP_DIR.match(os.path.basename(path)).group(1))
        return step, load_state(path, shardings=shardings, template=template)


class AsyncSaver:
    """Fire-and-forget async saver with at-most-one outstanding save."""

    def __init__(self):
        self._pending: Optional[_PendingSave] = None

    def save(self, state, directory):
        if self._pending is not None:
            self._pending.wait()
        self._pending = save_state(state, directory, async_=True)
        return self._pending

    def wait(self):
        if self._pending is not None:
            self._pending.wait()
            self._pending = None

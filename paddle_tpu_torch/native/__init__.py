"""The host runtime in C++: sparse tables, the PS and graph services, the
graph store and the slot feed (port of ``paddle_tpu/native/__init__.py``).

The sources under ``src/`` are the reference's, byte for byte, except
that ``ps_table.cc`` applies a push's keys shard by shard, each shard's in
batch order on one thread (the reference splits a push into chunks over
its threads, so duplicate keys in two chunks apply in a racing order). A
table file, a wire frame or a sample is the same from either package. They
compile with ``g++`` on first use into one shared library under
``build/native/`` at the repository root, bound with ctypes. The library's
file name carries a digest of the sources and the flags: an edited source
rebuilds, an unchanged one is reused, and nothing is written into the
package tree. Concurrent builders (a process and the servers it starts)
serialize on a file lock, and the library is published with
``os.replace``, so a reader never loads half of one.

Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SRC_DIR", "BUILD_DIR", "CXX", "CXX_FLAGS", "library_path", "build",
           "get_lib", "as_i64_ptr", "as_i32_ptr", "as_f32_ptr"]

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cc", ".h"))


def library_path() -> Path:
    """Where this checkout's library lives: named by a digest of every
    source and header and of the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return BUILD_DIR / f"paddle_tpu_native-{h.hexdigest()[:16]}.so"


def _compiler() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(
            f"native build: C++ compiler {CXX!r} not found; the runtime "
            f"compiles on first use with `{CXX} {' '.join(CXX_FLAGS)} "
            f"-o {library_path()} {SRC_DIR}/*.cc`")
    return found


def build(verbose: bool = False) -> str:
    """Compile the sources unless this checkout's library exists, and
    return its path. Raises ``RuntimeError`` with the command and the
    compiler's output if the build fails."""
    out = library_path()
    with _lock:
        if out.exists():
            return str(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(out.with_suffix(".lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if out.exists():  # another process built it meanwhile
                    return str(out)
                tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
                cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp),
                       *(str(p) for p in _sources() if p.suffix == ".cc")]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(
                        f"native build failed:\n{' '.join(cmd)}\n"
                        f"{proc.stderr}")
                os.replace(tmp, out)
                if verbose:
                    print(f"built {out}")
                return str(out)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    i64p = c.POINTER(c.c_int64)
    f32p = c.POINTER(c.c_float)
    i32p = c.POINTER(c.c_int32)

    lib.pt_table_create.restype = c.c_void_p
    lib.pt_table_create.argtypes = [
        c.c_int32, c.c_int32, c.c_float, c.c_float, c.c_float, c.c_float,
        c.c_float, c.c_uint64, c.c_int32]
    lib.pt_table_destroy.argtypes = [c.c_void_p]
    lib.pt_table_pull.argtypes = [c.c_void_p, i64p, c.c_int64, f32p]
    lib.pt_table_push.argtypes = [c.c_void_p, i64p, f32p, c.c_int64]
    lib.pt_table_size.restype = c.c_int64
    lib.pt_table_size.argtypes = [c.c_void_p]
    lib.pt_table_keys.restype = c.c_int64
    lib.pt_table_keys.argtypes = [c.c_void_p, i64p, c.c_int64]
    lib.pt_table_shrink.restype = c.c_int64
    lib.pt_table_shrink.argtypes = [c.c_void_p, c.c_float]
    lib.pt_table_save.restype = c.c_int32
    lib.pt_table_save.argtypes = [c.c_void_p, c.c_char_p]
    lib.pt_table_load.restype = c.c_int32
    lib.pt_table_load.argtypes = [c.c_void_p, c.c_char_p]
    lib.pt_table_load_merge.restype = c.c_int32
    lib.pt_table_load_merge.argtypes = [c.c_void_p, c.c_char_p]
    lib.pt_table_clear.argtypes = [c.c_void_p]
    lib.pt_table_set_lr.argtypes = [c.c_void_p, c.c_float]
    lib.pt_table_dim.restype = c.c_int32
    lib.pt_table_dim.argtypes = [c.c_void_p]

    lib.pt_table_push_raw.argtypes = [c.c_void_p, i64p, f32p, c.c_int64]
    lib.pt_table_push_show_click.argtypes = [c.c_void_p, i64p, f32p,
                                             c.c_int64]
    lib.pt_table_set_score_coeffs.argtypes = [c.c_void_p, c.c_float,
                                              c.c_float]

    lib.pt_dense_create.restype = c.c_void_p
    lib.pt_dense_create.argtypes = [c.c_int64, c.c_int32, c.c_float,
                                    c.c_float]
    lib.pt_dense_destroy.argtypes = [c.c_void_p]
    lib.pt_dense_len.restype = c.c_int64
    lib.pt_dense_len.argtypes = [c.c_void_p]
    lib.pt_dense_set_lr.argtypes = [c.c_void_p, c.c_float]
    lib.pt_dense_get.restype = c.c_int32
    lib.pt_dense_get.argtypes = [c.c_void_p, c.c_int64, c.c_int64, f32p]
    lib.pt_dense_set.restype = c.c_int32
    lib.pt_dense_set.argtypes = [c.c_void_p, c.c_int64, c.c_int64, f32p]
    lib.pt_dense_push.restype = c.c_int32
    lib.pt_dense_push.argtypes = [c.c_void_p, c.c_int64, c.c_int64, f32p]
    lib.pt_dense_save.restype = c.c_int32
    lib.pt_dense_save.argtypes = [c.c_void_p, c.c_char_p]
    lib.pt_dense_load.restype = c.c_int32
    lib.pt_dense_load.argtypes = [c.c_void_p, c.c_char_p]

    lib.pt_ps_server_start.restype = c.c_void_p
    lib.pt_ps_server_start.argtypes = [c.c_void_p, c.c_int32]
    lib.pt_ps_server_port.restype = c.c_int32
    lib.pt_ps_server_port.argtypes = [c.c_void_p]
    lib.pt_ps_server_stop.argtypes = [c.c_void_p]
    lib.pt_ps_server_wait.argtypes = [c.c_void_p]
    lib.pt_ps_server_destroy.argtypes = [c.c_void_p]
    lib.pt_ps_server_load_dense.restype = c.c_int32
    lib.pt_ps_server_load_dense.argtypes = [c.c_void_p, c.c_char_p]

    lib.pt_graph_create.restype = c.c_void_p
    lib.pt_graph_create.argtypes = []
    lib.pt_graph_destroy.argtypes = [c.c_void_p]
    lib.pt_graph_add_edges.argtypes = [c.c_void_p, i64p, i64p, c.c_int64]
    lib.pt_graph_clear_edges.argtypes = [c.c_void_p]
    lib.pt_graph_add_edges_weighted.argtypes = [
        c.c_void_p, i64p, i64p, f32p, c.c_int64]
    lib.pt_graph_build.argtypes = [c.c_void_p, c.c_int32]
    lib.pt_graph_num_nodes.restype = c.c_int64
    lib.pt_graph_num_nodes.argtypes = [c.c_void_p]
    lib.pt_graph_num_edges.restype = c.c_int64
    lib.pt_graph_num_edges.argtypes = [c.c_void_p]
    lib.pt_graph_node_ids.restype = c.c_int64
    lib.pt_graph_node_ids.argtypes = [c.c_void_p, i64p, c.c_int64]
    lib.pt_graph_degree.restype = c.c_int64
    lib.pt_graph_degree.argtypes = [c.c_void_p, c.c_int64]
    lib.pt_graph_sample_neighbors.argtypes = [
        c.c_void_p, i64p, c.c_int64, c.c_int32, c.c_int32, c.c_uint64, i64p,
        i32p]
    lib.pt_graph_random_walk.argtypes = [
        c.c_void_p, i64p, c.c_int64, c.c_int32, c.c_uint64, i64p]
    lib.pt_graph_walk_step.argtypes = [
        c.c_void_p, i64p, i64p, c.c_int64, c.c_int32, c.c_uint64, i64p]
    lib.pt_graph_set_features.restype = c.c_int32
    lib.pt_graph_set_features.argtypes = [
        c.c_void_p, i64p, f32p, c.c_int64, c.c_int32]
    lib.pt_graph_get_features.restype = c.c_int32
    lib.pt_graph_get_features.argtypes = [
        c.c_void_p, i64p, c.c_int64, c.c_int32, f32p]
    lib.pt_graph_feature_dim.restype = c.c_int32
    lib.pt_graph_feature_dim.argtypes = [c.c_void_p]

    lib.pt_graph_server_start.restype = c.c_void_p
    lib.pt_graph_server_start.argtypes = [c.c_void_p, c.c_int32]
    lib.pt_graph_server_port.restype = c.c_int32
    lib.pt_graph_server_port.argtypes = [c.c_void_p]
    lib.pt_graph_server_stop.argtypes = [c.c_void_p]
    lib.pt_graph_server_wait.argtypes = [c.c_void_p]
    lib.pt_graph_server_destroy.argtypes = [c.c_void_p]

    lib.pt_feed_create.restype = c.c_void_p
    lib.pt_feed_create.argtypes = [i64p, c.c_int64]
    lib.pt_feed_destroy.argtypes = [c.c_void_p]
    lib.pt_feed_load_file.restype = c.c_int64
    lib.pt_feed_load_file.argtypes = [c.c_void_p, c.c_char_p]
    lib.pt_feed_num_records.restype = c.c_int64
    lib.pt_feed_num_records.argtypes = [c.c_void_p]
    lib.pt_feed_shuffle.argtypes = [c.c_void_p, c.c_uint64]
    lib.pt_feed_clear.argtypes = [c.c_void_p]
    lib.pt_feed_batch_slot.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_int64, c.c_int64, c.c_int64,
        i64p, i32p]
    lib.pt_feed_batch_labels.argtypes = [c.c_void_p, c.c_int64, c.c_int64,
                                         f32p]


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        _declare(lib)
        _lib = lib
    return _lib


def as_i64_ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def as_i32_ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def as_f32_ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes), under ``build/kernels/`` at the repository root.
The library's file name carries a digest of its source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one is reused. :func:`build_all` starts one
``nvcc`` per source at once.

Nothing here runs at import time; this module is safe to import on a
machine without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["CSRC_DIR", "BUILD_DIR", "SOURCES", "NVCC_FLAGS", "build",
           "build_all", "load", "build_log"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: every kernel source of the port
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
           "flash_attention_fwd_sm90.cu", "flash_attention_fwd_f32_sm90.cu",
           "flash_attention_bwd_dq_sm90.cu",
           "flash_attention_bwd_dkv_sm90.cu", "flash_attention_bwd_f32_sm90.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are compiled on first use")
    return found


def _library_path(source: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_log(source: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) from the build of ``source``, or "" if it was not
    built by this checkout."""
    log = _library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _start(source: str):
    """Start ``nvcc`` on ``source`` unless an up-to-date library exists:
    ``(library path, running process or None, temporary output)``."""
    out = _library_path(source)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def _finish(source: str, out: Path, proc, tmp: Path) -> Path:
    if proc is None:
        return out
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed: {source}: nvcc exited "
                           f"{proc.returncode}\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    return out


def build(source: str) -> Path:
    """Compile ``source`` unless an up-to-date library exists, and return
    the library's path. Raises ``RuntimeError`` with the compiler's output
    if the build fails."""
    return _finish(source, *_start(source))


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build every source with one ``nvcc`` each, all started together;
    ``{source: library path}``. Raises on the first failed build, after
    every compiler has exited."""
    started = {s: _start(s) for s in sources}
    done, errors = {}, []
    for source, job in started.items():
        try:
            done[source] = _finish(source, *job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = _loaded[source] = ctypes.CDLL(str(build(source)))
        return lib

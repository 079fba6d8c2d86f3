"""paddle_tpu_torch.inference — the serving-side predictor API (port of
``paddle_tpu/inference/__init__.py``).

Reference parity: ``paddle/fluid/inference/`` ``AnalysisPredictor``
(``api/analysis_predictor.h:95``) + ``paddle_infer::Config`` and the
zero-copy input/output handles (``api/details/``). The saved program is a
``torch.export`` program (see :mod:`paddle_tpu_torch.jit`) that runs the
ATen operators and the port's registered kernels as captured, so the
"analysis pass pipeline" has nothing to do; Config switches that exist to
toggle hand-written fusions are accepted and ignored for API
compatibility, each with a debug line saying so.

The predictor runs on the card by default (``enable_use_gpu``) and raises
without one unless ``disable_gpu()`` was called. A program saved on the
card runs on the CPU after ``disable_gpu()``, moved there by
``torch.export.passes.move_to_device_pass`` (the counterpart of the
reference's multi-platform export); its flash-attention nodes then run
the operator's plain version. A program saved on the CPU runs on the card
in the same way and launches the kernel: while ``torch.export`` captures,
the kernel gate admits CPU tensors too, so the program records the
operator wherever it was saved.

``build_capi`` and ``build_demo`` compile the C inference API
(``native/capi/infer_capi.cc``) and its plain-C consumer
(``tools/torch_infer_demo.c``) under ``build/native/`` at the repository
root.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .dist_model import DistModel, DistModelConfig, save_dist_model

__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "DistModel", "DistModelConfig", "save_dist_model"]


class Config:
    """``paddle_infer.Config`` analogue."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        # accept either the artifact prefix or the explicit .pdmodel path
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self.prog_file = prog_file
        self.params_file = params_file
        self.device = "cuda"  # the card unless disable_gpu()
        self._memory_optim = True

    # ---- device selection -------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0):
        self.device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self.device = "cpu"

    def set_cpu_math_library_num_threads(self, n: int):
        self._noop("set_cpu_math_library_num_threads",
                   "torch owns host threading (torch.set_num_threads)")

    # ---- legacy switches accepted for compatibility ----------------------
    @staticmethod
    def _noop(switch: str, why: str) -> None:
        """Honesty for accepted-and-ignored switches: one debug line says a
        knob did nothing and why, instead of silently swallowing it."""
        logging.getLogger(__name__).debug(
            "inference.Config.%s is a no-op here (%s)", switch, why)

    def switch_ir_optim(self, flag: bool = True):
        self._noop("switch_ir_optim",
                   "the captured program runs as it was recorded")

    def enable_memory_optim(self, flag: bool = True):
        self._noop("enable_memory_optim",
                   "torch's caching allocator is always on")
        self._memory_optim = flag

    def enable_tensorrt_engine(self, *a, **kw):
        raise NotImplementedError(
            "TensorRT is not part of the port: the program runs its ATen "
            "operators and the port's own kernels")


class Tensor:
    """Zero-copy-style IO handle (reference ``paddle_infer::Tensor``)."""

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[np.ndarray] = None

    def copy_from_cpu(self, arr) -> None:
        self._value = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        return np.asarray(self._value)

    def reshape(self, shape: Sequence[int]) -> None:
        if self._value is not None:
            self._value = self._value.reshape(shape)

    @property
    def shape(self):
        return None if self._value is None else tuple(self._value.shape)


def _host(t) -> np.ndarray:
    """An output as numpy (bfloat16, which numpy lacks, as float32: the
    same values)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Predictor:
    """Loads a ``jit.save``d program and runs it (AnalysisPredictor shape)."""

    def __init__(self, config: Config):
        # the port's operators must be registered before the program that
        # names them is read
        from ..kernels import flash_attention  # noqa: F401
        from ..jit import load as jit_load

        if not config.prog_file:
            raise ValueError("Config.prog_file (artifact prefix) required")
        self.config = config
        self._layer = jit_load(config.prog_file, device=config.device)
        meta = self._layer._meta
        self._input_names = [f"x{i}" for i in range(meta["n_inputs"])]
        self._inputs: Dict[str, Tensor] = {
            n: Tensor(n) for n in self._input_names}
        self._output_names = [f"out{i}" for i in range(meta["n_outputs"])]
        self._outputs: Dict[str, Tensor] = {
            n: Tensor(n) for n in self._output_names}

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> Tensor:
        return self._inputs[name]

    def run_tensors(self, inputs: Sequence) -> list:
        """One run on tensors (or arrays), returning the output tensors on
        the predictor's device: the run without the host copies."""
        out = self._layer(*inputs)
        return torch.utils._pytree.tree_leaves(out)

    def run(self, inputs: Optional[Sequence[np.ndarray]] = None):
        """Execute. Either pass arrays directly (convenience) or use the
        handle API (copy_from_cpu -> run() -> copy_to_cpu)."""
        if inputs is None:
            unset = [n for n in self._input_names
                     if self._inputs[n]._value is None]
            if unset:
                raise RuntimeError(
                    f"inputs not set: {unset} — call "
                    f"get_input_handle(name).copy_from_cpu(arr) first")
            inputs = [self._inputs[n].copy_to_cpu() for n in self._input_names]
        flat = self.run_tensors(inputs)
        for name, leaf in zip(self._output_names, flat):
            self._outputs[name].copy_from_cpu(_host(leaf))
        return [self._outputs[n].copy_to_cpu() for n in self._output_names]

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_output_handle(self, name: str) -> Tensor:
        return self._outputs[name]


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


# ----------------------------------------------------------- the C API
def _capi_dir():
    from pathlib import Path

    return Path(__file__).resolve().parents[1] / "native" / "capi"


def _build_locked(out, cmd_for, what: str) -> str:
    """Run ``cmd_for(tmp)`` unless ``out`` exists, under a file lock, and
    publish the result with ``os.replace`` (the native build's
    discipline)."""
    import fcntl
    import os
    import subprocess

    if out.exists():
        return str(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it meanwhile
                return str(out)
            tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
            cmd = cmd_for(str(tmp))
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{what} build failed:\n{' '.join(cmd)}\n"
                                   f"{proc.stderr}")
            os.replace(tmp, out)
            return str(out)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def _digest(*parts: bytes) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in parts:
        h.update(p + b"\0")
    return h.hexdigest()[:16]


def build_capi(verbose: bool = False) -> str:
    """Compile the C inference API (``native/capi/infer_capi.cc``) into
    ``build/native/libpaddle_tpu_torch_infer-<digest>.so`` — the
    non-Python serving surface (reference
    ``paddle/fluid/inference/capi_exp/``; see ``infer_capi.h`` for why the
    runtime embeds CPython). The name carries a digest of the sources, the
    flags and the Python it links, so an edit rebuilds; the build runs
    under a file lock and is published with ``os.replace``. Returns the
    library path."""
    import sysconfig

    from ..native import BUILD_DIR

    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    pyver = sysconfig.get_config_var("LDVERSION")
    flags = ["-O2", "-std=c++17", "-fPIC", "-shared", f"-I{inc}"]
    libs = [f"-L{libdir}", f"-lpython{pyver}", "-ldl", "-lm"]
    capi = _capi_dir()
    srcs = [capi / "infer_capi.cc", capi / "infer_capi.h"]
    name = _digest(" ".join(flags + libs).encode(),
                   *(p.read_bytes() for p in srcs))
    out = BUILD_DIR / f"libpaddle_tpu_torch_infer-{name}.so"
    lib = _build_locked(
        out, lambda tmp: ["g++", *flags, "-o", tmp, str(srcs[0]), *libs],
        "capi")
    if verbose:
        print(f"built {lib}")
    return lib


def build_demo(verbose: bool = False) -> str:
    """Compile ``tools/torch_infer_demo.c`` (the plain-C consumer) with cc
    into ``build/native/torch_infer_demo-<digest>``; returns the executable
    path."""
    from ..native import BUILD_DIR

    src = _capi_dir().parents[2] / "tools" / "torch_infer_demo.c"
    out = BUILD_DIR / f"torch_infer_demo-{_digest(src.read_bytes())}"
    exe = _build_locked(out, lambda tmp: ["cc", "-O2", "-o", tmp, str(src),
                                          "-ldl"], "demo")
    if verbose:
        print(f"built {exe}")
    return exe

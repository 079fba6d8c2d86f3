"""paddle_tpu_torch.static — the static-graph API surface, collapsed (port
of ``paddle_tpu/static/__init__.py``).

Reference parity: ``python/paddle/static/`` (Program/Executor over the
C++ ``ProgramDesc`` + ``InterpreterCore``). The static graph is the
captured function here: ``to_static`` converts its control flow,
``jit.save`` captures it with ``torch.export`` and writes the artifact.
This module keeps the names ported scripts reach for:

- the pieces with a direct collapsed equivalent work:
  ``InputSpec`` (the class of ``hapi.InputSpec``),
  ``save_inference_model`` / ``load_inference_model`` (jit.save/load),
  ``default_main_program`` (a token), ``name_scope`` / ``program_guard``
  (no-op contexts — naming and graph scoping have no analogue in an
  eager program);
- the op-append machinery (``Program.block().append_op`` style) cannot
  be emulated without the whole fluid op system, so ``Program`` /
  ``Executor.run`` / ``CompiledProgram`` raise a clear migration error
  instead of failing somewhere deep.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

from ..hapi.model import InputSpec  # noqa: F401  (paddle.static.InputSpec)

__all__ = ["InputSpec", "Program", "Executor", "default_main_program",
           "default_startup_program", "program_guard", "name_scope",
           "save_inference_model", "load_inference_model", "data",
           "CompiledProgram"]

_MIGRATE = (
    "paddle_tpu_torch has ONE execution model: PyTorch code run eagerly, "
    "captured by torch.export where a program is needed. Port "
    "static-graph code by writing the forward as a function/Layer and "
    "using paddle_tpu_torch.jit.to_static (control flow converts "
    "automatically), TrainStep (training), or paddle_tpu_torch.inference "
    "(serving). Program/Executor op-append emulation is deliberately not "
    "provided."
)


class Program:
    """Placeholder token: exists so `default_main_program()` comparisons
    and `program_guard` blocks parse; any op-level use raises."""

    def global_block(self):
        raise NotImplementedError(_MIGRATE)

    def block(self, *a, **kw):
        raise NotImplementedError(_MIGRATE)

    def clone(self, for_test: bool = False):
        return self


_main = Program()
_startup = Program()


def default_main_program() -> Program:
    return _main


def default_startup_program() -> Program:
    return _startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    yield


@contextlib.contextmanager
def name_scope(prefix: Optional[str] = None):
    yield


def data(name: str, shape: Sequence[int], dtype: str = "float32",
         lod_level: int = 0):
    """``paddle.static.data`` -> an InputSpec (the collapsed 'placeholder':
    feed it to ``to_static``/``jit.save`` input_spec)."""
    return InputSpec(list(shape), dtype=dtype, name=name)


class Executor:
    def __init__(self, place=None):
        self.place = place

    def run(self, *a, **kw):
        raise NotImplementedError(_MIGRATE)


class CompiledProgram:
    def __init__(self, *a, **kw):
        raise NotImplementedError(_MIGRATE)


def save_inference_model(path_prefix: str, feed_vars, fetch_vars,
                         executor=None, **kwargs):
    """Collapsed ``save_inference_model``: ``fetch_vars`` is the Layer (or
    ``to_static`` wrapper) whose forward produces the outputs, and
    ``feed_vars`` its InputSpecs; the artifact is the pair
    ``paddle_tpu_torch.jit.save`` writes and the Predictor and C API
    serve."""
    from ..jit import save as jit_save

    if not isinstance(feed_vars, (list, tuple)):
        feed_vars = [feed_vars]
    return jit_save(fetch_vars, path_prefix, input_spec=list(feed_vars))


def load_inference_model(path_prefix: str, executor=None, **kwargs):
    """Returns a callable loaded program (TranslatedLayer) — the collapsed
    (program, feed_names, fetch_names) triple. ``device`` (a keyword) is
    where it runs: ``None`` means the card, ``"cpu"`` the CPU."""
    from ..jit import load as jit_load

    return jit_load(path_prefix, device=kwargs.get("device"))

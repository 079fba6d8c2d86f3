"""paddle_tpu_torch.jit — program capture, serialization and loading (port
of ``paddle_tpu/jit/__init__.py``).

Reference parity: ``python/paddle/jit/`` (``@to_static``,
``paddle.jit.save/load`` -> TranslatedLayer). The JAX package's static
graph is StableHLO from ``jax.export``; here it is an ``ExportedProgram``
from ``torch.export``, which records the ATen operators the eager
forward runs, the port's flash-attention forward as its registered
operator ``paddle_tpu_torch::flash_attention_fwd`` among them. The only
AST work is converting tensor-dependent control flow (:mod:`.dy2static`),
which lowers to ``torch.cond`` / ``while_loop`` under capture.

``to_static`` runs eagerly (:func:`paddle_tpu_torch.framework.jit.jit`):
the capture happens once, in :func:`save`, with the parameters and
buffers as program INPUTS (``functional_call``), as in the reference, so
the program holds no weights and :class:`TranslatedLayer` can swap them.

Artifacts (the reference's ``.pdmodel``/``.pdiparams`` pair):
  ``<path>.pdmodel``   — ``torch.export.save`` of the program, with a
                         small JSON record of its inputs and outputs
  ``<path>.pdiparams`` — the reference's format: a protocol-4 pickle of
                         the ``(params, buffers)`` pair of name -> numpy
                         dicts. bfloat16 leaves are stored as their bits
                         (``framework.io``'s record) and read back as
                         bfloat16; the reference's ``ml_dtypes`` arrays
                         read too. A ``.pdiparams`` written by the JAX
                         package loads into a port model of the same
                         class with no conversion.
"""
from __future__ import annotations

import functools
import inspect
import json
import os
import pickle
import time
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..framework.io import _to_numpy, _to_tensor
from ..framework.jit import jit  # re-export: @to_static alias  # noqa: F401
from ..hapi.model import InputSpec
from ..nn.layer import Layer, buffer_state, functional_call, param_state

__all__ = ["to_static", "save", "load", "TranslatedLayer", "InputSpec",
           "not_to_static", "ProgramTranslator", "TracedLayer",
           "set_code_level", "set_verbosity", "enable_to_static"]

_META = "paddle_tpu_torch.json"


def to_static(fn=None, *, loop_bound=None, **kwargs):
    """``paddle.jit.to_static``: dy2static conversion, then :func:`jit`.

    Tensor-dependent ``if``/``while``/``for`` in the function (or the
    Layer's ``forward``) is AST-converted first (:mod:`.dy2static`): run
    eagerly it behaves as the original; captured by :func:`save` it lowers
    to ``torch.cond`` / ``while_loop``. Code without data-dependent control
    flow passes through unchanged.

    ``loop_bound=N`` bakes a max trip count into converted ``while``
    loops: under capture they become a masked loop of N trips that
    autograd differentiates (torch's ``while_loop`` is forward-only).
    """
    if fn is None:
        return functools.partial(to_static, loop_bound=loop_bound, **kwargs)
    from .dy2static import convert_control_flow, convert_layer

    # the global switch is consulted at CALL time (the reference's
    # StaticFunction checks it per call): enable(False) after decoration
    # must fall back to the ORIGINAL eager code
    if isinstance(fn, torch.nn.Module):
        orig_forward = fn.forward  # bound, pre-conversion
        convert_layer(fn, loop_bound=loop_bound)
        compiled = jit(fn, **kwargs)

        def dispatch(*args, **kw):
            if not ProgramTranslator.enable_to_static:
                return orig_forward(*args, **kw)
            return compiled(*args, **kw)

        dispatch.__wrapped_layer__ = fn
        return dispatch
    if callable(fn):
        converted = convert_control_flow(fn, loop_bound=loop_bound)
        try:
            first_param = next(iter(inspect.signature(fn).parameters), None)
        except (TypeError, ValueError):
            first_param = None
        # method = first param named `self` AND defined in a CLASS body:
        # the qualname's parent segment is the class (possibly itself
        # nested, 'outer.<locals>.Cls.forward'). A free function that
        # merely names its first arg `self` keeps the standalone path.
        parent = getattr(fn, "__qualname__", "").rsplit(".", 1)[0] \
            if "." in getattr(fn, "__qualname__", "") else ""
        if first_param == "self" and parent \
                and not parent.endswith("<locals>"):
            # method decoration — the canonical `@to_static` on `forward`
            # in a class body: the converted method is the forward, run
            # eagerly and captured by save() with its instance
            if kwargs:
                warnings.warn(
                    "to_static on a method ignores jit options "
                    f"{sorted(kwargs)}: no standalone jit wraps `self`. "
                    "Apply them at the enclosing jit/TrainStep, or call "
                    "to_static(layer, ...) on the instance.",
                    stacklevel=2)
            target = converted
        else:
            target = jit(converted, **kwargs)

        def dispatch(*args, **kw):
            if not ProgramTranslator.enable_to_static:
                return fn(*args, **kw)
            return target(*args, **kw)

        functools.update_wrapper(dispatch, fn)
        return dispatch
    return jit(fn, **kwargs)


def not_to_static(fn):
    """Mark ``fn`` to be skipped by dy2static conversion (reference
    ``paddle.jit.not_to_static``)."""
    fn.__not_to_static__ = True
    return fn


def _spec_example(spec, dims: dict, device):
    """An InputSpec as an example tensor and its ``torch.export`` dynamic
    dims (the reference's ``_spec_to_shape_dtype``).

    Dim conventions: ``None``/-1 at axis 0 = the shared ``batch`` Dim
    (all inputs' leading dynamic dims agree, the common case); ``None``
    elsewhere = a dim of its own position, whose range is what the model's
    own checks imply (``Dim.AUTO``: e.g. a length up to the position
    table); a string names a Dim explicitly (inputs using the same string
    share it). Dynamic dims are captured at size 2: ``torch.export``
    specializes a dim whose example size is 0 or 1."""
    shape, dyn = [], {}
    for i, d in enumerate(spec.shape):
        if isinstance(d, str) or d is None or (isinstance(d, int) and d < 0):
            name = d if isinstance(d, str) else ("batch" if i == 0 else None)
            if name is None:
                dyn[i] = torch.export.Dim.AUTO
            else:
                if name not in dims:
                    dims[name] = torch.export.Dim(name, min=1)
                dyn[i] = dims[name]
            shape.append(2)
        else:
            shape.append(int(d))
    dtype = convert_dtype(spec.dtype or "float32")
    return torch.zeros(shape, dtype=dtype, device=device), (dyn or None)


class _Infer(torch.nn.Module):
    """The captured function ``infer(params, buffers, *inputs)``. The layer
    is held outside the module's state, so the program lifts none of its
    weights: they are inputs."""

    def __init__(self, layer):
        super().__init__()
        self.__dict__["_layer"] = layer

    def forward(self, params, buffers, *inputs):
        out, _ = functional_call(self._layer, params, buffers, *inputs)
        return out


def _layer_device(layer, device=None) -> torch.device:
    for t in list(layer.parameters()) + list(layer.buffers()):
        return t.device
    from .. import default_device

    return default_device(device)


def _output_specs(program) -> list:
    """The program's outputs as ``InputSpec``s (dims that vary as None)."""
    out = []
    for node in program.graph.output_node().args[0]:
        val = node.meta["val"]
        dims = [d if isinstance(d, int) else None for d in val.shape]
        out.append(InputSpec(dims, dtype=str(val.dtype).replace("torch.",
                                                                 "")))
    return out


def save(layer, path: str, input_spec: Optional[Sequence] = None,
         **config) -> "torch.export.ExportedProgram":
    """``paddle.jit.save`` analogue.

    ``layer`` may be a Layer (any ``torch.nn.Module``; its eval-mode
    forward is captured, and its mode is restored after) or a
    :func:`to_static` wrapper over one. The capture runs on the device the
    layer's parameters live on (``config["device"]`` for a layer without
    any; default the card); :func:`load` and the predictor move the
    program to another device. Returns the ``ExportedProgram``.
    """
    if callable(layer) and hasattr(layer, "__wrapped_layer__"):
        layer = layer.__wrapped_layer__
    if not isinstance(layer, torch.nn.Module):
        raise TypeError("jit.save expects a Layer or to_static(Layer)")
    if input_spec is None:
        raise ValueError(
            "input_spec is required: pass [InputSpec(shape, dtype), ...] "
            "(dims of None export with a dynamic size)")

    was_training = layer.training
    layer.eval()
    try:
        device = _layer_device(layer, config.get("device"))
        params = {k: v.detach() for k, v in param_state(layer).items()}
        buffers = {k: v.detach() for k, v in buffer_state(layer).items()}
        dims: dict = {}
        examples, dyn = [], []
        for spec in input_spec:
            if isinstance(spec, InputSpec):
                ex, d = _spec_example(spec, dims, device)
            else:  # concrete example array
                ex = torch.as_tensor(np.asarray(spec)
                                     if not isinstance(spec, torch.Tensor)
                                     else spec).to(device)
                d = None
            examples.append(ex)
            dyn.append(d)
        dynamic_shapes = ({k: None for k in params},
                          {k: None for k in buffers}, tuple(dyn))
        t0 = time.perf_counter()
        program = torch.export.export(
            _Infer(layer), (params, buffers, *examples),
            dynamic_shapes=dynamic_shapes)
        t1 = time.perf_counter()
        # the example inputs are the weights: the program keeps none
        program.example_inputs = None

        meta = {"format": "paddle_tpu_torch.jit.v1", "device": str(device),
                "params": list(params), "buffers": list(buffers),
                "n_inputs": len(examples),
                "n_outputs": len(program.graph_signature.user_outputs)}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path + ".pdmodel", "wb") as f:
            torch.export.save(program, f,
                              extra_files={_META: json.dumps(meta)})
        host_state = ({k: _to_numpy(v) for k, v in params.items()},
                      {k: _to_numpy(v) for k, v in buffers.items()})
        with open(path + ".pdiparams", "wb") as f:
            pickle.dump(host_state, f, protocol=4)
        # what the last save spent capturing and writing (host seconds)
        save.seconds = {"capture": t1 - t0,
                        "write": time.perf_counter() - t1}
        return program
    finally:
        if was_training:
            layer.train()


save.seconds = {}


def _flat_name(prefix: str, name: str) -> str:
    # state-dict names must be dot-free (dots split layer paths)
    return prefix + name.replace(".", "__")


class TranslatedLayer(Layer):
    """A loaded program, callable like the original Layer (reference
    ``TranslatedLayer``, ``python/paddle/jit/translated_layer.py``).

    The parameters and buffers are this layer's state under dot-free names
    (``p_<name>``, ``b_<name>``, dots as ``__``) and are passed to the
    program at call time, so ``state_dict``/``set_state_dict`` read and
    change what it computes. ``set_state_dict`` installs new tensors
    instead of writing into the old ones, so a ``state_dict`` taken before
    keeps its values, as the reference's arrays do.
    """

    def __init__(self, program, params, buffers, meta: dict, device):
        super().__init__()
        self._program = program
        self._module = program.module()
        self._device = torch.device(device)
        self._meta = meta
        # registered in the reference's (sorted) order; passed to the
        # program in the order it was captured with
        self._param_names = list(meta.get("params", params))
        self._buffer_names = list(meta.get("buffers", buffers))
        for k in sorted(self._param_names):
            self.register_parameter(_flat_name("p_", k), torch.nn.Parameter(
                _to_tensor(params[k]).to(self._device), requires_grad=False))
        for k in sorted(self._buffer_names):
            self.register_buffer(_flat_name("b_", k),
                                 _to_tensor(buffers[k]).to(self._device))

    @property
    def program(self):
        return self._program

    def _set_by_path(self, path: str, value: torch.Tensor) -> None:
        target = self._get_by_path(path)
        with torch.no_grad():
            target.data = value.to(device=target.device,
                                   dtype=target.dtype).clone()

    def forward(self, *inputs):
        params = {k: getattr(self, _flat_name("p_", k))
                  for k in self._param_names}
        buffers = {k: getattr(self, _flat_name("b_", k))
                   for k in self._buffer_names}
        args = []
        for x in inputs:
            if not isinstance(x, torch.Tensor):
                x = np.asarray(x)
                # a read-only buffer (the C API's input view) is copied
                x = torch.from_numpy(x if x.flags.writeable else x.copy())
            args.append(x.to(self._device))
        with torch.no_grad():
            return self._module(params, buffers, *args)


def _import_operators() -> None:
    """Register the port's operators before a program that names them is
    deserialized."""
    from ..kernels import flash_attention  # noqa: F401


def _read_program(path: str):
    _import_operators()
    extra = {_META: ""}
    with open(path + ".pdmodel", "rb") as f:
        program = torch.export.load(f, extra_files=extra)
    return program, json.loads(extra[_META])


def load(path: str, device=None) -> TranslatedLayer:
    """``paddle.jit.load`` analogue: the program and its parameters, on
    ``device`` (``None`` means the card; ``"cpu"`` for the CPU). A program
    saved on another device is moved there
    (``torch.export.passes.move_to_device_pass``), the counterpart of the
    reference's multi-platform export."""
    from .. import default_device
    from torch.export.passes import move_to_device_pass

    dev = default_device(device)
    program, meta = _read_program(path)
    if torch.device(meta["device"]).type != dev.type:
        program = move_to_device_pass(program, dev)
    with open(path + ".pdiparams", "rb") as f:
        params, buffers = pickle.load(f)
    return TranslatedLayer(program, params, buffers, meta, dev)


# ---------------------------------------------------- translator controls
class ProgramTranslator:
    """Global dy2static switch (reference ``ProgramTranslator``): ported
    code calls ``get_instance().enable(False)`` to run converted models
    eagerly — here that makes :func:`to_static` call the original,
    unconverted function or forward."""

    _instance = None
    enable_to_static = True

    @classmethod
    def get_instance(cls) -> "ProgramTranslator":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static: bool) -> None:
        type(self).enable_to_static = bool(enable_to_static)


def enable_to_static(flag: bool = True) -> None:
    ProgramTranslator.get_instance().enable(flag)


def set_verbosity(level: int = 0, also_to_stdout: bool = False) -> None:
    """dy2static logging verbosity (reference ``set_verbosity``)."""
    import logging
    import sys as _sys

    logger = logging.getLogger("paddle_tpu_torch.jit.dy2static")
    logger.setLevel(logging.DEBUG if level > 0 else logging.WARNING)
    if also_to_stdout and not any(
            isinstance(h, logging.StreamHandler) for h in logger.handlers):
        logger.addHandler(logging.StreamHandler(_sys.stdout))


def set_code_level(level: int = 100, also_to_stdout: bool = False) -> None:
    """Log the transformed source of converted functions (reference
    ``set_code_level``); consumed by dy2static.convert_control_flow."""
    from . import dy2static

    dy2static.CODE_LEVEL = int(level)
    set_verbosity(1 if level > 0 else 0, also_to_stdout)


class TracedLayer:
    """Reference ``TracedLayer``: a layer with its example inputs, called
    through :func:`jit`; ``save_inference_model`` writes the artifact the
    Predictor serves, captured at the example inputs' shapes."""

    def __init__(self, layer, example_inputs):
        self._layer = layer
        self._inputs = list(example_inputs)
        self._compiled = jit(layer)

    @staticmethod
    def trace(layer, inputs):
        traced = TracedLayer(layer, inputs)
        return traced(*inputs), traced

    def __call__(self, *inputs):
        return self._compiled(*inputs)

    def save_inference_model(self, path, feed=None, fetch=None, **kwargs):
        specs = [InputSpec(list(np.shape(x)),
                           dtype=str(torch.as_tensor(x).dtype).replace(
                               "torch.", ""))
                 for x in self._inputs]
        save(self._layer, path, input_spec=specs)

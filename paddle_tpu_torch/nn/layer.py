"""``Layer``, the module base class, and the named random streams of
stochastic layers (port of ``paddle_tpu/nn/layer.py``).

:class:`Layer` is a ``torch.nn.Module`` with the reference's method names
where torch's differ (``sublayers``, ``add_sublayer``,
``create_parameter``, ``set_state_dict``, ``parameters()`` as a list,
...). The port's own layers are plain torch modules; every
function here takes any module. Called with eager Tensors, a Layer runs
on the torch tensors inside them and returns eager Tensors
(:func:`paddle_tpu_torch.eager.eager_layer_call`).

A :class:`RNGContext` holds one base seed per stream name ("dropout",
...). Each :meth:`RNGContext.next` folds the stream's call counter into
its base, so a forward is deterministic given the base seeds: the
training step opens one context per step from (base seed, step count).
The draws are counter-based on purpose. ``torch.utils.checkpoint``
restores only torch's global CPU/CUDA RNG state, never an explicit
generator; the recompute wrapper instead replays a copy of the context
(:meth:`RNGContext.fork`) with the counters as they were, so a dropout
inside a recomputed block draws the same seed twice
(:mod:`paddle_tpu_torch.distributed.parallel.recompute`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple, \
    Union

import torch

from ..framework import random as framework_random

__all__ = ["RNGContext", "rng_context", "current_rng_context",
           "take_rng_key", "Parameter", "Layer", "param_state",
           "buffer_state", "functional_call"]


class RNGContext:
    """Named deterministic seed streams: ``next(name)`` is
    ``fold_in(base[name], counter[name]++)`` (the analogue of the
    reference's ``RNGStatesTracker``). Streams without a base of their own
    draw from the "default" base."""

    def __init__(self, seeds: Mapping[str, int],
                 counters: Optional[Dict[str, int]] = None):
        self._base = {k: int(v) for k, v in seeds.items()}
        self._counters: Dict[str, int] = dict(counters or {})

    def next(self, name: str = "dropout") -> Optional[int]:
        base = self._base.get(name, self._base.get("default"))
        if base is None:
            return None
        c = self._counters.get(name, 0)
        self._counters[name] = c + 1
        return framework_random.fold_in(base, c)

    def fork(self) -> "RNGContext":
        """A copy with the same bases and counters: it draws what this
        context would draw next, without advancing it."""
        return RNGContext(self._base, self._counters)

    def advance_to(self, other: "RNGContext") -> None:
        """Take ``other``'s counters (a fork that ran on ahead)."""
        self._counters = dict(other._counters)


_local = threading.local()


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


@contextlib.contextmanager
def rng_context(rngs: Union[Mapping[str, int], RNGContext]):
    """Make ``rngs`` (seeds by stream name, or a context) the streams that
    :func:`take_rng_key` draws from inside the block (per thread)."""
    ctx = rngs if isinstance(rngs, RNGContext) else RNGContext(rngs)
    stack = _stack()
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


def current_rng_context() -> Optional[RNGContext]:
    stack = _stack()
    return stack[-1] if stack else None


def take_rng_key(name: str = "dropout") -> int:
    """A seed for a stochastic layer: the innermost context's stream when
    one is open, the global generator otherwise (eager use)."""
    ctx = current_rng_context()
    if ctx is not None:
        key = ctx.next(name)
        if key is not None:
            return key
        raise RuntimeError(
            f"layer requested rng stream {name!r} inside an rng context "
            f"that has neither that stream nor a 'default' one")
    return framework_random.next_seed()


# --------------------------------------------------------------------- Layer
class Parameter(torch.nn.Parameter):
    """``Parameter(value, trainable=True)``: assigned to a module's
    attribute it registers as a parameter (``trainable`` is
    ``requires_grad``)."""

    def __new__(cls, value, trainable: bool = True):
        if not isinstance(value, torch.Tensor):
            from ..ops._common import t

            value = t(value)
        return super().__new__(cls, value.detach(), requires_grad=trainable)

    @property
    def value(self) -> torch.Tensor:
        return self

    @property
    def trainable(self) -> bool:
        return self.requires_grad


def _is_dtype(arg) -> bool:
    from ..framework.dtype import convert_dtype

    if isinstance(arg, torch.dtype):
        return True
    if not isinstance(arg, str):
        return False
    try:
        convert_dtype(arg)
    except ValueError:
        return False
    return True


class Layer(torch.nn.Module):
    """Base class of layers: a ``torch.nn.Module`` under paddle's method
    names."""

    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        from ..framework.dtype import convert_dtype, get_default_dtype

        super().__init__()
        self._dtype = convert_dtype(dtype) or get_default_dtype()
        # per-parameter partition specs (local names), read by the
        # distributed package
        self._param_shardings: Dict[str, tuple] = {}
        self._name_scope = name_scope or type(self).__name__.lower()

    def __setattr__(self, name: str, value: Any):
        # a plain tensor assigned to a parameter's name replaces it, as
        # the reference replaces the array
        params = self.__dict__.get("_parameters")
        if params is not None and name in params and \
                isinstance(value, torch.Tensor) and \
                not isinstance(value, torch.nn.Parameter):
            old = params[name]
            value = torch.nn.Parameter(
                value.detach(), requires_grad=True if old is None
                else old.requires_grad)
        super().__setattr__(name, value)

    # ------------------------------------------------------------- creation
    def create_parameter(self, shape, dtype=None, attr=None,
                         is_bias: bool = False, default_initializer=None):
        """A parameter on the current device, drawn by the initializer of
        ``attr`` (or the global one, or ``default_initializer``; else
        ``Constant(0)`` for a bias and ``XavierUniform`` otherwise)."""
        from ..framework.compat import current_device
        from ..framework.dtype import convert_dtype
        from .initializer import create_parameter

        return create_parameter(
            shape, attr=attr, is_bias=is_bias,
            default_initializer=default_initializer,
            dtype=convert_dtype(dtype) or self._dtype,
            device=current_device())

    def add_parameter(self, name: str, parameter):
        if parameter is not None and \
                not isinstance(parameter, torch.nn.Parameter):
            parameter = Parameter(parameter)
        self.register_parameter(name, parameter)
        return parameter

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent: Optional[bool] = None):
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            from ..ops._common import t

            tensor = t(tensor)
        super().register_buffer(
            name, tensor, persistent=persistable if persistent is None
            else persistent)
        return tensor

    def add_sublayer(self, name: str, sublayer: torch.nn.Module):
        self.add_module(name, sublayer)
        return sublayer

    def set_param_sharding(self, name: str, spec: tuple):
        """Declare how parameter ``name`` shards over mesh axes, e.g.
        ``("mp", None)``."""
        self._param_shardings[name] = tuple(spec)

    def named_param_shardings(self, prefix: str = ""):
        for name, spec in self._param_shardings.items():
            yield (f"{prefix}.{name}" if prefix else name), spec
        for sname, sub in self.named_children():
            if isinstance(sub, Layer):
                sp = f"{prefix}.{sname}" if prefix else sname
                yield from sub.named_param_shardings(prefix=sp)

    # ------------------------------------------------------------- traversal
    def named_sublayers(self, prefix: str = "", include_self: bool = False
                        ) -> Iterator[Tuple[str, torch.nn.Module]]:
        for name, m in self.named_modules(prefix=prefix):
            if m is not self or include_self:
                yield name, m

    def sublayers(self, include_self: bool = False) -> List[torch.nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True, recurse=None,
                         remove_duplicate: bool = True):
        return super().named_parameters(
            prefix=prefix, recurse=include_sublayers if recurse is None
            else recurse, remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers: bool = True, recurse=None
                   ) -> List[torch.nn.Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      recurse=None, remove_duplicate: bool = True):
        return super().named_buffers(
            prefix=prefix, recurse=include_sublayers if recurse is None
            else recurse, remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers: bool = True, recurse=None
                ) -> List[torch.Tensor]:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None

    # ------------------------------------------------------------- hooks
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)``, its result (if not None) the
        call's output."""
        return self.register_forward_hook(hook)

    # ------------------------------------------------------------- state dict
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", prefix: str = None,
                   keep_vars: bool = False):
        if prefix is None:
            prefix = structured_name_prefix
        if include_sublayers:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        from collections import OrderedDict

        out = OrderedDict() if destination is None else destination
        self._save_to_state_dict(out, prefix, keep_vars)
        return out

    def set_state_dict(self, state_dict: Dict[str, Any],
                       use_structured_name: bool = True):
        """Copy the entries of ``state_dict`` (tensors or arrays) into the
        parameters and buffers of the same name; returns ``(missing,
        unexpected)`` names."""
        from ..ops._common import t

        own = dict(self.named_parameters())
        own.update(self.named_buffers())
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        for k, v in state_dict.items():
            if k in own:
                self._set_by_path(k, t(getattr(v, "_data", v)))
        return missing, unexpected

    load_dict = set_state_dict

    def _set_by_path(self, path: str, value: torch.Tensor) -> None:
        target = self.get_parameter(path) if path in dict(
            self.named_parameters()) else self.get_buffer(path)
        with torch.no_grad():
            if target.shape == value.shape and target.dtype == value.dtype:
                target.copy_(value)
            else:
                target.data = value.to(target.device)

    def _get_by_path(self, path: str) -> torch.Tensor:
        if path in dict(self.named_parameters()):
            return self.get_parameter(path)
        return self.get_buffer(path)

    # ------------------------------------------------------------- dtype
    def to(self, *args, **kwargs):
        """``to(dtype)`` casts the floating parameters (not the buffers),
        as the reference's; any other call is torch's ``Module.to``."""
        if len(args) == 1 and not kwargs and _is_dtype(args[0]):
            from ..framework.dtype import convert_dtype

            d = convert_dtype(args[0])
            with torch.no_grad():
                for p in self.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(d)
            return self
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype)

    def float(self):
        return self.to("float32")

    def bfloat16(self):
        return self.to("bfloat16")

    # ------------------------------------------------------------- call
    def __call__(self, *args, **kwargs):
        from .. import eager

        if eager._has_tensor(args, kwargs):
            return eager.eager_layer_call(self, *args, **kwargs)
        return super().__call__(*args, **kwargs)


# -------------------------------------------------------- functional bridge
def param_state(layer: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters by name."""
    return dict(layer.named_parameters())


def buffer_state(layer: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The buffers (BatchNorm's statistics, ...) by name."""
    return dict(layer.named_buffers())


def functional_call(layer: torch.nn.Module, params: Dict[str, Any],
                    buffers: Optional[Dict[str, Any]], *args,
                    rngs: Optional[Dict[str, Any]] = None, **kwargs):
    """Run ``layer`` with ``params`` and ``buffers`` in place of its own
    (``torch.func.functional_call``); returns ``(out, new_buffers)``, the
    given buffers after the call (a training-mode BatchNorm updates them
    in place)."""
    state = dict(params)
    state.update(buffers or {})
    ctx = rng_context(rngs) if rngs is not None else contextlib.nullcontext()
    with ctx:
        out = torch.func.functional_call(layer, state, args, kwargs)
    return out, {k: state[k] for k in (buffers or {})}

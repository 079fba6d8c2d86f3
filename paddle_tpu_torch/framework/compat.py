"""Places, the current device, mode switches and the top-level API's long
tail (port of ``paddle_tpu/framework/compat.py``).

A Place names a torch device (``CUDAPlace(i)`` is ``cuda:i``,
``CPUPlace()`` the CPU). The port keeps one *current device*: creation
ops and ``to_tensor`` place their result there. It is ``cuda`` until
:func:`set_device` says otherwise, and resolving it without a card
raises, as :func:`paddle_tpu_torch.default_device` does. Grad mode is
torch's autograd mode, which is the eager tape's.
"""
from __future__ import annotations

import builtins
import warnings
from typing import List, Optional

import numpy as np
import torch

__all__ = [
    "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "NPUPlace", "TPUPlace",
    "enable_static", "disable_static", "in_dynamic_mode",
    "is_grad_enabled", "set_grad_enabled", "LazyGuard", "batch",
    "check_shape", "create_parameter", "disable_signal_handler",
    "create_array", "array_write", "array_read", "array_length",
    "index_add_", "dtype", "set_device", "get_device", "current_device",
    "resolve_place",
]


# ------------------------------------------------------------------ places
class _Place:
    """A device tag resolving to a ``torch.device``."""

    _type = "cuda"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        if self._type == "cpu":
            return torch.device("cpu")
        return torch.device(self._type, self.device_id)

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(_Place):
    _type = "cpu"

    def __init__(self):
        super().__init__(0)


class CUDAPlace(_Place):
    """The card: ``CUDAPlace(n)`` is ``cuda:n``."""


class TPUPlace(_Place):
    """Kept so that scripts written for the JAX package run: the
    accelerator here is the card, so it resolves to ``cuda:n``."""


class CUDAPinnedPlace(_Place):
    _type = "cpu"  # page-locked host memory is host memory


class NPUPlace(_Place):
    """Resolves to the card, as ``TPUPlace`` does."""


# ---------------------------------------------------------- current device
_current = ["cuda"]


def _check(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; call set_device('cpu') or pass place=CPUPlace()")
    return dev


def set_device(device: str = "gpu") -> str:
    """``paddle.set_device``: ``"gpu"``, ``"gpu:1"``, ``"cuda:0"`` or
    ``"cpu"``. Selects where creation ops put their results; returns
    the device's paddle name."""
    kind, _, idx = str(device).partition(":")
    if kind in ("gpu", "cuda", "tpu"):
        dev = torch.device("cuda", int(idx or 0))
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unknown device {device!r}")
    _current[0] = str(_check(dev))
    return get_device()


def get_device() -> str:
    dev = torch.device(_current[0])
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


def current_device() -> torch.device:
    """The current device as a ``torch.device`` (raises for ``cuda``
    without a card)."""
    return _check(torch.device(_current[0]))


def resolve_place(place=None) -> torch.device:
    """A ``place=`` argument (a Place, a device string or a torch device)
    as a ``torch.device``; None is the current device."""
    if place is None:
        return current_device()
    if isinstance(place, _Place):
        return _check(place.torch_device())
    if isinstance(place, str) and place.split(":")[0] == "gpu":
        place = "cuda" + place[3:]
    return _check(torch.device(place))


# ------------------------------------------------- static/dynamic switches
_static_mode = [False]


def enable_static():
    """Flag-level parity: the port runs eagerly, so static mode changes
    nothing about execution, only what ``in_dynamic_mode()`` reports."""
    if not _static_mode[0]:
        warnings.warn(
            "paddle_tpu_torch runs eagerly; enable_static() only flips the "
            "mode flag", stacklevel=2)
    _static_mode[0] = True


def disable_static():
    _static_mode[0] = False


def in_dynamic_mode() -> builtins.bool:
    return not _static_mode[0]


# --------------------------------------------------------------- grad mode
def is_grad_enabled() -> builtins.bool:
    """Whether the eager tape (torch's autograd) records."""
    return torch.is_grad_enabled()


class set_grad_enabled:
    """Context manager or direct call, as ``paddle.set_grad_enabled``."""

    def __init__(self, mode: builtins.bool):
        self.prev = torch.is_grad_enabled()
        torch.set_grad_enabled(builtins.bool(mode))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self.prev)
        return False


class LazyGuard:
    """``paddle.LazyGuard``: the reference has nothing to defer, and
    neither has the port (a model takes ``device=`` at construction), so
    this is a documented no-op context."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ------------------------------------------------------------- misc utils
def batch(reader, batch_size: int, drop_last: bool = False):
    """Classic ``paddle.batch``: a sample reader as a batch reader."""

    def batched():
        buf: List = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def check_shape(shape) -> None:
    """Validate a shape argument: ints (-1 for an inferred dim) or tensors
    per dim, or a 1-D integer tensor."""
    if isinstance(shape, (list, tuple)):
        for d in shape:
            if isinstance(d, (int, np.integer)):
                if d < -1:
                    raise ValueError(f"invalid dim {d} in shape {shape}")
            elif not isinstance(d, (torch.Tensor, np.ndarray)):
                raise TypeError(f"shape dims must be int/tensor, got "
                                f"{type(d).__name__}")
    elif isinstance(shape, (torch.Tensor, np.ndarray)):
        if np.ndim(shape) != 1:
            raise ValueError("shape tensor must be 1-D")
    else:
        raise TypeError(f"shape must be list/tuple/tensor, got "
                        f"{type(shape).__name__}")


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A standalone trainable parameter (``paddle.create_parameter``): an
    eager Tensor that requires grad, on the current device, initialised
    as ``nn.Layer.create_parameter`` does. ``name`` and ``attr`` are
    accepted for the signature."""
    from ..eager import Tensor
    from ..nn.initializer import create_parameter as _create
    from .dtype import convert_dtype

    p = _create(shape, attr=attr, is_bias=is_bias,
                default_initializer=default_initializer,
                dtype=convert_dtype(dtype), device=current_device())
    return Tensor(p.data, stop_gradient=False)


def disable_signal_handler() -> None:
    """The reference lets users disable its crash handlers; the port
    installs none, so this is a no-op."""


# ----------------------------------------------- LoDTensorArray (as list)
def create_array(dtype: str = "float32", initialized_list=None) -> list:
    """LoDTensorArray: a Python list."""
    return [] if initialized_list is None else list(initialized_list)


def array_write(x, i, array: Optional[list] = None) -> list:
    if array is None:
        array = []
    i = int(i)
    if i < len(array):
        array[i] = x
    elif i == len(array):
        array.append(x)
    else:
        raise IndexError(f"array_write index {i} beyond length {len(array)}")
    return array


def array_read(array: list, i):
    return array[int(i)]


def array_length(array: list):
    return torch.tensor(len(array), dtype=torch.int64)


def index_add_(x, index, axis, value, name=None):
    """In-place ``index_add``: writes into an eager Tensor's or a torch
    tensor's storage and returns it. Refused on a tensor that requires
    grad while the tape records, as the reference refuses it."""
    from ..eager import Tensor, _unwrap

    data = x._data if isinstance(x, Tensor) else x
    if torch.is_grad_enabled() and data.requires_grad:
        raise RuntimeError(
            "index_add_ on a tensor that requires grad would break the "
            "recorded tape; use the functional index_add, detach() first, "
            "or run under no_grad()")
    index = torch.as_tensor(_unwrap(index), device=data.device)
    value = torch.as_tensor(_unwrap(value), device=data.device,
                            dtype=data.dtype)
    data.index_add_(axis % data.ndim, index, value)
    return x


class dtype:
    """``paddle.dtype`` callable: any dtype spec as a ``torch.dtype``."""

    def __new__(cls, spec):
        from .dtype import convert_dtype

        return convert_dtype(spec)

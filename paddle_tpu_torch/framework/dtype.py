"""Dtype names and helpers (port of ``paddle_tpu/framework/dtype.py``).

The JAX package's dtypes are ``jnp`` dtypes with paddle's string names;
here they are ``torch.dtype`` objects under the same names. A dtype may be
given as a paddle name (``"float32"``), a numpy dtype or a torch dtype.
The default float dtype is this package's own setting: it is not torch's
global default, which stays as it is for other callers.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "float32", "float64", "float16", "bfloat16", "int8", "int16", "int32",
    "int64", "uint8", "bool_", "complex64", "complex128", "convert_dtype",
    "dtype_name", "set_default_dtype", "get_default_dtype",
    "is_floating_point", "is_integer", "is_complex", "finfo", "iinfo",
]

# paddle name -> torch dtype
_DTYPE_ALIASES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "bool": torch.bool,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}

float32 = torch.float32
float64 = torch.float64
float16 = torch.float16
bfloat16 = torch.bfloat16
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_DEFAULT_DTYPE = [torch.float32]


def convert_dtype(dtype):
    """A paddle name, numpy dtype (or scalar type) or torch dtype as a
    ``torch.dtype``; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _DTYPE_ALIASES:
            raise ValueError(f"unknown dtype string: {dtype!r}")
        return _DTYPE_ALIASES[dtype]
    name = np.dtype(dtype).name
    if name not in _DTYPE_ALIASES:
        raise ValueError(f"no torch dtype for {dtype!r}")
    return _DTYPE_ALIASES[name]


def dtype_name(dtype) -> str:
    """The paddle name of a dtype (the inverse of :func:`convert_dtype`)."""
    d = convert_dtype(dtype)
    for name, alias in _DTYPE_ALIASES.items():
        if alias == d:
            return name
    return str(d).replace("torch.", "")


def set_default_dtype(dtype):
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise ValueError("default dtype must be floating point")
    _DEFAULT_DTYPE[0] = d


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def _dtype_of(x):
    if hasattr(x, "dtype"):
        return convert_dtype(x.dtype)
    return convert_dtype(np.asarray(x).dtype)


def is_floating_point(x) -> bool:
    return _dtype_of(x).is_floating_point


def is_integer(x) -> bool:
    d = _dtype_of(x)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def is_complex(x) -> bool:
    return _dtype_of(x).is_complex


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))

"""Serialization: ``paddle.save`` / ``paddle.load`` (port of
``paddle_tpu/framework/io.py``).

A nested state (dicts, lists, tuples) is pickled with its tensors as
numpy arrays, as the reference pickles its jax arrays. bfloat16 has no
numpy dtype without ``ml_dtypes``, which the port does not use, so a
bfloat16 tensor is pickled as the record ``{"__dtype__": "bfloat16",
"bits": <uint16 ndarray>}``: plain numpy, loadable anywhere. The
reference pickles an ``ml_dtypes`` array instead; both are read here (an
``ml_dtypes`` bfloat16 array unpickles only where that package exists).
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from .tree import tree_map

__all__ = ["save", "load", "BF16_RECORD"]

BF16_RECORD = "__dtype__"


def _is_bf16_record(x) -> bool:
    return (isinstance(x, dict) and x.get(BF16_RECORD) == "bfloat16"
            and set(x) == {BF16_RECORD, "bits"})


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {BF16_RECORD: "bfloat16",
                    "bits": t.view(torch.uint16).numpy().copy()}
        return t.numpy().copy()
    return x


def _bf16_bits(x) -> np.ndarray:
    """The uint16 bits of a bfloat16 record or an ``ml_dtypes`` array."""
    return x["bits"] if _is_bf16_record(x) else x.view(np.uint16)


def _is_bf16(x) -> bool:
    return _is_bf16_record(x) or (isinstance(x, np.ndarray)
                                  and x.dtype.name == "bfloat16")


def _to_tensor(x):
    if _is_bf16(x):
        bits = np.require(_bf16_bits(x), requirements="C")
        return torch.from_numpy(bits).view(torch.bfloat16)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.require(x, requirements="C"))
    return x


def _to_plain_numpy(x):
    """bfloat16 leaves as float32 arrays (exact: bf16 is float32's top
    half); every other leaf as it was stored."""
    if _is_bf16(x):
        bits = np.asarray(_bf16_bits(x)).astype(np.uint32) << 16
        return bits.view(np.float32)
    return x


def save(obj: Any, path: str, protocol: int = 4):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(tree_map(_to_numpy, obj, is_leaf=_is_bf16_record), f,
                    protocol=protocol)


def load(path: str, return_numpy: bool = False):
    """The saved state with its arrays as CPU tensors (bfloat16 included),
    or as numpy with ``return_numpy`` (bfloat16 leaves then come back as
    float32 arrays of the same values)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return tree_map(_to_plain_numpy if return_numpy else _to_tensor, obj,
                    is_leaf=_is_bf16_record)

"""int8 KV-cache quantization (port of the KV part of
``paddle_tpu/quantization/__init__.py:63-98``).

Under ``kv_dtype="int8"`` a cache entry is a ``(values, scales)`` pair
instead of a plain ``[B, S, Hkv, D]`` tensor: int8 values plus one
float32 abs-max scale per (row, position, head), ``[B, S, Hkv, 1]``.
The scale keeps its trailing axis of 1, so every cache primitive of
:mod:`paddle_tpu_torch.models.generation` (row slice and scatter, block
gather and scatter) treats both leaves alike. Symmetric quantization to
±127, so dequantizing is one multiply.

``xf / scale`` is a division, as in the reference (not a multiply by
the reciprocal): with it, ``torch.round`` (half to even, as
``jnp.round``) gives the reference's values and scales bit for bit on
the same float32 input.

The QAT/PTQ half of the reference module is not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["KV_QUANT_EPS", "kv_quantize", "kv_dequantize",
           "is_quantized_kv"]

KV_QUANT_EPS = 1e-8


def kv_quantize(x, eps: float = KV_QUANT_EPS):
    """Quantize ``x`` ``[..., D]`` to ``(int8 values, float32 scales)``
    with a per-head abs-max scale over the trailing (head_dim) axis.
    All-zero heads get the ``eps`` floor, so they dequantize to exact
    zero instead of 0/0."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(eps) / 127.0
    q = torch.round(xf / scale).clamp(-127.0, 127.0).to(torch.int8)
    return q, scale


def kv_dequantize(q, scale, dtype=torch.float32):
    """Inverse of :func:`kv_quantize`: ``q * scale`` cast to ``dtype``."""
    return (q.float() * scale).to(dtype)


def is_quantized_kv(entry) -> bool:
    """True when a cache entry is a quantized ``(int8 values, scales)``
    pair rather than a plain full-precision tensor."""
    return (isinstance(entry, (tuple, list)) and len(entry) == 2
            and getattr(entry[0], "dtype", None) == torch.int8)

"""Flash-attention forward: a hand-written sm_90a CUDA kernel and its plain
PyTorch version (port of ``paddle_tpu/kernels/flash_attention.py``).

The kernel (``csrc/flash_attention_fwd.cu``) replaces the Pallas
``_fwd_kernel`` (``flash_attention.py:131``): online-softmax attention
that emits O and the per-row log-sum-exp, with a top-left-aligned causal
mask (query i sees key j iff i >= j), an optional additive bias broadcast
from ``[B|1, H|1, Lq, Lk]``, float32 or bfloat16 inputs with float32
statistics, and head dims 64, 128 and 256.

Dispatch is by device, never by a fallback: a wrapper given CPU tensors
runs the plain version (that is what the CPU tests exercise), and given
CUDA tensors it launches the kernel or raises.

The gate :func:`should_use_flash` keeps the JAX gate's shape rules (head
dim in {64, 128, 256}; a bias that broadcasts to ``[B, H, Lq, Lk]``) and
drops its two TPU-only rules:

- ``Lq < 2048`` went to XLA's fused softmax because that was faster on a
  TPU v5e's matrix unit below 2k tokens. That measurement says nothing
  about an H100, and on the card the only alternative to the kernel is
  the plain version, which materialises the ``[Lq, Lk]`` scores;
- ``L % 128 == 0`` came from Mosaic's (8, 128) block tiling. The CUDA
  kernel masks its own ragged edge, so any length runs.

So on the card every prefill bucket goes through the kernel.

In-kernel attention dropout (the TPU PRNG in ``_dropout_mask``) is not
ported yet; it comes with the backward kernels, and until then
``dropout_p > 0`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["SUPPORTED_HEAD_DIMS", "should_use_flash", "flash_attention_fwd",
           "flash_attention_bhld", "flash_attention_blhd",
           "reference_attention_bhld", "reference_attention_fwd"]

SUPPORTED_HEAD_DIMS = (64, 128, 256)
_SOURCE = "flash_attention_fwd.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def should_use_flash(q, k, attn_mask, dropout_p) -> bool:
    """Kernel gate on ``[B, L, H, D]`` tensors: CUDA tensors whose shapes
    the kernel takes. CPU tensors always answer False (they run the plain
    path)."""
    del dropout_p  # dropout > 0 reaches the wrapper, which raises for now
    if not q.is_cuda:
        return False
    Lq, Lk = q.shape[1], k.shape[1]
    if attn_mask is not None:
        # bias must broadcast to [B, H, Lq, Lk]
        if attn_mask.ndim != 4:
            return False
        mb, mh, mq, mk = attn_mask.shape
        if mq != Lq or mk != Lk:
            return False
        if mb not in (1, q.shape[0]) or mh not in (1, q.shape[2]):
            return False
    return q.shape[-1] in SUPPORTED_HEAD_DIMS


# ----------------------------------------------------------- plain version
def reference_attention_fwd(q, k, v, causal: bool = False,
                            bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel on ``[B, H, L, D]``: returns
    ``(o, lse)``, o in q's dtype, lse float32 ``[B, H, Lq]``. Causal is
    top-left aligned (``q_pos >= k_pos``), as in the kernel, also when
    ``Lq != Lk``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        Lq, Lk = s.shape[-2], s.shape[-1]
        mask = torch.ones(Lq, Lk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return o, lse


def reference_attention_bhld(q, k, v, causal: bool = False, bias=None):
    """Unfused reference (port of ``reference_attention_bhld``,
    ``flash_attention.py:590``): the output of
    :func:`reference_attention_fwd`."""
    return reference_attention_fwd(q, k, v, causal=causal, bias=bias)[0]


# ---------------------------------------------------------------- kernel
@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The typed ctypes entry of the kernel library (built and loaded on
    the first call, then reused)."""
    fn = _build.load(_SOURCE).pt_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_operand(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, q has {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    # the kernel reads rows with 16-byte (f32) / 8-byte (bf16) vector loads
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(
            f"{name} needs a contiguous last dimension, 16-byte aligned "
            f"storage and (batch, head, row) strides that are multiples of "
            f"4 elements; got strides {t.stride()}")


def _launch(q, k, v, causal: bool, bias, out):
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.ndim != 4:
        raise ValueError(f"q must be [B, H, L, D], got {tuple(q.shape)}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2] if k.ndim == 4 else -1
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if Lq < 1 or Lk < 1 or B > 65535 or H > 65535:
        raise ValueError(f"unsupported shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    _check_operand("k", k, q.device, q.dtype, (B, H, Lk, D))
    _check_operand("v", v, q.device, q.dtype, (B, H, Lk, D))
    _check_operand("q", q, q.device, q.dtype, (B, H, Lq, D))
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _check_operand("out", out, q.device, q.dtype, (B, H, Lq, D))
    lse = torch.empty((B, H, Lq), device=q.device, dtype=torch.float32)
    bias_strides = (0, 0, 0)
    if bias is not None:
        if bias.ndim != 4 or tuple(bias.shape[2:]) != (Lq, Lk) \
                or bias.shape[0] not in (1, B) or bias.shape[1] not in (1, H):
            raise ValueError(f"bias {tuple(bias.shape)} does not broadcast "
                             f"to {(B, H, Lq, Lk)}")
        if bias.device != q.device:
            raise ValueError(f"bias is on {bias.device}, q on {q.device}")
        # broadcast dims get stride 0 from expand(); the kernel reads f32
        bias = bias.to(torch.float32).contiguous().expand(B, H, Lq, Lk)
        bias_strides = bias.stride()[:3]
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        *bias_strides)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), _DTYPE_CODES[q.dtype],
                 B, H, Lq, Lk, D, strides, int(bool(causal)),
                 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, causal: bool = False, bias=None,
                        out: Optional[torch.Tensor] = None):
    """``(o, lse)`` of attention on ``[B, H, L, D]`` tensors.

    CUDA tensors launch the kernel (which raises on what it does not take:
    dtype other than float32/bfloat16, head dim outside {64, 128, 256},
    a last dimension that is not contiguous); CPU tensors run
    :func:`reference_attention_fwd`. ``out`` (optional, ``[B, H, Lq, D]``,
    any strides with a contiguous last dimension) receives O in place,
    e.g. a transposed view of a ``[B, L, H, D]`` buffer.
    ``flash_attention_fwd.launches`` counts kernel launches."""
    if q.is_cuda:
        return _launch(q, k, v, causal, bias, out)
    o, lse = reference_attention_fwd(q, k, v, causal=causal, bias=bias)
    if out is not None:
        out.copy_(o)
        o = out
    return o, lse


flash_attention_fwd.launches = 0


def _reject_dropout(dropout_p: float) -> None:
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention dropout inside the flash kernel is not ported yet "
            "(it arrives with the backward kernels); run with dropout_p=0")


def flash_attention_bhld(q, k, v, causal: bool = False, bias=None,
                         dropout_p: float = 0.0, seed: int = 0):
    """Flash attention on ``[B, H, L, D]`` tensors (forward only)."""
    del seed  # consumed by the in-kernel dropout, which is not ported yet
    _reject_dropout(dropout_p)
    return flash_attention_fwd(q, k, v, causal=causal, bias=bias)[0]


def flash_attention_blhd(q, k, v, causal: bool = False, bias=None,
                         dropout_p: float = 0.0, seed: int = 0):
    """Public entry on paddle-layout ``[B, L, H, D]`` tensors. The kernel
    reads the inputs through their strides and writes O straight into a
    ``[B, L, H, D]`` buffer, so neither side is transposed in memory."""
    del seed
    _reject_dropout(dropout_p)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, bias=bias,
                        out=out.transpose(1, 2))
    return out

"""Flash attention, forward and backward: hand-written sm_90a CUDA kernels
and their plain PyTorch versions (port of
``paddle_tpu/kernels/flash_attention.py``).

The kernels replace the three Pallas kernels of the reference:

- ``csrc/flash_attention_fwd.cu`` replaces ``_fwd_kernel`` (``:131``):
  online-softmax attention that emits O and the per-row log-sum-exp; the
  route takes it for float32 at head dim 256 only;
- ``csrc/flash_attention_bwd.cu`` replaces ``_bwd_dq_kernel`` (``:198``)
  and ``_bwd_dkv_kernel`` (``:269``): dQ (and dS, the bias gradient before
  its reduction) over query tiles, dK/dV over key tiles; the route takes
  them at head dim 256 only (dK/dV for float32 only);
- ``csrc/flash_attention_fwd_sm90.cu``,
  ``csrc/flash_attention_bwd_dq_sm90.cu`` and
  ``csrc/flash_attention_bwd_dkv_sm90.cu`` replace the three kernels again
  for bf16 inputs, on the tensor cores (wgmma fed by TMA,
  ``csrc/sm90.cuh``), with the reference's float32-operand numerics kept
  by splitting the float32 operands they make (P, dS) into three bf16
  terms: the forward and dK/dV at head dims 64, 128 and 256, dQ at 64 and
  128;
- ``csrc/flash_attention_fwd_f32_sm90.cu`` replaces the forward again for
  float32 inputs at head dims 64 and 128 (serving prefill), on the same
  tensor cores: a pre-pass (:func:`split_bf16_terms`) splits Q, K and V
  into three bf16 terms each, P is split in registers, and each product
  keeps the six term pairs ``i + j <= 2``;
- ``csrc/flash_attention_bwd_f32_sm90.cu`` replaces dQ and dK/dV again
  for float32 inputs at head dims 64 and 128 (float32 training) in the
  same way: Q, K, V and dO arrive as their three bf16 terms, P M and dS
  are split in registers, six term pairs per product;
- ``csrc/philox.cuh`` replaces the in-kernel dropout ``_dropout_mask``
  (``:120``): Philox4x32-10 bits keyed per element by (seed, b, h, row,
  col), so the three kernels regenerate one mask although they tile
  differently. :func:`philox_bits` computes the same bits with torch
  integer ops.

All take a top-left-aligned causal mask (query i sees key j iff i >= j),
an optional additive bias broadcast from ``[B|1, H|1, Lq, Lk]``, float32
or bfloat16 inputs with float32 arithmetic, any length, and head dims 64,
128 and 256. :class:`FlashAttention` (the counterpart of the reference's
``_flash_diff`` ``custom_vjp``, ``:539-565``) wires them into autograd.

Dispatch is by device, never by a fallback: a wrapper given CPU tensors
runs the plain version (that is what the CPU tests exercise), and given
CUDA tensors it launches the kernel or raises. Among the kernels the
route is picked by (dtype, head dim, kernel) alone (:func:`kernel_route`):
bf16 at D in {64, 128} takes the ``wgmma`` forward, dQ and dK/dV kernels,
and at D = 256 the ``wgmma`` forward and dK/dV with the ``fma`` dQ;
float32 at D in {64, 128} the ``wgmma_f32`` ones, at D = 256 the ``fma``
ones. Each wrapper
counts its launches in ``<wrapper>.launches`` and per route in
``<wrapper>.routes`` (:func:`launch_counts`).

The gate :func:`should_use_flash` keeps the JAX gate's shape rules (head
dim in {64, 128, 256}; a bias that broadcasts to ``[B, H, Lq, Lk]``) and
drops its two TPU-only rules:

- ``Lq < 2048`` went to XLA's fused softmax because that was faster on a
  TPU v5e's matrix unit below 2k tokens. That measurement says nothing
  about an H100, and on the card the only alternative to the kernel is
  the plain version, which materialises the ``[Lq, Lk]`` scores;
- ``L % 128 == 0`` came from Mosaic's (8, 128) block tiling. The CUDA
  kernels mask their own ragged edge, so any length runs.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["SUPPORTED_HEAD_DIMS", "TENSOR_CORE_HEAD_DIMS", "kernel_route",
           "tma_geometry", "launch_counts", "reset_launch_counts",
           "wgmma_selfcheck", "split_bf16_terms", "should_use_flash",
           "philox_bits", "dropout_bits", "dropout_mask", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_bwd", "FlashAttention", "flash_attention_bhld",
           "flash_attention_blhd", "reference_attention_bhld",
           "reference_attention_fwd", "reference_attention_bwd"]

SUPPORTED_HEAD_DIMS = (64, 128, 256)
#: head dims at which each (dtype, kernel) runs on the tensor cores: route
#: ``"wgmma"`` for bf16, ``"wgmma_f32"`` for float32; the rest is ``"fma"``
TENSOR_CORE_HEAD_DIMS = {
    (torch.bfloat16, "fwd"): (64, 128, 256), (torch.bfloat16, "dq"): (64, 128),
    (torch.bfloat16, "dkv"): (64, 128, 256),
    (torch.float32, "fwd"): (64, 128), (torch.float32, "dq"): (64, 128),
    (torch.float32, "dkv"): (64, 128)}
_TENSOR_CORE_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "wgmma_f32"}
_FWD_SOURCE = "flash_attention_fwd.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
_FWD_SM90_SOURCE = "flash_attention_fwd_sm90.cu"
_FWD_F32_SM90_SOURCE = "flash_attention_fwd_f32_sm90.cu"
_DQ_SM90_SOURCE = "flash_attention_bwd_dq_sm90.cu"
_DKV_SM90_SOURCE = "flash_attention_bwd_dkv_sm90.cu"
_BWD_F32_SM90_SOURCE = "flash_attention_bwd_f32_sm90.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_ROWS = 64  # rows of every TMA box (csrc/sm90.cuh)


def kernel_route(dtype: torch.dtype, head_dim: int, kernel: str) -> str:
    """Which kernel a CUDA input of ``dtype`` and ``head_dim`` takes for
    ``kernel`` ("fwd", "dq" or "dkv"): at the head dims of
    :data:`TENSOR_CORE_HEAD_DIMS` (all three kernels at D 64/128; the bf16
    forward and dK/dV also at D = 256) ``"wgmma"`` (the sm_90a
    tensor-core kernels) for bf16 and ``"wgmma_f32"`` (the same tensor
    cores, each float32 operand as three bf16 terms) for float32;
    ``"fma"`` for everything else."""
    if kernel not in ("fwd", "dq", "dkv"):
        raise ValueError(f"kernel must be fwd, dq or dkv, got {kernel!r}")
    if head_dim in TENSOR_CORE_HEAD_DIMS.get((dtype, kernel), ()):
        return _TENSOR_CORE_ROUTES[dtype]
    return "fma"


def tma_geometry(t: torch.Tensor) -> Tuple[int, ...]:
    """The 14 tensor-map words through which the wgmma kernels read a bf16
    ``[B, H, L, D]`` tensor by TMA (``csrc/sm90.cuh``): 4 dims (D, then the
    row, head and batch dims ordered by stride, size-1 dims last), the byte
    strides of dims 1..3, the box (64 columns of 128 bytes by 64 rows), and
    the map positions (1..3) of the row, head and batch dims.

    A TMA map needs a 16-byte-aligned base and byte strides that are
    multiples of 16 (below 2^40); a tensor that breaks either, or whose
    last dimension is not contiguous, raises ``ValueError``. The stride of
    a size-1 dim is never stepped and is replaced by a packed one."""
    if t.ndim != 4 or t.stride(-1) != 1:
        raise ValueError(f"TMA needs a [B, H, L, D] tensor with a "
                         f"contiguous last dim; got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError("TMA needs a 16-byte-aligned base address")
    return _layout_geometry(tuple(t.shape), t.stride(), t.element_size())


@functools.lru_cache(maxsize=256)
def _layout_geometry(shape, strides, es):
    """:func:`tma_geometry` of a layout (cached: a training step asks for
    the same few layouts a hundred times)."""
    B, H, L, D = shape
    if (D * es) % 128:
        raise ValueError(f"TMA boxes are 128-byte columns; D = {D} of "
                         f"{es}-byte elements is not a multiple of them")
    outer = [(L, strides[2], "row"), (H, strides[1], "head"),
             (B, strides[0], "batch")]
    for n, stride, name in outer:
        if n > 1 and (stride <= 0 or (stride * es) % 16
                      or stride * es >= 2 ** 40):
            raise ValueError(f"TMA needs byte strides that are positive "
                             f"multiples of 16; the {name} stride is "
                             f"{stride * es} bytes")
    order = sorted(range(3), key=lambda i: (outer[i][0] == 1, outer[i][1]))
    dims, strides, box, pos = [D], [], [128 // es], {}
    prev = D * es
    for place, i in enumerate(order, 1):
        n, stride, name = outer[i]
        sb = stride * es if n > 1 else prev
        dims.append(n)
        strides.append(sb)
        box.append(_TILE_ROWS if name == "row" else 1)
        pos[name] = place
        prev = sb * n
    return (*dims, *strides, *box, pos["row"], pos["head"], pos["batch"])


def _tma_ok(t: torch.Tensor) -> bool:
    try:
        tma_geometry(t)
    except ValueError:
        return False
    return True


def should_use_flash(q, k, attn_mask, dropout_p) -> bool:
    """Kernel gate on ``[B, L, H, D]`` tensors: CUDA tensors whose shapes
    the kernels take. CPU tensors always answer False (they run the plain
    path). Dropout runs inside the kernels, so it does not gate."""
    del dropout_p
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


# ---------------------------------------------------------------- dropout
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """``(hi, lo)`` 32-bit halves of ``m * x`` for a 32-bit constant ``m``
    and an int64 tensor ``x`` of 32-bit values, without overflowing int64:
    ``x`` is split into 16-bit halves."""
    t = m * (x & 0xFFFF)                  # < 2^48
    u = m * (x >> 16) + (t >> 16)         # < 2^48 + 2^32
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox_bits(seed: int, c0, c1, c2, c3) -> torch.Tensor:
    """The first output word of Philox4x32-10 for counters ``(c0, c1, c2,
    c3)`` (int64 tensors of 32-bit values, broadcast together) and key
    ``(seed & 0xFFFFFFFF, seed >> 32)``: the plain version of
    ``csrc/philox.cuh``, equal to it bit for bit. Returns int64 values in
    ``[0, 2^32)``."""
    seed = int(seed)
    k0, k1 = seed & _U32, (seed >> 32) & _U32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _U32, (k1 + _PHILOX_W1) & _U32
    return c0


def _plain_dropout_bits(seed, B, H, rows, cols, row0, col0, device):
    def ar(n, start, dims):
        shape = [1, 1, 1, 1]
        shape[dims] = n
        return (torch.arange(n, device=device, dtype=torch.int64)
                + start).view(shape)

    c0, c1 = ar(cols, col0, 3), ar(rows, row0, 2)
    c2, c3 = ar(H, 0, 1), ar(B, 0, 0)
    zero = torch.zeros((B, H, rows, cols), device=device, dtype=torch.int64)
    return philox_bits(seed, c0 + zero, c1, c2, c3)


@functools.lru_cache(maxsize=None)
def _mask_fn():
    fn = _build.load(_FWD_SOURCE).pt_dropout_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64] + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dropout_bits(seed: int, B: int, H: int, rows: int, cols: int,
                 device=None, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """The uint32 Philox words behind the dropout mask of the window
    ``[B, H, row0:row0+rows, col0:col0+cols]``, as int64 ``[B, H, rows,
    cols]``. On a CUDA device the kernel (``pt_dropout_mask``) writes
    them (``dropout_bits.launches`` counts it); on the CPU
    :func:`philox_bits` computes them."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return _plain_dropout_bits(seed, B, H, rows, cols, row0, col0, device)
    out = torch.empty((B, H, rows, cols), device=device, dtype=torch.int32)
    with torch.cuda.device(device):
        err = _mask_fn()(out.data_ptr(), int(seed) & (2 ** 64 - 1), B, H,
                         row0, rows, col0, cols,
                         torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout mask launch failed: CUDA error {err}")
    dropout_bits.launches += 1
    return out.to(torch.int64) & _U32


dropout_bits.launches = 0


def _dropout_params(dropout_p: float):
    """``(threshold, scale)`` as the reference computes them (``:126-128``):
    keep iff bits >= min(int(p * 2^32), 2^32 - 1), kept values times
    float32 ``1 / (1 - p)``."""
    threshold = min(int(dropout_p * (2 ** 32)), 2 ** 32 - 1)
    scale = float(np.float32(1.0) / np.float32(1.0 - dropout_p))
    return threshold, scale


def dropout_mask(seed: int, B: int, H: int, Lq: int, Lk: int,
                 dropout_p: float, device=None) -> torch.Tensor:
    """The float32 ``[B, H, Lq, Lk]`` multiplier the kernels apply to P: 0
    where dropped, ``1 / (1 - p)`` where kept (plain version, from
    :func:`philox_bits`)."""
    threshold, scale = _dropout_params(dropout_p)
    bits = _plain_dropout_bits(seed, B, H, Lq, Lk, 0, 0, device)
    return (bits >= threshold).to(torch.float32) * scale


# ----------------------------------------------------------- plain version
def _scores(q, k, bias):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    return s


def _causal_keep(Lq: int, Lk: int, device) -> torch.Tensor:
    return torch.ones(Lq, Lk, dtype=torch.bool, device=device).tril()


def reference_attention_fwd(q, k, v, causal: bool = False, bias=None,
                            keep_mask=None) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The plain version of the forward kernel on ``[B, H, L, D]``:
    returns ``(o, lse)``, o in q's dtype, lse float32 ``[B, H, Lq]``.
    Causal is top-left aligned (``q_pos >= k_pos``), as in the kernel,
    also when ``Lq != Lk``. ``keep_mask`` (optional, float32, broadcast to
    ``[B, H, Lq, Lk]``, e.g. :func:`dropout_mask`) multiplies the
    normalised probabilities before ``P V``; the LSE ignores it."""
    s = _scores(q, k, bias)
    if causal:
        s = s.masked_fill(~_causal_keep(s.shape[-2], s.shape[-1], s.device),
                          float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    if keep_mask is not None:
        p = p * keep_mask
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return o, lse


def reference_attention_bwd(q, k, v, bias, o, lse, do, causal: bool = False,
                            keep_mask=None):
    """The plain version of the two backward kernels, written out (not
    through autograd) on ``[B, H, L, D]``. With ``P = exp(S - LSE)`` (0
    above the top-left causal diagonal), M = ``keep_mask`` (1 when None)
    and ``Delta = rowsum(dO * O)``: ``dP = (dO V^T) M``,
    ``dS = P (dP - Delta)``, ``dQ = dS K scale``, ``dK = dS^T Q scale``,
    ``dV = (P M)^T dO``. Returns ``(dq, dk, dv, ds)``: the gradients in
    the inputs' dtypes and dS float32 ``[B, H, Lq, Lk]``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, bias) - lse.float()[..., None])
    if causal:
        p = p * _causal_keep(p.shape[-2], p.shape[-1], p.device)
    dof = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    pd = p
    if keep_mask is not None:
        dp = dp * keep_mask
        pd = p * keep_mask
    delta = (dof * o.float()).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds


def reference_attention_bhld(q, k, v, causal: bool = False, bias=None):
    """Unfused reference (port of ``reference_attention_bhld``,
    ``flash_attention.py:590``): the output of
    :func:`reference_attention_fwd`."""
    return reference_attention_fwd(q, k, v, causal=causal, bias=bias)[0]


# ---------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _fwd_fn():
    """The typed ctypes entry of the forward kernel (built and loaded on
    the first call, then reused)."""
    fn = _build.load(_FWD_SOURCE).pt_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fn(name: str):
    fn = getattr(_build.load(_BWD_SOURCE), name)
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32,
                      ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_SM90_TAIL = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
              ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_float,
              ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _fwd_sm90_fn():
    fn = _build.load(_FWD_SM90_SOURCE).pt_flash_attention_fwd_sm90
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + _SM90_TAIL
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fwd_f32_sm90_fn():
    fn = _build.load(_FWD_F32_SM90_SOURCE).pt_flash_attention_fwd_f32_sm90
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + _SM90_TAIL
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _split_fn():
    fn = _build.load(_FWD_F32_SM90_SOURCE).pt_split_bf16_terms
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_sm90_fn(which: str, route: str):
    """The typed entry of the ``route`` ("wgmma" or "wgmma_f32") backward
    kernel ``which`` ("dq" or "dkv")."""
    if route == "wgmma_f32":
        source, name = _BWD_F32_SM90_SOURCE, f"bwd_{which}_f32_sm90"
    else:
        source = _DQ_SM90_SOURCE if which == "dq" else _DKV_SM90_SOURCE
        name = f"bwd_{which}_sm90"
    fn = getattr(_build.load(source), f"pt_flash_attention_{name}")
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + _SM90_TAIL
    fn.restype = ctypes.c_int
    return fn


def _geometry_words(*tensors):
    return _words_array(tuple(w for t in tensors for w in tma_geometry(t)))


@functools.lru_cache(maxsize=256)
def _words_array(words):
    """The ctypes array of ``words`` (cached; the kernels only read it)."""
    return (ctypes.c_ulonglong * len(words))(*words)


def wgmma_selfcheck(D: int, device, generator=None,
                    dtype: torch.dtype = torch.bfloat16):
    """Run the wgmma descriptor self-check on random ``a``, ``b`` of
    ``[64, D]`` in ``dtype``: returns ``(a, b, c1, c2)`` with ``c1 = a
    b^T`` through the K-major descriptors and ``c2 = a[:, :64] b`` through
    the register-A, transposed-B form, both float32 from the card's wgmma,
    for the caller to hold against a float64 product.

    bf16 runs ``pt_sm90_selfcheck`` (``csrc/sm90.cuh``; D 64, 128 or 256):
    one bf16 product of each form. float32 (D 64 or 128) runs ``pt_sm90_selfcheck_f32``
    (``csrc/flash_attention_fwd_f32_sm90.cu``): a and b split by
    :func:`split_bf16_terms`, b's terms loaded by TMA, and the six term
    pairs of each product through the term-pair products every float32
    kernel uses (``csrc/sm90.cuh``; a's register fragments split in
    registers for ``c2``)."""
    a, b = (torch.randn(64, D, generator=generator, device=device).to(dtype)
            for _ in range(2))
    c1 = torch.empty(64, 64, device=device)
    c2 = torch.empty(64, D, device=device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if dtype == torch.float32:
        a3, b3 = split_bf16_terms(a.view(1, 1, 64, D), b.view(1, 1, 64, D))
        fn = _build.load(_FWD_F32_SM90_SOURCE).pt_sm90_selfcheck_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(a.device):
            err = fn(a.data_ptr(), a3.data_ptr(), b3.data_ptr(),
                     _geometry_words(a3), _geometry_words(b3), c1.data_ptr(),
                     c2.data_ptr(), D, stream)
    else:
        fn = _build.load(_FWD_SM90_SOURCE).pt_sm90_selfcheck
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(a.device):
            err = fn(a.data_ptr(), b.data_ptr(),
                     _geometry_words(a.view(1, 1, 64, D)),
                     _geometry_words(b.view(1, 1, 64, D)), c1.data_ptr(),
                     c2.data_ptr(), D, stream)
    if err != 0:
        raise RuntimeError(f"wgmma self-check launch failed: CUDA error {err}")
    return a, b, c1, c2


def _plain_split(x: torch.Tensor) -> torch.Tensor:
    """The plain version of the split pre-pass for one float32 ``[B, H, L,
    D]`` tensor: its three bf16 terms ``t0 = bf16(x)``, ``t1 = bf16(x -
    t0)``, ``t2 = bf16(x - t0 - t1)`` as one ``[3 B, H, L, D]`` tensor
    (term t at batch ``t B + b``)."""
    terms = []
    x = x.float()
    for _ in range(3):
        t = x.to(torch.bfloat16)
        terms.append(t)
        x = x - t.float()
    return torch.cat(terms, dim=0)


def split_bf16_terms(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Split one to three float32 ``[B, H, L_i, D]`` tensors (same B, H and
    D; any strides with a contiguous last dimension and 16-byte rows) into
    their three bf16 terms each, as contiguous ``[3 B, H, L_i, D]`` tensors
    (term t of batch b at batch ``t B + b``): the operands of the float32
    tensor-core forward, whose sum is x to within 2^-24 |x|.

    CUDA tensors launch ``pt_split_bf16_terms`` once for all of them
    (``split_bf16_terms.launches`` counts it); CPU tensors run
    :func:`_plain_split`, which equals the kernel bit for bit."""
    if not 1 <= len(xs) <= 3:
        raise ValueError(f"split_bf16_terms takes 1 to 3 tensors, got "
                         f"{len(xs)}")
    if not xs[0].is_cuda:
        return tuple(_plain_split(x) for x in xs)
    B, H, _, D = xs[0].shape
    for i, x in enumerate(xs):
        _check_operand(f"operand {i}", x, xs[0].device, torch.float32,
                       (B, H, x.shape[2], D))
    outs = tuple(torch.empty((3 * B, H, x.shape[2], D), device=x.device,
                             dtype=torch.bfloat16) for x in xs)
    n = len(xs)
    with torch.cuda.device(xs[0].device):
        err = _split_fn()(
            n, (ctypes.c_void_p * n)(*(x.data_ptr() for x in xs)),
            (ctypes.c_void_p * n)(*(t.data_ptr() for t in outs)),
            (ctypes.c_int * n)(*(x.shape[2] for x in xs)),
            (ctypes.c_longlong * (3 * n))(*(s for x in xs
                                            for s in x.stride()[:3])),
            B, H, D, torch.cuda.current_stream(xs[0].device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"split_bf16_terms launch failed: CUDA error {err}")
    split_bf16_terms.launches += 1
    return outs


split_bf16_terms.launches = 0


def _check_operand(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, q has {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    # the kernels read rows with 16-byte (f32) / 8-byte (bf16) vector loads
    if not _rows_ok(t):
        raise ValueError(
            f"{name} needs a contiguous last dimension, 16-byte aligned "
            f"storage and (batch, head, row) strides that are multiples of "
            f"4 elements; got strides {t.stride()}")


def _rows_ok(t: torch.Tensor) -> bool:
    return (t.stride(-1) == 1 and not any(s % 4 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _kernel_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels can read it through its strides, else a
    contiguous copy (an incoming gradient may be any view)."""
    return t if _rows_ok(t) else t.contiguous()


def _empty_like_rows(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``[B, H, L, D]`` tensor in ``t``'s layout: a
    transposed view of a ``[B, L, H, D]`` buffer when ``t``'s heads lie
    inside its rows (the GPT path's q/k/v, views of the fused qkv), else
    contiguous."""
    B, H, L, D = t.shape
    if t.stride(1) < t.stride(2):
        return torch.empty((B, L, H, D), device=t.device,
                           dtype=t.dtype).transpose(1, 2)
    return torch.empty(t.shape, device=t.device, dtype=t.dtype)


def _check_shapes(q, k, v):
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
    _check_operand("q", q, q.device, q.dtype, (B, H, Lq, D))
    _check_operand("k", k, q.device, q.dtype, (B, H, Lk, D))
    _check_operand("v", v, q.device, q.dtype, (B, H, Lk, D))
    return B, H, Lq, Lk, D


def _kernel_bias(bias, B, H, Lq, Lk, device):
    """The bias as the kernels read it (float32, broadcast dims with stride
    0) and its (batch, head, row) strides; ``(None, (0, 0, 0))`` without."""
    if bias is None:
        return None, (0, 0, 0)
    if bias.ndim != 4 or tuple(bias.shape[2:]) != (Lq, Lk) \
            or bias.shape[0] not in (1, B) or bias.shape[1] not in (1, H):
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast "
                         f"to {(B, H, Lq, Lk)}")
    if bias.device != device:
        raise ValueError(f"bias is on {bias.device}, q on {device}")
    bias = bias.to(torch.float32).contiguous().expand(B, H, Lq, Lk)
    return bias, bias.stride()[:3]


def _dropout_args(dropout_p: float, seed: int):
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p == 0.0:
        return 0, 0, 0, 1.0
    threshold, scale = _dropout_params(dropout_p)
    return 1, int(seed) & (2 ** 64 - 1), threshold, scale


def _fwd_buffers(q, k, v, bias, out):
    """The checked shape ``(B, H, Lq, Lk, D)``, O (``out`` or a new tensor
    in q's layout), an empty LSE, and the bias as the kernels read it with
    its strides (:func:`_kernel_bias`)."""
    B, H, Lq, Lk, D = _check_shapes(q, k, v)
    if out is None:
        out = _empty_like_rows(q)
    _check_operand("out", out, q.device, q.dtype, (B, H, Lq, D))
    lse = torch.empty((B, H, Lq), device=q.device, dtype=torch.float32)
    return ((B, H, Lq, Lk, D), out, lse,
            *_kernel_bias(bias, B, H, Lq, Lk, q.device))


def _launch_fwd_fma(q, k, v, causal: bool, bias, out, dropout_p, seed):
    """Launch the FMA forward kernel (``csrc/flash_attention_fwd.cu``):
    float32 at D = 256, and the yardstick the tensor-core forwards are
    timed against. Counts nothing."""
    (B, H, Lq, Lk, D), out, lse, bias, bias_strides = _fwd_buffers(
        q, k, v, bias, out)
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], *bias_strides)
    with torch.cuda.device(q.device):
        err = _fwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODES[q.dtype], B, H, Lq, Lk, D, strides,
            int(bool(causal)), 1.0 / math.sqrt(D),
            *_dropout_args(dropout_p, seed),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd (fma) launch failed: "
                           f"CUDA error {err}")
    return out, lse


def _launch_fwd_sm90(route: str, q, k, v, causal: bool, bias, out,
                     dropout_p, seed):
    """Launch the tensor-core forward kernel of ``route`` ("wgmma", or
    "wgmma_f32", which first splits q, k, v into their bf16 terms)."""
    (B, H, Lq, Lk, D), out, lse, bias, bias_strides = _fwd_buffers(
        q, k, v, bias, out)
    fn, ops = _fwd_sm90_fn(), (q, k, v)
    if route == "wgmma_f32":  # the tensor cores read bf16 terms
        fn, ops = _fwd_f32_sm90_fn(), split_bf16_terms(q, k, v)
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t in ops),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), B, H, Lq, Lk, D, _geometry_words(*ops),
                 (ctypes.c_longlong * 6)(*out.stride()[:3], *bias_strides),
                 int(bool(causal)), 1.0 / math.sqrt(D),
                 *_dropout_args(dropout_p, seed),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd ({route}) launch failed: "
                           f"CUDA error {err}")
    return out, lse


def _launch_fwd(q, k, v, causal: bool, bias, out, dropout_p, seed):
    """Launch the forward kernel of :func:`kernel_route` and count it."""
    route = kernel_route(q.dtype, q.shape[-1], "fwd")
    if route == "fma":
        out, lse = _launch_fwd_fma(q, k, v, causal, bias, out, dropout_p,
                                   seed)
    else:
        out, lse = _launch_fwd_sm90(route, q, k, v, causal, bias, out,
                                    dropout_p, seed)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.routes[route] += 1
    return out, lse


def flash_attention_fwd(q, k, v, causal: bool = False, bias=None,
                        out: Optional[torch.Tensor] = None,
                        dropout_p: float = 0.0, seed: int = 0):
    """``(o, lse)`` of attention on ``[B, H, L, D]`` tensors.

    CUDA tensors launch the kernel of :func:`kernel_route` (which raises on
    what it does not take: dtype other than float32/bfloat16, head dim
    outside {64, 128, 256}, a last dimension that is not contiguous, and
    on the wgmma route q/k/v that TMA cannot read, :func:`tma_geometry`;
    the ``wgmma_f32`` route first launches :func:`split_bf16_terms`);
    CPU tensors run
    :func:`reference_attention_fwd` with the plain :func:`dropout_mask`.
    ``out`` (optional, ``[B, H, Lq, D]``, any strides with a contiguous
    last dimension) receives O in place, e.g. a transposed view of a
    ``[B, L, H, D]`` buffer. ``dropout_p > 0`` drops probabilities with
    the Philox mask of ``seed``. ``flash_attention_fwd.launches`` counts
    kernel launches."""
    if q.is_cuda:
        return _launch_fwd(q, k, v, causal, bias, out, dropout_p, seed)
    keep = None
    if dropout_p > 0.0:
        B, H, Lq, _ = q.shape
        keep = dropout_mask(seed, B, H, Lq, k.shape[2], dropout_p, q.device)
    o, lse = reference_attention_fwd(q, k, v, causal=causal, bias=bias,
                                     keep_mask=keep)
    if out is not None:
        out.copy_(o)
        o = out
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.routes = {"fma": 0, "wgmma": 0, "wgmma_f32": 0}


def _check_stats(lse, delta, shape, device):
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name} must be contiguous float32 {shape} "
                             f"on {device}")


def _launch_bwd(which: str, q, k, v, bias, do, lse, delta, outs, ds,
                causal, dropout_p, seed):
    B, H, Lq, Lk, D = _check_shapes(q, k, v)
    _check_operand("do", do, q.device, q.dtype, (B, H, Lq, D))
    _check_stats(lse, delta, (B, H, Lq), q.device)
    bias, bias_strides = _kernel_bias(bias, B, H, Lq, Lk, q.device)
    grads = {"dq": (0, 0, 0), "dk": (0, 0, 0), "dv": (0, 0, 0)}
    for name, t in outs.items():
        src = q if name == "dq" else k
        _check_operand(name, t, q.device, q.dtype, src.shape)
        grads[name] = t.stride()[:3]
    strides = (ctypes.c_longlong * 24)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *grads["dq"], *grads["dk"], *grads["dv"], *bias_strides)
    out0, out1 = (outs["dq"], ds) if which == "dq" else (outs["dk"],
                                                         outs["dv"])
    fn = _bwd_fn(f"pt_flash_attention_bwd_{which}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), out0.data_ptr(),
                 None if out1 is None else out1.data_ptr(),
                 _DTYPE_CODES[q.dtype], B, H, Lq, Lk, D, strides,
                 int(bool(causal)), 1.0 / math.sqrt(D),
                 *_dropout_args(dropout_p, seed), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_{which} launch failed: "
                           f"CUDA error {err}")


def _launch_bwd_sm90(which: str, route: str, q, k, v, bias, do, lse, delta,
                     out0, out1, out_strides, causal, dropout_p, seed,
                     terms=None):
    """Launch a tensor-core backward kernel of ``route``: ``which`` "dq"
    writes dQ (``out0``) and, when ``out1`` is not None, dS; "dkv" writes
    dK and dV. ``out_strides`` are the (batch, head, row) strides of the
    gradients. The ``wgmma_f32`` kernels read q, k, v and do as their bf16
    ``terms`` (:func:`split_bf16_terms`), the ``wgmma`` ones as they are."""
    B, H, Lq, Lk, D = _check_shapes(q, k, v)
    _check_operand("do", do, q.device, q.dtype, (B, H, Lq, D))
    _check_stats(lse, delta, (B, H, Lq), q.device)
    bias, bias_strides = _kernel_bias(bias, B, H, Lq, Lk, q.device)
    ops = (q, k, v, do) if route == "wgmma" else terms
    if route == "wgmma_f32":
        # TMA reads past a tensor's end as zeros: a wrong shape would be a
        # wrong gradient, not a fault
        for name, t, x in zip(("q", "k", "v", "do"), terms, (q, k, v, do)):
            want = (3 * B, *x.shape[1:])
            if t.dtype != torch.bfloat16 or tuple(t.shape) != want \
                    or not t.is_contiguous() or t.device != q.device:
                raise ValueError(f"the terms of {name} must be contiguous "
                                 f"bf16 {want} on {q.device}")
    strides = (*out_strides, *bias_strides)
    with torch.cuda.device(q.device):
        err = _bwd_sm90_fn(which, route)(
            ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
            None if bias is None else bias.data_ptr(), ops[3].data_ptr(),
            lse.data_ptr(), delta.data_ptr(), out0.data_ptr(),
            None if out1 is None else out1.data_ptr(), B, H, Lq, Lk, D,
            _geometry_words(*ops),
            (ctypes.c_longlong * len(strides))(*strides),
            int(bool(causal)), 1.0 / math.sqrt(D),
            *_dropout_args(dropout_p, seed),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_{which} ({route}) launch "
                           f"failed: CUDA error {err}")


def _backward_terms(q, k, v, do):
    """The bf16 terms of float32 q, k, v and do, as the ``wgmma_f32``
    backward kernels read them: two launches of :func:`split_bf16_terms`
    (which takes up to three tensors)."""
    return (*split_bf16_terms(q, k, v), *split_bf16_terms(do))


def flash_attention_bwd_dq(q, k, v, bias, do, lse, delta,
                           causal: bool = False, dropout_p: float = 0.0,
                           seed: int = 0, emit_ds: bool = False, terms=None):
    """Launch the dQ kernel of :func:`kernel_route` on CUDA ``[B, H, L,
    D]`` tensors (``lse`` and ``delta = rowsum(dO * O)`` float32 ``[B, H,
    Lq]``; on the wgmma route ``do`` too must be readable by TMA): returns
    ``(dq, ds)``, with ``ds`` the float32 ``[B, H, Lq, Lk]`` score gradient
    when ``emit_ds`` else None. On the ``wgmma_f32`` route ``terms`` are
    the bf16 terms of ``(q, k, v, do)`` (:func:`split_bf16_terms`), split
    here when not given. ``flash_attention_bwd_dq.launches`` counts
    launches, ``.routes`` them per route. CUDA only: the plain version is
    :func:`reference_attention_bwd`."""
    dq = _empty_like_rows(q)
    ds = None
    if emit_ds:
        ds = torch.empty((q.shape[0], q.shape[1], q.shape[2], k.shape[2]),
                         device=q.device, dtype=torch.float32)
    route = kernel_route(q.dtype, q.shape[-1], "dq")
    if route == "wgmma_f32" and terms is None:
        terms = _backward_terms(q, k, v, do)
    if route == "fma":
        _launch_bwd("dq", q, k, v, bias, do, lse, delta, {"dq": dq}, ds,
                    causal, dropout_p, seed)
    else:
        _launch_bwd_sm90("dq", route, q, k, v, bias, do, lse, delta, dq, ds,
                         dq.stride()[:3], causal, dropout_p, seed, terms)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.routes[route] += 1
    return dq, ds


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.routes = {"fma": 0, "wgmma": 0, "wgmma_f32": 0}


def flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta,
                            causal: bool = False, dropout_p: float = 0.0,
                            seed: int = 0, terms=None):
    """Launch the dK/dV kernel of :func:`kernel_route` on CUDA tensors
    (arguments as :func:`flash_attention_bwd_dq`): returns ``(dk, dv)``.
    ``flash_attention_bwd_dkv.launches`` counts launches, ``.routes`` them
    per route."""
    dk, dv = _empty_like_rows(k), _empty_like_rows(v)
    route = kernel_route(q.dtype, q.shape[-1], "dkv")
    if route == "wgmma_f32" and terms is None:
        terms = _backward_terms(q, k, v, do)
    if route == "fma":
        _launch_bwd("dkv", q, k, v, bias, do, lse, delta,
                    {"dk": dk, "dv": dv}, None, causal, dropout_p, seed)
    else:
        _launch_bwd_sm90("dkv", route, q, k, v, bias, do, lse, delta, dk, dv,
                         (*dk.stride()[:3], *dv.stride()[:3]), causal,
                         dropout_p, seed, terms)
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.routes[route] += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.routes = {"fma": 0, "wgmma": 0, "wgmma_f32": 0}
_WRAPPERS = {"fwd": flash_attention_fwd, "dq": flash_attention_bwd_dq,
             "dkv": flash_attention_bwd_dkv}


def launch_counts() -> dict:
    """``{"fwd" | "dq" | "dkv": {route: launches}}`` since the last
    :func:`reset_launch_counts`."""
    return {k: dict(w.routes) for k, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's ``launches`` and per-route counts, and
    :func:`split_bf16_terms`'s launches, to 0."""
    for w in _WRAPPERS.values():
        w.launches = 0
        w.routes = dict.fromkeys(w.routes, 0)
    split_bf16_terms.launches = 0


def _reduce_dbias(ds, bias):
    """Sum dS over the bias's broadcast dims (``:480-485``)."""
    if bias.shape[0] == 1:
        ds = ds.sum(0, keepdim=True)
    if bias.shape[1] == 1:
        ds = ds.sum(1, keepdim=True)
    return ds.to(bias.dtype)


def flash_attention_bwd(q, k, v, bias, o, lse, do, causal: bool = False,
                        dropout_p: float = 0.0, seed: int = 0,
                        bias_grad: bool = True):
    """Backward of attention on ``[B, H, L, D]`` (port of
    ``_flash_bwd_impl``, ``:411``): ``(dq, dk, dv, dbias_or_None)``.

    ``Delta = rowsum(dO * O)`` is a torch op in float32 (an XLA op outside
    the kernels in the reference, ``:429``); CUDA tensors then launch the
    dQ and dK/dV kernels (on the ``wgmma_f32`` route after splitting q, k,
    v and dO into the bf16 terms both read), CPU tensors run
    :func:`reference_attention_bwd` with the plain mask.
    ``bias_grad=False`` skips the ``[B, H, Lq, Lk]`` dS output and returns
    a zero dbias."""
    want_dbias = bias is not None and bias_grad
    if q.is_cuda:
        do = _kernel_rows(do)
        routes = {kernel_route(q.dtype, q.shape[-1], w) for w in ("dq", "dkv")}
        if "wgmma" in routes and not _tma_ok(do):
            do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1).contiguous()
        terms = _backward_terms(q, k, v, do) if "wgmma_f32" in routes \
            else None
        dq, ds = flash_attention_bwd_dq(q, k, v, bias, do, lse, delta,
                                        causal, dropout_p, seed,
                                        emit_ds=want_dbias, terms=terms)
        dk, dv = flash_attention_bwd_dkv(q, k, v, bias, do, lse, delta,
                                         causal, dropout_p, seed, terms=terms)
    else:
        keep = None
        if dropout_p > 0.0:
            B, H, Lq, _ = q.shape
            keep = dropout_mask(seed, B, H, Lq, k.shape[2], dropout_p,
                                q.device)
        dq, dk, dv, ds = reference_attention_bwd(q, k, v, bias, o, lse, do,
                                                 causal, keep)
    if bias is None:
        return dq, dk, dv, None
    if not want_dbias:
        return dq, dk, dv, torch.zeros_like(bias)
    return dq, dk, dv, _reduce_dbias(ds, bias)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on ``[B, H, L, D]`` (the counterpart
    of ``_flash_diff``'s ``custom_vjp``, ``:539-565``): the forward saves
    ``(q, k, v, bias, o, lse)`` and the seed, the backward launches the two
    backward kernels, which regenerate the forward's dropout mask."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal: bool, dropout_p: float,
                seed: int, bias_grad: bool):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, bias=bias,
                                     dropout_p=dropout_p, seed=seed)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.dropout_p, ctx.seed = causal, dropout_p, seed
        ctx.bias_grad = bias_grad
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_bwd(
            q, k, v, bias, o, lse, do, ctx.causal, ctx.dropout_p, ctx.seed,
            bias_grad=ctx.bias_grad and ctx.needs_input_grad[3])
        if not ctx.needs_input_grad[3]:
            dbias = None
        return dq, dk, dv, dbias, None, None, None, None


def flash_attention_bhld(q, k, v, causal: bool = False, bias=None,
                         dropout_p: float = 0.0, seed: int = 0,
                         bias_grad: bool = True):
    """Differentiable flash attention on ``[B, H, L, D]`` tensors, with an
    optional additive bias and in-kernel dropout (``seed`` picks the
    mask). ``bias_grad=False`` skips the O(L^2) dbias pass for masks that
    are not trained."""
    return FlashAttention.apply(q, k, v, bias, bool(causal),
                                float(dropout_p), int(seed), bool(bias_grad))


def flash_attention_blhd(q, k, v, causal: bool = False, bias=None,
                         dropout_p: float = 0.0, seed: int = 0,
                         bias_grad: bool = True):
    """Public entry on paddle-layout ``[B, L, H, D]`` tensors. The kernels
    read the inputs through their strides and write O and the gradients
    straight into ``[B, L, H, D]`` buffers, so nothing is transposed in
    memory."""
    out = flash_attention_bhld(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal, bias=bias,
                               dropout_p=dropout_p, seed=seed,
                               bias_grad=bias_grad)
    return out.transpose(1, 2)

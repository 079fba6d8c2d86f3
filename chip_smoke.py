#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines; any failure raises and the script
exits non-zero:

1. device    - the card (nvidia-smi name and power limit), torch and CUDA.
2. build     - compiles every CUDA source of the port from this checkout
               (nvcc, one library per source, all started together), fails
               on a register spill in the five wgmma sources, and holds the
               wgmma/TMA self-check (a 64 x 64 x D product through each
               descriptor form, in bf16 at D = 64, 128 and 256 and through
               the float32 forward's three-term products at 64 and 128)
               against a float64 product.
3. kernels   - calls each kernel's wrapper on the card at the shapes the
               serving and training paths give it, and holds the result
               against its plain PyTorch version on the same inputs (stated
               tolerance): the forward kernels (wgmma_f32 for float32 at
               D = 64 and 128 with its bf16-term split pre-pass, which must
               equal its plain version bit for bit; wgmma for bf16 at D = 64
               and 128, and at 256 for bf16; FMA for float32 at D = 256;
               each case checked for its route; the FMA forward timed
               beside the wgmma one at bf16 D = 256, also at the D = 256
               step's [2,8,1024,256]), the dQ and dK/dV
               backward kernels (wgmma for bf16 and wgmma_f32 for float32
               at D = 64 and 128; at bf16 D = 256 the wgmma dK/dV and the
               FMA dQ; FMA for float32 at D = 256; each case checked for
               the route of each kernel; dS as the bias gradient, also
               causal; every tensor-core kernel replayed bit for bit; the
               whole backward wrapper, with Delta and the split pre-pass,
               timed beside SDPA's; the FMA dQ and dK/dV, which the
               tensor-core ones replace, timed beside them at
               [2,16,1024,128] and [2,16,1024,64] float32 and at
               [1,8,1024,256], [2,16,1024,256] and the D = 256 step's
               [2,8,1024,256] bf16), and dropout (the
               CUDA Philox mask against the plain one bit for bit, its keep
               rate, replay of a fixed seed, and forward and backward at
               p = 0.1 given the same mask, also at bf16 D = 256 at its
               three shapes). Times the
               kernel and one PyTorch library call computing the same
               function (a yardstick the port never calls) in turns, as the
               median and range of 6 loops of 20 calls each, the plain
               version once, beside the least time the card could take.
4. serving   - a gpt_1p3b model (full width, random weights from a seed)
               behind InferenceServer(slots=4, max_length=2048) serves six
               requests; every stream must equal a solo generate() with the
               same arguments, no request may be requeued or failed, the
               wgmma_f32 flash forward and its split (float32 prefill) must
               launch exactly once per layer per prefill over the served
               run, no other forward at all, and the
               kernel-path prefill logits must agree with the
               plain-attention path.
5. training  - the bench's GPT-3 1.3B pretrain step (bf16 O2 AdamW,
               recompute, chunked loss, batch 2 x 1024) through TrainStep:
               5 warm-up and 8 timed steps; finite losses that fall, and
               exactly 48 wgmma forward, 24 wgmma dQ and 24 wgmma dK/dV
               launches per step, none on an FMA kernel. Then
               one float32 forward and backward of the same configuration
               with the kernels (exactly 48 wgmma_f32 forward, 24 dQ and 24
               dK/dV launches, and 96 of the split, none on an FMA kernel)
               and with plain attention (loss and
               per-parameter gradients within tolerance), and a 2-layer
               full-width bf16 dropout run on the wgmma kernels that
               replays bit for bit from its seed.
6. d256      - the same bf16 O2 step at gpt_1p3b width with 8 heads of 256
               and 2 layers: the gradients of the first loss with the
               kernels against plain attention's, each parameter within
               twice plain attention's own distance from a float32
               reference; one step with the kernels (exactly 4 wgmma
               forward, 2 wgmma dK/dV and 2 FMA dQ launches) and one with
               plain attention, the losses equal within two bf16 ulps.

Then a line with the kernels' summary, a line with the card's name and
power limit, and the last line {"ok": true, "device": {...}}.

It exits non-zero without printing a result when no CUDA device is
present, and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12        # CUDA cores, no tensor cores
PEAK_BF16_TC_FLOPS = 989e12   # tensor cores
PEAK_HBM_BYTES = 3.35e12
# INT32 on the CUDA cores: 64 lanes per SM x 132 SMs at the 1.98 GHz boost
# clock behind the data sheet's 67 TFLOP/s float32 (Hopper white paper)
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# the least integer instructions per dropout element of csrc/philox.cuh:
# each of the 10 rounds takes 2 wide 32 x 32 -> 64-bit products (hi and lo
# in one IMAD.WIDE) and 2 three-input XORs (one LOP3 each); the key
# schedule is the same for every element and not counted; 1 compare
PHILOX_OPS = 10 * (2 + 2) + 1

F32_TOL = 1e-4   # float32 kernel vs float32 einsum: summation order only
# the wgmma_f32 forward (six bf16 term pairs, float32's own 2^-24): the
# reference's float32 forward tolerance, |x - y| <= atol + rtol |y|, on O
# and on LSE, as its cuda tests hold it
F32_FWD_RTOL, F32_FWD_ATOL = 1e-5, 1e-5
# bf16 outputs: kernel and plain version each round an f32 value (equal to
# ~1e-6) to bf16, so they differ by at most one bf16 ulp of the element;
# the limit is two ulps of each element's own size, plus 1e-6 near zero
BF16_ULPS = 2
# backward, float32: the reference's backward tolerance, elementwise
# |x - y| <= BWD_ATOL + BWD_RTOL * |y|
BWD_RTOL, BWD_ATOL = 2e-4, 2e-5
# backward, bf16 outputs: BF16_ULPS ulps of each reference element plus
# 1e-5 of the tensor's largest magnitude (an element near zero is a
# float32 sum with cancellation; two summation orders differ there by
# about 1e-6 of the tensor's scale)
BWD_BF16_FLOOR = 1e-5
PREFILL_LOGITS_TOL = 2e-3  # 24 layers of f32 rounding between two attention paths
# training, float32, kernels vs plain attention through 24 layers: loss
# relative 1e-4, each parameter's gradient relative L2 error 1e-3
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_L2 = 1e-4, 1e-3
# training, bf16: the kernels' gradients and plain attention's may differ by
# twice what bf16 puts between plain attention's and float32's (each
# parameter, relative L2): the bound two paths that are each as close to
# float32 as plain attention could reach (triangle inequality)
BF16_GRAD_SLACK = 2
DROPOUT_P = 0.1
TRAIN_BATCH, TRAIN_SEQ = 2, 1024     # bench.py bench_gpt_1p3b
TRAIN_WARMUP, TRAIN_TIMED = 5, 8
# the D = 256 step (phase_d256_step): gpt_1p3b width with 8 heads of 256;
# its attention, [TRAIN_BATCH, 8, TRAIN_SEQ, 256] bf16 causal, is also a
# case of the forward, backward and dropout phases
D256_STEP_HEADS = 8
D256_STEP_FWD = f"d256_step_bf16_B{TRAIN_BATCH}_H{D256_STEP_HEADS}_L{TRAIN_SEQ}"
D256_STEP_BWD = f"d256_step_bfloat16_B{TRAIN_BATCH}_H{D256_STEP_HEADS}_L{TRAIN_SEQ}"


def bf16_ulp(x):
    """The bf16 spacing at |x|, elementwise (8 significant bits): 2^(e-8)
    for 2^(e-1) <= |x| < 2^e; 0 where x is 0."""
    import torch

    _, e = torch.frexp(x.float().abs())
    return torch.where(x == 0, 0.0, torch.exp2((e - 8).float()))


def output_tolerance(o_ref, route):
    """The elementwise limit on |o - o_ref| of a forward output of
    ``route``: BF16_ULPS ulps of o_ref plus 1e-6 for bfloat16, F32_FWD_ATOL
    + F32_FWD_RTOL |o_ref| on the wgmma_f32 route, F32_TOL for the float32
    FMA kernel."""
    import torch

    if o_ref.dtype == torch.bfloat16:
        return BF16_ULPS * bf16_ulp(o_ref) + 1e-6
    if route == "wgmma_f32":
        return F32_FWD_ATOL + F32_FWD_RTOL * o_ref.float().abs()
    return torch.full_like(o_ref, F32_TOL, dtype=torch.float32)


def lse_tolerance(lse_ref, route):
    """The elementwise limit on the LSE's error: as the output's on the
    wgmma_f32 route, else 10 F32_TOL."""
    if route == "wgmma_f32":
        return F32_FWD_ATOL + F32_FWD_RTOL * lse_ref.abs()
    return F32_TOL * 10


def bwd_tolerance(ref):
    """The elementwise limit on a backward output's error: BWD_ATOL +
    BWD_RTOL |ref| for float32; BF16_ULPS ulps plus BWD_BF16_FLOOR of the
    largest magnitude for bfloat16."""
    import torch

    if ref.dtype == torch.bfloat16:
        return (BF16_ULPS * bf16_ulp(ref)
                + BWD_BF16_FLOOR * ref.float().abs().max())
    return BWD_ATOL + BWD_RTOL * ref.abs()


def check_close(name, got, ref, limit) -> dict:
    """Max |got - ref| and its largest share of ``limit``; raises when an
    element is past its limit or not finite, or when the reference is all
    zeros (a check that could not fail)."""
    if not ref.abs().max().item() > 0:
        raise AssertionError(f"{name}: the plain version is all zeros")
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item()
    share = (diff / limit).max().item()
    if not (math.isfinite(err) and share <= 1.0):
        raise AssertionError(f"{name}: kernel vs plain max|err| {err} at "
                             f"{share} of its limit")
    return {"max_abs_err": err, "err_share_of_tol": share}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# A spin kernel of this many cycles (about 10 ms) runs ahead of each timed
# loop, so the host has queued the whole loop before its first launch
# starts: the events then time the device's work back to back, not the
# host's launch rate (a Python wrapper takes tens of microseconds a call,
# more than a 0.05 ms kernel).
HOST_LEAD_CYCLES = 20_000_000


def _timed_loop(fn, iters: int) -> float:
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_LEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    return _timed_loop(fn, iters)


def timed_in_turns(fns, loops: int = 20, rounds: int = 3) -> dict:
    """Device ms per call of each of ``fns`` (name -> callable), taken in
    turns so that drift of the card's clock falls on all alike: after one
    warm-up loop each, every round runs each callable's loop of ``loops``
    calls in order and then in reverse (A, B, B, A), so each gets
    ``2 * rounds`` loops. Returns ``{name: {"median", "min", "max"}}``."""
    import statistics

    for fn in fns.values():
        for _ in range(3):
            fn()
    samples = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            samples[name].append(_timed_loop(fns[name], loops))
    return {name: {"median": statistics.median(v), "min": min(v),
                   "max": max(v)} for name, v in samples.items()}


def _route_of(fa, which: str) -> str:
    """The one route of wrapper ``which`` launched since the last reset."""
    used = [r for r, n in fa.launch_counts()[which].items() if n]
    if len(used) != 1:
        raise AssertionError(f"{which}: launches by route "
                             f"{fa.launch_counts()[which]}, expected one route")
    return used[0]


def kept_pairs(Lq, Lk, causal):
    """The (query, key) pairs a top-left causal mask keeps (all without)."""
    if causal:  # row i keeps min(i + 1, Lk) keys
        return sum(min(i + 1, Lk) for i in range(Lq))
    return Lq * Lk


def _bound(flops, nbytes, tensor_cores):
    ops_ms = flops / (PEAK_BF16_TC_FLOPS if tensor_cores else PEAK_F32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def attention_bound_ms(B, H, Lq, Lk, D, causal, dtype_bytes, bias_bytes,
                       tensor_cores: bool, term_pairs: int = 1):
    """The least time an H100 could take for one attention forward: the
    larger of (bytes moved once: q, k, v, bias read; o, lse written) over
    HBM bandwidth and (FLOPs of the pairs this run's mask keeps: 2*D for
    QK^T and 2*D for PV per pair, times ``term_pairs``) over the peak rate
    of the units that do them. Float32 operands on the bf16 tensor cores
    need 6 term pairs per product (``wgmma_f32``: three bf16 terms of each
    operand, pairs i + j <= 2), the least work that keeps float32 accuracy
    there. Exponentials are not counted."""
    flops = 4.0 * D * kept_pairs(Lq, Lk, causal) * B * H * term_pairs
    nbytes = (B * H * (Lq + 2 * Lk) * D * dtype_bytes      # q, k, v
              + B * H * Lq * D * dtype_bytes + B * H * Lq * 4  # o, lse
              + bias_bytes)
    return _bound(flops, nbytes, tensor_cores)


def bwd_bound_ms(kernel, B, H, Lq, Lk, D, causal, dtype_bytes, bias_bytes,
                 ds_bytes, tensor_cores: bool, term_pairs: int = 1):
    """The least time an H100 could take for one backward kernel: the
    larger of its bytes (q, k, v, dO, lse, delta and bias read once; dQ
    and dS, or dK and dV, written once) over HBM bandwidth and its FLOPs
    (per kept pair 6D for dQ: Q K^T, dO V^T, dS K; 8D for dK/dV: those two
    again, P^T dO and dS^T Q; times ``term_pairs``) over the peak of the
    units that do them. Float32 operands on the bf16 tensor cores
    (``wgmma_f32``) take 6 term pairs per product and read q, k, v and dO
    as their three bf16 terms too (6 bytes an element)."""
    per_pair = 6 if kernel == "dq" else 8
    flops = per_pair * D * kept_pairs(Lq, Lk, causal) * B * H * term_pairs
    nbytes = (B * H * (2 * Lq + 2 * Lk) * D * dtype_bytes   # q, do, k, v
              + 2 * B * H * Lq * 4 + bias_bytes)              # lse, delta
    if term_pairs > 1:
        nbytes += B * H * (2 * Lq + 2 * Lk) * D * 3 * 2     # their terms
    if kernel == "dq":
        nbytes += B * H * Lq * D * dtype_bytes + ds_bytes
    else:
        nbytes += 2 * B * H * Lk * D * dtype_bytes
    return _bound(flops, nbytes, tensor_cores)


def _views(g, B, L, H, D, dtype, n=3):
    """``n`` [B, H, L, D] tensors as the GPT path hands them to the
    kernels: strided views of one fused [B, L, n, H, D] tensor."""
    import torch

    t = torch.randn(B, L, n, H, D, generator=g, device="cuda").to(dtype)
    return tuple(t[:, :, i].transpose(1, 2) for i in range(n))


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def phase_build(seed: int) -> None:
    """Build every kernel source, fail on a spill in the wgmma kernels, and
    hold the wgmma/TMA self-check against torch.matmul."""
    import re

    import torch

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    libs = {s: p.name for s, p in _build.build_all().items()}
    ptxas = {s: [ln.strip() for ln in _build.build_log(s).splitlines()
                 if "Used" in ln or "spill" in ln] for s in libs}
    emit("build", seconds=time.perf_counter() - t0, libraries=libs,
         ptxas=[ln for lines in ptxas.values() for ln in lines])
    spills = [ln for s in (fa._FWD_SM90_SOURCE, fa._FWD_F32_SM90_SOURCE,
                           fa._DQ_SM90_SOURCE, fa._DKV_SM90_SOURCE,
                           fa._BWD_F32_SM90_SOURCE)
              for ln in ptxas[s]
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
    if spills:
        raise AssertionError(f"register spills in the wgmma kernels: {spills}")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    out = {}
    # the head dims of each dtype's tensor-core forward
    for dtype, D in [(dtype, D) for (dtype, kernel), dims
                     in fa.TENSOR_CORE_HEAD_DIMS.items() if kernel == "fwd"
                     for D in dims]:
        a, b, c1, c2 = fa.wgmma_selfcheck(D, "cuda", g, dtype=dtype)
        torch.cuda.synchronize()
        for name, got, x, y in (("kmajor", c1, a, b.T), ("transposed_b", c2,
                                                        a[:, :64], b)):
            # bf16 products are exact in float32; a float32 sum of K terms
            # is within K 2^-24 of sum |x y| of the exact one. float32
            # operands as six bf16 term pairs drop a few 2^-24 more.
            k = x.shape[1] + (4 if dtype == torch.float32 else 0)
            limit = 2 * k * 2.0 ** -24 * (x.double().abs() @ y.double().abs())
            key = f"{name}_{_dtype_name(a)}_d{D}"
            out[key] = check_close(f"wgmma self-check {key}", got,
                                   x.double() @ y.double(), limit + 1e-30)
    emit("selfcheck", **out)


def _fwd_cases(g):
    """(name, q, k, v, causal, bias, route, tol) of the forward checks."""
    import torch

    bf16_tol = f"{BF16_ULPS} bf16 ulps + 1e-6"
    f32_tol = f"{F32_FWD_ATOL} + {F32_FWD_RTOL} |ref|"
    cases = []
    for L in (64, 512, 1024, 2048):  # the serving path's prefill buckets
        cases.append((f"prefill_f32_L{L}", *_views(g, 1, L, 16, 128, torch.float32),
                      True, None, "wgmma_f32", f32_tol))
    cases.append(("d64_causal_f32_B2_L1024", *_views(g, 2, 1024, 16, 64, torch.float32),
                  True, None, "wgmma_f32", f32_tol))
    cases.append(("d256_causal_f32_L1024", *_views(g, 1, 1024, 8, 256, torch.float32),
                  True, None, "fma", F32_TOL))
    cases.append(("causal_bf16_L2048", *_views(g, 1, 2048, 16, 128, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    # the training step's attention: [2, 16, 1024, 128] bf16, causal
    cases.append(("train_bf16_B2_L1024", *_views(g, 2, 1024, 16, 128, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    cases.append(("d64_causal_bf16_B2_L1024", *_views(g, 2, 1024, 16, 64, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    # bench.py bench_gpt_primary's attention: [8, 16, 1024, 64] bf16, causal
    cases.append(("primary_bf16_B8_L1024", *_views(g, 8, 1024, 16, 64, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    # D = 256: the wgmma forward at two sizes, and at the D = 256 step's
    # own [2, 8, 1024, 256] (phase_d256_step)
    cases.append(("d256_causal_bf16_L1024", *_views(g, 1, 1024, 8, 256, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    cases.append(("d256_causal_bf16_B2_L1024", *_views(g, 2, 1024, 16, 256, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    cases.append((D256_STEP_FWD, *_views(g, TRAIN_BATCH, TRAIN_SEQ, D256_STEP_HEADS,
                                         256, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    for dtype, D, route, tol in ((torch.float32, 128, "wgmma_f32", f32_tol),
                                 (torch.bfloat16, 64, "wgmma", bf16_tol)):
        q = torch.randn(1, 16, 384, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(1, 16, 640, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(1, 16, 640, D, generator=g, device="cuda").to(dtype)
        bias = torch.randn(1, 16, 384, 640, generator=g, device="cuda")
        cases.append((f"bias_noncausal_{_dtype_name(q)}_d{D}_Lq384_Lk640",
                      q, k, v, False, bias, route, tol))
    for dtype, route, tol in ((torch.float32, "wgmma_f32", f32_tol),
                              (torch.bfloat16, "wgmma", bf16_tol)):
        q, k, v = _views(g, 1, 1500, 16, 128, dtype)
        cases.append((f"ragged_causal_{_dtype_name(q)}_L1500", q, k, v, True,
                      None, route, tol))
    return cases


def split_case(fa, name, q, k, v) -> dict:
    """The wgmma_f32 route's pre-pass (``split_bf16_terms``) on q, k, v
    against its plain version, bit for bit, and timed: its bound is its
    bytes (float32 read once, three bf16 terms written once)."""
    import torch

    got = fa.split_bf16_terms(q, k, v)
    torch.cuda.synchronize()
    if not all(torch.equal(t, fa._plain_split(x)) for t, x in zip(got, (q, k, v))):
        raise AssertionError(f"{name}: the split kernel differs from its "
                             f"plain version")
    t = timed_in_turns({"kernel": lambda: fa.split_bf16_terms(q, k, v)})
    nbytes = sum(x.numel() * (4 + 3 * 2) for x in (q, k, v))
    out = dict(shape=list(q.shape), max_abs_err=0.0, bit_exact=True,
               ms=t["kernel"]["median"],
               ms_range=[t["kernel"]["min"], t["kernel"]["max"]],
               plain_ms=cuda_ms(lambda: [fa._plain_split(x) for x in (q, k, v)],
                                iters=5),
               bound_ms=nbytes / PEAK_HBM_BYTES * 1e3, bound_by="bytes",
               library_ms=None)
    emit("kernels_split", case=name, **out)
    return out


# the bf16 cases at which the FMA forward, which the wgmma one replaces at
# D = 256, is timed beside it
FWD_FMA_COMPARED = ("d256_causal_bf16_L1024", "d256_causal_bf16_B2_L1024",
                    D256_STEP_FWD)


def phase_kernels(seed: int) -> dict:
    """The forward kernels against their plain version."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    results = {}
    for name, q, k, v, causal, bias, want, tol in _fwd_cases(g):
        if want == "wgmma_f32" and bias is None:
            results[f"split_{name}"] = split_case(fa, name, q, k, v)
        fa.reset_launch_counts()
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, bias=bias)
        torch.cuda.synchronize()
        route = _route_of(fa, "fwd")
        if route != want:
            raise AssertionError(f"{name}: forward took the {route} kernel, "
                                 f"expected {want}")
        o_ref, lse_ref = fa.reference_attention_fwd(q, k, v, causal=causal,
                                                    bias=bias)
        num = check_close(name, o, o_ref, output_tolerance(o_ref, route))
        lse_err = check_close(f"{name} lse", lse, lse_ref,
                              lse_tolerance(lse_ref, route))["max_abs_err"]
        fns = {"kernel": lambda: fa.flash_attention_fwd(q, k, v,
                                                        causal=causal,
                                                        bias=bias),
               "library": lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=bias, is_causal=causal)}
        if name in FWD_FMA_COMPARED:
            # the FMA forward on the same inputs, launched directly: timing
            fns["fma"] = lambda: fa._launch_fwd_fma(q, k, v, causal, bias,
                                                    None, 0.0, 0)
        t = timed_in_turns(fns)
        plain_ms = cuda_ms(lambda: fa.reference_attention_fwd(
            q, k, v, causal=causal, bias=bias), iters=5)
        B, H, Lq, D = q.shape
        bound_ms, bound_by = attention_bound_ms(
            B, H, Lq, k.shape[2], D, causal, q.element_size(),
            0 if bias is None else bias.numel() * bias.element_size(),
            tensor_cores=route != "fma",
            term_pairs=6 if route == "wgmma_f32" else 1)
        ms = t["kernel"]["median"]
        results[name] = dict(shape=[B, H, Lq, k.shape[2], D],
                             dtype=_dtype_name(q), causal=causal,
                             bias=bias is not None, route=route, **num,
                             lse_max_abs_err=lse_err, tol=tol,
                             ms=ms, ms_range=[t["kernel"]["min"], t["kernel"]["max"]],
                             plain_ms=plain_ms,
                             library_ms=t["library"]["median"],
                             library_ms_range=[t["library"]["min"],
                                               t["library"]["max"]],
                             bound_ms=bound_ms, bound_by=bound_by,
                             roofline_share=bound_ms / ms)
        if "fma" in t:
            results[name].update(fma_ms=t["fma"]["median"],
                                 fma_ms_range=[t["fma"]["min"],
                                               t["fma"]["max"]])
        emit("kernels", case=name, **results[name])
    return results


def _sdpa_fns(q, k, v, do, bias, causal):
    """The library yardstick of the backward, as two callables: the
    forward of F.scaled_dot_product_attention, and its forward plus
    backward through ``torch.autograd.grad`` (nothing accumulates into
    ``.grad``). The backward's time is the difference of their medians."""
    import torch
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias,
                                           is_causal=causal)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias,
                                           is_causal=causal)
        torch.autograd.grad(o, (qg, kg, vg), do)

    return fwd, fwd_bwd


def _both(route):
    """The routes of a backward case whose dQ and dK/dV take one route."""
    return {"dq": route, "dkv": route}


def _bwd_cases(g):
    """(name, q, k, v, dO, causal, bias, routes) of the backward checks;
    ``routes`` holds the route of the dQ and of the dK/dV kernel."""
    import torch

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    cases = []
    for dtype, route in ((torch.bfloat16, "wgmma"),
                         (torch.float32, "wgmma_f32")):
        # the training step's shape; q/k/v views of the fused qkv and dO a
        # view of the [B, L, H, D] gradient, as autograd hands them over
        q, k, v = _views(g, 2, 1024, 16, 128, dtype)
        do = rn(2, 1024, 16, 128).to(dtype).transpose(1, 2)
        cases.append((f"train_{_dtype_name(q)}_B2_L1024", q, k, v, do, True,
                      None, _both(route)))
    for dtype, D, route in ((torch.float32, 128, "wgmma_f32"),
                            (torch.bfloat16, 64, "wgmma")):
        q, k, v = (rn(1, 16, n, D).to(dtype) for n in (384, 640, 640))
        cases.append((f"bias_noncausal_{_dtype_name(q)}_d{D}_Lq384_Lk640", q,
                      k, v, rn(1, 16, 384, D).to(dtype), False,
                      rn(1, 16, 384, 640), _both(route)))
    # a trained bias under the causal mask: dS of the key tiles no row of a
    # query tile sees must come back as zeros
    for dtype, route in ((torch.bfloat16, "wgmma"),
                         (torch.float32, "wgmma_f32")):
        q, k, v, do = (rn(1, 16, 1024, 128).to(dtype) for _ in range(4))
        cases.append((f"causal_bias_{_dtype_name(q)}_L1024", q, k, v, do,
                      True, rn(1, 16, 1024, 1024), _both(route)))
    for dtype, route in ((torch.float32, "wgmma_f32"),
                         (torch.bfloat16, "wgmma")):
        q, k, v = _views(g, 1, 1500, 16, 128, dtype)
        cases.append((f"ragged_causal_{_dtype_name(q)}_L1500", q, k, v,
                      rn(1, 1500, 16, 128).to(dtype).transpose(1, 2), True,
                      None, _both(route)))
    # D = 64 at the training batch and at bench_gpt_primary's batch of 8,
    # and D = 256 (bf16: the wgmma dK/dV beside the FMA dQ)
    d256_bf16 = {"dq": "fma", "dkv": "wgmma"}
    for dtype, D, B, H, routes in (
            (torch.float32, 64, 2, 16, _both("wgmma_f32")),
            (torch.float32, 256, 1, 8, _both("fma")),
            (torch.bfloat16, 64, 2, 16, _both("wgmma")),
            (torch.bfloat16, 64, 8, 16, _both("wgmma")),
            (torch.bfloat16, 256, 1, 8, d256_bf16),
            (torch.bfloat16, 256, 2, 16, d256_bf16)):
        q, k, v, do = (rn(B, H, 1024, D).to(dtype) for _ in range(4))
        cases.append((f"d{D}_causal_{_dtype_name(q)}_B{B}_L1024", q, k, v, do,
                      True, None, routes))
    # the D = 256 step's attention, as its autograd hands it over
    q, k, v = _views(g, TRAIN_BATCH, TRAIN_SEQ, D256_STEP_HEADS, 256,
                     torch.bfloat16)
    do = rn(TRAIN_BATCH, TRAIN_SEQ, D256_STEP_HEADS, 256).to(
        torch.bfloat16).transpose(1, 2)
    cases.append((D256_STEP_BWD, q, k, v, do, True, None, d256_bf16))
    return cases


# the cases at which the FMA dQ and dK/dV kernels, which the tensor-core ones
# replace (the wgmma_f32 pair at float32 D = 64 and 128, the wgmma dK/dV at
# bf16 D = 256), are timed beside them
FMA_COMPARED = ("train_float32_B2_L1024", "d64_causal_float32_B2_L1024",
                "d256_causal_bfloat16_B1_L1024",
                "d256_causal_bfloat16_B2_L1024", D256_STEP_BWD)


def _fma_bwd_fns(fa, q, k, v, bias, do, lse, delta, causal, emit_ds):
    """The FMA dQ and dK/dV kernels on the same inputs, launched directly
    (the route sends float32 at D = 64 and 128, and the bf16 dK/dV at
    D = 256, elsewhere): timing only."""
    import torch

    def dq_fma():
        ds = (torch.empty(*q.shape[:3], k.shape[2], device=q.device)
              if emit_ds else None)
        fa._launch_bwd("dq", q, k, v, bias, do, lse, delta,
                       {"dq": fa._empty_like_rows(q)}, ds, causal, 0.0, 0)

    def dkv_fma():
        fa._launch_bwd("dkv", q, k, v, bias, do, lse, delta,
                       {"dk": fa._empty_like_rows(k),
                        "dv": fa._empty_like_rows(v)}, None, causal, 0.0, 0)

    return {"dq_fma": dq_fma, "dkv_fma": dkv_fma}


def phase_backward(seed: int) -> dict:
    """The dQ and dK/dV kernels against the plain backward, the
    tensor-core kernels replayed bit for bit, and each kernel, the split
    pre-pass and the whole backward wrapper timed beside SDPA's backward."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    results = {}
    for name, q, k, v, do, causal, bias, want in _bwd_cases(g):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, bias=bias)
        fa.reset_launch_counts()
        got = fa.flash_attention_bwd(q, k, v, bias, o, lse, do, causal)
        torch.cuda.synchronize()
        routes = {w: _route_of(fa, w) for w in ("dq", "dkv")}
        if routes != want:
            raise AssertionError(f"{name}: backward took {fa.launch_counts()}"
                                 f", expected {want}")
        dq, dk, dv, ds = fa.reference_attention_bwd(q, k, v, bias, o, lse, do,
                                                    causal)
        refs = {"dq": dq, "dk": dk, "dv": dv}
        if bias is not None:
            refs["dbias"] = ds.sum(0, keepdim=True)
        errs = {}
        for (key, ref), x in zip(refs.items(), got):
            errs[key] = check_close(f"{name} {key}", x, ref,
                                    bwd_tolerance(ref))
        delta = (do.float() * o.float()).sum(-1).contiguous()
        emit_ds = bias is not None
        used = set(routes.values())
        do_k = do if "wgmma" not in used or fa._tma_ok(do) else do.contiguous()
        # the wgmma_f32 kernels read the split's terms: timed apart from it
        terms = fa._backward_terms(q, k, v, do_k) if "wgmma_f32" in used \
            else None

        def dq_call():
            return fa.flash_attention_bwd_dq(q, k, v, bias, do_k, lse, delta,
                                             causal, emit_ds=emit_ds,
                                             terms=terms)

        def dkv_call():
            return fa.flash_attention_bwd_dkv(q, k, v, bias, do_k, lse, delta,
                                              causal, terms=terms)

        # no atomics: the same inputs give the same dQ (and dS), dK, dV from
        # every tensor-core kernel
        calls = [c for w, c in (("dq", dq_call), ("dkv", dkv_call))
                 if routes[w] != "fma"]
        if calls:
            first, again = ([x for c in calls for x in c() if x is not None]
                            for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"{name}: the {routes} backward does "
                                     f"not replay bit for bit")
        sdpa_fwd, sdpa_fwd_bwd = _sdpa_fns(q, k, v, do, bias, causal)
        fns = {"dq": dq_call, "dkv": dkv_call,
               "bwd": lambda: fa.flash_attention_bwd(q, k, v, bias, o, lse,
                                                     do, causal),
               "sdpa_fwd": sdpa_fwd, "sdpa_fwd_bwd": sdpa_fwd_bwd}
        if terms is not None:
            fns["split"] = lambda: fa._backward_terms(q, k, v, do_k)
        if name in FMA_COMPARED:
            fns.update(_fma_bwd_fns(fa, q, k, v, bias, do_k, lse, delta,
                                    causal, emit_ds))
        t = timed_in_turns(fns)
        plain_ms = cuda_ms(lambda: fa.reference_attention_bwd(
            q, k, v, bias, o, lse, do, causal), iters=5)
        library_ms = t["sdpa_fwd_bwd"]["median"] - t["sdpa_fwd"]["median"]
        B, H, Lq, D = q.shape
        Lk = k.shape[2]
        common = (B, H, Lq, Lk, D, causal, q.element_size(),
                  0 if bias is None else bias.numel() * 4)
        dq_bound, dq_by = bwd_bound_ms(
            "dq", *common, B * H * Lq * Lk * 4 if emit_ds else 0,
            tensor_cores=routes["dq"] != "fma",
            term_pairs=6 if routes["dq"] == "wgmma_f32" else 1)
        dkv_bound, dkv_by = bwd_bound_ms(
            "dkv", *common, 0, tensor_cores=routes["dkv"] != "fma",
            term_pairs=6 if routes["dkv"] == "wgmma_f32" else 1)
        dq_ms, dkv_ms = t["dq"]["median"], t["dkv"]["median"]
        results[name] = dict(
            shape=[B, H, Lq, Lk, D], dtype=_dtype_name(q), causal=causal,
            bias=bias is not None, routes=routes, errors=errs,
            replay_bit_exact=bool(calls) or None,
            tol=("2 bf16 ulps + 1e-5 of max" if q.dtype == torch.bfloat16
                 else f"rtol {BWD_RTOL} atol {BWD_ATOL}"),
            dq_ms=dq_ms, dq_ms_range=[t["dq"]["min"], t["dq"]["max"]],
            dkv_ms=dkv_ms, dkv_ms_range=[t["dkv"]["min"], t["dkv"]["max"]],
            bwd_ms=t["bwd"]["median"],
            bwd_ms_range=[t["bwd"]["min"], t["bwd"]["max"]],
            split_ms=t["split"]["median"] if "split" in t else None,
            **{f"{w}_fma_ms": t[f"{w}_fma"]["median"] for w in ("dq", "dkv")
               if f"{w}_fma" in t},
            dq_bound_ms=dq_bound, dq_bound_by=dq_by,
            dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by,
            plain_ms=plain_ms, library_ms=library_ms,
            library_fwd_bwd_ms_range=[t["sdpa_fwd_bwd"]["min"],
                                      t["sdpa_fwd_bwd"]["max"]],
            library_fwd_ms_range=[t["sdpa_fwd"]["min"], t["sdpa_fwd"]["max"]],
            dq_roofline_share=dq_bound / dq_ms,
            dkv_roofline_share=dkv_bound / dkv_ms)
        emit("kernels_bwd", case=name, **results[name])
    return results


def _plain_bits(fa, seed, B, H, L):
    import torch

    def ar(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, device="cuda").view(shape)

    return fa.philox_bits(seed, ar(L, 3), ar(L, 2), ar(H, 1),
                          ar(B, 0)).expand(B, H, L, L)


def phase_dropout(seed: int) -> dict:
    """The CUDA Philox mask against the plain one, its keep rate, replay,
    and forward/backward at p = DROPOUT_P against the plain versions given
    the same mask."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    B, H, L, D = 2, 16, 1024, 128
    mseed = 1234 + seed
    bits = fa.dropout_bits(mseed, B, H, L, L, device="cuda")
    if not torch.equal(bits, _plain_bits(fa, mseed, B, H, L)):
        raise AssertionError("CUDA dropout bits differ from the plain Philox")
    window = fa.dropout_bits(mseed, B, H, 100, 300, device="cuda",
                             row0=517, col0=211)
    if not torch.equal(window, bits[:, :, 517:617, 211:511]):
        raise AssertionError("a window of the CUDA mask differs from the "
                             "same window of the full mask")
    if not torch.equal(bits, fa.dropout_bits(mseed, B, H, L, L, device="cuda")):
        raise AssertionError("the CUDA mask does not replay its seed")
    threshold = min(int(DROPOUT_P * 2 ** 32), 2 ** 32 - 1)
    n = bits.numel()
    kept = int((bits >= threshold).sum())
    sigma = math.sqrt(n * DROPOUT_P * (1 - DROPOUT_P))
    if abs(kept - n * (1 - DROPOUT_P)) > 5 * sigma:
        raise AssertionError(f"keep rate {kept / n} outside 5 sigma of "
                             f"{1 - DROPOUT_P}")
    del bits, window
    keep = fa.dropout_mask(mseed, B, H, L, L, DROPOUT_P, "cuda")

    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 2)
    # the least time one kernel could take to draw the mask of this run's
    # kept (causal) pairs on the CUDA cores' integer units
    mask_bound_ms = (kept_pairs(L, L, True) * B * H * PHILOX_OPS
                     / PEAK_INT32_OPS * 1e3)
    out = dict(mask_bits_equal_plain=True, keep_rate=kept / n,
               keep_rate_sigma=sigma / n, mask_bound_ms=mask_bound_ms,
               mask_bound_by="operations")
    # D = 256 at both of its timed shapes and at the D = 256 step's: the
    # mask of the first Bc batches and Hc heads is the corner of the full
    # one (Philox keys by (b, h, row, col))
    for dtype, D, Bc, Hc in ((torch.float32, D, B, H),
                             (torch.bfloat16, D, B, H),
                             (torch.bfloat16, 256, B, H),
                             (torch.bfloat16, 256, 1, 8),
                             (torch.bfloat16, 256, TRAIN_BATCH,
                              D256_STEP_HEADS)):
        kp = keep[:Bc, :Hc]
        q, k, v = _views(g, Bc, L, Hc, D, dtype)
        do = torch.randn(Bc, L, Hc, D, generator=g, device="cuda") \
            .to(dtype).transpose(1, 2)
        fa.reset_launch_counts()
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True,
                                        dropout_p=DROPOUT_P, seed=mseed)
        o2, _ = fa.flash_attention_fwd(q, k, v, causal=True,
                                       dropout_p=DROPOUT_P, seed=mseed)
        got = fa.flash_attention_bwd(q, k, v, None, o, lse, do, True,
                                     DROPOUT_P, mseed)
        got2 = fa.flash_attention_bwd(q, k, v, None, o, lse, do, True,
                                      DROPOUT_P, mseed)
        torch.cuda.synchronize()
        routes = {w: fa.kernel_route(dtype, D, w) for w in ("fwd", "dq", "dkv")}
        if {w: _route_of(fa, w) for w in routes} != routes:
            raise AssertionError(f"dropout {dtype}: launches "
                                 f"{fa.launch_counts()}, expected {routes}")
        if not (torch.equal(o, o2)
                and all(torch.equal(a, b) for a, b in zip(got[:3], got2[:3]))):
            raise AssertionError("dropout kernels do not replay a fixed seed")
        o_ref, lse_ref = fa.reference_attention_fwd(q, k, v, causal=True,
                                                    keep_mask=kp)
        d256 = "_d256" if D == 256 else ""
        name = f"dropout_{_dtype_name(q)}{d256}_B{Bc}_H{Hc}_L1024"
        errs = {"o": check_close(f"{name} o", o, o_ref,
                                 output_tolerance(o_ref, routes["fwd"]))}
        errs["lse"] = check_close(f"{name} lse", lse, lse_ref,
                                  lse_tolerance(lse_ref, routes["fwd"]))
        ref = fa.reference_attention_bwd(q, k, v, None, o, lse, do, True, kp)
        for key, x, y in zip(("dq", "dk", "dv"), got, ref):
            errs[key] = check_close(f"{name} {key}", x, y, bwd_tolerance(y))
        delta = (do.float() * o.float()).sum(-1).contiguous()
        do_k = (do if "wgmma" not in routes.values() or fa._tma_ok(do)
                else do.contiguous())
        out[name] = dict(
            shape=[Bc, Hc, L, L, D], errors=errs, routes=routes,
            fwd_ms=cuda_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=True, dropout_p=DROPOUT_P, seed=mseed)),
            dq_ms=cuda_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, None, do_k, lse, delta, True, DROPOUT_P, mseed)),
            dkv_ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, None, do_k, lse, delta, True, DROPOUT_P, mseed)))
    emit("dropout", p=DROPOUT_P, shape=[B, H, L, L], **out)
    return out


def phase_serving(seed: int) -> dict:
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.serving import InferenceServer

    cfg = gpt_1p3b(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                   dtype="bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", generator=gen).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    requests = [dict(prompt=rng.integers(0, cfg.vocab_size, n), max_new_tokens=16)
                for n in (40, 300, 900, 1500, 1900)]
    requests.append(dict(prompt=rng.integers(0, cfg.vocab_size, 700),
                         max_new_tokens=16, do_sample=True, seed=7,
                         temperature=0.8, top_p=0.9))
    geo = dict(max_length=2048)

    # warm-up outside the measured run: cuBLAS handles, allocator pools
    model.generate(requests[0]["prompt"][None, :8], max_new_tokens=2, **geo)
    torch.cuda.synchronize()

    server = InferenceServer(model, slots=4, device="cuda", **geo)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    handles = [server.submit(**r) for r in requests]
    streams = [h.result(timeout=900) for h in handles]
    wall_s = time.perf_counter() - t0
    counts = fa.launch_counts()["fwd"]
    launches, split_launches = counts["wgmma_f32"], fa.split_bf16_terms.launches
    if counts["fma"] or counts["wgmma"]:
        raise AssertionError(f"float32 prefill launched a forward other than "
                             f"wgmma_f32: {fa.launch_counts()}")
    server.shutdown(timeout=60)
    snap = server.snapshot()

    if snap["requests_completed"] != len(requests):
        raise AssertionError(f"{snap['requests_completed']} of "
                             f"{len(requests)} requests completed")
    # the server recovers from a fault in admit/step by resetting the engine
    # and re-running the request; a smoke run must need no such recovery
    if snap["requests_requeued"] or snap["requests_failed"]:
        raise AssertionError(f"{snap['requests_requeued']} requests requeued, "
                             f"{snap['requests_failed']} failed")
    need = cfg.num_layers * len(requests)
    if snap["prefills"] != len(requests) or (launches, split_launches) != (need, need):
        raise AssertionError(f"wgmma_f32 forward launched {launches} times "
                             f"and its split {split_launches} over "
                             f"{snap['prefills']} prefills in the served run, "
                             f"expected exactly {need} each ({cfg.num_layers} "
                             f"layers x {len(requests)} requests)")
    for r, got in zip(requests, streams):
        solo = model.generate(r["prompt"][None], **{k: v for k, v in r.items()
                                                     if k != "prompt"}, **geo)[0]
        if got.shape != (16,) or not np.array_equal(got, solo):
            raise AssertionError(f"served stream {got.tolist()} != solo "
                                 f"generate {solo.tolist()} (prompt "
                                 f"{len(r['prompt'])})")

    # the kernel path against the plain-attention path, end to end: the
    # prefill logits of one full-width prompt through all 24 layers
    ids = torch.as_tensor(requests[1]["prompt"][None], device="cuda")
    with torch.inference_mode():
        from paddle_tpu_torch.models.generation import init_cache

        def prefill_logits():
            return model(ids, cache=init_cache(model, 1, 512),
                         position_offset=0)[0]

        flash_logits = prefill_logits()
        model.cfg.use_flash_attention = False
        try:
            plain_logits = prefill_logits()
        finally:
            model.cfg.use_flash_attention = True
    if not bool(torch.isfinite(flash_logits).all()):
        raise AssertionError("non-finite prefill logits")
    logit_err = (flash_logits - plain_logits).abs().max().item()
    if logit_err > PREFILL_LOGITS_TOL:
        raise AssertionError(f"prefill logits, kernel vs plain attention: "
                             f"max|err| {logit_err} > {PREFILL_LOGITS_TOL}")

    out = dict(model="gpt_1p3b", params=sum(p.numel() for p in model.parameters()),
               model_build_s=build_s, requests=len(requests),
               prompt_lens=[len(r["prompt"]) for r in requests],
               streams_equal_solo=True, flash_launches=launches,
               split_launches=split_launches,
               prefills=snap["prefills"], decode_steps=snap["decode_steps"],
               wall_s=wall_s, tokens=snap["tokens_emitted"],
               tokens_per_s=snap["tokens_emitted"] / wall_s,
               ttft_ms=[h.ttft_s * 1e3 for h in handles],
               decode_ms_per_token=snap["inter_token"]["mean_ms"],
               decode_ms_per_token_p50=snap["inter_token"]["p50_ms"],
               prefill_logits_max_abs_err=logit_err,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               card=nvidia_smi_line())
    emit("serving", **out)
    return out


_COUNT_NAMES = ("fwd_fma", "fwd_wgmma", "fwd_wgmma_f32", "dq_fma",
                "dq_wgmma", "dq_wgmma_f32", "dkv_fma", "dkv_wgmma",
                "dkv_wgmma_f32")


def _counts(fa):
    """Launches since the last reset, in the order of _COUNT_NAMES."""
    c = fa.launch_counts()
    return tuple(c[kernel][route] for kernel, route in
                 (n.split("_", 1) for n in _COUNT_NAMES))


def _train_config(**overrides):
    """bench.py bench_gpt_1p3b's configuration (hidden 2048, 24 layers,
    16 heads, vocab 50304, 1024 positions, recompute, flash attention,
    chunked loss of 256, dropout 0)."""
    from paddle_tpu_torch.models.gpt import gpt_1p3b

    cfg = dict(max_position_embeddings=TRAIN_SEQ, hidden_dropout_prob=0.0,
               attention_dropout_prob=0.0, use_recompute=True,
               use_flash_attention=True, loss_chunk=256, dtype="bfloat16")
    cfg.update(overrides)
    return gpt_1p3b(**cfg)


def _o2_step(cfg, seed: int, global_seed: int):
    """A TrainStep over a seeded model, AdamW(1e-4, wd 0.01) and
    amp.decorate O2 bf16, as the bench builds it."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import random as framework_random
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    framework_random.seed(global_seed)
    model = GPTForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed)).train()
    model, opt = amp.decorate(model, AdamW(learning_rate=1e-4,
                                           weight_decay=0.01),
                              level="O2", dtype="bfloat16")
    return TrainStep(model, opt, loss_fn=None)


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_training(seed: int) -> dict:
    """The GPT-3 1.3B bf16 (O2) pretrain step, 5 warm-up and 8 timed."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import gpt_flops_per_token

    cfg = _train_config()
    t0 = time.perf_counter()
    step = _o2_step(cfg, seed, seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    # bf16 at D = 128: the wgmma forward (and its recompute), dQ and dK/dV
    need = (0, 2 * cfg.num_layers, 0, 0, cfg.num_layers, 0, 0,
            cfg.num_layers, 0)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    fa.reset_launch_counts()
    for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
        before = _counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step((ids, ids))
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(a - b for a, b in zip(_counts(fa), before)))
    launches = _counts(fa)
    if any(c != need for c in per_step):
        raise AssertionError(f"launches per step {_COUNT_NAMES} {per_step}, "
                             f"expected {need} every step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}: not finite or not "
                             f"falling")
    timed = step_ms[TRAIN_WARMUP:]
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * TRAIN_TIMED / (sum(timed) / 1e3)
    flops_per_token = gpt_flops_per_token(cfg, TRAIN_SEQ)
    out = dict(model="gpt_1p3b O2 bf16", batch=[TRAIN_BATCH, TRAIN_SEQ],
               params=sum(p.numel() for p in step.params.values()),
               model_build_s=build_s, losses=losses,
               launches=dict(zip(_COUNT_NAMES, launches)),
               launches_per_step=dict(zip(_COUNT_NAMES, need)),
               step_ms=step_ms, step_ms_median=float(np.median(timed)),
               tokens_per_s=tokens_per_s,
               mfu=tokens_per_s * flops_per_token / PEAK_BF16_TC_FLOPS,
               flops_per_token=flops_per_token,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               card=nvidia_smi_line())
    emit("training", **out)
    return out


def phase_train_parity(seed: int) -> dict:
    """One float32 forward and backward of the training configuration,
    with the flash kernels and with plain attention, no update."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    cfg = _train_config()
    model = GPTForCausalLM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed)).train()
    params = list(model.parameters())
    ids = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)), device="cuda")

    def run(flash: bool):
        model.cfg.use_flash_attention = flash
        loss = model(ids, ids)
        return loss.item(), torch.autograd.grad(loss, params)

    fa.reset_launch_counts()
    loss_k, grads_k = run(True)
    launches, split_launches = _counts(fa), fa.split_bf16_terms.launches
    loss_p, grads_p = run(False)
    model.cfg.use_flash_attention = True
    # float32 at D = 128: the wgmma_f32 forward (and its recompute), dQ and
    # dK/dV; the split once per forward and twice per backward (q, k, v;
    # dO)
    n = cfg.num_layers
    if launches != (0, 0, 2 * n, 0, 0, n, 0, 0, n) or split_launches != 4 * n:
        raise AssertionError(f"float32 kernel run launched "
                             f"{dict(zip(_COUNT_NAMES, launches))} and the "
                             f"split {split_launches} times")
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(grads_k, grads_p)]
    worst = max(rel)
    if not (abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p)
            and worst <= TRAIN_GRAD_REL_L2):
        raise AssertionError(f"float32 training, kernels vs plain: loss "
                             f"{loss_k} vs {loss_p}, worst grad rel L2 {worst}")
    names = [n for n, _ in model.named_parameters()]
    out = dict(dtype="float32", loss_kernel=loss_k, loss_plain=loss_p,
               grad_rel_l2_max=worst, grad_rel_l2_worst_param=names[rel.index(worst)],
               tol=dict(loss_rtol=TRAIN_LOSS_RTOL, grad_rel_l2=TRAIN_GRAD_REL_L2),
               launches=dict(zip(_COUNT_NAMES, launches)),
               split_launches=split_launches)
    emit("train_parity", **out)
    return out


def phase_dropout_replay(seed: int) -> dict:
    """Full width, 2 layers, dropout 0.1: two TrainSteps from the same seed
    give bit-identical losses over 2 steps; another seed does not."""
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa

    cfg = _train_config(num_layers=2, hidden_dropout_prob=DROPOUT_P,
                        attention_dropout_prob=DROPOUT_P)
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)

    def losses(global_seed):
        step = _o2_step(cfg, seed, global_seed)
        return [float(step((ids, ids))) for _ in range(2)]

    fa.reset_launch_counts()
    a, b = losses(seed), losses(seed)
    launches = _counts(fa)
    other = losses(seed + 1)
    # 2 runs x 2 steps x 2 layers x (forward + recompute), bf16: wgmma
    need = (0, 16, 0, 0, 8, 0, 0, 8, 0)
    if a != b or launches != need or other == a:
        raise AssertionError(f"dropout replay: {a} vs {b} (other seed "
                             f"{other}), launches {launches} != {need}")
    out = dict(layers=2, p=DROPOUT_P, losses=a, replay_losses=b,
               other_seed_losses=other,
               launches=dict(zip(_COUNT_NAMES, launches)))
    emit("dropout_replay", **out)
    return out


def _loss_and_grads(model, ids):
    """The loss of ``model(ids, ids)`` and its gradient for every
    parameter, in ``named_parameters`` order; no update."""
    import torch

    loss = model(ids, ids).float()
    return loss.item(), torch.autograd.grad(loss, list(model.parameters()))


def phase_d256_step(seed: int) -> dict:
    """The bf16 O2 step at gpt_1p3b width with 8 heads of 256 (D = 256) and
    2 layers, from one seed with the flash kernels and with plain
    attention. Before each step, the gradients of its loss: the kernels'
    may differ from plain attention's by at most BF16_GRAD_SLACK times
    what bf16 puts between plain attention's and a float32 reference
    (the same weights, plain attention, float32), parameter by parameter
    in relative L2. Then one step each: the losses agree within BF16_ULPS
    bf16 ulps, and the kernel step launches exactly 2 forwards per layer
    (recompute included) on the wgmma route, and one dK/dV (wgmma) and
    one dQ (FMA)."""
    import copy

    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    n = 2  # layers
    vocab = _train_config().vocab_size
    ids = np.random.default_rng(seed).integers(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    ids_t = torch.as_tensor(ids, device="cuda")
    need = (0, 2 * n, 0, n, 0, 0, 0, n, 0)

    def one_step(flash: bool):
        step = _o2_step(_train_config(num_layers=n, num_heads=D256_STEP_HEADS,
                                      use_flash_attention=flash), seed, seed)
        _, grads = _loss_and_grads(step.model, ids_t)
        ref_grads = None
        if not flash:
            # the float32 reference: the same weights (bf16, exact in
            # float32) before the update, plain attention
            ref = copy.deepcopy(step.model).float()
            _, ref_grads = _loss_and_grads(ref, ids_t)
            del ref
        fa.reset_launch_counts()
        loss = float(step((ids, ids)))
        names = [name for name, _ in step.model.named_parameters()]
        return loss, _counts(fa), grads, ref_grads, names

    loss_k, launches, grads_k, _, names = one_step(True)
    _free()
    loss_p, plain_launches, grads_p, grads_ref, _ = one_step(False)
    if launches != need or any(plain_launches):
        raise AssertionError(f"D = 256 step launches {_COUNT_NAMES} "
                             f"{launches}, expected {need}; the plain step "
                             f"{plain_launches}")
    tol = BF16_ULPS * bf16_ulp(torch.tensor(loss_p)).item()
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= tol):
        raise AssertionError(f"D = 256 step: loss {loss_k} with the kernels, "
                             f"{loss_p} with plain attention (limit {tol})")
    # per parameter, relative to the reference's norm: kernels vs plain
    # attention, plain attention vs the float32 reference, and the share of
    # the limit BF16_GRAD_SLACK * (plain vs reference) + 2^-24
    rel_kp, rel_pr, share = [], [], []
    for gk, gp, gr in zip(grads_k, grads_p, grads_ref):
        gk, gp, gr = gk.double(), gp.double(), gr.double()
        ref_norm = gr.norm().clamp_min(1e-30)
        rel_kp.append(((gk - gp).norm() / ref_norm).item())
        rel_pr.append(((gp - gr).norm() / ref_norm).item())
        share.append(rel_kp[-1] / (BF16_GRAD_SLACK * rel_pr[-1] + 2.0 ** -24))
    worst = max(range(len(share)), key=share.__getitem__)
    if not all(math.isfinite(x) for x in rel_kp) or share[worst] > 1.0:
        raise AssertionError(
            f"D = 256 gradients, kernels vs plain attention: {names[worst]} "
            f"at relative L2 {rel_kp[worst]}, {share[worst]} of its limit "
            f"({BF16_GRAD_SLACK} x plain attention's {rel_pr[worst]} from "
            f"the float32 reference)")
    out = dict(model="gpt_1p3b width, 8 heads of 256, 2 layers, O2 bf16",
               head_dim=256, layers=n,
               loss_kernel=loss_k, loss_plain=loss_p, tol=tol,
               grad_rel_l2_kernel_vs_plain_max=max(rel_kp),
               grad_rel_l2_plain_vs_f32_max=max(rel_pr),
               grad_worst_param=names[worst],
               grad_worst_share_of_tol=share[worst],
               launches=dict(zip(_COUNT_NAMES, launches)))
    emit("d256_step", **out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch import default_device

    default_device("cuda")  # pins float32 matmul precision (no TF32)
    card = nvidia_smi_line()
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    phase_build(args.seed)
    fwd = phase_kernels(args.seed)
    bwd = phase_backward(args.seed)
    phase_dropout(args.seed)
    serve = phase_serving(args.seed)
    _free()
    train = phase_training(args.seed)
    _free()
    parity = phase_train_parity(args.seed)
    _free()
    phase_dropout_replay(args.seed)
    _free()
    d256 = phase_d256_step(args.seed)

    src = "paddle_tpu_torch/kernels/csrc/"
    ref = "paddle_tpu/kernels/flash_attention.py:"

    def fwd_row(name, source, case, launches, path):
        c = fwd[case]
        return dict(name=name, route="cuda", source=src + source,
                    replaces=ref + "131", launches=launches, main_path=path,
                    max_abs_err=c["max_abs_err"], ms=c["ms"],
                    ms_range=c["ms_range"], plain_ms=c["plain_ms"],
                    bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                    library_ms=c["library_ms"],
                    library_ms_range=c.get("library_ms_range"),
                    shape=c["shape"], dtype=c.get("dtype", "float32"),
                    causal=c.get("causal"))

    def bwd_row(name, source, which, case, launches, path):
        c = bwd[case]
        keys = ("dq",) if which == "dq" else ("dk", "dv")
        return dict(name=name, route="cuda", source=src + source,
                    replaces=ref + ("198" if which == "dq" else "269"),
                    launches=launches, main_path=path,
                    max_abs_err=max(c["errors"][k]["max_abs_err"] for k in keys),
                    ms=c[f"{which}_ms"], ms_range=c[f"{which}_ms_range"],
                    plain_ms=c["plain_ms"], bound_ms=c[f"{which}_bound_ms"],
                    bound_by=c[f"{which}_bound_by"],
                    library_ms=c["library_ms"], shape=c["shape"],
                    dtype=c["dtype"], causal=c["causal"])

    step = "training (bf16 O2 step)"
    f32_step = "training (float32 parity run)"
    prefill = "serving (float32 prefill)"
    d256_step = "training (bf16 O2 step, D = 256, 2 layers)"
    d256_counts = d256["launches"]
    kernels = [
        fwd_row("flash_attention_fwd_f32_sm90",
                "flash_attention_fwd_f32_sm90.cu", "prefill_f32_L2048",
                serve["flash_launches"], prefill),
        fwd_row("split_bf16_terms", "flash_attention_fwd_f32_sm90.cu",
                "split_prefill_f32_L2048", serve["split_launches"], prefill),
        # no path runs a float32 forward at D = 256 since float32 prefill
        # moved to wgmma_f32: 0 launches there, timed at its own case
        fwd_row("flash_attention_fwd", "flash_attention_fwd.cu",
                "d256_causal_f32_L1024", 0, None),
        fwd_row("flash_attention_fwd_sm90", "flash_attention_fwd_sm90.cu",
                "train_bf16_B2_L1024", train["launches"]["fwd_wgmma"], step),
        fwd_row("flash_attention_fwd_sm90_d256", "flash_attention_fwd_sm90.cu",
                D256_STEP_FWD, d256_counts["fwd_wgmma"], d256_step),
        # no path runs a float32 backward at D = 256 since float32 training
        # moved to wgmma_f32: 0 launches there, timed at its own case
        bwd_row("flash_attention_bwd_dq", "flash_attention_bwd.cu", "dq",
                "d256_causal_float32_B1_L1024", 0, None),
        bwd_row("flash_attention_bwd_dq_bf16_d256", "flash_attention_bwd.cu",
                "dq", D256_STEP_BWD, d256_counts["dq_fma"], d256_step),
        bwd_row("flash_attention_bwd_dq_sm90",
                "flash_attention_bwd_dq_sm90.cu", "dq",
                "train_bfloat16_B2_L1024", train["launches"]["dq_wgmma"],
                step),
        bwd_row("flash_attention_bwd_dq_f32_sm90",
                "flash_attention_bwd_f32_sm90.cu", "dq",
                "train_float32_B2_L1024", parity["launches"]["dq_wgmma_f32"],
                f32_step),
        bwd_row("flash_attention_bwd_dkv", "flash_attention_bwd.cu", "dkv",
                "d256_causal_float32_B1_L1024", 0, None),
        bwd_row("flash_attention_bwd_dkv_sm90",
                "flash_attention_bwd_dkv_sm90.cu", "dkv",
                "train_bfloat16_B2_L1024", train["launches"]["dkv_wgmma"],
                step),
        bwd_row("flash_attention_bwd_dkv_sm90_d256",
                "flash_attention_bwd_dkv_sm90.cu", "dkv",
                D256_STEP_BWD, d256_counts["dkv_wgmma"], d256_step),
        bwd_row("flash_attention_bwd_dkv_f32_sm90",
                "flash_attention_bwd_f32_sm90.cu", "dkv",
                "train_float32_B2_L1024", parity["launches"]["dkv_wgmma_f32"],
                f32_step),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

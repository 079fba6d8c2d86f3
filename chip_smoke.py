#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines; any failure raises and the script
exits non-zero:

1. device    - the card (nvidia-smi name and power limit), torch and CUDA.
2. build     - compiles every CUDA source of the port from this checkout
               (nvcc, one library per source, all started together), fails
               on a register spill in the six wgmma sources, and holds the
               wgmma/TMA self-check (a 64 x 64 x D product through each
               descriptor form, in bf16 and through the float32 forward's
               three-term products, at D = 64, 128 and 256) against a
               float64 product.
3. kernels   - calls each kernel's wrapper on the card at the shapes the
               serving and training paths give it, and holds the result
               against its plain PyTorch version on the same inputs (stated
               tolerance): the forward kernels (wgmma_f32 for float32 with
               its bf16-term split pre-pass, which must equal its plain
               version bit for bit; wgmma for bf16; at D = 64, 128 and 256;
               each case checked for its route and replayed bit for bit;
               the FMA forward timed beside the tensor-core ones at
               D = 256, also at the D = 256 step's [2,8,1024,256] and at
               the D = 256 prefill's [1,8,2048,256]), the dQ and dK/dV
               backward kernels (wgmma for bf16 and wgmma_f32 for float32,
               each at D = 64, 128 and 256; each case checked for the
               route of each kernel; dS as the bias gradient, also causal
               with zeros above the diagonal; every kernel replayed bit
               for bit; the whole backward wrapper, with Delta and the
               split pre-pass, timed beside SDPA's; the FMA dQ and dK/dV,
               on no route, timed beside the tensor-core ones at
               [2,16,1024,128] and [2,16,1024,64] float32, at
               [1,8,1024,256] and the float32 D = 256 run's [2,8,1024,256]
               float32 (at these four also held to the float32
               tolerance), and at [1,8,1024,256], [2,16,1024,256] and the
               D = 256 step's [2,8,1024,256] bf16), and dropout (the
               CUDA Philox mask against the plain one bit for bit, its keep
               rate, replay of a fixed seed, and forward and backward at
               p = 0.1 given the same mask, also at bf16 D = 256 at its
               three shapes and at float32 D = 256). Times the
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
               forward, 2 wgmma dQ and 2 wgmma dK/dV launches, none on an
               FMA kernel) and one with plain attention, the losses equal
               within two bf16 ulps. Then the float32 check of phase 5 at
               that width and depth (d256_f32: exactly 4 wgmma_f32
               forward, 2 dQ and 2 dK/dV launches and 8 of the split, none
               on an FMA kernel; its attention shape [2,8,1024,256]
               float32 is also a case of the backward phase). Then
               gpt_1p3b width with 8 heads of 256 and 2 layers behind
               InferenceServer(slots=2, max_length=2048) serves two
               greedy prompts of 900 and 1900 tokens: the checks of
               phase 4, with the wgmma_f32 forward at D = 256 (exactly one
               launch and one split per layer per prefill, no other
               forward).

Then a line with the kernels' summary, a line with the card's name and
power limit, and the last line {"ok": true, "device": {...}}.
``--kernels-only`` stops after phase 3 and prints none of those three
lines, and reports a register spill without failing on it: a partial
run, to compare kernel builds (a layout that spills among them) in turns.

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
# Llama's prefill logits (32 layers) are held against a float64-attention
# reference: the kernels' distance from it may be this many times plain
# float32 attention's distance, measured in the same run. Each kernel
# output is held to F32_FWD_RTOL relative of the plain one, 168 float32
# unit roundoffs (2^-24): a perturbation that many times float32's
# rounding, carried through the same 32 layers, moves the logits at most
# about that many times as far.
LLAMA_LOGITS_FACTOR = F32_FWD_RTOL / 2.0 ** -24
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
# the float32 D = 256 run (phase_d256_f32): the D = 256 step's
# configuration in float32; its attention, [TRAIN_BATCH, 8, TRAIN_SEQ, 256]
# float32 causal, is also a case of the backward phase
D256_F32_BWD = f"d256_f32_float32_B{TRAIN_BATCH}_H{D256_STEP_HEADS}_L{TRAIN_SEQ}"
# the D = 256 prefill (phase_d256_prefill): its longest prompt's bucket,
# [1, 8, 2048, 256] float32 causal, is a case of the forward phase
D256_PREFILL_LENGTHS = (900, 1900)
D256_PREFILL_FWD = "prefill_f32_d256_L2048"
# Llama-2-7B (phase 7): its attention, [1, 32, 4096, 128] causal, from
# separate q/k/v projections, is a case of the forward phase in float32
# (serving prefill's 4096 bucket) and bf16 (training), and of the
# backward phase in bf16
LLAMA_SEQ, LLAMA_HEADS = 4096, 32
LLAMA_PREFILL_FWD = f"llama_prefill_f32_L{LLAMA_SEQ}"
LLAMA_TRAIN_FWD = f"llama_train_bf16_L{LLAMA_SEQ}"
LLAMA_TRAIN_BWD = f"llama_train_bfloat16_L{LLAMA_SEQ}"
LLAMA_TRAIN_LAYERS = 8  # of 32: AdamW's state at 16 bytes a parameter
LLAMA_GQA_KV_HEADS, LLAMA_GQA_LAYERS = 8, 2
LLAMA_PROMPT_LENGTHS = (60, 700, 1500, 3000, 4000)
LLAMA_SAMPLED_LENGTH = 1200
LLAMA_LOGITS_PROMPT = 3000


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


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``elapsed_s`` is the host time since the script
    started (to budget its time limit)."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _START}), flush=True)


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


def _blhd_views(g, B, L, H, D, dtype, n=3):
    """``n`` [B, H, L, D] tensors as the Llama path hands them to the
    kernels: transposed views of separate [B, L, H, D] tensors (the
    rotated q and k, v; K and V repeated for GQA)."""
    import torch

    return tuple(torch.randn(B, L, H, D, generator=g, device="cuda")
                 .to(dtype).transpose(1, 2) for _ in range(n))


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def ptxas_report(log: str) -> list:
    """Per kernel of one source's build log (``-Xptxas -v``): its name and
    template arguments, registers, and spill stores and loads in bytes."""
    import re

    out = []
    for entry in log.split("Compiling entry function")[1:]:
        # the mangled name: length-prefixed nested names, the last one the
        # kernel's, then its integer and bool template arguments
        mangled = entry.split("'")[1]
        i = 3 if mangled.startswith("_ZN") else 2
        name = mangled
        while i < len(mangled) and mangled[i].isdigit():
            j = i
            while mangled[j].isdigit():
                j += 1
            name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
        args = [v if k == "i" else ("false", "true")[int(v)]
                for k, v in re.findall(r"L([ib])(\d+)E",
                                       mangled[i:].split("Ev")[0])]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        out.append(dict(kernel=f"{name}<{', '.join(args)}>" if args else name,
                        registers=int(re.search(r"Used (\d+) registers",
                                                entry).group(1)),
                        spill_stores=int(spill.group(1)) if spill else 0,
                        spill_loads=int(spill.group(2)) if spill else 0))
    return out


def phase_build(seed: int, fail_on_spill: bool = True) -> None:
    """Build every kernel source, fail on a spill in the wgmma kernels
    (unless ``fail_on_spill`` is False: a spill is then only reported),
    and hold the wgmma/TMA self-check against torch.matmul."""
    import torch

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    libs = {s: p.name for s, p in _build.build_all().items()}
    ptxas = {s: ptxas_report(_build.build_log(s)) for s in libs}
    emit("build", seconds=time.perf_counter() - t0, libraries=libs,
         ptxas=ptxas)
    spills = [(s, k) for s in (fa._FWD_SM90_SOURCE, fa._FWD_F32_SM90_SOURCE,
                               fa._DQ_SM90_SOURCE, fa._DKV_SM90_SOURCE,
                               fa._BWD_F32_SM90_SOURCE,
                               fa._BWD_F32_D256_SM90_SOURCE)
              for k in ptxas[s] if k["spill_stores"] or k["spill_loads"]]
    if spills and fail_on_spill:
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
    # D = 256, float32: the wgmma_f32 forward at [1, 8, 1024, 256] and at
    # the D = 256 prefill's longest bucket (phase_d256_prefill)
    cases.append(("d256_causal_f32_L1024", *_views(g, 1, 1024, 8, 256, torch.float32),
                  True, None, "wgmma_f32", f32_tol))
    cases.append((D256_PREFILL_FWD, *_views(g, 1, 2048, D256_STEP_HEADS, 256,
                                            torch.float32),
                  True, None, "wgmma_f32", f32_tol))
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
    # Llama-2-7B's attention: serving prefill's 4096 bucket (float32) and
    # the training step's (bf16)
    cases.append((LLAMA_PREFILL_FWD, *_blhd_views(g, 1, LLAMA_SEQ, LLAMA_HEADS,
                                                  128, torch.float32),
                  True, None, "wgmma_f32", f32_tol))
    cases.append((LLAMA_TRAIN_FWD, *_blhd_views(g, 1, LLAMA_SEQ, LLAMA_HEADS,
                                                128, torch.bfloat16),
                  True, None, "wgmma", bf16_tol))
    for dtype, D, H, route, tol in (
            (torch.float32, 128, 16, "wgmma_f32", f32_tol),
            (torch.float32, 256, 8, "wgmma_f32", f32_tol),
            (torch.bfloat16, 64, 16, "wgmma", bf16_tol)):
        q = torch.randn(1, H, 384, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(1, H, 640, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(1, H, 640, D, generator=g, device="cuda").to(dtype)
        bias = torch.randn(1, H, 384, 640, generator=g, device="cuda")
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


# the D = 256 cases at which the FMA forward, which the tensor-core ones
# replace there, is timed beside them
FWD_FMA_COMPARED = ("d256_causal_f32_L1024", D256_PREFILL_FWD,
                    "d256_causal_bf16_L1024", "d256_causal_bf16_B2_L1024",
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
        again = fa.flash_attention_fwd(q, k, v, causal=causal, bias=bias)
        torch.cuda.synchronize()
        route = _route_of(fa, "fwd")
        if route != want:
            raise AssertionError(f"{name}: forward took the {route} kernel, "
                                 f"expected {want}")
        # no atomics: the same inputs give the same O and LSE
        if not (torch.equal(o, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"{name}: the {route} forward does not "
                                 f"replay bit for bit")
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
                             replay_bit_exact=True,
                             ms=ms, ms_range=[t["kernel"]["min"], t["kernel"]["max"]],
                             plain_ms=plain_ms,
                             library_ms=t["library"]["median"],
                             library_ms_range=[t["library"]["min"],
                                               t["library"]["max"]],
                             bound_ms=bound_ms, bound_by=bound_by,
                             roofline_share=bound_ms / ms)
        if "fma" in t:
            # the FMA forward is on no path; held to its own tolerance here
            o_fma, _ = fa._launch_fwd_fma(q, k, v, causal, bias, None, 0.0, 0)
            fma_err = check_close(f"{name} fma", o_fma, o_ref,
                                  output_tolerance(o_ref, "fma"))
            fma_bound, fma_by = attention_bound_ms(
                B, H, Lq, k.shape[2], D, causal, q.element_size(),
                0 if bias is None else bias.numel() * bias.element_size(),
                tensor_cores=False)
            results[name].update(fma_ms=t["fma"]["median"],
                                 fma_ms_range=[t["fma"]["min"],
                                               t["fma"]["max"]],
                                 fma_max_abs_err=fma_err["max_abs_err"],
                                 fma_bound_ms=fma_bound, fma_bound_by=fma_by)
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
    for dtype, D, H, route in ((torch.float32, 128, 16, "wgmma_f32"),
                               (torch.bfloat16, 64, 16, "wgmma"),
                               (torch.float32, 256, 8, "wgmma_f32")):
        q, k, v = (rn(1, H, n, D).to(dtype) for n in (384, 640, 640))
        cases.append((f"bias_noncausal_{_dtype_name(q)}_d{D}_Lq384_Lk640", q,
                      k, v, rn(1, H, 384, D).to(dtype), False,
                      rn(1, H, 384, 640), _both(route)))
    # a trained bias under the causal mask: dS of the key tiles no row of a
    # query tile sees must come back as zeros (also at D = 256: bf16, where
    # two warpgroups share the zeroing, and float32)
    for dtype, D, H, route in ((torch.bfloat16, 128, 16, "wgmma"),
                               (torch.float32, 128, 16, "wgmma_f32"),
                               (torch.bfloat16, 256, 8, "wgmma"),
                               (torch.float32, 256, 8, "wgmma_f32")):
        q, k, v, do = (rn(1, H, 1024, D).to(dtype) for _ in range(4))
        d256 = "_d256" if D == 256 else ""
        cases.append((f"causal_bias_{_dtype_name(q)}{d256}_L1024", q, k, v,
                      do, True, rn(1, H, 1024, 1024), _both(route)))
    for dtype, D, H, route in ((torch.float32, 128, 16, "wgmma_f32"),
                               (torch.bfloat16, 128, 16, "wgmma"),
                               (torch.float32, 256, 8, "wgmma_f32")):
        q, k, v = _views(g, 1, 1500, H, D, dtype)
        d256 = "_d256" if D == 256 else ""
        cases.append((f"ragged_causal_{_dtype_name(q)}{d256}_L1500", q, k, v,
                      rn(1, 1500, H, D).to(dtype).transpose(1, 2), True,
                      None, _both(route)))
    # D = 64 at the training batch and at bench_gpt_primary's batch of 8,
    # and D = 256
    for dtype, D, B, H, routes in (
            (torch.float32, 64, 2, 16, _both("wgmma_f32")),
            (torch.float32, 256, 1, 8, _both("wgmma_f32")),
            (torch.bfloat16, 64, 2, 16, _both("wgmma")),
            (torch.bfloat16, 64, 8, 16, _both("wgmma")),
            (torch.bfloat16, 256, 1, 8, _both("wgmma")),
            (torch.bfloat16, 256, 2, 16, _both("wgmma"))):
        q, k, v, do = (rn(B, H, 1024, D).to(dtype) for _ in range(4))
        cases.append((f"d{D}_causal_{_dtype_name(q)}_B{B}_L1024", q, k, v, do,
                      True, None, routes))
    # the attention of the D = 256 step (bf16) and of the float32 D = 256
    # run, as their autograd hands it over
    for name, dtype, route in ((D256_STEP_BWD, torch.bfloat16, "wgmma"),
                               (D256_F32_BWD, torch.float32, "wgmma_f32")):
        q, k, v = _views(g, TRAIN_BATCH, TRAIN_SEQ, D256_STEP_HEADS, 256,
                         dtype)
        do = rn(TRAIN_BATCH, TRAIN_SEQ, D256_STEP_HEADS, 256).to(
            dtype).transpose(1, 2)
        cases.append((name, q, k, v, do, True, None, _both(route)))
    # Llama-2-7B's training attention, as its autograd hands it over
    q, k, v = _blhd_views(g, 1, LLAMA_SEQ, LLAMA_HEADS, 128, torch.bfloat16)
    do = rn(1, LLAMA_SEQ, LLAMA_HEADS, 128).to(torch.bfloat16).transpose(1, 2)
    cases.append((LLAMA_TRAIN_BWD, q, k, v, do, True, None, _both("wgmma")))
    return cases


# the cases at which the FMA dQ and dK/dV kernels, which the tensor-core ones
# replace (the wgmma_f32 pair at float32 D = 64, 128 and 256, the wgmma pair
# at bf16 D = 256), are timed beside them; at the float32 ones they are also
# held to the backward's tolerance
FMA_COMPARED = ("train_float32_B2_L1024", "d64_causal_float32_B2_L1024",
                "d256_causal_float32_B1_L1024", D256_F32_BWD,
                "d256_causal_bfloat16_B1_L1024",
                "d256_causal_bfloat16_B2_L1024", D256_STEP_BWD)


def _fma_bwd_fns(fa, q, k, v, bias, do, lse, delta, causal, emit_ds):
    """The FMA dQ and dK/dV kernels on the same inputs, launched directly
    (no route takes them); ``{"dq_fma", "dkv_fma"}``, each returning its
    gradients."""
    import torch

    def dq_fma():
        ds = (torch.empty(*q.shape[:3], k.shape[2], device=q.device)
              if emit_ds else None)
        dq = fa._empty_like_rows(q)
        fa._launch_bwd("dq", q, k, v, bias, do, lse, delta, {"dq": dq}, ds,
                       causal, 0.0, 0)
        return {"dq": dq}

    def dkv_fma():
        dk, dv = fa._empty_like_rows(k), fa._empty_like_rows(v)
        fa._launch_bwd("dkv", q, k, v, bias, do, lse, delta,
                       {"dk": dk, "dv": dv}, None, causal, 0.0, 0)
        return {"dk": dk, "dv": dv}

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
        if bias is not None and causal and not bool((got[3].triu(1) == 0).all()):
            raise AssertionError(f"{name}: dS is not zero above the diagonal")
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
        fma_errs = {}
        if name in FMA_COMPARED:
            fns.update(_fma_bwd_fns(fa, q, k, v, bias, do_k, lse, delta,
                                    causal, emit_ds))
            if q.dtype == torch.float32:
                # on no route: held to the float32 tolerance here
                fma_out = {**fns["dq_fma"](), **fns["dkv_fma"]()}
                torch.cuda.synchronize()
                fma_errs = {key: check_close(f"{name} fma {key}", x,
                                             refs[key], bwd_tolerance(refs[key]))
                            for key, x in fma_out.items()}
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
        fma = {}
        for w in ("dq", "dkv"):
            if f"{w}_fma" not in t:
                continue
            bound, by = bwd_bound_ms(
                w, *common, B * H * Lq * Lk * 4 if emit_ds and w == "dq"
                else 0, tensor_cores=False)
            fma.update({f"{w}_fma_ms": t[f"{w}_fma"]["median"],
                        f"{w}_fma_ms_range": [t[f"{w}_fma"]["min"],
                                              t[f"{w}_fma"]["max"]],
                        f"{w}_fma_bound_ms": bound,
                        f"{w}_fma_bound_by": by})
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
            **fma, fma_errors=fma_errs or None,
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
    # D = 256 at both of its timed shapes and at the D = 256 step's, and
    # float32 at D = 256: the mask of the first Bc batches and Hc heads is
    # the corner of the full one (Philox keys by (b, h, row, col))
    for dtype, D, Bc, Hc in ((torch.float32, D, B, H),
                             (torch.bfloat16, D, B, H),
                             (torch.bfloat16, 256, B, H),
                             (torch.bfloat16, 256, 1, 8),
                             (torch.bfloat16, 256, TRAIN_BATCH,
                              D256_STEP_HEADS),
                             (torch.float32, 256, 1, 8)):
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
        # each kernel's least time: its products at p = 0 or this case's
        # mask draws, whichever is larger (they run on different units)
        mask_ms = (kept_pairs(L, L, True) * Bc * Hc * PHILOX_OPS
                   / PEAK_INT32_OPS * 1e3)
        tc = {w: r != "fma" for w, r in routes.items()}
        pairs = {w: 6 if r == "wgmma_f32" else 1 for w, r in routes.items()}
        common = (Bc, Hc, L, L, D, True, q.element_size(), 0)
        bounds = {"fwd": attention_bound_ms(*common, tensor_cores=tc["fwd"],
                                            term_pairs=pairs["fwd"])[0],
                  **{w: bwd_bound_ms(w, *common, 0, tensor_cores=tc[w],
                                     term_pairs=pairs[w])[0]
                     for w in ("dq", "dkv")}}
        out[name] = dict(
            shape=[Bc, Hc, L, L, D], errors=errs, routes=routes,
            mask_bound_ms=mask_ms,
            **{f"{w}_bound_ms": max(t, mask_ms) for w, t in bounds.items()},
            fwd_ms=cuda_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=True, dropout_p=DROPOUT_P, seed=mseed)),
            dq_ms=cuda_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, None, do_k, lse, delta, True, DROPOUT_P, mseed)),
            dkv_ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, None, do_k, lse, delta, True, DROPOUT_P, mseed)))
    emit("dropout", p=DROPOUT_P, shape=[B, H, L, L], **out)
    return out


def _serve_and_check(model, requests, slots: int, geo: dict):
    """Serve ``requests`` behind ``InferenceServer(model, slots)`` and hold
    the run to the serving checks: every request completed, none requeued
    or failed, one prefill each, the flash forward launched on the
    wgmma_f32 route only (float32 prefill), it and its split exactly once
    per layer per prefill, and every stream equal to a solo generate()
    with the same arguments. Returns ``(handles, snapshot, launches,
    split launches, wall seconds)``."""
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import InferenceServer

    server = InferenceServer(model, slots=slots, device="cuda", **geo)
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
    layers = model.cfg.num_layers
    need = layers * len(requests)
    if snap["prefills"] != len(requests) or (launches, split_launches) != (need, need):
        raise AssertionError(f"wgmma_f32 forward launched {launches} times "
                             f"and its split {split_launches} over "
                             f"{snap['prefills']} prefills in the served run, "
                             f"expected exactly {need} each ({layers} "
                             f"layers x {len(requests)} requests)")
    for r, got in zip(requests, streams):
        solo = model.generate(r["prompt"][None], **{k: v for k, v in r.items()
                                                     if k != "prompt"}, **geo)[0]
        if got.shape != (r["max_new_tokens"],) or not np.array_equal(got, solo):
            raise AssertionError(f"served stream {got.tolist()} != solo "
                                 f"generate {solo.tolist()} (prompt "
                                 f"{len(r['prompt'])})")
    return handles, snap, launches, split_launches, wall_s


def _prefill_logits_err(model, prompt, cache_len: int) -> float:
    """The kernel path against the plain-attention path, end to end: the
    largest difference of one prompt's prefill logits through every layer
    (raises past PREFILL_LOGITS_TOL or on a non-finite logit)."""
    import torch

    from paddle_tpu_torch.models.generation import init_cache

    ids = torch.as_tensor(prompt[None], device="cuda")
    with torch.inference_mode():
        def prefill_logits():
            return model(ids, cache=init_cache(model, 1, cache_len),
                         position_offset=0)[0]

        flash_logits = prefill_logits()
        model.cfg.use_flash_attention = False
        try:
            plain_logits = prefill_logits()
        finally:
            model.cfg.use_flash_attention = True
    if not bool(torch.isfinite(flash_logits).all()):
        raise AssertionError("non-finite prefill logits")
    err = (flash_logits - plain_logits).abs().max().item()
    if err > PREFILL_LOGITS_TOL:
        raise AssertionError(f"prefill logits, kernel vs plain attention: "
                             f"max|err| {err} > {PREFILL_LOGITS_TOL}")
    return err


def _model_cls(cfg):
    """The port's causal-LM class of ``cfg``'s family."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    return LlamaForCausalLM if isinstance(cfg, LlamaConfig) else GPTForCausalLM


def _gpt_serving_config(**overrides):
    """gpt_1p3b for serving: dropout 0, bf16 KV cache."""
    from paddle_tpu_torch.models.gpt import gpt_1p3b

    return gpt_1p3b(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                    dtype="bfloat16", **overrides)


def _serving_model(seed: int, cfg):
    """A model of ``cfg`` for serving (float32 parameters, random weights
    from ``seed``), warmed up outside any measured run (cuBLAS handles,
    allocator pools); ``(model, build s)``."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    model = _model_cls(cfg)(cfg, device="cuda", generator=gen).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model.generate(np.zeros((1, 8), np.int64), max_new_tokens=2,
                   max_length=cfg.max_position_embeddings)
    torch.cuda.synchronize()
    return model, build_s


def phase_serving(seed: int) -> dict:
    """gpt_1p3b (full width, random weights from ``seed``) behind
    InferenceServer(slots=4, max_length=2048): six requests held to the
    serving checks (_serve_and_check), and one prompt's prefill logits
    through all 24 layers against plain attention's."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    model, build_s = _serving_model(seed, _gpt_serving_config())
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    requests = [dict(prompt=rng.integers(0, cfg.vocab_size, n), max_new_tokens=16)
                for n in (40, 300, 900, 1500, 1900)]
    requests.append(dict(prompt=rng.integers(0, cfg.vocab_size, 700),
                         max_new_tokens=16, do_sample=True, seed=7,
                         temperature=0.8, top_p=0.9))
    geo = dict(max_length=2048)
    handles, snap, launches, split_launches, wall_s = _serve_and_check(
        model, requests, 4, geo)
    # the prefill logits of one full-width prompt through all 24 layers
    logit_err = _prefill_logits_err(model, requests[1]["prompt"], 512)

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


def phase_d256_prefill(seed: int) -> dict:
    """gpt_1p3b width with 8 heads of 256 (D = 256) and 2 layers, random
    weights from ``seed``, behind InferenceServer(slots=2,
    max_length=2048): two greedy prompts of D256_PREFILL_LENGTHS tokens, 8
    new tokens each, held to the serving checks (_serve_and_check: the
    wgmma_f32 forward at D = 256 once per layer per prefill), and the
    kernel path's prefill logits against plain attention's."""
    import numpy as np

    n = 2  # layers
    model, build_s = _serving_model(seed, _gpt_serving_config(
        num_layers=n, num_heads=D256_STEP_HEADS))
    rng = np.random.default_rng(seed + 3)
    requests = [dict(prompt=rng.integers(0, model.cfg.vocab_size, length),
                     max_new_tokens=8) for length in D256_PREFILL_LENGTHS]
    handles, snap, launches, split_launches, wall_s = _serve_and_check(
        model, requests, 2, dict(max_length=2048))
    logit_err = _prefill_logits_err(model, requests[0]["prompt"], 1024)
    out = dict(model="gpt_1p3b width, 8 heads of 256, 2 layers",
               head_dim=256, layers=n, model_build_s=build_s,
               prompt_lens=list(D256_PREFILL_LENGTHS), streams_equal_solo=True,
               flash_launches=launches, split_launches=split_launches,
               prefills=snap["prefills"], wall_s=wall_s,
               ttft_ms=[h.ttft_s * 1e3 for h in handles],
               prefill_logits_max_abs_err=logit_err)
    emit("d256_prefill", **out)
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
    from paddle_tpu_torch.optimizer import AdamW

    framework_random.seed(global_seed)
    model = _model_cls(cfg)(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed)).train()
    model, opt = amp.decorate(model, AdamW(learning_rate=1e-4,
                                           weight_decay=0.01),
                              level="O2", dtype="bfloat16")
    return TrainStep(model, opt, loss_fn=None)


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


# what may stay allocated on the card between phases (the RoPE tables,
# cuBLAS workspaces): a phase that finds more was left a model
LEFTOVER_GIB = 2.0


def _check_freed(phase: str) -> float:
    """GiB allocated on the card as ``phase`` starts; raises past
    LEFTOVER_GIB."""
    import torch

    gib = torch.cuda.memory_allocated() / 2 ** 30
    if gib > LEFTOVER_GIB:
        raise AssertionError(f"{phase}: {gib} GiB still allocated from the "
                             f"phases before it")
    return gib


def _train_run(phase: str, label: str, step, ids, need, flops_per_token,
               build_s: float, **report) -> dict:
    """TRAIN_WARMUP + TRAIN_TIMED steps of ``step`` on ``(ids, ids)``:
    finite losses that fall, exactly ``need`` launches (in the order of
    _COUNT_NAMES) every step, and a fresh batch's loss afterwards above
    half the first loss (no step saw the tokens it predicts); reports the
    median of the timed steps (host clock, synchronised), tokens/s, MFU
    against the bf16 peak and peak memory."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

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
        raise AssertionError(f"{phase}: launches per step {_COUNT_NAMES} "
                             f"{per_step}, expected {need} every step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: losses {losses}: not finite or not "
                             f"falling")
    # the steps repeat one batch, and a model that can see only earlier
    # tokens learns nothing from it about a fresh batch, whose loss stays
    # high however far the trained batch's falls; an attention mask that
    # let a position see the token it predicts would let the model copy
    # it, and the fresh batch's loss fall as well
    fresh = torch.as_tensor(np.random.default_rng(ids.size).integers(
        0, step.model.cfg.vocab_size, ids.shape), device="cuda")
    with torch.no_grad():
        fresh_loss = float(step.model(fresh, fresh))
    if not fresh_loss > losses[0] / 2:
        raise AssertionError(f"{phase}: a fresh batch's loss {fresh_loss} "
                             f"after training on one batch (first loss "
                             f"{losses[0]}): the model may see the tokens "
                             f"it predicts")
    timed = step_ms[TRAIN_WARMUP:]
    tokens_per_s = ids.size * TRAIN_TIMED / (sum(timed) / 1e3)
    out = dict(model=label, **report, batch=list(ids.shape),
               params=sum(p.numel() for p in step.params.values()),
               model_build_s=build_s, losses=losses,
               fresh_batch_loss=fresh_loss,
               launches=dict(zip(_COUNT_NAMES, launches)),
               launches_per_step=dict(zip(_COUNT_NAMES, need)),
               step_ms=step_ms, step_ms_median=float(np.median(timed)),
               tokens_per_s=tokens_per_s,
               mfu=tokens_per_s * flops_per_token / PEAK_BF16_TC_FLOPS,
               flops_per_token=flops_per_token,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               card=nvidia_smi_line())
    emit(phase, **out)
    return out


def phase_training(seed: int) -> dict:
    """The GPT-3 1.3B bf16 (O2) pretrain step, 5 warm-up and 8 timed."""
    import numpy as np
    import torch

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
    return _train_run("training", "gpt_1p3b O2 bf16", step, ids, need,
                      gpt_flops_per_token(cfg, TRAIN_SEQ), build_s)


def phase_train_parity(seed: int) -> dict:
    """One float32 forward and backward of the training configuration,
    with the flash kernels and with plain attention, no update."""
    return _float32_parity(seed, "train_parity")


def phase_d256_f32(seed: int) -> dict:
    """phase_train_parity at gpt_1p3b width with 8 heads of 256 (D = 256),
    cut to 2 layers: the float32 forward and backward through the
    wgmma_f32 kernels at D = 256 against plain attention."""
    return _float32_parity(seed, "d256_f32", num_layers=2,
                           num_heads=D256_STEP_HEADS)


def _float32_parity(seed: int, phase: str, **overrides) -> dict:
    """One float32 forward and backward (no ``amp.decorate``, no update) of
    the training configuration with ``overrides``, with the flash kernels
    and with plain attention: the loss within TRAIN_LOSS_RTOL and every
    parameter's gradient within TRAIN_GRAD_REL_L2 (relative L2), and the
    kernel run's launches exactly 2 wgmma_f32 forwards (recompute
    included), one dQ and one dK/dV per layer and 4 of the split, no FMA
    kernel."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    cfg = _train_config(**overrides)
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
    # float32: the wgmma_f32 forward (and its recompute), dQ and dK/dV; the
    # split once per forward and twice per backward (q, k, v; dO)
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
    out = dict(dtype="float32", layers=n, head_dim=cfg.hidden_size // cfg.num_heads,
               loss_kernel=loss_k, loss_plain=loss_p,
               grad_rel_l2_max=worst, grad_rel_l2_worst_param=names[rel.index(worst)],
               tol=dict(loss_rtol=TRAIN_LOSS_RTOL, grad_rel_l2=TRAIN_GRAD_REL_L2),
               launches=dict(zip(_COUNT_NAMES, launches)),
               split_launches=split_launches)
    emit(phase, **out)
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


def _bf16_step_vs_plain(seed: int, phase: str, make_cfg, ids, **report):
    """The bf16 O2 step of ``make_cfg(flash)`` from one seed with the
    flash kernels and with plain attention. Before each step, the
    gradients of its loss: the kernels' may differ from plain attention's
    by at most BF16_GRAD_SLACK times what bf16 puts between plain
    attention's and a float32 reference (the same weights, plain
    attention, float32), parameter by parameter in relative L2. Then one
    step each: the losses agree within BF16_ULPS bf16 ulps, and the kernel
    step launches exactly 2 forwards per layer (recompute included), one
    dQ and one dK/dV, all on the wgmma route, the plain step none."""
    import copy

    import torch

    from paddle_tpu_torch.kernels import flash_attention as fa

    n = make_cfg(True).num_layers
    ids_t = torch.as_tensor(ids, device="cuda")
    need = (0, 2 * n, 0, 0, n, 0, 0, n, 0)

    def one_step(flash: bool):
        step = _o2_step(make_cfg(flash), seed, seed)
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
        raise AssertionError(f"{phase}: step launches {_COUNT_NAMES} "
                             f"{launches}, expected {need}; the plain step "
                             f"{plain_launches}")
    tol = BF16_ULPS * bf16_ulp(torch.tensor(loss_p)).item()
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= tol):
        raise AssertionError(f"{phase}: loss {loss_k} with the kernels, "
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
            f"{phase}: gradients, kernels vs plain attention: {names[worst]} "
            f"at relative L2 {rel_kp[worst]}, {share[worst]} of its limit "
            f"({BF16_GRAD_SLACK} x plain attention's {rel_pr[worst]} from "
            f"the float32 reference)")
    out = dict(**report, layers=n, batch=list(ids.shape),
               loss_kernel=loss_k, loss_plain=loss_p, tol=tol,
               grad_rel_l2_kernel_vs_plain_max=max(rel_kp),
               grad_rel_l2_plain_vs_f32_max=max(rel_pr),
               grad_worst_param=names[worst],
               grad_worst_share_of_tol=share[worst],
               launches=dict(zip(_COUNT_NAMES, launches)))
    emit(phase, **out)
    return out


def phase_d256_step(seed: int) -> dict:
    """_bf16_step_vs_plain at gpt_1p3b width with 8 heads of 256 (D = 256)
    and 2 layers, batch TRAIN_BATCH x TRAIN_SEQ."""
    import numpy as np

    vocab = _train_config().vocab_size
    ids = np.random.default_rng(seed).integers(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    return _bf16_step_vs_plain(
        seed, "d256_step",
        lambda flash: _train_config(num_layers=2, num_heads=D256_STEP_HEADS,
                                    use_flash_attention=flash), ids,
        model="gpt_1p3b width, 8 heads of 256, 2 layers, O2 bf16",
        head_dim=256)


def _llama_config(**overrides):
    """llama2_7b at full width (bf16 KV cache: serving's storage type)."""
    from paddle_tpu_torch.models.llama import llama2_7b

    return llama2_7b(dtype="bfloat16", **overrides)


def _attention_f64(q, k, v, dropout_p=0.0, training=True, use_flash=True):
    """Causal attention on [B, L, H, D] in float64, cast back to q's
    dtype: the reference of the Llama prefill logits check."""
    import torch

    del dropout_p, training, use_flash  # prefill: no dropout, no kernel
    L, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / math.sqrt(D)
    s.masked_fill_(torch.ones(L, L, dtype=torch.bool,
                              device=q.device).triu(1), -math.inf)
    p = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bhqk,bkhd->bqhd", p, v.double()).to(q.dtype)


def _prefill_logits_vs_f64(model, prompt, cache_len: int) -> dict:
    """One prompt's prefill logits through every layer with the kernels,
    with plain float32 attention and with float64 attention (the rest of
    the model float32 in all three): the kernels' distance from the
    float64 logits may be LLAMA_LOGITS_FACTOR times plain attention's."""
    import torch

    from paddle_tpu_torch.models import lm_utils
    from paddle_tpu_torch.models.generation import init_cache

    ids = torch.as_tensor(prompt[None], device="cuda")

    def prefill_logits():
        with torch.inference_mode():
            return model(ids, cache=init_cache(model, 1, cache_len),
                         position_offset=0)[0]

    flash = prefill_logits()
    plain_attention = lm_utils.causal_attention
    model.cfg.use_flash_attention = False
    try:
        plain = prefill_logits()
        lm_utils.causal_attention = _attention_f64
        ref = prefill_logits()
    finally:
        lm_utils.causal_attention = plain_attention
        model.cfg.use_flash_attention = True
    if not bool(torch.isfinite(flash).all()):
        raise AssertionError("non-finite prefill logits")
    err_kernel = (flash - ref).abs().max().item()
    err_plain = (plain - ref).abs().max().item()
    limit = LLAMA_LOGITS_FACTOR * err_plain
    if not err_kernel <= limit:
        raise AssertionError(f"prefill logits, kernels vs float64 attention: "
                             f"max|err| {err_kernel} > {limit} "
                             f"({LLAMA_LOGITS_FACTOR} x plain float32 "
                             f"attention's {err_plain})")
    return dict(prompt_len=len(prompt), logits_max_abs=ref.abs().max().item(),
                kernel_vs_f64_max_abs_err=err_kernel,
                plain_vs_f64_max_abs_err=err_plain,
                kernel_vs_plain_max_abs_err=(flash - plain).abs().max().item(),
                limit=limit, share_of_limit=err_kernel / limit)


def phase_llama_serving(seed: int) -> dict:
    """llama2_7b at full width and depth (random float32 weights from
    ``seed``, bf16 KV cache) behind InferenceServer(slots=4,
    max_length=4096): six requests held to the serving checks
    (_serve_and_check: the wgmma_f32 forward and its split 32 times per
    prefill), and the 3000-token prompt's prefill logits against float64
    attention (_prefill_logits_vs_f64)."""
    import numpy as np
    import torch

    mem_before = _check_freed("llama_serving")
    torch.cuda.reset_peak_memory_stats()
    model, build_s = _serving_model(seed, _llama_config())
    cfg = model.cfg
    rng = np.random.default_rng(seed + 5)
    requests = [dict(prompt=rng.integers(0, cfg.vocab_size, n),
                     max_new_tokens=16) for n in LLAMA_PROMPT_LENGTHS]
    requests.append(dict(prompt=rng.integers(0, cfg.vocab_size,
                                             LLAMA_SAMPLED_LENGTH),
                         max_new_tokens=16, do_sample=True, seed=7,
                         temperature=0.8, top_p=0.9))
    handles, snap, launches, split_launches, wall_s = _serve_and_check(
        model, requests, 4, dict(max_length=LLAMA_SEQ))
    logits = _prefill_logits_vs_f64(
        model, requests[LLAMA_PROMPT_LENGTHS.index(LLAMA_LOGITS_PROMPT)]["prompt"],
        LLAMA_SEQ)
    out = dict(model="llama2_7b", layers=cfg.num_layers, heads=cfg.num_heads,
               kv_heads=cfg.num_kv_heads,
               params=sum(p.numel() for p in model.parameters()),
               model_build_s=build_s, mem_before_gib=mem_before,
               requests=len(requests),
               prompt_lens=[len(r["prompt"]) for r in requests],
               streams_equal_solo=True, flash_launches=launches,
               split_launches=split_launches,
               prefills=snap["prefills"], decode_steps=snap["decode_steps"],
               wall_s=wall_s, tokens=snap["tokens_emitted"],
               tokens_per_s=snap["tokens_emitted"] / wall_s,
               ttft_ms=[h.ttft_s * 1e3 for h in handles],
               decode_ms_per_token=snap["inter_token"]["mean_ms"],
               decode_ms_per_token_p50=snap["inter_token"]["p50_ms"],
               prefill_logits=logits,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               card=nvidia_smi_line())
    emit("llama_serving", **out)
    return out


def phase_llama_training(seed: int) -> dict:
    """The bf16 O2 step of llama2_7b at full width, cut to
    LLAMA_TRAIN_LAYERS layers (recompute, chunked loss of 256, AdamW(1e-4,
    wd 0.01), batch 1 x 4096): 5 warm-up and 8 timed steps, exactly 16
    wgmma forward, 8 dQ and 8 dK/dV launches per step."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models.llama import llama_flops_per_token

    mem_before = _check_freed("llama_training")
    cfg = _llama_config(num_layers=LLAMA_TRAIN_LAYERS, use_recompute=True,
                        loss_chunk=256)
    t0 = time.perf_counter()
    step = _o2_step(cfg, seed, seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, LLAMA_SEQ)).astype(np.int32)
    n = cfg.num_layers
    need = (0, 2 * n, 0, 0, n, 0, 0, n, 0)
    return _train_run("llama_training",
                      f"llama2_7b, {n} of 32 layers, O2 bf16", step, ids,
                      need, llama_flops_per_token(cfg, LLAMA_SEQ), build_s,
                      reduced=f"num_layers 32 -> {n} (optimizer state)",
                      mem_before_gib=mem_before)


def phase_llama_gqa_grads(seed: int) -> dict:
    """_bf16_step_vs_plain on llama2_7b with LLAMA_GQA_KV_HEADS KV heads
    (4 query heads each) and LLAMA_GQA_LAYERS layers at [1, 4096]: GQA's
    repeat of K and V (a sum over each group in the backward) feeds the
    kernels' dK and dV."""
    import numpy as np

    mem_before = _check_freed("llama_gqa_grads")
    ids = np.random.default_rng(seed + 6).integers(
        0, _llama_config().vocab_size, (1, LLAMA_SEQ)).astype(np.int32)
    return _bf16_step_vs_plain(
        seed, "llama_gqa_grads",
        lambda flash: _llama_config(
            num_layers=LLAMA_GQA_LAYERS, num_kv_heads=LLAMA_GQA_KV_HEADS,
            use_recompute=True, loss_chunk=256, use_flash_attention=flash),
        ids, model=f"llama2_7b width, {LLAMA_GQA_KV_HEADS} KV heads, "
                   f"{LLAMA_GQA_LAYERS} layers, O2 bf16",
        kv_heads=LLAMA_GQA_KV_HEADS, head_dim=128,
        reduced=f"num_layers 32 -> {LLAMA_GQA_LAYERS}, num_kv_heads 32 -> "
                f"{LLAMA_GQA_KV_HEADS}", mem_before_gib=mem_before)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1-3 and stop, printing no result "
                         "line, with a register spill reported but not "
                         "fatal: to compare kernel builds in turns, each "
                         "from its own checkout")
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

    phase_build(args.seed, fail_on_spill=not args.kernels_only)
    fwd = phase_kernels(args.seed)
    bwd = phase_backward(args.seed)
    phase_dropout(args.seed)
    if args.kernels_only:
        return 0
    serve = phase_serving(args.seed)
    _free()
    train = phase_training(args.seed)
    _free()
    parity = phase_train_parity(args.seed)
    _free()
    phase_dropout_replay(args.seed)
    _free()
    d256 = phase_d256_step(args.seed)
    _free()
    d256_f32 = phase_d256_f32(args.seed)
    _free()
    d256_prefill = phase_d256_prefill(args.seed)
    _free()
    llama_serve = phase_llama_serving(args.seed)
    _free()
    llama_train = phase_llama_training(args.seed)
    _free()
    llama_gqa = phase_llama_gqa_grads(args.seed)

    src = "paddle_tpu_torch/kernels/csrc/"
    ref = "paddle_tpu/kernels/flash_attention.py:"

    def fwd_row(name, source, case, launches, path, fma=False):
        c = fwd[case]
        f = "fma_" if fma else ""  # the FMA forward timed beside the case's
        return dict(name=name, route="cuda", source=src + source,
                    replaces=ref + "131", launches=launches, main_path=path,
                    max_abs_err=c[f + "max_abs_err"], ms=c[f + "ms"],
                    ms_range=c[f + "ms_range"], plain_ms=c["plain_ms"],
                    bound_ms=c[f + "bound_ms"], bound_by=c[f + "bound_by"],
                    library_ms=c["library_ms"],
                    library_ms_range=c.get("library_ms_range"),
                    shape=c["shape"], dtype=c.get("dtype", "float32"),
                    causal=c.get("causal"))

    def bwd_row(name, source, which, case, launches, path, fma=False):
        c = bwd[case]
        keys = ("dq",) if which == "dq" else ("dk", "dv")
        errs = c["fma_errors"] if fma else c["errors"]
        f = f"{which}_fma" if fma else which  # the FMA kernel timed beside
        return dict(name=name, route="cuda", source=src + source,
                    replaces=ref + ("198" if which == "dq" else "269"),
                    launches=launches, main_path=path,
                    max_abs_err=max(errs[k]["max_abs_err"] for k in keys),
                    ms=c[f"{f}_ms"], ms_range=c[f"{f}_ms_range"],
                    plain_ms=c["plain_ms"], bound_ms=c[f"{f}_bound_ms"],
                    bound_by=c[f"{f}_bound_by"],
                    library_ms=c["library_ms"], shape=c["shape"],
                    dtype=c["dtype"], causal=c["causal"])

    step = "training (bf16 O2 step)"
    f32_step = "training (float32 parity run)"
    prefill = "serving (float32 prefill)"
    d256_step = "training (bf16 O2 step, D = 256, 2 layers)"
    d256_prefill_path = "serving (float32 prefill, D = 256, 2 layers)"
    d256_f32_path = "training (float32 parity run, D = 256, 2 layers)"
    d256_counts = d256["launches"]
    kernels = [
        fwd_row("flash_attention_fwd_f32_sm90",
                "flash_attention_fwd_f32_sm90.cu", "prefill_f32_L2048",
                serve["flash_launches"], prefill),
        fwd_row("split_bf16_terms", "flash_attention_fwd_f32_sm90.cu",
                "split_prefill_f32_L2048", serve["split_launches"], prefill),
        fwd_row("flash_attention_fwd_f32_sm90_d256",
                "flash_attention_fwd_f32_sm90.cu", D256_PREFILL_FWD,
                d256_prefill["flash_launches"], d256_prefill_path),
        # no route takes the FMA forward since every head dim runs on the
        # tensor cores: 0 launches on a path, checked and timed beside the
        # wgmma_f32 forward at [1, 8, 1024, 256]
        fwd_row("flash_attention_fwd", "flash_attention_fwd.cu",
                "d256_causal_f32_L1024", 0, None, fma=True),
        fwd_row("flash_attention_fwd_sm90", "flash_attention_fwd_sm90.cu",
                "train_bf16_B2_L1024", train["launches"]["fwd_wgmma"], step),
        fwd_row("flash_attention_fwd_sm90_d256", "flash_attention_fwd_sm90.cu",
                D256_STEP_FWD, d256_counts["fwd_wgmma"], d256_step),
        # no route takes the FMA dQ and dK/dV since every head dim runs on
        # the tensor cores: 0 launches on a path, checked and timed beside
        # the wgmma_f32 pair at [1, 8, 1024, 256]
        bwd_row("flash_attention_bwd_dq", "flash_attention_bwd.cu", "dq",
                "d256_causal_float32_B1_L1024", 0, None, fma=True),
        bwd_row("flash_attention_bwd_dq_bf16_d256",
                "flash_attention_bwd_dq_sm90.cu", "dq", D256_STEP_BWD,
                d256_counts["dq_wgmma"], d256_step),
        bwd_row("flash_attention_bwd_dq_sm90",
                "flash_attention_bwd_dq_sm90.cu", "dq",
                "train_bfloat16_B2_L1024", train["launches"]["dq_wgmma"],
                step),
        bwd_row("flash_attention_bwd_dq_f32_sm90",
                "flash_attention_bwd_f32_sm90.cu", "dq",
                "train_float32_B2_L1024", parity["launches"]["dq_wgmma_f32"],
                f32_step),
        bwd_row("flash_attention_bwd_dkv", "flash_attention_bwd.cu", "dkv",
                "d256_causal_float32_B1_L1024", 0, None, fma=True),
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
        bwd_row("flash_attention_bwd_dq_f32_sm90_d256",
                "flash_attention_bwd_f32_d256_sm90.cu", "dq", D256_F32_BWD,
                d256_f32["launches"]["dq_wgmma_f32"], d256_f32_path),
        bwd_row("flash_attention_bwd_dkv_f32_sm90_d256",
                "flash_attention_bwd_f32_d256_sm90.cu", "dkv", D256_F32_BWD,
                d256_f32["launches"]["dkv_wgmma_f32"], d256_f32_path),
    ]
    # Llama-2-7B's attention, [1, 32, 4096, 128] causal, per Llama path
    llama_prefill = "serving (llama2_7b float32 prefill)"
    kernels += [
        fwd_row("flash_attention_fwd_f32_sm90_llama",
                "flash_attention_fwd_f32_sm90.cu", LLAMA_PREFILL_FWD,
                llama_serve["flash_launches"], llama_prefill),
        fwd_row("split_bf16_terms_llama", "flash_attention_fwd_f32_sm90.cu",
                "split_" + LLAMA_PREFILL_FWD, llama_serve["split_launches"],
                llama_prefill)]
    for suffix, run, path in (
            ("llama", llama_train,
             f"training (llama2_7b bf16 O2 step, {LLAMA_TRAIN_LAYERS} layers)"),
            ("llama_gqa", llama_gqa,
             f"training (llama2_7b GQA gradients, {LLAMA_GQA_LAYERS} layers)")):
        counts = run["launches"]
        kernels += [
            fwd_row(f"flash_attention_fwd_sm90_{suffix}",
                    "flash_attention_fwd_sm90.cu", LLAMA_TRAIN_FWD,
                    counts["fwd_wgmma"], path),
            bwd_row(f"flash_attention_bwd_dq_sm90_{suffix}",
                    "flash_attention_bwd_dq_sm90.cu", "dq", LLAMA_TRAIN_BWD,
                    counts["dq_wgmma"], path),
            bwd_row(f"flash_attention_bwd_dkv_sm90_{suffix}",
                    "flash_attention_bwd_dkv_sm90.cu", "dkv", LLAMA_TRAIN_BWD,
                    counts["dkv_wgmma"], path)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

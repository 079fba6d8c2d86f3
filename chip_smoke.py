#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. device   - the card (nvidia-smi name and power limit), torch and CUDA.
2. build    - compiles every CUDA kernel of the port from the sources in
              this checkout (nvcc, one library per source).
3. kernels  - calls each kernel's wrapper on the card at the shapes the
              serving path gives it, and holds the result against its plain
              PyTorch version on the same inputs (stated tolerance). Times
              the kernel, the plain version and one PyTorch library call
              computing the same function (a yardstick the port never
              calls), beside the least time the card could take.
4. serving  - a gpt_1p3b model (full width, random weights from a seed)
              behind InferenceServer(slots=4, max_length=2048) serves six
              requests; every stream must equal a solo generate() with the
              same arguments, no request may be requeued or failed, the
              flash kernel must launch exactly once per layer per prefill
              over the served run, and the kernel-path
              prefill logits must agree with the plain-attention path.

Then a line with the kernels' summary, a line with the card's name and
power limit, and the last line {"ok": true, "device": {...}}.

It exits non-zero without printing a result when no CUDA device is
present, and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12        # CUDA cores, no tensor cores
PEAK_BF16_TC_FLOPS = 989e12   # tensor cores
PEAK_HBM_BYTES = 3.35e12

F32_TOL = 1e-4   # float32 kernel vs float32 einsum: summation order only
# bf16 outputs: kernel and plain version each round an f32 value (equal to
# ~1e-6) to bf16, so they differ by at most one bf16 ulp of the element;
# the limit is two ulps of each element's own size, plus 1e-6 near zero
BF16_ULPS = 2
PREFILL_LOGITS_TOL = 2e-3  # 24 layers of f32 rounding between two attention paths


def bf16_ulp(x):
    """The bf16 spacing at |x|, elementwise (8 significant bits): 2^(e-8)
    for 2^(e-1) <= |x| < 2^e; 0 where x is 0."""
    import torch

    _, e = torch.frexp(x.float().abs())
    return torch.where(x == 0, 0.0, torch.exp2((e - 8).float()))


def output_tolerance(o_ref, tol):
    """The elementwise limit on |o - o_ref|: ``tol`` for float32 outputs,
    BF16_ULPS ulps of o_ref plus 1e-6 for bfloat16 ones."""
    import torch

    if o_ref.dtype == torch.bfloat16:
        return BF16_ULPS * bf16_ulp(o_ref) + 1e-6
    return torch.full_like(o_ref, tol, dtype=torch.float32)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(B, H, Lq, Lk, D, causal, dtype_bytes, bias_bytes,
                       tensor_cores: bool):
    """The least time an H100 could take for one attention forward: the
    larger of (bytes moved once: q, k, v, bias read; o, lse written) over
    HBM bandwidth and (FLOPs of the pairs this run's mask keeps: 2*D for
    QK^T and 2*D for PV per pair) over the peak rate of the input type.
    Exponentials are not counted."""
    if causal:  # top-left: row i keeps min(i + 1, Lk) keys
        kept = sum(min(i + 1, Lk) for i in range(Lq))
    else:
        kept = Lq * Lk
    flops = 4.0 * D * kept * B * H
    nbytes = (B * H * (Lq + 2 * Lk) * D * dtype_bytes      # q, k, v
              + B * H * Lq * D * dtype_bytes + B * H * Lq * 4  # o, lse
              + bias_bytes)
    ops_ms = flops / (PEAK_BF16_TC_FLOPS if tensor_cores else PEAK_F32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_kernels(seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def blhd_views(L, H, D, dtype):
        # q, k, v as the GPT prefill hands them to the kernel: strided
        # [B, H, L, D] views of one fused [B, L, 3, H, D] projection
        qkv = torch.randn(1, L, 3, H, D, generator=g, device="cuda").to(dtype)
        return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))

    cases = []
    for L in (64, 512, 1024, 2048):  # the serving path's prefill buckets
        cases.append((f"prefill_f32_L{L}", *blhd_views(L, 16, 128, torch.float32),
                      True, None, F32_TOL))
    cases.append(("causal_bf16_L2048", *blhd_views(2048, 16, 128, torch.bfloat16),
                  True, None, f"{BF16_ULPS} bf16 ulps + 1e-6"))
    q = torch.randn(1, 16, 384, 128, generator=g, device="cuda")
    k = torch.randn(1, 16, 640, 128, generator=g, device="cuda")
    v = torch.randn(1, 16, 640, 128, generator=g, device="cuda")
    bias = torch.randn(1, 16, 384, 640, generator=g, device="cuda")
    cases.append(("bias_noncausal_f32_Lq384_Lk640", q, k, v, False, bias, F32_TOL))
    cases.append(("ragged_causal_f32_L1500", *blhd_views(1500, 16, 128, torch.float32),
                  True, None, F32_TOL))

    results = {}
    for name, q, k, v, causal, bias, tol in cases:
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, bias=bias)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.reference_attention_fwd(q, k, v, causal=causal,
                                                    bias=bias)
        diff = (o.float() - o_ref.float()).abs()
        err = diff.max().item()
        # the largest error as a share of its element's limit (<= 1 passes)
        err_share = (diff / output_tolerance(o_ref, tol)).max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        if not (math.isfinite(err) and err_share <= 1.0
                and lse_err <= F32_TOL * 10):
            raise AssertionError(f"{name}: kernel vs plain max|err| {err} "
                                 f"at {err_share} of its limit (tol {tol}), "
                                 f"lse {lse_err}")
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                                    bias=bias))
        plain_ms = cuda_ms(lambda: fa.reference_attention_fwd(
            q, k, v, causal=causal, bias=bias), iters=5)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, is_causal=causal))
        B, H, Lq, D = q.shape
        bound_ms, bound_by = attention_bound_ms(
            B, H, Lq, k.shape[2], D, causal, q.element_size(),
            0 if bias is None else bias.numel() * bias.element_size(),
            tensor_cores=q.dtype == torch.bfloat16)
        results[name] = dict(shape=[B, H, Lq, k.shape[2], D],
                             dtype=str(q.dtype).replace("torch.", ""),
                             causal=causal, bias=bias is not None,
                             max_abs_err=err, err_share_of_tol=err_share,
                             lse_max_abs_err=lse_err, tol=tol,
                             ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             roofline_share=bound_ms / ms)
        emit("kernels", case=name, **results[name])
    return results


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
    fa.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    handles = [server.submit(**r) for r in requests]
    streams = [h.result(timeout=900) for h in handles]
    wall_s = time.perf_counter() - t0
    launches = fa.flash_attention_fwd.launches
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
    if snap["prefills"] != len(requests) or launches != need:
        raise AssertionError(f"flash kernel launched {launches} times over "
                             f"{snap['prefills']} prefills in the served run, "
                             f"expected exactly {need} ({cfg.num_layers} "
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
    from paddle_tpu_torch.kernels import _build

    default_device("cuda")  # pins float32 matmul precision (no TF32)
    card = nvidia_smi_line()
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    libs = {s: _build.build(s).name for s in _build.SOURCES}
    emit("build", seconds=time.perf_counter() - t0, libraries=libs,
         ptxas=[ln.strip() for s in libs for ln in _build.build_log(s).splitlines()
                if "Used" in ln or "spill" in ln])

    kern = phase_kernels(args.seed)
    serve = phase_serving(args.seed)

    main_case = kern["prefill_f32_L2048"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/kernels/flash_attention.py:131",
        "launches": serve["flash_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

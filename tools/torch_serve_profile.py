#!/usr/bin/env python3
"""Where the time goes in the port's serving path, on one GPU.

    python3 tools/torch_serve_profile.py [--seed N] [--model llama2_7b]

Builds ``gpt_1p3b`` (full width, random weights from ``--seed``, bf16 KV
cache) on ``cuda``, fills every slot of a ``ContinuousBatchingEngine``
with a ``PROMPT_LEN``-token prompt, then:

- times ``STEPS`` decode steps on the host clock (each ends in the
  engine's token read-back, so each is complete on the device);
- times one prefill per bucket (64 ... 2048) the same way;
- traces 5 decode steps and one 2048-token prefill with
  ``torch.profiler`` and prints the GPU-kernel time by kernel and the
  kernel launch count, per step / per prefill. Kernel time over the
  untraced host-clock time is the device's busy share.

``--model llama2_7b`` does the same for Llama-2-7B at full width and
depth (float32 weights, bf16 KV cache, 4096 positions): the buckets go
up to 4096 and the traced prefill is the 4096-token one.

One JSON line per measurement; the card's name and power limit first.
Needs a CUDA device (exits 1 without one). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SLOTS = 4          # the smoke's InferenceServer(slots=4)
PROMPT_LEN = 512   # a 512-token prefill bucket per slot
STEPS = 20         # timed decode steps


def _emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def _profile(fn, label: str, calls: int):
    """Trace ``fn`` (``calls`` units of work) and print device-kernel time
    by kernel name, per unit. Only GPU kernels count (the CPU-side aten
    ops that launched them are left out, so nothing is counted twice)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((ev.key, dev_us / 1e3 / calls, ev.count / calls))
    rows.sort(key=lambda r: -r[1])
    _emit(profile=label, per=f"1 of {calls}",
          kernel_ms=sum(r[1] for r in rows),
          kernel_launches=sum(r[2] for r in rows),
          top=[{"kernel": k[:100], "ms": ms, "launches": n}
               for k, ms, n in rows[:12]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", choices=("gpt_1p3b", "llama2_7b"),
                    default="gpt_1p3b")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.serving import ContinuousBatchingEngine, Request

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    _emit(card=card, torch=torch.__version__, model=args.model)
    if args.model == "llama2_7b":
        cfg, model_cls = llama2_7b(dtype="bfloat16"), LlamaForCausalLM
    else:
        cfg = gpt_1p3b(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                       dtype="bfloat16")
        model_cls = GPTForCausalLM
    max_len = cfg.max_position_embeddings
    model = model_cls(cfg, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(args.seed)).eval()
    engine = ContinuousBatchingEngine(model, slots=SLOTS, max_length=max_len)
    rng = np.random.default_rng(args.seed)
    for s in range(SLOTS):
        engine.admit(Request(prompt=rng.integers(0, cfg.vocab_size, PROMPT_LEN),
                             max_new_tokens=max_len - PROMPT_LEN), s)
    for _ in range(3):  # warm-up
        engine.step()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        engine.step()
        times.append((time.perf_counter() - t0) * 1e3)
    _emit(measure="decode_step_ms", slots=SLOTS, steps=STEPS,
          median=float(np.median(times)), p25=float(np.percentile(times, 25)),
          p75=float(np.percentile(times, 75)), all=times)
    _profile(lambda: [engine.step() for _ in range(5)], "decode_step", 5)

    for s in range(SLOTS):
        engine.release(s)
    prefill = {}
    for L in (b for b in (64, 512, 1024, 2048, 4096) if b <= max_len):
        req = Request(prompt=rng.integers(0, cfg.vocab_size, L - 1),
                      max_new_tokens=1)
        engine.admit(req, 0)  # warm-up at this bucket
        engine.release(0)
        t0 = time.perf_counter()
        engine.admit(req, 0)
        prefill[L] = (time.perf_counter() - t0) * 1e3
        engine.release(0)
    _emit(measure="prefill_ms_by_bucket", **{str(k): v for k, v in prefill.items()})
    req = Request(prompt=rng.integers(0, cfg.vocab_size, max_len - 1),
                  max_new_tokens=1)
    _profile(lambda: (engine.admit(req, 0), engine.release(0)),
             f"prefill_{max_len}", 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
up to 4096 and the traced prefill is the 4096-token one. ``--model
serve_preset`` takes ``tools/decode_bench.py``'s serving preset (h1024,
24 layers, 16 heads of 64, 1024 positions). ``--kv-dtype int8`` runs
every engine on the int8 cache.

``--admits`` measures the prefix pool's admit instead: a prompt of a
shared prefix (half the positions) and a 64-token suffix admitted by a
pool-less engine (the flash prefill), by a pooled engine on a miss (the
whole prompt through ``cached_attention``) and on a hit (the suffix
only, after the matched blocks are gathered); each timed on the host
clock (median of 5, each ending in the first token's read-back) and
traced once.

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


def _admits(model, cfg, kv_dtype, rng) -> None:
    """Pool-less, pooled-miss and pooled-hit admits of one prompt (see
    the module docstring)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.serving import ContinuousBatchingEngine, Request

    max_len = cfg.max_position_embeddings
    prefix = rng.integers(0, cfg.vocab_size, max_len // 2)

    def prompt():
        return np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 64)])

    plain = ContinuousBatchingEngine(model, slots=SLOTS, max_length=max_len,
                                     kv_dtype=kv_dtype)
    pooled = ContinuousBatchingEngine(model, slots=SLOTS, max_length=max_len,
                                      kv_dtype=kv_dtype,
                                      prefix_cache=256 << 20)

    def admit(engine, reset_pool: bool):
        if reset_pool:
            engine.pool.reset()
        _, _, hit = engine.admit(Request(prompt=prompt(), max_new_tokens=1), 0)
        engine.release(0)
        return hit

    cases = {"pool_less": lambda: admit(plain, False),
             "pooled_miss": lambda: admit(pooled, True),
             "pooled_hit": lambda: admit(pooled, False)}
    for name, fn in cases.items():
        fn()   # warm-up (and, for the hit, the store it matches)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hit = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        _emit(measure=f"admit_ms_{name}", kv_dtype=kv_dtype or "bfloat16",
              prompt=len(prefix) + 64, hit_tokens=hit,
              median=float(np.median(times)), all=times)
        _profile(fn, f"admit_{name}", 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", choices=("gpt_1p3b", "llama2_7b",
                                        "serve_preset"),
                    default="gpt_1p3b")
    ap.add_argument("--kv-dtype", choices=("none", "int8"), default="none")
    ap.add_argument("--admits", action="store_true",
                    help="time and trace pool-less, pooled-miss and "
                         "pooled-hit admits")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM, gpt_1p3b
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.serving import ContinuousBatchingEngine, Request

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    _emit(card=card, torch=torch.__version__, model=args.model)
    if args.model == "llama2_7b":
        cfg, model_cls = llama2_7b(dtype="bfloat16"), LlamaForCausalLM
    elif args.model == "serve_preset":
        cfg = GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=24,
                        num_heads=16, max_position_embeddings=1024,
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                        dtype="bfloat16")
        model_cls = GPTForCausalLM
    else:
        cfg = gpt_1p3b(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                       dtype="bfloat16")
        model_cls = GPTForCausalLM
    max_len = cfg.max_position_embeddings
    model = model_cls(cfg, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(args.seed)).eval()
    kv_dtype = None if args.kv_dtype == "none" else args.kv_dtype
    rng = np.random.default_rng(args.seed)
    if args.admits:
        _admits(model, cfg, kv_dtype, rng)
        return 0
    engine = ContinuousBatchingEngine(model, slots=SLOTS, max_length=max_len,
                                      kv_dtype=kv_dtype)
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

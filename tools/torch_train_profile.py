#!/usr/bin/env python3
"""Where the time goes in the port's training step, on one GPU.

    python3 tools/torch_train_profile.py [--seed N] [--dtype float32]
                                         [--model llama2_7b |
                                          transformer_base | bert_base |
                                          resnet50]

Builds the GPT-3 1.3B pretrain step of ``bench.py``'s ``bench_gpt_1p3b``
on ``cuda`` (hidden 2048, 24 layers, 16 heads, vocab 50304, 1024
positions, recompute, flash attention, chunked loss of 256, AdamW(1e-4,
weight decay 0.01) under ``amp.decorate`` O2 bf16; random weights from
``--seed``), drives ``TrainStep`` on a ``[2, 1024]`` batch, then:

- times ``STEPS`` steps on the host clock after ``WARMUP`` (each ends in
  the loss's read-back, so each is complete on the device);
- traces ``TRACED`` steps with ``torch.profiler`` and prints the
  GPU-kernel time by kernel and the launch count, per step, and the
  device's busy share (kernel time over the untraced step time) and idle
  share (one minus it).

``--dtype float32`` trains the same model in float32 instead (no
``amp.decorate``: float32 parameters, as the reference keeps them, and
the float32 attention kernels, route ``wgmma_f32``). ``--model
llama2_7b`` profiles ``chip_smoke.py``'s Llama step instead: Llama-2-7B
at full width cut to 8 layers (its AdamW state at 32 layers outgrows
one card), recompute, chunked loss of 256, on a ``[1, 4096]`` batch.
``--model transformer_base`` and ``--model bert_base`` profile
``chip_smoke.py``'s encoder steps (bf16 O2 only): Transformer-base
(``nn.Transformer()`` at its defaults, dropout 0.1, a 37000-word tied
embedding, label smoothing 0.1) on its ``[32 x 256 / 200]`` batch with
padding masks, and ``BertForSequenceClassification(bert_base())`` on its
padded ``[32, 128]`` batch; tokens/s counts every position, MFU is not
reported for them. ``--model resnet50`` profiles ``chip_smoke.py``'s
bench_resnet50 step (ResNet-50, 1000 classes, batch 64 at 224 x 224, bf16
O2 Momentum(0.1, 0.9) on float32 images: float32 compute, as the
reference) and groups its kernels as a convolutional step spends them:
convolution forward and backward (cuDNN), batch-norm statistics and the
elementwise work, pooling, the optimizer, copies; its "tokens" are
images, and MFU counts 3 x the ported ``flops()`` forward against the
bf16 peak.

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

BATCH, SEQ = 2, 1024   # bench_gpt_1p3b
LLAMA_BATCH, LLAMA_SEQ, LLAMA_LAYERS = 1, 4096, 8
WARMUP = 5             # steps before the timed ones
STEPS = 8              # timed steps
TRACED = 2             # profiled steps


def _emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def _profile(fn, calls: int):
    """Trace ``fn`` (``calls`` steps) and return GPU-kernel rows
    ``(name, ms per step, launches per step)``, largest first. Only GPU
    kernels count (the CPU-side ops that launched them are left out, so
    nothing is counted twice)."""
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
    return rows


def _group(name: str) -> str:
    """A coarse class of a GPU kernel, by its name."""
    n = name.lower()
    route = "wgmma_f32" if "f32_sm90" in n else "wgmma_f16" if "f16_sm90" \
        in n else "wgmma" if "sm90" in n else "FMA"
    if "split_terms" in n:
        return "flash operand split (ours)"
    if "flash_fwd" in n:
        return f"flash forward (ours, {route})"
    if "flash_bwd_dq" in n:
        return f"flash dQ (ours, {route})"
    if "flash_bwd_dkv" in n:
        return f"flash dK/dV (ours, {route})"
    if any(w in n for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer (foreach)"
    if "softmax" in n or "nll" in n or "cross" in n:
        return "softmax / loss"
    if "layer_norm" in n or "layernorm" in n:
        return "layer norm"
    if "copy" in n or "cat" in n or "index" in n or "fill" in n:
        return "copies / index / fill"
    return "other elementwise and reductions"


def _conv_group(name: str) -> str:
    """A coarse class of a GPU kernel of the convolutional step."""
    n = name.lower()
    if "dgrad" in n or "wgrad" in n or "bprop" in n or \
            ("conv" in n and "backward" in n):
        return "convolution backward (cuDNN)"
    if "nchwtonhwc" in n or "nhwctonchw" in n or "transpose" in n:
        return "layout transposes (cuDNN)"
    if any(w in n for w in ("fprop", "conv", "cudnn", "xmma", "implicit",
                            "winograd", "fft")):
        return "convolution forward (cuDNN)"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer (foreach)"
    if "welford" in n or "reduce" in n or "var_mean" in n:
        return "batch-norm statistics (reductions)"
    if "pool" in n:
        return "pooling"
    if any(w in n for w in ("gemm", "gemv", "nvjet", "cutlass")):
        return "matmul (cuBLAS: the classifier)"
    if "softmax" in n or "nll" in n or "cross" in n:
        return "softmax / loss"
    if "copy" in n or "cat" in n or "index" in n or "fill" in n:
        return "copies / index / fill"
    return "elementwise (batch-norm apply and its backward, ReLU, adds)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="bfloat16: O2 (bench_gpt_1p3b); float32: no amp")
    ap.add_argument("--model", choices=("gpt_1p3b", "llama2_7b",
                                        "transformer_base", "bert_base",
                                        "resnet50"),
                    default="gpt_1p3b")
    args = ap.parse_args(argv)
    if args.model in ("transformer_base", "bert_base", "resnet50") \
            and args.dtype != "bfloat16":
        ap.error(f"--model {args.model} is profiled in bf16 O2 only")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch import amp, default_device
    from paddle_tpu_torch.framework import random as framework_random
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_1p3b,
                                             gpt_flops_per_token)
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama2_7b,
                                               llama_flops_per_token)
    from paddle_tpu_torch.optimizer import AdamW

    default_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    _emit(card=card, torch=torch.__version__, dtype=args.dtype,
          model=args.model)
    flops_per_token = None
    group = _group
    if args.model == "resnet50":
        import chip_smoke as smoke
        from paddle_tpu_torch.hapi.dynamic_flops import flops

        step, batch = smoke._rn_bench_step(args.seed)
        positions = smoke.RN_BATCH
        fwd_flops = flops(step.model, (1, 3, smoke.RN_SIZE, smoke.RN_SIZE))
        flops_per_token = lambda cfg, seq: 3 * fwd_flops  # noqa: E731
        cfg = seq = None
        group = _conv_group
    elif args.model in ("transformer_base", "bert_base"):
        import chip_smoke as smoke
        from paddle_tpu_torch.models.bert import (
            BertForSequenceClassification, bert_base)

        framework_random.seed(args.seed)
        if args.model == "transformer_base":
            model = smoke._transformer_base_lm(args.seed).train()
            batch = smoke._transformer_base_batch(args.seed)[0]
            positions = smoke.TB_BATCH * (smoke.TB_SRC + smoke.TB_TGT)
            opt = AdamW(learning_rate=5e-4, weight_decay=0.01)
        else:
            cfg = bert_base()
            model = BertForSequenceClassification(
                cfg, device="cuda", generator=torch.Generator(
                    "cuda").manual_seed(args.seed)).train()
            batch = smoke._bert_classification_batch(args.seed,
                                                     cfg.vocab_size)[0]
            positions = smoke.BERT_BATCH * smoke.BERT_SEQ
            opt = smoke._bert_optimizer()
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    elif args.model == "llama2_7b":
        batch_size, seq = LLAMA_BATCH, LLAMA_SEQ
        cfg = llama2_7b(num_layers=LLAMA_LAYERS, use_recompute=True,
                        loss_chunk=256, dtype="bfloat16")
        model_cls, flops_per_token = LlamaForCausalLM, llama_flops_per_token
    else:
        batch_size, seq = BATCH, SEQ
        cfg = gpt_1p3b(max_position_embeddings=SEQ, hidden_dropout_prob=0.0,
                       attention_dropout_prob=0.0, use_recompute=True,
                       use_flash_attention=True, loss_chunk=256,
                       dtype="bfloat16")
        model_cls, flops_per_token = GPTForCausalLM, gpt_flops_per_token
    if flops_per_token is not None and args.model != "resnet50":
        framework_random.seed(args.seed)
        model = model_cls(cfg, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(args.seed)).train()
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01)
        if args.dtype == "bfloat16":
            model, opt = amp.decorate(model, opt, level="O2",
                                      dtype="bfloat16")
        ids = np.random.default_rng(args.seed).integers(
            0, cfg.vocab_size, (batch_size, seq)).astype(np.int32)
        batch = (ids, ids)
        positions = batch_size * seq
    if args.model != "resnet50":
        step = TrainStep(model, opt, loss_fn=None)
    for _ in range(WARMUP):
        float(step(batch))
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        float(step(batch))
        times.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(times))
    tokens_per_s = positions / (median / 1e3)
    _emit(measure="train_step_ms", steps=STEPS, median=median,
          p25=float(np.percentile(times, 25)),
          p75=float(np.percentile(times, 75)), all=times,
          tokens_per_s=tokens_per_s,
          mfu=None if flops_per_token is None
          else tokens_per_s * flops_per_token(cfg, seq) / 989e12,
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    rows = _profile(lambda: [float(step(batch)) for _ in range(TRACED)],
                    TRACED)
    kernel_ms = sum(r[1] for r in rows)
    groups = {}
    for name, ms, n in rows:
        g = groups.setdefault(group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += n
    _emit(profile="train_step", per=f"1 of {TRACED}", kernel_ms=kernel_ms,
          kernel_launches=sum(r[2] for r in rows),
          busy_share=kernel_ms / median, idle_share=1 - kernel_ms / median,
          groups={k: {"ms": v[0], "launches": v[1]} for k, v in
                  sorted(groups.items(), key=lambda kv: -kv[1][0])},
          top=[{"kernel": k[:100], "ms": ms, "launches": n}
               for k, ms, n in rows[:15]])
    return 0


if __name__ == "__main__":
    sys.exit(main())

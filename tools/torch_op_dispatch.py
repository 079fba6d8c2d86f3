#!/usr/bin/env python3
"""What the flash-attention forward's operator registration costs the
host, on one GPU.

    python3 tools/torch_op_dispatch.py [--seed N] [--json-out PATH]

``kernels/flash_attention.py`` registers the bf16/float16/float32 forward
launch as the operator ``paddle_tpu_torch::flash_attention_fwd`` (with
``torch.library.Library``), so that a program captured by ``jit.save``
keeps the kernel. This script times three ways of reaching the same
launch, in turns within one process:

- ``library``: the registered operator, as the port calls it;
- ``custom_op``: the same launch registered with
  ``torch.library.custom_op`` under another name (the registration the
  port does not use);
- ``direct``: ``_launch_fwd`` called from Python, with no operator.

It reports (1) the host microseconds a call of each at ``[1, 2, 128, 64]``
bf16 causal, where the kernel is shorter than the call (medians of
``ROUNDS`` x 2 samples of ``CALLS`` calls); and (2) the end-to-end cost:
``bench_gpt_primary``'s GPT-350M (bf16 O2 AdamW, ``[8, 1024]``, flash
attention, ``chip_smoke.py``'s ``_primary_net``) trained by ``TrainStep``
and run forward in eval mode at ``[1, 1024]`` with ``FlashAttention``'s
forward going through each of the three (step and forward ms, medians on
the host clock, each ending in a read-back or a synchronize). Each
variant's launches are counted and checked: 24 a step and a forward.

One JSON line per measurement; the card's name and power limit first.
Needs a CUDA device (exits 1 without one). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CALLS = 200          # calls a dispatch sample
ROUNDS = 3           # each round runs the variants forward, then reversed
STEP_WARMUP, STEPS = 2, 4      # a variant's steps a round: untimed, timed
FWD_WARMUP, FWDS = 2, 10       # the same for the eval forward
FWD_SHAPE = (1, 1024)


def _variants(fa, torch):
    """``name -> flash_attention_fwd``-shaped callable``, each carrying the
    ``launches``/``routes`` counters ``_launch_fwd`` bumps."""

    @torch.library.custom_op(
        "paddle_tpu_torch_probe::flash_attention_fwd", mutates_args=(),
        schema="(Tensor q, Tensor k, Tensor v, Tensor? bias, bool causal, "
               "float dropout_p, int seed) -> (Tensor, Tensor)")
    def probe(q, k, v, bias, causal, dropout_p, seed):
        raise NotImplementedError("the probe runs on CUDA tensors only")

    @probe.register_kernel("cuda")
    def _(q, k, v, bias, causal, dropout_p, seed):
        return fa._launch_fwd(q, k, v, causal, bias, None, dropout_p, seed)

    def custom_op(q, k, v, causal=False, bias=None, dropout_p=0.0, seed=0):
        return torch.ops.paddle_tpu_torch_probe.flash_attention_fwd(
            q, k, v, bias, bool(causal), float(dropout_p),
            fa._int64_seed(seed))

    def direct(q, k, v, causal=False, bias=None, dropout_p=0.0, seed=0):
        return fa._launch_fwd(q, k, v, causal, bias, None, dropout_p, seed)

    library = fa.flash_attention_fwd
    out = {"library": library, "custom_op": custom_op, "direct": direct}
    for fn in (custom_op, direct):
        fn.launches, fn.routes = 0, dict(library.routes)
    return out


def _in_turns(names):
    """The variants' order in each round: forward, then reversed."""
    for r in range(ROUNDS):
        yield from (names if r % 2 == 0 else list(reversed(names)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None,
                    help="also write the lines to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_op_dispatch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from paddle_tpu_torch import default_device
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.kernels import flash_attention as fa

    default_device("cuda")
    lines = []

    def emit(**rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    emit(phase="device", card=smoke.nvidia_smi_line(),
         torch=torch.__version__, cuda=torch.version.cuda)
    variants = _variants(fa, torch)
    names = list(variants)

    # (1) host microseconds a call
    q, k, v = smoke._views(torch.Generator(device="cuda").manual_seed(
        args.seed), 1, 128, 2, 64, torch.bfloat16)
    want, _ = fa._launch_fwd(q, k, v, True, None, None, 0.0, 0)
    samples = {n: [] for n in names}
    for name in _in_turns(names):
        fn = variants[name]
        assert torch.equal(fn(q, k, v, causal=True)[0], want), name
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn(q, k, v, causal=True)
        torch.cuda.synchronize()
        samples[name].append((time.perf_counter() - t0) * 1e6 / CALLS)
    emit(phase="dispatch_us_per_call", shape=[1, 2, 128, 64], dtype="bf16",
         calls=CALLS, median={n: statistics.median(s)
                               for n, s in samples.items()},
         samples=samples)

    # (2) GPT-350M: a TrainStep step and an eval forward through each
    cfg = smoke._primary_config()
    model, opt = smoke._primary_net(cfg, args.seed)
    step = TrainStep(model, opt, loss_fn=None)
    rng = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    batch = torch.randint(0, cfg.vocab_size, (smoke.HF_BATCH, smoke.HF_SEQ),
                          device="cuda", generator=rng)
    ids = torch.randint(0, cfg.vocab_size, FWD_SHAPE, device="cuda",
                        generator=rng)
    step_ms = {n: [] for n in names}
    fwd_ms = {n: [] for n in names}
    launches = {}
    for name in _in_turns(names):
        fn = variants[name]
        fa.flash_attention_fwd = fn   # what FlashAttention.forward calls
        try:
            model.train()
            for i in range(STEP_WARMUP + STEPS):
                fn.launches = 0
                t0 = time.perf_counter()
                float(step((batch, batch)))
                if i >= STEP_WARMUP:
                    step_ms[name].append((time.perf_counter() - t0) * 1e3)
            launches[f"{name}_step"] = fn.launches
            model.eval()
            with torch.no_grad():
                for i in range(FWD_WARMUP + FWDS):
                    fn.launches = 0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model(ids)
                    torch.cuda.synchronize()
                    if i >= FWD_WARMUP:
                        fwd_ms[name].append((time.perf_counter() - t0) * 1e3)
            launches[f"{name}_forward"] = fn.launches
        finally:
            fa.flash_attention_fwd = variants["library"]
    bad = {k: n for k, n in launches.items() if n != cfg.num_layers}
    if bad:
        raise AssertionError(f"launches {bad}, expected {cfg.num_layers}")
    emit(phase="gpt350m", batch=[smoke.HF_BATCH, smoke.HF_SEQ],
         forward_shape=list(FWD_SHAPE), launches=launches,
         step_ms_median={n: statistics.median(s) for n, s in step_ms.items()},
         forward_ms_median={n: statistics.median(s)
                            for n, s in fwd_ms.items()},
         step_ms=step_ms, forward_ms=fwd_ms)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())

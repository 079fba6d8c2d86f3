#!/usr/bin/env python3
"""The world-2 checks of ``chip_smoke.py`` on sound runs and on runs with a
planted fault, on one GPU.

    python3 tools/torch_dist_faults.py [--seed N] [--out PATH]

``chip_smoke.py``'s ``distributed_training`` holds each world-2 run of
bench_gpt_primary's GPT-350M step (two rank processes on one card, gloo
with CUDA tensors, 13 steps) to a single-process ``TrainStep`` on the same
batches through two numbers: the losses' largest relative error
(``DIST_LOSS_RTOL``) and the worst leaf's update error, ||world-2 master
- yardstick's|| over ||yardstick's - initial|| (``DIST_UPDATE_RTOL``).
This script builds the kernels and the yardstick as the smoke does, then
reads both numbers on each of CASES, every run two fresh rank processes:

- the smoke's three runs as they are (ZeRO-2 with the overlap buckets,
  mp = 2, ZeRO-3);
- ``no_update``: the step never updates (ZeRO-2 with the buckets);
- ``no_grad_reduce``: each rank keeps its own gradients, reduced over no
  rank (ZeRO-2 with the buckets);
- ``no_input_grad_reduce``: the column layers' backward skips its
  all-reduce over "mp" (mp = 2);
- ``f32_row_partials``: no fault; each row layer's partial product over
  its half of the features stays in float32 through the all-reduce over
  "mp" and is rounded to bf16 once, as the single-process product is
  (mp = 2): what is left of the mp run's error is not the bf16 partial
  sums'.

A gate is sound when it lies between the sound runs' readings and the
faulty runs'. Prints one JSON line a run, with the card's name and power
limit, and writes them all to ``--out`` (default
``chiprun_out/dist_faults.json``). Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

CASES = (
    ("sdp2_zero2_overlap", None),
    ("mp2", None),
    ("sdp2_zero3", None),
    ("sdp2_zero2_overlap", "no_update"),
    ("sdp2_zero2_overlap", "no_grad_reduce"),
    ("mp2", "no_input_grad_reduce"),
    ("mp2", "f32_row_partials"),
)
READ = ("loss_max_rel_err", "update_err_worst_leaf", "worst_leaf",
        "update_err_model", "master_max_abs_err", "master_frac_beyond_lr",
        "losses")


def plant(fault) -> None:
    """Patch the port in this rank process as ``fault`` says."""
    import torch

    from paddle_tpu_torch.distributed import shard
    from paddle_tpu_torch.distributed.parallel import mp_layers

    if fault is None:
        return
    if fault == "no_update":
        shard.DistributedTrainStep._update = \
            lambda self, grads, loss, checked: (None, None)
    elif fault == "no_grad_reduce":
        def local(self, names, grads):
            def finish():
                out = {}
                for k in names:
                    g, d = grads[k], self._sdp_dim[k]
                    if d is not None:
                        w = g.shape[d] // self.mesh.axis_size(shard.SDP)
                        g = g.narrow(d, self.mesh.axis_index(shard.SDP) * w,
                                     w)
                    out[k] = g.contiguous()
                return out

            return shard._Reduced(finish)

        shard.DistributedTrainStep._issue = local
    elif fault == "no_input_grad_reduce":
        mp_layers._CopyToMP.backward = staticmethod(lambda ctx, g: (g, None))
    elif fault == "f32_row_partials":
        plain = mp_layers.RowParallelLinear.forward

        def forward(self, x):
            mesh = mp_layers.mp_mesh_of(self)
            if mesh is None or not self.input_is_parallel:
                return plain(self, x)
            part = torch.matmul(x.float(), self.weight.float())
            out = mp_layers.reduce_from_mp(part, mesh).to(x.dtype)
            return out if self.bias is None else out + self.bias

        mp_layers.RowParallelLinear.forward = forward
    else:
        raise ValueError(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "dist_faults.json"))
    ap.add_argument("--child", nargs=3, metavar=("RUN", "FAULT", "REF"),
                    help=argparse.SUPPRESS)   # one rank of a case
    args = ap.parse_args(argv)
    if args.child:
        run, fault, ref = args.child
        plant(None if fault == "none" else fault)
        return cs.dist_child(run, ref)

    import torch

    if not torch.cuda.is_available():
        print("torch_dist_faults: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch import default_device

    default_device("cuda")
    card = cs.nvidia_smi_line()
    cs.phase_build(args.seed)
    cfg = cs._primary_config()
    tmp = tempfile.mkdtemp(prefix="dist_faults_")
    rows = []
    try:
        ref_path = os.path.join(tmp, "reference.pt")
        cs._dist_reference(cfg, args.seed, ref_path)
        for run, fault in CASES:
            t0 = time.perf_counter()
            name = f"{run}-{fault or 'none'}"
            ranks = cs._join_world(cs._start_world(
                name, 2, ref_path, args.seed, tmp,
                child=[os.path.abspath(__file__), "--child", run,
                       fault or "none", ref_path]))[0]
            row = dict(run=run, fault=fault, card=card,
                       seconds=time.perf_counter() - t0,
                       step_ms=[r["step_ms"] for r in ranks],
                       peak_gib=[r["peak_gib"] for r in ranks],
                       **{k: ranks[0][k] for k in READ})
            if not rows:
                row["ref_losses"] = ranks[0]["ref_losses"]
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Compare builds of the float32 D = 256 backward in turns, on one GPU.

    python3 tools/torch_flash_variants.py LABEL=SOURCE.cu [LABEL=SOURCE.cu ...]
        [--seed N]

Each SOURCE is a variant of
``paddle_tpu_torch/kernels/csrc/flash_attention_bwd_f32_d256_sm90.cu``
with the same C entries: a candidate layout or a tuning of it, e.g. the
file as it stands in another commit (``git show REV:PATH > FILE``).

All variants compile at once with the port's nvcc flags (the headers of
``kernels/csrc`` on the include path) into ``build/kernels/variants/``;
the ``-Xptxas -v`` report gives each kernel's registers and spill bytes.
Then, in one process, the dQ and dK/dV wrappers are pointed at each
variant's entries in turn: each variant is held against the plain
backward (``chip_smoke.bwd_tolerance``: the reference's rtol 2e-4 / atol
2e-5) at p = 0 and p = 0.1, and the two kernels are timed at
``[1, 8, 1024, 256]`` and ``[2, 8, 1024, 256]`` float32 causal (the head
count and batch of the D = 256 model's runs), at p = 0 and p = 0.1, as
device medians of 6 loops of 20 calls taken in turns (A B ... B A, three
times), so that drift of the card's clock falls on all alike.

One JSON line per measurement, the card's name and power limit first.
Needs a CUDA device and nvcc (exits 1 without a device); imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = {"B1": (1, 8, 1024), "B2": (2, 8, 1024)}  # (B, H, L)
HEAD_DIM = 256
DROPOUT_P = 0.1
ROUNDS = 3


def _emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def build(variants: dict) -> dict:
    """Compile every ``{label: source}`` at once; ``{label: (library,
    ptxas report)}``. Raises with the compiler's output if one fails."""
    import chip_smoke
    from paddle_tpu_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, source in variants.items():
        lib = out_dir / f"{label}.so"
        procs[label] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(lib), source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{label}: nvcc exited {proc.returncode}\n{log}")
        built[label] = (lib, chip_smoke.ptxas_report(log))
    return built


def entries(fa, lib: str) -> dict:
    """The typed dQ and dK/dV entries of one variant's library (the C
    entries of the current source: the gradients' element type before
    the stream)."""
    handle = ctypes.CDLL(lib)
    fns = {}
    for which in ("dq", "dkv"):
        fn = getattr(handle, f"pt_flash_attention_bwd_{which}_f32_d256_sm90")
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + fa._SM90_F32_TAIL)
        fn.restype = ctypes.c_int
        fns[which] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", metavar="LABEL=SOURCE.cu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from paddle_tpu_torch import default_device
    from paddle_tpu_torch.kernels import flash_attention as fa

    default_device("cuda")  # float32 matmuls in full float32 (no TF32)
    _emit(card=chip_smoke.nvidia_smi_line())
    variants = dict(v.split("=", 1) for v in args.variants)
    built = build(variants)
    for label, (lib, report) in built.items():
        _emit(variant=label, source=variants[label], ptxas=report)
    fns = {label: entries(fa, str(lib)) for label, (lib, _) in built.items()}

    # the wrappers look their entries up per call: point them at a variant
    default_fn = fa._bwd_sm90_fn
    current = {}

    def lookup(which, route, head_dim):
        if (route, head_dim) == ("wgmma_f32", HEAD_DIM):
            return current[which]
        return default_fn(which, route, head_dim)

    fa._bwd_sm90_fn = lookup
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    cases = {}
    for name, (B, H, L) in SHAPES.items():
        q, k, v, do = (torch.randn(B, H, L, HEAD_DIM, generator=g,
                                   device="cuda") for _ in range(4))
        for p in (0.0, DROPOUT_P):
            o, lse = fa.flash_attention_fwd(q, k, v, causal=True, dropout_p=p,
                                            seed=args.seed)
            keep = (fa.dropout_mask(args.seed, B, H, L, L, p, "cuda") if p
                    else None)
            ref = fa.reference_attention_bwd(q, k, v, None, o, lse, do, True,
                                             keep)
            delta = (do * o).sum(-1).contiguous()
            terms = fa._backward_terms(q, k, v, do)
            cases[(name, p)] = (q, k, v, do, o, lse, delta, terms, ref)

    for label in fns:
        current.update(fns[label])
        for (name, p), (q, k, v, do, o, lse, delta, _, ref) in cases.items():
            got = fa.flash_attention_bwd(q, k, v, None, o, lse, do, True, p,
                                         args.seed)
            errs = {key: chip_smoke.check_close(f"{label} {name} p={p} {key}",
                                                x, y, chip_smoke.bwd_tolerance(y))
                    for key, x, y in zip(("dq", "dk", "dv"), got, ref)}
            _emit(variant=label, shape=name, p=p,
                  err_share_of_tol={k: e["err_share_of_tol"]
                                    for k, e in errs.items()})

    def call(which, case, p):
        q, k, v, do, _, lse, delta, terms, _ = case
        wrapper = getattr(fa, f"flash_attention_bwd_{which}")
        return lambda: wrapper(q, k, v, None, do, lse, delta, True, p,
                               args.seed, terms=terms)

    samples = {}
    order = list(fns)
    for _ in range(ROUNDS):
        for label in order + order[::-1]:
            current.update(fns[label])
            for (name, p), case in cases.items():
                for which in ("dq", "dkv"):
                    fn = call(which, case, p)
                    for _ in range(3):
                        fn()
                    samples.setdefault((label, name, p, which), []).append(
                        chip_smoke._timed_loop(fn, 20))
    for (label, name, p, which), ms in samples.items():
        B, H, L = SHAPES[name]
        _emit(variant=label, kernel=which, shape=[B, H, L, HEAD_DIM],
              p=p, ms=statistics.median(ms), ms_range=[min(ms), max(ms)])
    fa._bwd_sm90_fn = default_fn
    return 0


if __name__ == "__main__":
    sys.exit(main())

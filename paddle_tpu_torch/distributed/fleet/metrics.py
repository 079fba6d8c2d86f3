"""Cross-trainer metric reduction (port of
``paddle_tpu/distributed/fleet/metrics.py``).

Reference parity: ``python/paddle/distributed/fleet/metrics/metric.py``
(``sum``/``max``/``min``/``auc``/``mae``/``rmse``/``acc`` all-reduced over
trainers via the fleet util's Gloo/NCCL all_reduce). Metric state lives
host-side as numpy; reduction rides whichever transport the job already
has —

- a live ``torch.distributed`` world: an all-reduce over the world's ranks
  through :mod:`..collective`, on the mesh that ``fleet.init`` built;
- a launch KV store (``PADDLE_KV_ENDPOINT``): HTTP gather-reduce-broadcast,
  the TCPStore pattern — works between plain processes, no cards involved;
- neither: single-trainer identity.

All functions accept numpy arrays or scalars and return numpy.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "acc"]


def _world() -> int:
    return int(os.environ.get("PADDLE_TRAINERS_NUM",
                              os.environ.get("WORLD_SIZE", "1")))


def _rank() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID",
                              os.environ.get("RANK", "0")))


def _torch_world_live() -> bool:
    from .. import env

    return env.is_initialized() and env.get_world_size() > 1


def _device_allreduce(value: np.ndarray, op: str) -> np.ndarray:
    """Reduce across the live world: every rank contributes its array once
    (on the device ``init_parallel_env`` bound it to) to an all-reduce over
    every axis of the mesh, which spans the world. The reference stacks
    one copy per local device and divides its "sum" by their number; one
    copy a rank gives that normalized sum directly."""
    import torch

    from .. import collective, env
    from ..mesh import get_mesh

    mesh = get_mesh()
    if mesh is None or mesh.size != env.get_world_size():
        raise RuntimeError(
            "fleet.metrics over a live world needs a mesh over all of its "
            "ranks: call fleet.init() (or init_mesh()) first")
    dev = env.device() or torch.device("cpu")
    t = torch.as_tensor(value, dtype=torch.float64, device=dev)
    red = {"sum": collective.ReduceOp.SUM, "max": collective.ReduceOp.MAX,
           "min": collective.ReduceOp.MIN}[op]
    out = collective.all_reduce(t, op=red, group=mesh.axis_names, mesh=mesh)
    return out.cpu().numpy()


_kv_seq = 0  # in-process call counter; see namespace derivation below
_KV_KEY_TTL = 600.0  # metric keys are transient; lease them so the KV
                     # store can't grow unboundedly with per-step metrics


def _kv_allreduce(value: np.ndarray, op: str,
                  timeout: float = 120.0) -> np.ndarray:
    """TCPStore-style gather→reduce→broadcast over the launch KV server.

    Namespace: ``metrics/{job}/{pod generation}/{call #}``. The generation
    comes from ``PADDLE_MASTER`` (the coordinator address) — unique per pod
    incarnation and identical across its ranks — and the call counter is
    in-process, so an elastic restart resets every rank to call 0 together.
    (A counter persisted in the KV would desynchronize ranks whenever a pod
    died between increments, deadlocking all later reductions.)
    """
    global _kv_seq
    from ..launch.kv_server import KVClient

    kv = KVClient(os.environ["PADDLE_KV_ENDPOINT"])
    world, rank = _world(), _rank()
    gen = os.environ.get("PADDLE_MASTER",
                         os.environ.get("PADDLE_METRIC_GEN"))
    if gen is None:
        gen = "0"
        if not _kv_seq:
            logging.warning(
                "fleet.metrics: neither PADDLE_MASTER nor PADDLE_METRIC_GEN "
                "is set — the KV namespace is not incarnation-scoped, so a "
                "restarted trainer within %ss may read the previous run's "
                "leased metric keys. Run under the launcher or set "
                "PADDLE_METRIC_GEN uniquely per run.", int(_KV_KEY_TTL))
    gen = gen.replace("/", "_").replace(":", "_")
    seq = _kv_seq
    _kv_seq += 1
    base = (f"metrics/{os.environ.get('PADDLE_JOB_ID', 'default')}"
            f"/{gen}/{seq}")
    kv.put(f"{base}/part/{rank}",
           json.dumps({"shape": list(value.shape),
                       "data": value.reshape(-1).tolist()}),
           ttl=_KV_KEY_TTL)
    if rank == 0:
        parts = []
        deadline = time.time() + timeout
        for r in range(world):
            raw = None
            while raw is None:
                raw = kv.get(f"{base}/part/{r}")
                if raw is None:
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"metric allreduce: rank {r} never reported")
                    time.sleep(0.05)
            obj = json.loads(raw)
            parts.append(np.asarray(obj["data"]).reshape(obj["shape"]))
        fn = {"sum": np.sum, "max": np.max, "min": np.min}[op]
        out = fn(np.stack(parts), axis=0)
        kv.put(f"{base}/result",
               json.dumps({"shape": list(out.shape),
                           "data": out.reshape(-1).tolist()}),
               ttl=_KV_KEY_TTL)
        return out.astype(value.dtype)
    raw = kv.wait(f"{base}/result", timeout=timeout)
    obj = json.loads(raw)
    return np.asarray(obj["data"]).reshape(obj["shape"]).astype(value.dtype)


def _allreduce(value, op: str) -> np.ndarray:
    value = np.asarray(value, np.float64)
    scalar = value.ndim == 0
    value = np.atleast_1d(value)
    if _world() > 1:
        if _torch_world_live():
            out = _device_allreduce(value, op)
        elif "PADDLE_KV_ENDPOINT" in os.environ:
            out = _kv_allreduce(value, op)
        else:
            raise RuntimeError(
                "distributed metric reduction needs a torch.distributed "
                "world or PADDLE_KV_ENDPOINT (run under the launcher)")
    else:
        out = value
    return out[0] if scalar else out


def sum(input, scope=None, util=None):  # noqa: A001 — reference name
    """Global sum over trainers (``fleet.metrics.metric.sum``)."""
    return _allreduce(input, "sum")


def max(input, scope=None, util=None):  # noqa: A001
    return _allreduce(input, "max")


def min(input, scope=None, util=None):  # noqa: A001
    return _allreduce(input, "min")


def auc(stat_pos, stat_neg, scope=None, util=None) -> float:
    """Global AUC from per-trainer histogram buckets — sums the bucket
    arrays across trainers, then runs the same trapezoid accumulation as
    :class:`paddle_tpu_torch.metric.Auc` (reference ``metric.py`` ``auc``)."""
    stat_pos = _allreduce(np.asarray(stat_pos, np.float64), "sum")
    stat_neg = _allreduce(np.asarray(stat_neg, np.float64), "sum")
    tot_pos = tot_neg = area = 0.0
    for i in range(len(stat_pos) - 1, -1, -1):
        prev_pos, prev_neg = tot_pos, tot_neg
        tot_pos += float(stat_pos[i])
        tot_neg += float(stat_neg[i])
        area += abs(prev_neg - tot_neg) * (prev_pos + tot_pos) / 2.0
    denom = tot_pos * tot_neg
    return float(area / denom) if denom else 0.0


def mae(abserr_sum, total_ins_num, scope=None, util=None) -> float:
    """Global mean absolute error from (local abs-error sum, local count)."""
    s = _allreduce(np.asarray(abserr_sum, np.float64), "sum")
    n = _allreduce(np.asarray(total_ins_num, np.float64), "sum")
    return float(np.sum(s) / np.sum(n)) if np.sum(n) else 0.0


def rmse(sqrerr_sum, total_ins_num, scope=None, util=None) -> float:
    s = _allreduce(np.asarray(sqrerr_sum, np.float64), "sum")
    n = _allreduce(np.asarray(total_ins_num, np.float64), "sum")
    return float(np.sqrt(np.sum(s) / np.sum(n))) if np.sum(n) else 0.0


def acc(correct, total, scope=None, util=None) -> float:
    c = _allreduce(np.asarray(correct, np.float64), "sum")
    t = _allreduce(np.asarray(total, np.float64), "sum")
    return float(np.sum(c) / np.sum(t)) if np.sum(t) else 0.0

"""The port's ``fleet.metrics`` (``paddle_tpu_torch.distributed.fleet.
metrics``) against the JAX package's, on the CPU.

Single trainer: identity reductions and the bucketed AUC, held equal to
the reference's (float64 arithmetic on both sides: exact). Two trainers:
over the launch KV store, a port trainer and a reference trainer reduce
together (the same key namespace, TTL and JSON), and over a live
``torch.distributed`` world of two gloo ranks the reduction runs through
the port's collectives. Each trainer is a fresh interpreter.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from paddle_tpu.distributed.fleet import metrics as JM
from paddle_tpu_torch.distributed.fleet import metrics as M
from paddle_tpu_torch.distributed.launch.kv_server import KVServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    if sys.argv[1] == "port":
        from paddle_tpu_torch.distributed.fleet import metrics
    else:
        from paddle_tpu.distributed.fleet import metrics
    if sys.argv[2] == "world":
        from paddle_tpu_torch.distributed import fleet
        fleet.init(device="cpu")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", os.environ.get("RANK")))
    local = np.array([1.0 + rank, 10.0 * (rank + 1)])
    total = metrics.sum(local)
    mx = metrics.max(np.float64(rank))
    mn = metrics.min(np.array([rank, -rank], np.float64))
    pos = np.zeros(8); neg = np.zeros(8)
    if rank == 0:
        pos[6] = 10; neg[2] = 3
    else:
        neg[1] = 10; pos[5] = 2
    a = metrics.auc(pos, neg)
    acc = metrics.acc(np.float64(3 + rank), np.float64(4))
    print(json.dumps({"sum": total.tolist(), "max": float(mx),
                      "min": mn.tolist(), "auc": a, "acc": acc}), flush=True)
    if sys.argv[2] == "world":
        # leave the world before exit: gloo's threads must not outlive it
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
""")


def _run(tmp_path, kinds, env_of, mode):
    script = tmp_path / "m.py"
    script.write_text(SCRIPT)
    procs = [subprocess.Popen([sys.executable, str(script), kind, mode],
                              env=env_of(r), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r, kind in enumerate(kinds)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def _expected():
    pos, neg = np.zeros(8), np.zeros(8)
    pos[6], neg[2], neg[1], pos[5] = 10, 3, 10, 2
    return {"sum": [3.0, 30.0], "max": 1.0, "min": [0.0, -1.0],
            "auc": JM.auc(pos, neg), "acc": 7 / 8}


def _check(outs):
    want = _expected()
    for o in outs:
        assert o == want, (o, want)


def test_single_trainer_identity():
    for mod in (M, JM):
        np.testing.assert_allclose(mod.sum(np.array([2.0, 3.0])), [2.0, 3.0])
        assert mod.max(np.float64(4.0)) == 4.0
        assert mod.acc(np.float64(3), np.float64(4)) == 0.75
        assert mod.mae(np.float64(2.0), np.float64(4)) == 0.5
        assert mod.rmse(np.float64(16.0), np.float64(4)) == 2.0
        assert mod.acc(np.float64(3), np.float64(0)) == 0.0


def test_auc_matches_reference_and_metric():
    from paddle_tpu_torch.metric import Auc

    rng = np.random.default_rng(0)
    for _ in range(5):
        pos = rng.integers(0, 50, 64).astype(np.float64)
        neg = rng.integers(0, 50, 64).astype(np.float64)
        assert M.auc(pos, neg) == JM.auc(pos, neg)
    auc = Auc(num_thresholds=255)
    preds = rng.random(500)
    labels = (rng.random(500) < preds).astype(np.int64)
    auc.update(preds, labels)
    assert M.auc(auc.stat_pos, auc.stat_neg) == pytest.approx(
        auc.accumulate(), rel=1e-12)
    assert M.auc(np.zeros(4), np.zeros(4)) == 0.0


def test_kv_allreduce_port_and_reference_trainers(tmp_path):
    """A port trainer and a reference trainer reduce through one KV store:
    both see the global sum, max, min, AUC and accuracy."""
    with KVServer(0, host="127.0.0.1") as server:
        ep = f"127.0.0.1:{server.port}"

        def env_of(rank):
            env = dict(os.environ)
            env.update({
                "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": "2",
                "PADDLE_KV_ENDPOINT": ep, "PADDLE_JOB_ID": "mtest",
                "PADDLE_METRIC_GEN": "g0", "JAX_PLATFORMS": "cpu",
                "PYTHONPATH": REPO})
            for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                      "PADDLE_MASTER"):
                env.pop(k, None)
            return env

        _check(_run(tmp_path, ["port", "reference"], env_of, "kv"))


def test_torch_world_allreduce(tmp_path):
    """Two gloo ranks of the port: fleet.init builds the mesh and the
    metrics reduce over the world through the port's collectives."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()

    def env_of(rank):
        env = dict(os.environ)
        env.update({"RANK": str(rank), "WORLD_SIZE": "2",
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "PYTHONPATH": REPO})
        for k in ("PADDLE_KV_ENDPOINT", "PADDLE_TRAINER_ID",
                  "PADDLE_TRAINERS_NUM", "PADDLE_MASTER"):
            env.pop(k, None)
        return env

    _check(_run(tmp_path, ["port", "port"], env_of, "world"))


def test_no_transport_raises(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.delenv("PADDLE_KV_ENDPOINT", raising=False)
    with pytest.raises(RuntimeError, match="PADDLE_KV_ENDPOINT"):
        M.sum(np.ones(2))

"""The port's launcher, elastic membership, elastic mesh and multi-process
checkpoints (``paddle_tpu_torch.distributed.{launch,elastic_mesh,
checkpoint}``) against the JAX package's, on the CPU.

- Twins of ``tests/test_launch.py``: the KV store, ``Pod`` supervision,
  the worker environment (``PADDLE_LOCAL_RANK`` included), a restart under
  ``--max_restarts``, a preemption restart, the failure exit code and the
  ``-m`` entry.
- The kill-a-node drill of ``tests/test_elastic.py:163`` over the port:
  two launchers in elastic mode (``--nnodes 1:2``) run
  ``tools/torch_launch_train.py --tiny`` (``gpt_tiny``, bf16 O2, ZeRO-2 at
  sdp = 2, the collective checks and a LocalSGD segment first); node B's
  process group is SIGKILLed once a checkpoint is published; node A must
  resize to world 1, restore the newest checkpoint resharded (bit-equal to
  the files) and finish. The KV store binds its port before anyone is
  told it (``KVServer(0)``) and the drill has its own deadline.
- Twins of ``tests/test_elastic_mesh.py:55-105, 246-280``: mesh planning,
  batch rescaling, the recorded mesh and ``reshaped_mesh`` from it.
- A checkpoint written by a world of two gloo ranks (``torch_world``)
  restored at one process and back at two through ``load_state
  (shardings=)``, bit-equal, and read by the reference's ``load_state``;
  one written by the reference's ``DistributedTrainStep`` on two of its
  virtual devices restored by the port at one process and at two,
  bit-equal; ``validate_checkpoint`` naming a missing
  rank; ``prefetch_to_device(mesh=, spec=)`` landing each rank's slice.
"""
import functools
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed import elastic_mesh as jem
from paddle_tpu.distributed.mesh import init_mesh as jinit_mesh
from paddle_tpu.distributed.mesh import set_mesh as jset_mesh
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.elastic_mesh import (plan_mesh_shape,
                                                       rescale_batch,
                                                       reshaped_mesh)
from paddle_tpu_torch.distributed.launch import (Container, KVClient,
                                                 KVServer, Pod, launch)
from paddle_tpu_torch.distributed.mesh import set_mesh

import torch_dist_tasks as tasks
from torch_world import World
from torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DROP = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
               use_flash_attention=False)


@pytest.fixture(autouse=True)
def _no_port_mesh():
    yield
    set_mesh(None)
    jset_mesh(None)


# ------------------------------------------------------------ launcher
def test_kv_put_get_wait_barrier():
    with KVServer(0, host="127.0.0.1") as server:
        kv = KVClient(f"127.0.0.1:{server.port}")
        assert kv.get("missing") is None
        kv.put("a/b", "hello")
        assert kv.get("a/b") == "hello"
        assert kv.wait("a/b", timeout=1) == "hello"
        with pytest.raises(TimeoutError):
            kv.wait("never", timeout=0.5)
        kv.barrier("sync", rank=0, world=1, timeout=2)


def test_pod_success_and_failure(tmp_path):
    pod = Pod()
    pod.add(Container([sys.executable, "-c", "print('w0')"], {},
                      str(tmp_path / "w0.log")))
    pod.add(Container([sys.executable, "-c", "print('w1')"], {},
                      str(tmp_path / "w1.log")))
    pod.deploy()
    assert pod.join() == 0
    assert "w0" in (tmp_path / "w0.log").read_text()
    bad = Pod()
    bad.add(Container([sys.executable, "-c", "import sys; sys.exit(3)"], {}))
    bad.add(Container([sys.executable, "-c", "import time; time.sleep(60)"],
                      {}))
    bad.deploy()
    assert bad.join() == 3   # failure propagates, peer terminated
    assert all(not c.alive for c in bad.containers)


def test_launch_sets_worker_env(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent("""
        import os, sys
        import paddle_tpu_torch
        e = os.environ
        keys = ("PADDLE_TRAINER_ID", "RANK", "PADDLE_TRAINERS_NUM",
                "WORLD_SIZE", "PADDLE_LOCAL_RANK", "CUDA_VISIBLE_DEVICES",
                "PADDLE_MASTER", "PADDLE_JOB_ID")
        got = {k: e[k] for k in keys}
        got["PKG"] = os.path.dirname(os.path.dirname(
            paddle_tpu_torch.__file__))
        got["JAX"] = "jax" in sys.modules
        import json
        print("ENV " + json.dumps(got), flush=True)
    """))
    log_dir = str(tmp_path / "logs")
    rc = launch(["--nproc_per_node", "2", "--devices_per_proc", "2",
                 "--job_id", "envjob", "--log_dir", log_dir, str(script)])
    assert rc == 0
    assert sorted(os.listdir(log_dir)) == ["worker.0.log", "worker.1.log"]
    for r, cards in ((0, "0,1"), (1, "2,3")):
        text = open(os.path.join(log_dir, f"worker.{r}.log")).read()
        got = json.loads(text.split("ENV ", 1)[1].splitlines()[0])
        assert got["PADDLE_TRAINER_ID"] == got["RANK"] == str(r)
        assert got["PADDLE_TRAINERS_NUM"] == got["WORLD_SIZE"] == "2"
        assert got["PADDLE_LOCAL_RANK"] == str(r)
        assert got["CUDA_VISIBLE_DEVICES"] == cards
        assert got["PADDLE_MASTER"].startswith("127.0.0.1:")
        assert got["PADDLE_JOB_ID"] == "envjob" and got["PKG"] == REPO
        assert got["JAX"] is False


def test_launch_restarts_under_max_restarts(tmp_path):
    """The worker fails on its first attempt and succeeds on the restart
    (state via a sentinel file); a preemption exit restarts without
    charging ``--max_restarts``."""
    sentinel = tmp_path / "tried"
    script = tmp_path / "flaky.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        s = {str(sentinel)!r}
        n = int(open(s).read()) if os.path.exists(s) else 0
        open(s, "w").write(str(n + 1))
        if n == 0:
            sys.exit(7)          # a failure: charged
        if n == 1:
            sys.exit(44)         # EXIT_PREEMPTED: free
        print("recovered", n, flush=True)
    """))
    log_dir = str(tmp_path / "logs")
    rc = launch(["--max_restarts", "1", "--log_dir", log_dir, str(script)])
    assert rc == 0
    assert "recovered 2" in open(os.path.join(log_dir, "worker.0.log")).read()


def test_launch_failure_exit_code(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text("import sys; sys.exit(9)")
    assert launch([str(script)]) == 9


def test_cli_module_entry(tmp_path):
    script = tmp_path / "ok.py"
    script.write_text("print('cli ok')")
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         str(script)], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "cli ok" in out.stdout


# ------------------------------------------------------------ elastic mesh
@pytest.mark.parametrize("saved,n", [
    ({"dp": 8}, 4), ({"dp": 4, "mp": 2}, 4), ({"dp": 2, "mp": 2}, 8),
    ({"dp": 4}, 16), ({"dp": 4}, 6), ({"dp": 4, "mp": 2}, 6),
    ({"dp": 2, "sdp": 2, "mp": 2}, 4), ({"dp": 2, "sdp": 4, "mp": 1}, 4),
    ({"dp": 2, "mp": 4}, 8), ({"mp": 4}, 8), ({"sdp": 2}, 1)])
def test_plan_mesh_shape_matches_the_reference(saved, n):
    assert plan_mesh_shape(saved, n) == jem.plan_mesh_shape(saved, n)


def test_plan_refusals_and_batch_rescaling():
    with pytest.raises(ValueError, match="frozen axes"):
        plan_mesh_shape({"dp": 4, "mp": 4}, 2)
    with pytest.raises(ValueError):
        plan_mesh_shape({"dp": 4}, 0)
    for g, axes in ((32, {"dp": 4, "mp": 2}), (32, {"dp": 2, "mp": 2}),
                    (32, {"mp": 2}), (8, {"sdp": 1})):
        assert rescale_batch(g, axes) == jem.rescale_batch(g, axes)
    with pytest.raises(ValueError, match="does not divide"):
        rescale_batch(10, {"dp": 4})


def test_reshaped_mesh_from_the_recorded_topology(tmp_path, monkeypatch):
    from paddle_tpu_torch.distributed.mesh import init_mesh

    mesh8 = init_mesh({"dp": 4, "mp": 2}, devices=range(8))
    root = tmp_path / "auto"
    d = root / "step_10"
    ckpt.save_state({"w": np.ones(4, np.float32)}, str(d), mesh=mesh8)
    info = ckpt.mesh_info(str(d))
    assert info == {"axes": {"dp": 4, "mp": 2}, "devices": 8,
                    "process_count": 1}
    # surviving capacity: 4 ranks -> dp shrinks, mp frozen; then regrow
    assert dict(reshaped_mesh(str(d), devices=4).shape) == {"dp": 2, "mp": 2}
    assert dict(reshaped_mesh(str(root), devices=8).shape) == {"dp": 4,
                                                              "mp": 2}
    # a checkpoint without the record: the caller's axes
    meta = json.load(open(d / "metadata.json"))
    meta.pop("mesh")
    json.dump(meta, open(d / "metadata.json", "w"))
    assert ckpt.mesh_info(str(d)) is None
    mesh = reshaped_mesh(str(d), default_axes={"dp": -1, "mp": 2},
                         devices=8)
    assert dict(mesh.shape) == {"dp": 4, "mp": 2}
    monkeypatch.setenv("PADDLE_ELASTIC", "1")
    from paddle_tpu_torch.distributed import elastic_mesh

    assert elastic_mesh.is_elastic()


# ------------------------------------------------------------ checkpoints
@pytest.fixture(scope="module")
def world():
    w = World(2, timeout=150)
    yield w
    w.close()


@functools.lru_cache(maxsize=1)
def _gpt_state():
    pt.seed(11)
    cfg = {**NO_DROP, "loss_chunk": 16, "num_layers": 1}
    jm = JGPT(jgpt_tiny(**cfg))
    return cfg, {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _gpt_job(mesh, step=None):
    cfg, state = _gpt_state()
    rng = np.random.default_rng(3)
    batches = [(ids, ids) for ids in (rng.integers(0, 1024, (4, 32))
                                      for _ in range(5))]
    return dict(kind="gpt", cfg=cfg, state=state, mesh=mesh,
                opt=("AdamW", {"learning_rate": 1e-3}), batches=batches,
                step=step or {})


def _gathered(flat, like):
    """``load_state``'s flat result as ``like``'s tree (``ckpt_save``'s
    gathered state): count, params and each optimizer slot."""
    return {"count": int(flat["count"]),
            "params": {k: np.asarray(flat[f"params/{k}"])
                       for k in like["params"]},
            "opt_state": {slot: {k: np.asarray(flat[f"opt_state/{slot}/{k}"])
                                 for k in vals}
                          for slot, vals in like["opt_state"].items()}}


def _bit_equal(a, b, what):
    assert a["count"] == b["count"]
    for part in ("params", "opt_state"):
        flat_a = json.dumps(sorted(a[part]))
        assert flat_a == json.dumps(sorted(b[part])), what
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v, err_msg=f"{what} {k}")
    for slot, vals in a["opt_state"].items():
        for k, v in vals.items():
            np.testing.assert_array_equal(b["opt_state"][slot][k], v,
                                          err_msg=f"{what} {slot}/{k}")


@pytest.mark.parametrize("mesh2,mesh1,step", [
    ({"mp": 2}, {"mp": 1}, {}),
    ({"sdp": 2}, {"sdp": 1}, {"sharding_stage": 2})],
    ids=["mp2_fused_qkv", "sdp2_zero2"])
def test_checkpoint_two_processes_to_one_and_back(world, tmp_path, mesh2,
                                                  mesh1, step):
    d2, d1 = str(tmp_path / "from2"), str(tmp_path / "from1")
    saved = world.run("ckpt_save", _gpt_job(mesh2, step), d2, 2)[0]
    meta = json.load(open(os.path.join(d2, "metadata.json")))
    assert meta["process_count"] == 2
    assert ckpt.mesh_info(d2)["axes"] == mesh2
    assert os.path.exists(os.path.join(d2, "metadata.1.json"))
    assert ckpt.validate_checkpoint(d2) is None
    # restored in this process (a world of one), saved again from it
    one = tasks.ckpt_load(_gpt_job(mesh1, step), d2, 2, save_to=d1)
    _bit_equal(saved, one, "2 -> 1")
    # the reference reads both: the two processes' files and the one's
    for d in (d2, d1):
        _bit_equal(one, _gathered(jckpt.load_state(d), one), f"jax {d}")
    assert max(one["local"].values(), key=len)  # whole leaves at world 1
    assert one["local"]["params/gpt.h.0.attn.qkv_proj.weight"] == (128, 384)
    assert one["stats"]["bytes_read"] > 0
    # ...and back at world 2
    two = world.run("ckpt_load", _gpt_job(mesh2, step), d1, 2)
    _bit_equal(saved, two[0], "1 -> 2")
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=1e-4,
                               atol=1e-5)
    if "mp" in mesh2:   # each rank read its heads of the fused q, k, v
        assert two[0]["local"]["params/gpt.h.0.attn.qkv_proj.weight"] == (
            128, 192)


@pytest.mark.parametrize("mesh2,mesh1,step", [
    ({"mp": 2}, {"mp": 1}, {}),
    ({"sdp": 2}, {"sdp": 1}, {"sharding_stage": 2})],
    ids=["mp2_fused_qkv", "sdp2_zero2"])
def test_reference_checkpoint_restores_resharded(world, tmp_path, mesh2,
                                                 mesh1, step):
    """The reference's DistributedTrainStep on two of its virtual devices
    saves after two steps (a shard file per device for every split
    leaf); the port restores it through ``load_state(shardings=)`` in a
    world of one and of two, bit-equal, and trains on to the reference's
    next losses."""
    cfg, state = _gpt_state()
    job = _gpt_job(mesh2, step)
    jm = JGPT(jgpt_tiny(**cfg))
    jm.set_state_dict(state)
    ref = jdist.DistributedTrainStep(
        jm.train(), jopt.AdamW(learning_rate=1e-3),
        mesh=jinit_mesh(dict(mesh2)), **step)
    for b in job["batches"][:2]:
        ref(b)
    d = str(tmp_path / "jax")
    sd = ref.state_dict()
    jckpt.save_state(sd, d)
    want = {"count": 2,
            "params": {k: np.asarray(v) for k, v in sd["params"].items()},
            "opt_state": {slot: {k: np.asarray(v) for k, v in val.items()}
                          for slot, val in sd["opt_state"].items()
                          if isinstance(val, dict)}}
    ref_losses = [float(ref(b)) for b in job["batches"][2:4]]
    jset_mesh(None)
    split = [rec for rec in json.load(open(os.path.join(
        d, "metadata.json")))["leaves"].values() if len(rec.get("shards",
                                                                 ())) > 1]
    assert split     # the reference wrote several shards of some leaves
    one = tasks.ckpt_load(_gpt_job(mesh1, step), d, 2)
    two = world.run("ckpt_load", job, d, 2)[0]
    for got, what in ((one, "jax -> 1"), (two, "jax -> 2")):
        _bit_equal(want, got, what)
        np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-4,
                                   atol=1e-5, err_msg=what)


def test_validate_checkpoint_names_a_missing_rank(world, tmp_path):
    root = tmp_path / "root"
    good, torn = root / "step_2", root / "step_4"
    world.run("ckpt_save", _gpt_job({"sdp": 2}, {"sharding_stage": 2}),
              str(good), 1)
    shutil.copytree(good, torn)
    os.remove(torn / "metadata.1.json")
    problem = ckpt.validate_checkpoint(str(torn))
    assert "rank(s) [1]" in problem and "metadata.1.json" in problem
    assert ckpt.latest_checkpoint(str(root)) == str(good)
    # a lost shard file of rank 1's is attributed to rank 1
    shutil.rmtree(torn)
    shutil.copytree(good, torn)
    meta = json.load(open(torn / "metadata.1.json"))
    lost = next(s["file"] for rec in meta["leaves"].values()
                for s in rec.get("shards", []))
    os.remove(torn / lost)
    assert "from rank(s) [1]" in ckpt.validate_checkpoint(str(torn))
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_state(str(torn))


def test_prefetch_lands_each_ranks_slice(world):
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(4, 3)).astype(np.float32),
                rng.integers(0, 9, (4,)))
               for _ in range(3)]
    res = world.run("prefetch_sharded", batches, (("dp",),))
    for r, got in enumerate(res):
        assert len(got) == 3
        for (x, y), (gx, gy) in zip(batches, got):
            np.testing.assert_array_equal(gx, x[2 * r:2 * r + 2])
            np.testing.assert_array_equal(gy, y[2 * r:2 * r + 2])


# ------------------------------------------------------------ the drill
def _reports(out_dir):
    rows = []
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            rows += [json.loads(line) for line in f]
    return rows


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_launch_train", os.path.join(REPO, "tools",
                                           "torch_launch_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DRILL = dict(steps=8, save_every=2, kill_after=4, batch=4, seq=32)
# the drill's losses against the single-process yardstick on the same
# global batches: bf16 O2, where ZeRO-2's split reductions round
# differently (read up to 2.9e-4 on the CPU); two global batches' losses
# part by about 1e-2, so a rank on the wrong slice of the batch fails
DRILL_LOSS_RTOL = 1e-3


def _drill_yardstick():
    """The drill's job in one process: ``gpt_tiny`` under bf16 O2 with
    AdamW, a single-process ``TrainStep`` on every global batch."""
    from paddle_tpu_torch.framework.jit import TrainStep

    tool = _tool()
    import chip_smoke   # on the path the tool put it on

    cfg = tool.config(True, 0, DRILL["seq"])
    model, opt = chip_smoke._primary_net(cfg, 0, device="cpu")
    step = TrainStep(model, opt, loss_fn=None)
    return [float(step((b, b))) for b in tool.global_batches(
        cfg, 0, DRILL["batch"], DRILL["seq"], DRILL["steps"])]


def test_elastic_kill_node_resumes_smaller_world(tmp_path):
    """Two elastic launchers train the tiny job at world 2; node B (its
    launcher and worker) is SIGKILLed after a checkpoint is published;
    node A resizes to world 1, restores it resharded and finishes. The
    losses of both worlds follow the single-process yardstick."""
    out, root = tmp_path / "out", tmp_path / "ckpt"
    logs_a, logs_b = tmp_path / "logs_a", tmp_path / "logs_b"
    tool = os.path.join(REPO, "tools", "torch_launch_train.py")
    deadline = time.monotonic() + 150
    with KVServer(0, host="127.0.0.1") as server:
        ep = f"127.0.0.1:{server.port}"
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME",
                                                     "lo"))
        common = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                  "--nnodes", "1:2", "--master", ep, "--job_id", "drill",
                  "--elastic_ttl", "2.0"]
        args = [tool, "--tiny", "--device", "cpu", "--out", str(out),
                "--ckpt", str(root), "--steps", str(DRILL["steps"]),
                "--save-every", str(DRILL["save_every"]), "--batch",
                str(DRILL["batch"]), "--seq", str(DRILL["seq"]),
                "--pace", "0.25"]
        pa = subprocess.Popen(common + ["--node_rank", "1", "--log_dir",
                                        str(logs_a)] + args, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True)
        pb = subprocess.Popen(common + ["--node_rank", "2", "--log_dir",
                                        str(logs_b)] + args, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True)
        kill_at = root / f"step_{DRILL['kill_after']}"
        try:
            # the yardstick trains while the two nodes boot
            want = _drill_yardstick()
            while not kill_at.exists():
                if time.monotonic() > deadline or pa.poll() is not None \
                        or pb.poll() is not None:
                    raise AssertionError(f"the two-node world never "
                                         f"published {kill_at.name}")
                time.sleep(0.05)
            killed_after = max(r["step"] for r in _reports(out)
                               if r["event"] == "step")
            # node B's launcher and worker: lost with no goodbye
            os.killpg(pb.pid, signal.SIGKILL)
            out_a, _ = pa.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in (pa, pb):
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
            pb.stdout.close()
    assert pa.returncode == 0, out_a[-3000:]
    assert "membership changed; resizing" in out_a
    rows = _reports(out)
    two = [r for r in rows if r["world"] == 2]
    one = [r for r in rows if r["world"] == 1]
    for rank in (0, 1):
        mine = {r["event"] for r in two if r["rank"] == rank}
        assert {"boot", "collectives", "localsgd", "built"} <= mine
    checks = next(r for r in two if r["event"] == "collectives")["checks"]
    assert "recv_without_buffer" in checks or "recv_into_buffer" in checks
    sgd = next(r for r in two if r["event"] == "localsgd")["rows"]
    assert [r["equal"] for r in sgd] == [False, True, False, True]
    replay = next(r for r in two if r["event"] == "localsgd_reference")
    assert replay["loss_max_rel_err"] <= DRILL_LOSS_RTOL
    saves = {r["step"] for r in two if r["event"] == "save"}
    assert DRILL["kill_after"] in saves
    restore = next(r for r in one if r["event"] == "restore")
    assert restore["bit_equal"] and restore["shard_files_checked"] > 0
    assert restore["written_on"]["axes"] == {"sdp": 2}
    assert restore["mesh"] == {"sdp": 1}
    assert restore["step"] in saves
    assert restore["step"] >= DRILL["kill_after"]
    # resumed, not restarted: the world-1 steps start at the checkpoint
    steps_one = [r["step"] for r in one if r["event"] == "step"]
    assert steps_one == list(range(restore["step"], DRILL["steps"]))
    assert killed_after >= DRILL["kill_after"] - 1
    built = next(r for r in one if r["event"] == "built")
    assert built["mesh"] == {"sdp": 1} and built["per_replica_batch"] == 4
    assert any(r["event"] == "done" for r in one)
    # the losses of both worlds continue one trajectory: every step's,
    # on every rank and at both worlds, within DRILL_LOSS_RTOL of the
    # yardstick's on the same global batch
    steps = [r for r in rows if r["event"] == "step"]
    assert {r["step"] for r in steps} == set(range(DRILL["steps"]))
    for r in steps:
        err = abs(r["loss"] - want[r["step"]]) / abs(want[r["step"]])
        assert err <= DRILL_LOSS_RTOL, (r, want[r["step"]])


def test_supervisor_restores_onto_the_reshaped_mesh(world, tmp_path, capsys):
    """A supervised world-2 checkpoint (ZeRO-2 at sdp = 2) restored by a
    world of one whose mesh comes from ``reshaped_mesh``: the supervisor
    reports the reshard, as the reference's does, and the parameters
    come back bit-equal."""
    from paddle_tpu_torch.framework.supervisor import (RecoveryPolicy,
                                                       TrainingSupervisor)

    root = str(tmp_path / "sup")
    job = _gpt_job({"sdp": 2}, {"sharding_stage": 2})
    saved = world.run("supervised_save", job, root, 2)[0]
    assert ckpt.mesh_info(ckpt.latest_checkpoint(root))["axes"] == {"sdp": 2}
    mesh = reshaped_mesh(root, default_axes={"sdp": -1})
    assert dict(mesh.shape) == {"sdp": 1}
    step = tasks._make_step(dict(job, mesh={"sdp": 1}))
    capsys.readouterr()
    TrainingSupervisor(step, RecoveryPolicy(checkpoint_dir=root)).restore()
    out = capsys.readouterr().out
    assert "elastic reshard: checkpoint written on mesh {'sdp': 2}" in out
    assert "restoring onto {'sdp': 1}" in out
    got = tasks._np(step.state_dict()["params"])
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

"""The port's crash-safe checkpoints (``paddle_tpu_torch.distributed.
checkpoint``, ``framework.io``) against the JAX package's, on the CPU.

The parity tests give one state tree to both packages (numpy to the
reference, tensors to the port): the shard files must be byte-equal and
``metadata.json`` equal, bfloat16, int32, float32, scalar and string
leaves included, and each package must load what the other wrote. The
rest are twins of ``tests/test_checkpoint.py`` and
``tests/test_checkpoint_faults.py`` on the port alone: values are compared
exactly (a checkpoint stores bits).
"""
import glob
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.framework import io as jio
from paddle_tpu_torch.distributed.checkpoint import (
    AutoCheckpoint, CheckpointCorruptError, last_load_stats,
    latest_checkpoint, load_state, mesh_info, save_state,
    validate_checkpoint)
from paddle_tpu_torch.distributed.resilience import CRASH_EXIT, FaultPlan
from paddle_tpu_torch.framework import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bf16_tensor(a32):
    """``a32`` rounded to bfloat16 the way ml_dtypes rounds it, as a
    tensor, and the ml_dtypes array."""
    a = np.asarray(a32).astype(ml_dtypes.bfloat16)
    return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16), a


def _trees():
    """One state tree as the reference takes it (numpy) and as the port
    does (tensors), with every leaf kind a training state holds."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = rng.integers(-9, 9, (7,)).astype(np.int32)
    i64 = rng.integers(0, 9, (2, 2)).astype(np.int64)
    b_t, b_np = _bf16_tensor(rng.standard_normal((4, 3)).astype(np.float32))
    s_t, s_np = _bf16_tensor(np.array(1.5, np.float32))
    ref = {"params": {"fc.weight": b_np, "fc.bias": f32},
           "opt_state": {"step": np.asarray(3, np.int32),
                         "moments": [f32 * 2, {"ids": i64}]},
           "count": 5, "lr": 0.25, "name": "gpt", "done": False,
           "base_seed": 2 ** 62 + 11, "none": None, "scale": s_np,
           "i32": i32}
    port = {"params": {"fc.weight": b_t, "fc.bias": torch.from_numpy(f32)},
            "opt_state": {"step": torch.tensor(3, dtype=torch.int32),
                          "moments": [torch.from_numpy(f32 * 2),
                                      {"ids": torch.from_numpy(i64)}]},
            "count": 5, "lr": 0.25, "name": "gpt", "done": False,
            "base_seed": 2 ** 62 + 11, "none": None, "scale": s_t,
            "i32": torch.from_numpy(i32)}
    return ref, port


def _files(d):
    return sorted(os.listdir(d))


def _as_np(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    if isinstance(v, np.ndarray) and v.dtype == ml_dtypes.bfloat16:
        return v.view(np.uint16)
    return v


# --------------------------------------------------- parity with the JAX package
def test_shard_files_and_metadata_equal_the_reference(tmp_path):
    ref, port = _trees()
    jckpt.save_state(ref, str(tmp_path / "ref"))
    save_state(port, str(tmp_path / "port"))
    names = _files(tmp_path / "ref")
    assert names == _files(tmp_path / "port")
    assert len([n for n in names if n.endswith(".npy")]) == 7
    for name in names:
        a = (tmp_path / "ref" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert a == b, name
    meta = json.loads((tmp_path / "port" / "metadata.json").read_text())
    assert meta["leaves"]["params/fc.weight"]["dtype"] == "bfloat16"
    # the reference records int64 leaves as jnp.asarray gives them (int32)
    assert meta["leaves"]["opt_state/moments/1/ids"]["dtype"] == "int32"
    header = (tmp_path / "port" /
              meta["leaves"]["scale"]["shards"][0]["file"]).read_bytes()[:60]
    assert b"'descr': '<V2'" in header


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_between_packages(tmp_path, writer):
    ref, port = _trees()
    d = str(tmp_path / "ckpt")
    if writer == "reference":
        jckpt.save_state(ref, d)
        got = load_state(d)
        assert got["params/fc.weight"].dtype == torch.bfloat16
        assert got["opt_state/step"].dtype == torch.int32
        want = jckpt.load_state(d)
    else:
        save_state(port, d)
        got = jckpt.load_state(d)
        assert got["params/fc.weight"].dtype == ml_dtypes.bfloat16
        want = load_state(d)
    assert set(got) == set(want)
    for k in want:
        a, b = _as_np(got[k]), _as_np(want[k])
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b and type(a) is type(b), k
    assert got["base_seed"] == 2 ** 62 + 11 and got["name"] == "gpt"


def test_framework_io_roundtrip_and_reference_pickle(tmp_path):
    ref, port = _trees()
    del ref["none"], port["none"]
    tio.save(port, str(tmp_path / "p.pdparams"))
    back = tio.load(str(tmp_path / "p.pdparams"))
    assert back["params"]["fc.weight"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["fc.weight"].view(torch.int16),
                       port["params"]["fc.weight"].view(torch.int16))
    assert torch.equal(back["opt_state"]["moments"][1]["ids"],
                       port["opt_state"]["moments"][1]["ids"])
    # return_numpy: bfloat16 leaves as float32 of the same values
    host = tio.load(str(tmp_path / "p.pdparams"), return_numpy=True)
    np.testing.assert_array_equal(
        host["params"]["fc.weight"],
        port["params"]["fc.weight"].float().numpy())
    assert host["count"] == 5 and host["name"] == "gpt"
    # the reference's pickle (an ml_dtypes array) loads in the port
    jio.save(ref, str(tmp_path / "r.pdparams"))
    rb = tio.load(str(tmp_path / "r.pdparams"))
    assert rb["params"]["fc.weight"].dtype == torch.bfloat16
    assert torch.equal(rb["params"]["fc.weight"].view(torch.int16),
                       port["params"]["fc.weight"].view(torch.int16))
    np.testing.assert_array_equal(rb["i32"].numpy(), ref["i32"])
    # the port's record is plain numpy: the reference unpickles it
    rec = jio.load(str(tmp_path / "p.pdparams"), return_numpy=True)
    assert rec["params"]["fc.weight"]["__dtype__"] == "bfloat16"
    np.testing.assert_array_equal(rec["params"]["fc.weight"]["bits"],
                                  ref["params"]["fc.weight"].view(np.uint16))


# ------------------------------------------------ twins of test_checkpoint.py
def test_save_load_roundtrip_plain(tmp_path):
    state = {"w": torch.arange(24, dtype=torch.float32).reshape(4, 6),
             "nested": {"b": torch.ones(3), "step": 7},
             "scalar": torch.tensor(2.5)}
    d = str(tmp_path / "ckpt")
    save_state(state, d)
    out = load_state(d)
    assert torch.equal(out["w"], state["w"])
    assert torch.equal(out["nested/b"], state["nested"]["b"])
    assert out["nested/step"] == 7
    assert float(out["scalar"]) == 2.5
    tree = load_state(d, template=state)
    assert set(tree.keys()) == {"w", "nested", "scalar"}
    assert torch.equal(tree["nested"]["b"], state["nested"]["b"])
    assert last_load_stats()["leaves"] == 3
    assert mesh_info(d) is None


def test_save_load_bfloat16(tmp_path):
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    state = {"w": w.to(torch.bfloat16)}
    save_state(state, str(tmp_path / "bf16"))
    out = load_state(str(tmp_path / "bf16"))
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16),
                       state["w"].view(torch.int16))


def test_sharded_load_and_multiprocess_save_wait_for_a8(tmp_path):
    """The sharded load and the multi-process save have landed (their
    worlds of two are in ``tests/test_torch_launch.py``): in one process
    a sharded leaf on a mesh of one comes back whole, and the save
    records the mesh it was written on."""
    from paddle_tpu_torch.distributed.checkpoint import Sharding, mesh_info
    from paddle_tpu_torch.distributed.mesh import P, init_mesh, set_mesh

    mesh = init_mesh(sdp=1)
    try:
        w = torch.arange(6.0).reshape(2, 3)
        sh = {"w": Sharding(mesh, P("sdp", None))}
        save_state({"w": w}, str(tmp_path / "c"), shardings=sh)
        assert mesh_info(str(tmp_path / "c")) == {
            "axes": {"sdp": 1}, "devices": 1, "process_count": 1}
        got = load_state(str(tmp_path / "c"), shardings=sh)
        assert torch.equal(got["w"], w)
    finally:
        set_mesh(None)


def test_async_save(tmp_path):
    d = str(tmp_path / "async")
    w = torch.randn(32, 32)
    before = w.clone()
    pending = save_state({"w": w}, d, async_=True)
    w.add_(1.0)  # a later in-place update must not reach the snapshot
    assert pending.wait(30)
    assert torch.equal(load_state(d)["w"], before)


def test_auto_checkpoint_resume(tmp_path):
    root = str(tmp_path / "auto")
    ac = AutoCheckpoint(root, save_interval_steps=5, keep_max=2,
                        async_save=True)
    state = {"w": torch.zeros(4), "step": 0}
    for step in range(1, 21):
        state = {"w": state["w"] + 1, "step": step}
        ac.maybe_save(step, state)
    ac.wait()
    kept = sorted(n for n in os.listdir(root) if n.startswith("step_"))
    assert kept == ["step_15", "step_20"]
    step, restored = ac.restore()
    assert step == 20
    assert torch.equal(restored["w"], torch.full((4,), 20.0))
    assert restored["step"] == 20
    step2, restored2 = AutoCheckpoint(root, save_interval_steps=5).restore()
    assert step2 == 20 and restored2["step"] == 20


def test_colliding_sanitized_keys(tmp_path):
    w1, w2 = torch.full((2, 2), 1.0), torch.full((2, 2), 2.0)
    d = str(tmp_path / "coll")
    save_state({"a": {"b": w1}, "a_b": w2}, d)
    out = load_state(d)
    assert torch.equal(out["a/b"], w1) and torch.equal(out["a_b"], w2)


def test_async_save_error_propagates(tmp_path):
    target = tmp_path / "not_a_dir"
    target.write_text("file in the way")
    with pytest.raises((RuntimeError, NotADirectoryError, FileExistsError)):
        pending = save_state({"w": torch.ones(2)}, str(target / "sub"),
                             async_=True)
        if pending is not None:
            pending.wait(30)


def test_auto_checkpoint_empty(tmp_path):
    assert AutoCheckpoint(str(tmp_path / "none")).restore() == (0, None)
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_trainstep_checkpoint_roundtrip(tmp_path):
    """A whole TrainStep state (params, AdamW's moments and step, the
    count and base seed) through save_state/load_state: the restored step
    continues bit-identically."""
    from paddle_tpu_torch.framework import random as trandom
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.nn.layers.common import Linear
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam

    def make():
        trandom.seed(0)
        return TrainStep(Linear(8, 4, device="cpu"), Adam(learning_rate=0.01),
                         loss_fn=lambda out, b: F.cross_entropy(out, b[1]))

    step = make()
    x = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).integers(0, 4, (16, 1))
    for _ in range(3):
        step((x, y))
    save_state(step.state_dict(), str(tmp_path / "ts"))
    step2 = make()
    step2.set_state_dict(load_state(str(tmp_path / "ts"),
                                    template=step2.state_dict()))
    assert float(step((x, y))) == float(step2((x, y)))
    for k, v in step.params.items():
        assert torch.equal(v, step2.params[k]), k


# ----------------------------------------- twins of test_checkpoint_faults.py
def _state(step):
    return {"w": torch.full((8, 4), float(step)),
            "b": torch.arange(6, dtype=torch.float32) + step, "step": step}


def _two_checkpoints(root):
    for step in (1, 2):
        save_state(_state(step), os.path.join(root, f"step_{step}"))
    assert latest_checkpoint(root).endswith("step_2")


def _shard_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npy"))


def _flip_tail(path, n, mask=0xFF):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - n)
        chunk = f.read(n)
        f.seek(size - n)
        f.write(bytes(b ^ mask for b in chunk))
    assert os.path.getsize(path) == size


def test_truncated_shard_detected_and_skipped(tmp_path):
    root = str(tmp_path)
    _two_checkpoints(root)
    d2 = os.path.join(root, "step_2")
    victim = os.path.join(d2, _shard_files(d2)[0])
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(CheckpointCorruptError, match="bytes"):
        load_state(d2)
    assert "bytes" in validate_checkpoint(d2)
    assert latest_checkpoint(root).endswith("step_1")
    assert torch.equal(load_state(latest_checkpoint(root))["w"],
                       torch.full((8, 4), 1.0))


def test_flipped_bytes_detected_and_skipped(tmp_path):
    root = str(tmp_path)
    _two_checkpoints(root)
    d2 = os.path.join(root, "step_2")
    _flip_tail(os.path.join(d2, _shard_files(d2)[-1]), 3)
    with pytest.raises(CheckpointCorruptError, match="crc32"):
        load_state(d2)
    assert latest_checkpoint(root).endswith("step_1")
    load_state(d2, verify=False)


def test_proactive_verify_rejects_corrupt_shard_up_front(tmp_path):
    root = str(tmp_path)
    _two_checkpoints(root)
    d2 = os.path.join(root, "step_2")
    victim = os.path.join(d2, _shard_files(d2)[0])
    _flip_tail(victim, 2, mask=0x01)
    with pytest.raises(CheckpointCorruptError,
                       match=os.path.basename(victim)):
        load_state(d2, verify="proactive")
    d1 = os.path.join(root, "step_1")
    lazy, proactive = load_state(d1), load_state(d1, verify="proactive")
    assert torch.equal(lazy["w"], proactive["w"])
    assert torch.equal(lazy["b"], proactive["b"])


def test_supervisor_restore_falls_back_past_corrupt_shard(tmp_path):
    from paddle_tpu_torch.framework.supervisor import (RecoveryPolicy,
                                                       TrainingSupervisor)

    class Step:
        _count = 0

        def state_dict(self):
            return {"w": torch.full((4,), float(self._count)),
                    "count": torch.tensor(self._count)}

        def set_state_dict(self, state):
            self._count = int(state["count"])

    root = str(tmp_path / "ckpt")
    step = Step()
    sup = TrainingSupervisor(step, RecoveryPolicy(
        checkpoint_dir=root, save_interval_steps=1, keep_max=4,
        async_save=False, preemption=False))
    sup.save_now()
    step._count = 1
    sup.save_now()
    d1 = os.path.join(root, "step_1")
    _flip_tail(os.path.join(d1, _shard_files(d1)[0]), 1, mask=0x01)
    step._count = 99
    sup.restore()
    assert step._count == 0


@pytest.mark.parametrize("damage", ["metadata", "shard"])
def test_missing_file_detected_and_skipped(tmp_path, damage):
    root = str(tmp_path)
    _two_checkpoints(root)
    d2 = os.path.join(root, "step_2")
    if damage == "metadata":
        os.remove(os.path.join(d2, "metadata.json"))
        match = "metadata.json"
    else:
        os.remove(os.path.join(d2, _shard_files(d2)[0]))
        match = "missing"
    with pytest.raises(CheckpointCorruptError, match=match):
        load_state(d2)
    assert latest_checkpoint(root).endswith("step_1")


def test_missing_peer_metadata_detected_and_skipped(tmp_path):
    root = str(tmp_path)
    _two_checkpoints(root)
    d2 = os.path.join(root, "step_2")
    mpath = os.path.join(d2, "metadata.json")
    meta = json.loads(open(mpath).read())
    meta["process_count"] = 2
    with open(mpath, "w") as f:
        json.dump(meta, f)
    assert "metadata.1.json" in validate_checkpoint(d2)
    with pytest.raises(CheckpointCorruptError, match="killed before"):
        load_state(d2)
    assert latest_checkpoint(root).endswith("step_1")


def test_stale_peer_metadata_from_larger_world_ignored(tmp_path):
    root = str(tmp_path)
    _two_checkpoints(root)
    d2 = os.path.join(root, "step_2")
    stale = {"format": "paddle_tpu.ckpt.v1", "process_count": 2,
             "leaves": {"ghost": {"kind": "array", "shape": [2],
                                  "dtype": "float32",
                                  "shards": [{"file": "ghost.npy",
                                              "start": [0], "shape": [2]}]}}}
    with open(os.path.join(d2, "metadata.1.json"), "w") as f:
        json.dump(stale, f)
    assert validate_checkpoint(d2) is None
    out = load_state(d2)
    assert "ghost" not in out and out["step"] == 2


def test_all_checkpoints_corrupt_returns_none(tmp_path):
    root = str(tmp_path)
    save_state(_state(1), os.path.join(root, "step_1"))
    os.remove(os.path.join(root, "step_1", "metadata.json"))
    assert latest_checkpoint(root) is None


def test_autocheckpoint_restore_skips_torn_snapshot(tmp_path):
    root = str(tmp_path)
    ac = AutoCheckpoint(root, save_interval_steps=1, async_save=False)
    ac.save(1, _state(1))
    ac.save(2, _state(2))
    d2 = os.path.join(root, "step_2")
    with open(os.path.join(d2, _shard_files(d2)[0]), "r+b") as f:
        f.truncate(1)
    step, restored = AutoCheckpoint(root).restore()
    assert step == 1 and restored["step"] == 1


def test_orphaned_staging_dirs_swept_on_startup(tmp_path):
    root = str(tmp_path)
    save_state(_state(3), os.path.join(root, "step_3"))
    for orphan in ("step_5.tmp-pt1234", "step_4.tmp"):
        os.makedirs(os.path.join(root, orphan))
        with open(os.path.join(root, orphan, "junk.npy"), "wb") as f:
            f.write(b"x")
    AutoCheckpoint(root)
    assert sorted(os.listdir(root)) == ["step_3"]


def test_stale_staging_dirs_reaped_by_ttl_mid_run(tmp_path):
    root = str(tmp_path)
    ac = AutoCheckpoint(root, save_interval_steps=1, async_save=False,
                        staging_ttl_seconds=600.0)
    stale = os.path.join(root, "step_9.tmp-pt4242")
    fresh = os.path.join(root, "step_8.tmp-pt4343")
    for d in (stale, fresh):
        os.makedirs(d)
        with open(os.path.join(d, "junk.npy"), "wb") as f:
            f.write(b"x")
    hours_ago = time.time() - 7200
    os.utime(stale, (hours_ago, hours_ago))
    ac.save(1, _state(1))
    names = sorted(os.listdir(root))
    assert os.path.basename(stale) not in names
    assert os.path.basename(fresh) in names and "step_1" in names
    AutoCheckpoint(root)
    assert os.path.basename(fresh) not in os.listdir(root)


def test_overwrite_trash_restored_when_target_missing(tmp_path):
    root = str(tmp_path)
    save_state(_state(2), os.path.join(root, "step_2"))
    os.rename(os.path.join(root, "step_2"),
              os.path.join(root, "step_2.old-pt999"))
    AutoCheckpoint(root)
    assert sorted(os.listdir(root)) == ["step_2"]
    assert load_state(os.path.join(root, "step_2"))["step"] == 2


def test_overwrite_publishes_the_new_state(tmp_path):
    d = str(tmp_path / "step_1")
    save_state(_state(1), d)
    save_state(_state(7), d)
    assert sorted(os.listdir(tmp_path)) == ["step_1"]
    assert load_state(d)["step"] == 7


def test_gc_never_evicts_last_valid_checkpoint(tmp_path):
    root = str(tmp_path)
    ac = AutoCheckpoint(root, save_interval_steps=1, keep_max=2,
                        async_save=False)
    ac.save(1, _state(1))
    ac.save(2, _state(2))
    os.remove(os.path.join(root, "step_2", "metadata.json"))
    ac.save(3, _state(3))
    assert os.path.isdir(os.path.join(root, "step_1"))
    assert AutoCheckpoint(root).restore()[0] == 3
    ac.save(4, _state(4))
    assert latest_checkpoint(root).endswith("step_4")


KILL_SCRIPT = textwrap.dedent("""
    import os
    import torch
    from paddle_tpu_torch.distributed.checkpoint import (
        AsyncSaver, latest_checkpoint, load_state)

    root = os.environ["CKPT_ROOT"]

    def state(step):
        return {"w": torch.full((64, 32), float(step)),
                "b0": torch.ones(4) * step, "b1": torch.ones(4) * step,
                "b2": torch.ones(4) * step, "step": step}

    prev = latest_checkpoint(root)
    resumed = load_state(prev)["step"] if prev else 0
    print(f"RESUMED {resumed}", flush=True)
    saver = AsyncSaver()
    if resumed < 1:
        saver.save(state(1), os.path.join(root, "step_1"))
        saver.wait()
        print("SAVED 1", flush=True)
    saver.save(state(2), os.path.join(root, "step_2"))
    saver.wait()
    print("SAVED 2", flush=True)
""")


def _run_child(tmp_path, root, wait=True):
    script = tmp_path / "worker.py"
    script.write_text(KILL_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO, CKPT_ROOT=root)
    proc = subprocess.Popen([sys.executable, "-u", str(script)], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    if wait:
        out, _ = proc.communicate(timeout=120)
        return proc, out
    return proc, None


def test_sigkill_mid_async_save_falls_back_and_resumes(tmp_path):
    root = str(tmp_path / "ckpt")
    os.makedirs(root)
    plan = FaultPlan([{"site": "ckpt.shard_write", "kind": "delay",
                       "delay": 0.5, "times": None, "after": 4}], seed=0)
    with plan:  # exported through PT_FAULT_PLAN: the child inherits it
        proc, _ = _run_child(tmp_path, root, wait=False)
        try:
            deadline = time.monotonic() + 60.0
            while not glob.glob(os.path.join(root, "step_2.tmp-pt*")):
                assert time.monotonic() < deadline, "no step_2 staging dir"
                time.sleep(0.01)
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert proc.returncode == -signal.SIGKILL
    assert not os.path.exists(os.path.join(root, "step_2"))
    best = latest_checkpoint(root)
    assert best is not None and best.endswith("step_1")
    assert torch.equal(load_state(best)["w"], torch.full((64, 32), 1.0))
    proc2, out2 = _run_child(tmp_path, root)
    assert proc2.returncode == 0, out2[-3000:]
    assert "RESUMED 1" in out2 and "SAVED 2" in out2
    assert latest_checkpoint(root).endswith("step_2")


def test_injected_crash_mid_save_falls_back(tmp_path):
    root = str(tmp_path / "ckpt")
    os.makedirs(root)
    plan = FaultPlan([{"site": "ckpt.shard_write", "kind": "crash",
                       "after": 7}], seed=1)
    with plan:
        proc, out = _run_child(tmp_path, root)
    assert proc.returncode == CRASH_EXIT, out[-2000:]
    assert "SAVED 1" in out and "SAVED 2" not in out
    assert latest_checkpoint(root).endswith("step_1")
    proc2, out2 = _run_child(tmp_path, root)
    assert proc2.returncode == 0, out2[-3000:]
    assert latest_checkpoint(root).endswith("step_2")


# ----------------------------------------------- resilience, against the JAX
def test_resilience_policies_and_plans_equal_the_reference():
    from paddle_tpu.distributed import resilience as jres
    from paddle_tpu_torch.distributed import resilience as tres

    for kw in (dict(max_attempts=5, jitter=0.3, seed=4),
               dict(deadline=2.0, base_delay=0.1, multiplier=3.0)):
        a, b = tres.RetryPolicy(**kw).delays(), jres.RetryPolicy(**kw).delays()
        assert [next(a) for _ in range(8)] == [next(b) for _ in range(8)]
    with pytest.raises(ValueError):
        tres.RetryPolicy()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("not yet")
        return "ok"

    assert tres.RetryPolicy(max_attempts=4, base_delay=0.0).call(flaky) \
        == "ok" and len(calls) == 3
    with pytest.raises(TimeoutError):
        tres.with_timeout(lambda: time.sleep(1.0), 0.05)
    assert tres.Deadline(5.0).remaining() > 4.0
    rules = [{"site": "ckpt.*", "kind": "slow", "delay": 0.0, "times": 3},
             {"site": "train.data", "kind": "drop", "after": 1}]
    tp, jp = tres.FaultPlan(rules, seed=9), jres.FaultPlan(rules, seed=9)
    assert tp.to_json() == jp.to_json()
    assert tres.FaultPlan.from_json(jp.to_json()).to_json() == tp.to_json()
    with tp:
        assert os.environ[tres.FAULT_PLAN_ENV] == tp.to_json()
        tres.fault_point("train.data")
        with pytest.raises(tres.InjectedFault):
            tres.fault_point("train.data")
    assert tp.fired == [0, 1] and tres.FAULT_PLAN_ENV not in os.environ
    assert (tres.CRASH_EXIT, tres.EXIT_PREEMPTED, tres.EXIT_HANG,
            tres.EXIT_EVICTED) == (jres.CRASH_EXIT, jres.EXIT_PREEMPTED,
                                   jres.EXIT_HANG, jres.EXIT_EVICTED)

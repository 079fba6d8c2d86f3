"""The port's bucketed gradient reduction (``paddle_tpu_torch.distributed.
overlap``) and the ZeRO sharded update of its ``DistributedTrainStep``:
twins of ``tests/test_overlap_schedule.py``.

The host-side schedule (bucket order, bucket cuts, the ZeRO dimension
rule, the fallback accounting) is held to the reference's functions on
the same inputs. The step runs in one world of four gloo ranks for the
whole file (``torch_world``). ``overlap_grad_reduce=True`` issues the
bucketed collectives from gradient hooks during the backward; it changes
the schedule, not the values: against the port's own serial path the
losses, parameters and optimizer state are bit-equal at world 2 (a sum
of two addends does not depend on its order) and within float32
tolerance (rtol 1e-6, atol 1e-7) at world 4, where a bucket's all-reduce
may add the four addends in another order than a per-parameter one. The
MLP's last layer has 6 outputs, so its bias (6,) does not divide sdp =
4 or 2 and exercises the ZeRO fallback, as the reference's (4,) bias
does at sdp = 8.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import distributed as jdist
from paddle_tpu.distributed import overlap as jov
from paddle_tpu.distributed.mesh import init_mesh as jinit_mesh
from paddle_tpu.distributed.mesh import set_mesh as jset_mesh
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.distributed import overlap as tov
from paddle_tpu_torch.distributed.mesh import P
from paddle_tpu_torch.distributed.mesh import init_mesh, set_mesh
from paddle_tpu_torch.observability.registry import default_registry

from torch_world import World

SIZES = (16, 32, 8, 6)


@pytest.fixture(scope="module")
def world():
    w = World(4, timeout=150)
    yield w
    w.close()


@pytest.fixture
def mesh8():
    """A port mesh of 8 ranks for the host-side functions (no world)."""
    m = init_mesh(sdp=8, devices=list(range(8)))
    yield m
    set_mesh(None)


class JMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 32)
        self.fc2 = jnn.Linear(32, 8)
        self.fc3 = jnn.Linear(8, 6)

    def forward(self, x):
        return self.fc3(JF.relu(self.fc2(JF.relu(self.fc1(x)))))


def _state():
    pt.seed(0)
    return {k: np.asarray(v) for k, v in JMLP().state_dict().items()}


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 16)).astype(np.float32)
    y = rng.standard_normal((16, 6)).astype(np.float32)
    return x, y


def _job(n, stage, batches=3, **step):
    return dict(kind="mlp", cfg={"sizes": SIZES}, state=_state(),
                mesh={"sdp": n}, opt=("AdamW", {"learning_rate": 1e-2}),
                loss="sq", batches=[_data()] * batches,
                step={"sharding_stage": stage, "overlap_grad_reduce": False,
                      "bucket_size_mb": 0.001, **step})


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    for k, v in tree.items():
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif hasattr(v, "shape"):
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_same(a, b, exact=True):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if exact:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        else:
            np.testing.assert_allclose(fa[k], fb[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)


# ------------------------------------------------------------ bucket logic
def test_bucket_order_is_reverse_backward():
    names = ["fc1.w", "fc1.b", "fc2.w"]
    assert tov.bucket_order(names) == jov.bucket_order(names) == \
        ["fc2.w", "fc1.b", "fc1.w"]


def test_build_buckets_deterministic_and_covering():
    sizes = {f"p{i}": 100 * (i + 1) for i in range(7)}
    a = tov.build_buckets(sizes, bucket_bytes=500)
    assert a == tov.build_buckets(sizes, bucket_bytes=500)
    assert [b.to_dict() for b in a] == [
        b.to_dict() for b in jov.build_buckets(sizes, bucket_bytes=500)]
    names = [n for bk in a for n in bk.names]
    assert names == tov.bucket_order(list(sizes))
    assert [bk.index for bk in a] == list(range(len(a)))
    for bk in a:
        assert bk.bytes == sum(sizes[n] for n in bk.names)


def test_build_buckets_count_override():
    sizes = {f"p{i}": 128 for i in range(12)}
    for count, target, want in ((3, 128, 3), (1, 10 ** 9, 1),
                                (None, 128, 12)):
        got = tov.build_buckets(sizes, bucket_bytes=target,
                                bucket_count=count)
        ref = jov.build_buckets(sizes, bucket_bytes=target,
                                bucket_count=count)
        assert len(got) == len(ref) == want


def test_shard_first_free_dim(mesh8):
    jm = jinit_mesh(sdp=8)
    from jax.sharding import PartitionSpec as JP

    for spec, shape in ((P(), (32, 4)), (P(), (4, 32)), (P(), (4,)),
                        (P("sdp"), (32,)), (P(None, "mp"), (16, 8))):
        got, ok = tov.shard_first_free_dim(spec, shape, "sdp", mesh8)
        jspec = JP(*spec)
        if "mp" in spec.axes():
            want, jok = (P("sdp", "mp"), True)
        else:
            want, jok = jov.shard_first_free_dim(jspec, shape, "sdp", jm)
        assert ok == jok and tuple(got) == tuple(want), (spec, shape)
    # a fused spec keeps its blocks
    got, _ = tov.shard_first_free_dim(P(None, "mp", blocks=3), (16, 48),
                                      "sdp", mesh8)
    assert tuple(got) == ("sdp", "mp") and got.blocks == 3


def test_weight_update_specs_reports_fallbacks(mesh8):
    fell = []
    specs = tov.weight_update_specs(
        {"a": P(), "b": P()}, {"a": (32, 8), "b": (3,)}, "sdp", mesh8,
        on_fallback=fell.append)
    assert specs["a"] == P("sdp", None)
    assert specs["b"] == P(None)
    assert fell == ["b"]


def test_bucketed_reduce_waits_for_whole_buckets():
    """A bucket is issued only when all its gradients arrived and every
    bucket before it was issued; finish() issues the rest (a missing
    gradient reduces zeros) and waits for all."""
    import torch

    sizes = {"a": 4, "b": 4, "c": 4}
    buckets = tov.build_buckets(sizes, bucket_bytes=8)   # (c, b), (a,)
    issued = []

    class Done:
        def __init__(self, grads):
            self.grads = grads

        def wait(self):
            return {k: v * 2 for k, v in self.grads.items()}

    red = tov.BucketedReduce(
        buckets, lambda names, g: issued.append(names) or Done(g),
        lambda n: torch.zeros(1))
    red.arrive("b", torch.ones(1))
    assert issued == []
    red.arrive("a", torch.ones(1))
    assert issued == []                  # bucket 0 still waits for c
    red.arrive("c", torch.ones(1))
    assert issued == [("c", "b"), ("a",)]
    out = red.finish()
    assert {k: float(v) for k, v in out.items()} == {"a": 2, "b": 2, "c": 2}
    red2 = tov.BucketedReduce(buckets, lambda names, g: Done(g),
                              lambda n: torch.zeros(1))
    assert float(red2.finish()["a"]) == 0.0


# --------------------------------------------------------- schedule surface
def test_collective_schedule_and_statusz(world):
    job = _job(4, 1)
    res = world.run("pair", job, {"overlap_grad_reduce": True})
    serial_sz, bucketed_sz = res[0]["statusz"]
    sched_serial, sched = res[0]["schedule"]
    assert sched and sched_serial == []
    # the reference's schedule for the same model and bucket target
    jset_mesh(None)
    pt.seed(0)
    jstep = jdist.DistributedTrainStep(
        JMLP(), JAdamW(learning_rate=1e-2), loss_fn=lambda o, b: o.mean(),
        mesh=jinit_mesh(sdp=4), sharding_stage=1, overlap_grad_reduce=True,
        bucket_size_mb=0.001)
    jset_mesh(None)
    assert sched == jstep.collective_schedule()
    assert bucketed_sz["overlap_grad_reduce"] and \
        bucketed_sz["sharding_stage"] == 1
    assert len(bucketed_sz["buckets"]) == len(sched)
    assert not serial_sz["overlap_grad_reduce"]
    # fc3.bias (6,) is indivisible by sdp=4 -> counted and surfaced
    assert bucketed_sz["zero_fallback_params"] == ["fc3.bias"]
    assert jstep.statusz()["zero_fallback_params"] == ["fc3.bias"]
    # every bucket was issued from the hooks, inside the backward
    assert bucketed_sz["buckets_issued_in_backward"] == len(sched)


def test_zero_fallback_is_metered_in_the_registry(world):
    counters = world.run("fallback_counters", _job(4, 1))
    for c in counters:
        assert any(k.startswith("distributed.zero_fallback_params_total")
                   and v >= 1 for k, v in c.items())
    assert isinstance(default_registry().snapshot(), dict)


def test_bucket_count_knob_reaches_step(world):
    res = world.run("pair", _job(4, 1, batches=1),
                    {"overlap_grad_reduce": True, "bucket_count": 2})
    assert len(res[0]["schedule"][1]) == 2


# ------------------------------------------------------------ step parity
@pytest.mark.parametrize("n", [2, 4], ids=["world2", "world4"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_overlap_parity(world, stage, n):
    """The bucketed schedule at every sharding stage against the port's
    serial path: losses, local and gathered parameters and optimizer
    state over three steps; bit-equal at world 2."""
    res = world.run("pair", _job(n, stage), {"overlap_grad_reduce": True})
    for r in range(n):
        out = res[r]
        _assert_same(out["losses"][0], out["losses"][1], exact=n == 2)
        _assert_same(out["local"][0], out["local"][1], exact=n == 2)
        _assert_same(out["full"][0], out["full"][1], exact=n == 2)
    assert all(res[r] is None for r in range(n, 4))


def test_overlap_grad_accum_parity(world):
    """Gradient merge composes with the bucketed schedule: the merged
    accumulator feeds the same update as the serial one."""
    res = world.run("pair", _job(2, 1, batches=4, grad_accum_steps=2),
                    {"overlap_grad_reduce": True})
    out = res[0]
    _assert_same(out["losses"][0], out["losses"][1])
    _assert_same(out["local"][0], out["local"][1])


def test_scaler_rollback_restores_sharded_opt_state(world):
    """A poisoned step under the bucketed + ZeRO schedule leaves the
    sharded state bit-equal (params, moments, masters)."""
    job = _job(4, 1, overlap_grad_reduce=True)
    job["scaler"] = {"init_loss_scaling": 2.0 ** 10,
                     "use_dynamic_loss_scaling": True}
    res = world.run("rollback", job)
    for r in range(4):
        out = res[r]
        assert out["first"][1] and np.isfinite(out["first"][0])
        assert not out["second"][1]
        _assert_same(out["before"], out["after"])


def test_overlap_state_reshards_across_dp_resize(world):
    """A state written by the bucketed + ZeRO step on sdp = 4 resumes on
    sdp = 2 (``set_state_dict`` takes the full state and each rank copies
    its blocks) and keeps training parity with an uninterrupted run."""
    job = _job(4, 1, batches=3, overlap_grad_reduce=True)
    resumed = world.run("resume", job, 2, {"sdp": 2})[0]
    straight = world.run("train", dict(job, mesh={"sdp": 2}))[0]
    np.testing.assert_allclose(resumed["losses"], straight["losses"][2:],
                               rtol=1e-5, atol=1e-6)
    for k, v in straight["params"].items():
        np.testing.assert_allclose(resumed["params"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)

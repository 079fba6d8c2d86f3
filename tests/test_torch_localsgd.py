"""The port's LocalSGD (``distributed/parallel/localsgd.py``), fleet's
dispatch to it, and Lamb, LarsMomentum and DGCMomentum on split
parameters (ZeRO-2 at sdp = 2 and tensor parallelism at mp = 2, on a
column-parallel and a row-parallel linear), against the JAX package's, on
the CPU.

Twins of ``tests/test_localsgd_lars.py:70`` and ``:112``: the port runs in
a world of two gloo ranks (``torch_world``), one replica a rank; the
reference steps its two replicas stacked on two of its virtual CPU
devices. The same numpy weights and batches go to both, in float32.
Tolerance: rtol 1e-4, atol 1e-5 (the reference's own) on the losses and
SGD/LARS/DGC-trained parameters; Lamb's Adam-type parameters at 3e-4
absolute, as ``tests/test_torch_distributed.py`` holds Adam's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import distributed as jdist
from paddle_tpu.distributed.mesh import init_mesh as jinit_mesh
from paddle_tpu.distributed.mesh import set_mesh as jset_mesh
from paddle_tpu.distributed.parallel.localsgd import LocalSGDStep as JLocal
from paddle_tpu.distributed.parallel.mp_layers import (
    ColumnParallelLinear as JCol, RowParallelLinear as JRow)
from paddle_tpu import optimizer as jopt

from torch_world import World
from torch_threads import few_torch_threads  # noqa: F401

RTOL, ATOL, ADAM_ATOL = 1e-4, 1e-5, 3e-4


@pytest.fixture(scope="module")
def world():
    w = World(2, timeout=150)
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _no_jax_mesh():
    yield
    jset_mesh(None)


class JMLP(jnn.Layer):
    def __init__(self, sizes=(16, 32, 4)):
        super().__init__()
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            setattr(self, f"fc{i + 1}", jnn.Linear(a, b))

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


def _mse(out, batch):
    return jnp.mean((out - batch[1]) ** 2)


def _mlp_case(seed=5, steps=4):
    pt.seed(seed)
    jm = JMLP()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    rng = np.random.default_rng(seed)
    batches = [(rng.normal(size=(8, 16)).astype(np.float32),
                rng.normal(size=(8, 4)).astype(np.float32))
               for _ in range(steps)]
    return jm, state, batches


@pytest.mark.parametrize("axis,via_fleet", [("sdp", False), ("dp", True)],
                         ids=["sdp2_direct", "dp2_fleet"])
def test_localsgd_matches_the_reference(world, axis, via_fleet):
    """k_steps 2, 4 steps of SGD: each rank's replica equals the
    reference's replica of the same index after every step; the replicas
    differ before a sync and are equal after one."""
    jm, state, batches = _mlp_case()
    mesh = jinit_mesh({axis: 2})
    ref = JLocal(jm, jopt.SGD(learning_rate=0.1), loss_fn=_mse, mesh=mesh,
                 k_steps=2, axis=axis)
    ref_losses, ref_reps = [], []
    for b in batches:
        ref_losses.append(float(ref(tuple(jnp.asarray(x) for x in b))))
        # copies: the reference donates its parameter buffers to the next
        # step, and a CPU array's numpy view would change with them
        ref_reps.append({k: np.array(v, copy=True)
                         for k, v in ref.replica_params().items()})
    ref_avg = {k: np.asarray(v) for k, v in ref.averaged_params().items()}
    jset_mesh(None)
    job = dict(kind="mlp", cfg={}, state=state, loss="mse",
               opt=("SGD", {"learning_rate": 0.1}), batches=batches)
    res = world.run("localsgd", job, 2, axis, via_fleet)
    for r, got in enumerate(res):
        assert got["type"] == "LocalSGDStep" and got["k_steps"] == 2
        np.testing.assert_allclose(got["losses"], ref_losses, rtol=RTOL,
                                   atol=ATOL)
        for t in range(len(batches)):
            for k, v in got["replicas"][t].items():
                np.testing.assert_allclose(v, ref_reps[t][k][r], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{t} {k}")
        for k, v in got["averaged"].items():
            np.testing.assert_allclose(v, ref_avg[k], rtol=RTOL, atol=ATOL)
    for t in range(len(batches)):
        w0 = res[0]["replicas"][t]["fc1.weight"]
        w1 = res[1]["replicas"][t]["fc1.weight"]
        if (t + 1) % 2:
            assert not np.array_equal(w0, w1)    # diverged between syncs
        else:
            np.testing.assert_array_equal(w0, w1)


def _plain_o2_localsgd(state, batches, lr, k_steps):
    """LocalSGD under bf16 O2 in plain PyTorch: two replicas, each a
    float32 master of every parameter, a bf16 copy of it in the forward
    (whose float32 activations promote it, as the port's ``linear``
    does), SGD on the master from its half of each batch; every
    ``k_steps``-th step both masters become their mean. The masters
    start from the bf16 parameters, as ``amp.decorate`` leaves them. The
    averaged losses and the masters after each step."""
    masters = [{k: torch.tensor(v).to(torch.bfloat16).float()
                for k, v in state.items()} for _ in range(2)]
    losses, after = [], []
    for t, (x, y) in enumerate(batches):
        half = x.shape[0] // 2
        step_losses = []
        for r, m in enumerate(masters):
            p = {k: v.to(torch.bfloat16).requires_grad_() for k, v in
                 m.items()}
            xs = torch.tensor(x[r * half:(r + 1) * half])
            ys = torch.tensor(y[r * half:(r + 1) * half])
            h = torch.relu(xs @ p["fc1.weight"].float()
                           + p["fc1.bias"].float())
            out = h @ p["fc2.weight"].float() + p["fc2.bias"].float()
            loss = ((out - ys) ** 2).mean()
            grads = torch.autograd.grad(loss, list(p.values()))
            for (k, v), g in zip(m.items(), grads):
                v -= lr * g.float()
            step_losses.append(float(loss.detach()))
        if (t + 1) % k_steps == 0:
            for k in masters[0]:
                avg = (masters[0][k] + masters[1][k]) / 2
                masters[0][k], masters[1][k] = avg.clone(), avg.clone()
        losses.append(sum(step_losses) / 2)
        after.append([{k: v.numpy().copy() for k, v in m.items()}
                      for m in masters])
    return losses, after


def test_localsgd_o2_averages_the_float32_masters(world):
    """The port's accepted divergence (ROADMAP §C): under bf16 O2 a sync
    averages the float32 masters and casts the parameters from the mean
    (the reference averages the parameters only). Held to a plain
    PyTorch replay: the losses, and each rank's masters after every step;
    right after a sync the two ranks' masters are bit-equal and the
    parameters are their bf16 cast."""
    _, state, batches = _mlp_case()
    job = dict(kind="mlp", cfg={}, state=state, loss="mse",
               opt=("SGD", {"learning_rate": 0.1}), batches=batches,
               o2=True)
    res = world.run("localsgd", job, 2, "dp", False)
    losses, masters = _plain_o2_localsgd(state, batches, 0.1, 2)
    for r, got in enumerate(res):
        assert set(got["dtypes"].values()) == {"torch.bfloat16"}
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-6,
                                   atol=1e-7)
        for t in range(len(batches)):
            for k, v in got["masters"][t].items():
                np.testing.assert_allclose(v, masters[t][r][k], rtol=1e-6,
                                           atol=1e-7, err_msg=f"{t} {k}")
    for t in range(len(batches)):
        m0, m1 = res[0]["masters"][t], res[1]["masters"][t]
        if (t + 1) % 2:
            assert not np.array_equal(m0["fc1.weight"], m1["fc1.weight"])
            continue
        for k in m0:
            np.testing.assert_array_equal(m0[k], m1[k], err_msg=f"{t} {k}")
            np.testing.assert_array_equal(
                res[0]["replicas"][t][k],
                torch.tensor(m0[k]).to(torch.bfloat16).float().numpy())


def test_fleet_localsgd_dispatch_reference():
    """The reference's dispatch, which the port's ``dp2_fleet`` case
    mirrors: ``strategy.localsgd`` makes ``distributed_model`` a
    LocalSGDStep with the configured ``k_steps``."""
    from paddle_tpu.distributed import fleet

    s = fleet.DistributedStrategy()
    s.localsgd = True
    s.localsgd_configs = {"k_steps": 3}
    fleet.init(strategy=s)
    jm, _, _ = _mlp_case()
    step = fleet.distributed_model(jm, jopt.SGD(learning_rate=0.1),
                                   loss_fn=_mse)
    assert isinstance(step, JLocal) and step.k_steps == 3


# ------------------------------------------- norms of split parameters
class JTPNet(jnn.Layer):
    """A column-parallel then a row-parallel linear (the port's
    ``torch_dist_tasks.TPNet``): split by "mp" at mp = 2, by the ZeRO
    dim rule at sdp = 2."""

    def __init__(self):
        super().__init__()
        self.col = JCol(16, 64, gather_output=False)
        self.row = JRow(64, 16, input_is_parallel=True)

    def forward(self, x):
        return self.row(JF.relu(self.col(x)))


OPTIMIZERS = {
    "Lamb": {"learning_rate": 1e-2, "lamb_weight_decay": 0.01},
    "LarsMomentum": {"learning_rate": 0.1, "momentum": 0.9,
                     "lars_coeff": 0.01},
    "DGCMomentum": {"learning_rate": 0.01, "momentum": 0.9,
                    "rampup_begin_step": 1, "sparsity": [0.5]},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("mesh,step", [
    ({"sdp": 2}, {"sharding_stage": 2}), ({"mp": 2}, {})],
    ids=["sdp2_zero2", "mp2"])
def test_norm_optimizers_on_split_parameters(world, name, mesh, step):
    """Three steps with each per-parameter-norm optimizer on a mesh that
    splits every matrix: the port's norms, trust ratios and DGC's quantile
    are the whole parameter's, as GSPMD gives the reference's."""
    kw = OPTIMIZERS[name]
    pt.seed(5)
    jm = JTPNet()
    state = {k: np.array(v) for k, v in jm.state_dict().items()}
    # one block of each matrix ten times the rest, on the halves both
    # meshes cut: a norm of a half then differs from the whole's by far
    # more than the tolerance, so a rank-local norm cannot pass
    state["col.weight"][:8, :32] *= 10.0
    state["row.weight"][:32] *= 10.0
    jm.set_state_dict(state)
    rng = np.random.default_rng(5)
    batches = [(rng.standard_normal((8, 16)).astype(np.float32),
                rng.standard_normal((8, 16)).astype(np.float32))
               for _ in range(3)]
    jmesh = jinit_mesh(dict(mesh))
    ref = jdist.DistributedTrainStep(
        jm, getattr(jopt, name)(**kw), mesh=jmesh,
        loss_fn=lambda o, b: JF.mse_loss(o, b[1]), **step)
    losses = [float(ref(b)) for b in batches]
    params = {k: np.asarray(v) for k, v in ref.params.items()}
    jset_mesh(None)
    job = dict(kind="tpnet", state=state, mesh=mesh, loss="mse",
               opt=(name, kw), batches=batches, step=step)
    res = world.run("train", job)
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=RTOL,
                               atol=ATOL)
    atol = ADAM_ATOL if name == "Lamb" else ATOL
    for k in params:
        np.testing.assert_allclose(res[0]["params"][k], params[k], rtol=RTOL,
                                   atol=atol, err_msg=k)
    # the matrices really were split on the ranks (their update slices)
    slot = "moment1" if name == "Lamb" else "velocity"
    split = [k for k, shape in res[0]["local_opt"][slot].items()
             if shape != params[k].shape]
    assert {"col.weight", "row.weight"} <= set(split)

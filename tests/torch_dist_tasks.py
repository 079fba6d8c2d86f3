"""What the ranks of a ``torch_world.World`` run for the port's distributed
tests: each function runs on every rank at once and returns plain numpy
data (or None on a rank outside the task's mesh). Imports torch and the
port only."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.distributed.mesh import init_mesh, set_mesh
from paddle_tpu_torch.distributed.parallel.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers.common import Linear


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np(v) for v in t]
    return t


# ------------------------------------------------------------ collectives
def collectives(n):
    """Each collective at dp=n on this rank's block of the reference
    test's input (``tests/test_distributed.py``)."""
    m = init_mesh(dp=n)
    try:
        if not m.member:
            return None
        r = m.axis_index("dp")
        x = torch.arange(float(n))
        out = {
            "all_reduce": C.all_reduce(x[r:r + 1], group="dp"),
            "all_reduce_max": C.all_reduce(x[r:r + 1], op=C.ReduceOp.MAX,
                                           group="dp"),
            "all_reduce_avg": C.all_reduce(x[r:r + 1], op=C.ReduceOp.AVG,
                                           group="dp"),
            "all_gather": C.all_gather(
                torch.arange(2.0 * n).reshape(n, 2)[r:r + 1], group="dp",
                axis=0),
            "alltoall": C.alltoall(
                torch.arange(float(n * n)).reshape(n, n)[r:r + 1],
                group="dp", split_axis=1, concat_axis=1),
            "broadcast": C.broadcast(x[r:r + 1], src=n - 1, group="dp"),
            "shift_right": C.shift_right(x[r:r + 1], group="dp"),
            "shift_left": C.shift_left(x[r:r + 1], group="dp"),
            "reduce_scatter": C.reduce_scatter(torch.ones(n, n), group="dp"),
            "reduce_scatter_avg": C.reduce_scatter(
                torch.ones(n, n) * (r + 1), op=C.ReduceOp.AVG, group="dp"),
            "buckets": C.all_reduce_buckets(
                [torch.arange(float(n))[r:r + 1] + i for i in range(3)],
                group="dp"),
            "mapped": [C.all_reduce(torch.arange(float(n))[r:r + 1] + i,
                                    group="dp") for i in range(3)],
            "axis_index": C.axis_index("dp"),
            "axis_size": C.axis_size_of("dp"),
        }
        return _np(out)
    finally:
        set_mesh(None)


# ------------------------------------------------------------ models
class MLP(nn.Module):
    def __init__(self, sizes=(16, 32, 4)):
        super().__init__()
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            self.add_module(f"fc{i + 1}", Linear(a, b, device="cpu"))

    def forward(self, x):
        mods = list(self.children())
        for mod in mods[:-1]:
            x = F.relu(mod(x))
        return mods[-1](x)


class TPNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.col = ColumnParallelLinear(16, 64, gather_output=False,
                                        device="cpu")
        self.row = RowParallelLinear(64, 16, input_is_parallel=True,
                                     device="cpu")

    def forward(self, x):
        return self.row(F.relu(self.col(x)))


def _build(kind, cfg, state):
    from paddle_tpu_torch import convert

    if kind == "gpt":
        from paddle_tpu_torch.models.gpt import gpt_tiny
        return convert.gpt_from_jax(state, gpt_tiny(**cfg),
                                    device="cpu").train()
    if kind == "llama":
        from paddle_tpu_torch.models.llama import llama_tiny
        return convert.llama_from_jax(state, llama_tiny(**cfg),
                                      device="cpu").train()
    model = TPNet() if kind == "tpnet" else MLP(**cfg)
    return convert.layer_from_jax(model, state).train()


def _optimizer(name, kw):
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn import clip

    kw = dict(kw)
    if "clip_norm" in kw:
        kw["grad_clip"] = clip.ClipGradByGlobalNorm(kw.pop("clip_norm"))
    return getattr(O, name)(**kw)


LOSSES = {
    "ce": lambda out, b: F.cross_entropy(out, b[1]),
    "mse": lambda out, b: ((out - b[1]) ** 2).mean(),
    "sq": lambda out, b: ((out - b[1]) ** 2).mean(),
    None: None,
}


def _make_step(job):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed.shard import DistributedTrainStep
    from paddle_tpu_torch.framework import random as trandom

    trandom.seed(job.get("seed", 0))   # the step's base seed
    model = _build(job["kind"], job.get("cfg", {}), job["state"])
    opt = _optimizer(*job["opt"])
    if job.get("o2"):
        model, opt = amp.decorate(model, opt, level="O2")
    if job.get("gsp"):   # the public ZeRO entry tags the optimizer
        from paddle_tpu_torch.distributed import group_sharded_parallel

        model, opt, _ = group_sharded_parallel(model, opt, job["gsp"])
    scaler = None
    if job.get("scaler"):
        scaler = amp.GradScaler(**job["scaler"])
    return DistributedTrainStep(model, opt, loss_fn=LOSSES[job.get("loss")],
                                scaler=scaler, **job.get("step", {}))


def train(job):
    """Build the model from the reference's state, run the batches
    through a ``DistributedTrainStep`` on ``job["mesh"]`` and return the
    losses, the gathered parameters and optimizer state, the local shapes
    and the step's status."""
    m = init_mesh(job["mesh"])
    try:
        if not m.member:
            return None
        step = _make_step(job)
        losses = [float(step(b)) for b in job["batches"]]
        sd = step.state_dict()
        return {
            "losses": losses,
            "params": _np(sd["params"]),
            "opt_state": _np({k: v for k, v in sd["opt_state"].items()
                              if isinstance(v, dict)}),
            "local_params": {k: tuple(v.shape)
                             for k, v in step.params.items()},
            "local_opt": {slot: {k: tuple(v.shape) for k, v in val.items()}
                          for slot, val in step.opt_state.items()
                          if isinstance(val, dict)},
            "specs": {k: (tuple(v), v.blocks) for k, v in step.specs.items()},
            "statusz": {k: v for k, v in step.statusz().items()
                        if k != "collectives"},
            "grad_accum_steps": step.grad_accum_steps,
            "coordinate": dict(m.coordinate),
        }
    finally:
        set_mesh(None)


def pair(job, other):
    """Two steps built from the same state, stepped in turns on the same
    batches (``other`` overrides ``job["step"]``): their losses, full
    parameters and optimizer states, and the local ones."""
    m = init_mesh(job["mesh"])
    try:
        if not m.member:
            return None
        a = _make_step(job)
        b = _make_step(dict(job, step={**job.get("step", {}), **other}))
        la, lb = [], []
        for batch in job["batches"]:
            la.append(_np(a(batch)))
            lb.append(_np(b(batch)))
        return {"losses": (la, lb),
                "local": [(_np(s.params), _np(s.opt_state)) for s in (a, b)],
                "full": [(_np(s.state_dict()["params"]),
                          _np(s.state_dict()["opt_state"])) for s in (a, b)],
                "schedule": [s.collective_schedule() for s in (a, b)],
                "statusz": [{k: v for k, v in s.statusz().items()
                             if k != "collectives"} for s in (a, b)]}
    finally:
        set_mesh(None)


def rollback(job):
    """A guarded step, then a poisoned one: the local state before and
    after the poisoned step, and its flags."""
    m = init_mesh(job["mesh"])
    try:
        if not m.member:
            return None
        step = _make_step(job)
        x = job["batches"][0]
        loss, ok, found = step.watchdog_call(x)
        first = (float(loss), bool(ok))
        before = (_np(step.params), _np(step.opt_state))
        step.inject_anomaly()
        loss, ok, found = step.watchdog_call(x)
        return {"first": first, "second": (float(loss), bool(ok)),
                "before": before,
                "after": (_np(step.params), _np(step.opt_state))}
    finally:
        set_mesh(None)


def resume(job, steps_before, mesh_after):
    """Train ``steps_before`` batches, take the full state, rebuild the
    step on ``mesh_after`` from it and train the rest: the losses and the
    final full parameters."""
    m = init_mesh(job["mesh"])
    sd = losses = None
    try:
        if m.member:
            step = _make_step(job)
            losses = [float(step(b)) for b in job["batches"][:steps_before]]
            sd = step.state_dict()
    finally:
        set_mesh(None)
    # every rank takes rank 0's state, as a checkpoint written by rank 0
    import torch.distributed as dist

    box = [sd]
    dist.broadcast_object_list(box, src=0)
    sd = box[0]
    m = init_mesh(mesh_after)
    try:
        if not m.member:
            return None
        step = _make_step(dict(job, mesh=mesh_after))
        step.set_state_dict(sd)
        losses = [float(step(b)) for b in job["batches"][steps_before:]]
        return {"losses": losses, "params": _np(step.state_dict()["params"])}
    finally:
        set_mesh(None)


# ------------------------------------------------------------ TP layers
def tp_layers(shape, col_state, row_state, emb_state, x, ids):
    """The column/row pair and the vocab embedding on ``shape``: their
    outputs and the gathered gradients of a sum of squares."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.distributed.shard import param_specs, shard_model

    m = init_mesh(shape)
    try:
        if not m.member:
            return None

        class Pair(nn.Module):
            def __init__(self):
                super().__init__()
                self.col = ColumnParallelLinear(16, 32, gather_output=False,
                                                device="cpu")
                self.row = RowParallelLinear(32, 16, input_is_parallel=True,
                                             device="cpu")

        net = Pair()
        convert.layer_from_jax(net.col, col_state)
        convert.layer_from_jax(net.row, row_state)
        emb = VocabParallelEmbedding(64, 16, device="cpu")
        convert.layer_from_jax(emb, emb_state)
        specs = param_specs(net, m)
        especs = param_specs(emb, m)
        shard_model(net, specs, m)
        shard_model(emb, especs, m)
        xt = torch.as_tensor(x)
        out = net.row(net.col(xt))
        grads = torch.autograd.grad((out ** 2).sum(),
                                    list(net.parameters()))
        gfull = convert.gather_state(
            dict(zip(dict(net.named_parameters()), grads)), specs, m)
        e = emb(torch.as_tensor(ids).long())
        return {"out": _np(out), "grads": _np(gfull), "emb": _np(e),
                "specs": {k: tuple(v) for k, v in specs.items()},
                "local": {k: tuple(p.shape)
                          for k, p in net.named_parameters()},
                "emb_local": tuple(emb.weight.shape)}
    finally:
        set_mesh(None)


def vocab_ce(shape, logits, labels):
    """``ParallelCrossEntropy`` over this rank's vocab slice of
    ``logits`` and the gathered gradient of its mean."""
    from paddle_tpu_torch.distributed.parallel.mp_layers import (
        ParallelCrossEntropy)

    m = init_mesh(shape)
    try:
        if not m.member:
            return None
        ce = ParallelCrossEntropy()
        ce._mp_mesh = m
        n, r = m.axis_size("mp"), m.axis_index("mp")
        w = logits.shape[-1] // n
        z = torch.tensor(logits[..., r * w:(r + 1) * w], requires_grad=True)
        loss = ce(z, torch.as_tensor(labels))
        (g,) = torch.autograd.grad(loss.mean(), [z])
        return {"loss": _np(loss),
                "grad": _np(C.all_gather(g, "mp", axis=g.ndim - 1))}
    finally:
        set_mesh(None)


# ------------------------------------------------------------ fleet
def fleet_hcg(hybrid, merge):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.optimizer import SGD

    s = DistributedStrategy()
    s.hybrid_configs = dict(hybrid)
    try:
        mesh = fleet.init(is_collective=True, strategy=s, device="cpu")
        hcg = fleet.get_hybrid_communicate_group()
        out = {"shape": dict(mesh.shape),
               "mp": hcg.get_model_parallel_world_size(),
               "dp": hcg.get_data_parallel_world_size(),
               "mp_rank": hcg.get_model_parallel_rank(),
               "dp_rank": hcg.get_data_parallel_rank(),
               "nranks": hcg.nranks(), "worker_num": fleet.worker_num(),
               "worker_index": fleet.worker_index(),
               "first": fleet.is_first_worker()}
        fleet.barrier_worker()
        s2 = DistributedStrategy()
        s2.gradient_merge = True
        s2.gradient_merge_configs = dict(merge)
        fleet._fleet_state.update(strategy=s2)
        step = fleet.distributed_model(MLP(), SGD(learning_rate=0.1),
                                       loss_fn=LOSSES["sq"])
        out["merge"] = (step.grad_accum_steps, step.grad_accum_avg)
        return out
    finally:
        fleet._fleet_state.update(strategy=None, hcg=None,
                                  initialized=False)
        set_mesh(None)


def zero3_residency(job):
    """Train ``job["batches"]`` at ZeRO-3 while watching which decoder
    blocks hold their gathered parameters: at each block's forward (after
    the step's own hook), at each of its parameters' gradients (after the
    step's own hook) and after each step. Returns the losses, the gathered
    parameters and ``(event, block, blocks gathered)`` records."""
    m = init_mesh(job["mesh"])
    try:
        if not m.member:
            return None
        step = _make_step(job)
        stored = [k for k, s in step.specs.items() if "sdp" in s.axes()]
        blocks = step.model.gpt.h

        def gathered():
            return sorted({int(k.split(".")[2]) for k in stored
                           if k.startswith("gpt.h.")
                           and step.compute_params[k].numel()})

        events = []
        for i, blk in enumerate(blocks):
            blk.register_forward_pre_hook(
                lambda mod, args, i=i: events.append(("fwd", i, gathered())))
            for name, p in blk.named_parameters():
                if f"gpt.h.{i}.{name}" in stored:
                    p.register_hook(lambda g, i=i: events.append(
                        ("grad", i, gathered())))
        losses = []
        for b in job["batches"]:
            losses.append(float(step(b)))
            events.append(("after", -1, gathered()))
        return {"losses": losses, "params": _np(step.state_dict()["params"]),
                "events": events, "stored": stored}
    finally:
        set_mesh(None)


def train_error(job):
    """``train(job)`` where it must raise: the exception's type and text
    (None on ranks off the mesh)."""
    try:
        train(job)
    except Exception as e:   # the raise under test, reported as data
        return f"{type(e).__name__}: {e}"
    return "no error" if env.get_rank() < 2 else None


def fallback_counters(job):
    """Build the step; the metrics registry's counters."""
    from paddle_tpu_torch.observability.registry import default_registry

    m = init_mesh(job["mesh"])
    try:
        if not m.member:
            return {}
        _make_step(job)
        return dict(default_registry().snapshot()["counters"])
    finally:
        set_mesh(None)


def loaded_modules():
    """Whether jax or the reference package was ever imported here."""
    import sys

    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))


# ------------------------------------------------------------ api_compat
def api_groups():
    """Groups (made collectively: both ranks make both), the world group
    and ParallelEnv."""
    import paddle_tpu_torch.distributed as D
    import torch.distributed as dist

    pair = D.new_group([0, 1])
    solo = D.new_group([1])          # rank 0 makes it too, as torch needs
    world = D.get_group(0)
    pe = D.ParallelEnv()
    me = torch.tensor([float(pe.rank + 1)])
    return {"ids": (pair.id, solo.id), "pair_rank": pair.rank,
            "solo_member": solo.is_member(), "nranks": pair.nranks,
            "world": (world.id, world.ranks, world.pg is dist.group.WORLD),
            "lookup": D.get_group(pair.id) is pair,
            "env": (pe.rank, pe.world_size, pe.nranks, pe.local_rank,
                    pe.device_id),
            "pair_reduce": _np(D.reduce(me, dst=1, group=pair)),
            "solo_reduce": _np(D.reduce(me, dst=0, group=solo))}


def api_p2p():
    """Every P2P form between the two ranks: send/recv without and with
    a buffer, isend/irecv, tags as separate streams, batch_isend_irecv,
    and stream.send/recv."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import stream

    r, out = env.get_rank(), {}
    if r == 0:
        D.send(torch.arange(6, dtype=torch.float32).reshape(2, 3), dst=1,
               tag=7)
        buf = torch.zeros(1)
        got = D.recv(buf, src=1, tag=9)
        out["recv_buf"] = (_np(buf), got is buf)
        D.isend(torch.tensor([[1, 2], [3, 4]]), dst=1, tag=3).wait()
        a = D.isend(torch.tensor([1.0]), dst=1, tag=11)
        b = D.isend(torch.tensor([2.0]), dst=1, tag=12)
        a.wait()
        b.wait()
        reqs = D.batch_isend_irecv([
            D.P2POp(D.irecv, None, 1, tag=5),
            D.P2POp(D.isend, torch.full((3,), 2.5, dtype=torch.bfloat16), 1,
                    tag=4)])
        out["batch"] = _np(reqs[0].wait())
        reqs[1].wait()
        stream.send(torch.tensor([7, 8], dtype=torch.int32), dst=1,
                    sync_op=False, use_calc_stream=True)
    else:
        got = D.recv(src=0, tag=7)                     # no buffer
        out["recv_nobuf"] = (_np(got), str(got.dtype))
        D.send(torch.tensor([5.0]), dst=0, tag=9)
        got = D.irecv(src=0, tag=3).wait()
        out["irecv"] = (_np(got), str(got.dtype))
        # tag 12 first: the two tags are separate streams
        out["tags"] = (_np(D.recv(src=0, tag=12)), _np(D.recv(src=0, tag=11)))
        buf = torch.zeros(3, dtype=torch.bfloat16)
        reqs = D.batch_isend_irecv([
            D.P2POp(D.irecv, buf, 0, tag=4),
            D.P2POp(D.isend, torch.tensor([10.0, 11.0]), 0, tag=5)])
        out["batch"] = (_np(reqs[0].wait()), _np(buf))
        reqs[1].wait()
        out["stream"] = _np(stream.recv(src=0, use_calc_stream=True))
    return out


def api_collectives(x, rows):
    """reduce/scatter/alltoall_single/all_gather_object over the world
    (no mesh), then over the mesh's "dp" axis through a Group made with
    ``axis=``, and stream.all_reduce. ``x`` is the [2, ...] input of the
    reference's shard_map (rank r holds ``x[r:r+1]``); ``rows`` the
    scatter list."""
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import stream

    r = env.get_rank()
    mine = torch.as_tensor(x[r:r + 1])
    out = {"reduce": D.reduce(mine, dst=1),
           "reduce_max": D.reduce(mine, dst=0, op=C.ReduceOp.MAX),
           "scatter": D.scatter(torch.as_tensor(x).reshape(-1), src=0),
           "alltoall": D.alltoall_single(torch.arange(4.0) + 10 * r),
           "objects": D.all_gather_object([], {"rank": r, "s": "x" * r})}
    buf = torch.zeros(rows.shape[1:])
    got = D.scatter(buf, [torch.as_tensor(v) for v in rows], src=1)
    out["scatter_list"] = (got, buf)
    into = torch.empty(4)
    D.alltoall_single(torch.arange(4.0) * (r + 1), into)
    out["alltoall_into"] = into
    try:
        D.alltoall_single(torch.ones(4), in_split_sizes=[1, 3])
        out["uneven"] = "no error"
    except NotImplementedError as e:
        out["uneven"] = str(e)
    m = init_mesh(dp=2)
    try:
        gdp = D.new_group([0, 1], axis="dp")
        out["reduce_axis"] = D.reduce(mine, dst=0, group=gdp)
        out["scatter_axis"] = D.scatter(torch.as_tensor(x).reshape(-1), src=1,
                                        group="dp")
        out["stream_all_reduce"] = stream.all_reduce(
            mine, group="dp", sync_op=False, use_calc_stream=True)
        out["wait"] = D.wait(mine)
    finally:
        set_mesh(None)
    return _np(out)


def api_deadline():
    """Rank 0 receives from rank 1, which sends nothing: the receive
    fails at its own deadline (seconds taken, the error's text)."""
    import time

    import paddle_tpu_torch.distributed as D

    if env.get_rank() != 0:
        return None
    t0 = time.monotonic()
    try:
        D.recv(src=1, tag=99, timeout=1.0)
    except TimeoutError as e:
        return (time.monotonic() - t0, str(e))
    return (time.monotonic() - t0, "no error")


def group_sharded_save(job, out_dir):
    """Train ``job`` (its optimizer tagged by group_sharded_parallel) and
    save the pair with save_group_sharded_model (rank 0 writes): the
    losses, the gathered parameters, and whether the optimizer holds the
    step's split hook outside its update (it must not)."""
    from paddle_tpu_torch.distributed import save_group_sharded_model
    from paddle_tpu_torch.distributed.shard import step_of

    m = init_mesh(job["mesh"])
    try:
        step = _make_step(job)
        losses = [float(step(b)) for b in job["batches"]]
        assert step_of(step.optimizer) is step
        save_group_sharded_model(step.model, out_dir, step.optimizer)
        return {"losses": losses,
                "params": _np(step.state_dict()["params"]),
                "stage": step.sharding_stage,
                "split_hook_left": step.optimizer._split is not None}
    finally:
        set_mesh(None)


# ------------------------------------------------------------ localsgd
def localsgd(job, k_steps, axis, via_fleet):
    """``LocalSGDStep`` (directly on ``axis``, or through
    fleet.distributed_model with strategy.localsgd) for the batches: the
    losses and this rank's replica (and, under ``job["o2"]``, its float32
    masters) after each step."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.parallel.localsgd import LocalSGDStep

    model = _build(job["kind"], job.get("cfg", {}), job["state"])
    opt = _optimizer(*job["opt"])
    if job.get("o2"):
        from paddle_tpu_torch import amp

        model, opt = amp.decorate(model, opt, level="O2")
    loss_fn = LOSSES[job.get("loss")]
    if via_fleet:
        s = fleet.DistributedStrategy()
        s.localsgd = True
        s.localsgd_configs = {"k_steps": k_steps}
        fleet.init(strategy=s, device="cpu")
        step = fleet.distributed_model(model, opt, loss_fn=loss_fn)
    else:
        step = LocalSGDStep(model, opt, loss_fn, mesh=init_mesh({axis: 2}),
                            k_steps=k_steps, axis=axis)
    try:
        losses, replicas, masters = [], [], []
        for b in job["batches"]:
            losses.append(float(step(b)))
            replicas.append(_np(step.replica_params()))
            masters.append(_np({k: v.clone() for k, v in step.opt_state.get(
                "master_weights", {}).items()}))
        avg = _np(step.averaged_params())
        return {"type": type(step).__name__, "k_steps": step.k_steps,
                "losses": losses, "replicas": replicas, "masters": masters,
                "dtypes": {k: str(p.dtype) for k, p in step.params.items()},
                "averaged": avg}
    finally:
        set_mesh(None)


# ------------------------------------------------------------ checkpoints
def ckpt_save(job, directory, steps):
    """Train ``steps`` batches of ``job`` and save the step's sharded
    state from every rank as one checkpoint: the gathered state after
    the save, and this rank's shard files' process tags."""
    from paddle_tpu_torch.distributed.checkpoint import save_state

    m = init_mesh(job["mesh"])
    try:
        step = _make_step(job)
        for b in job["batches"][:steps]:
            step(b)
        tree, shardings = step.sharded_state_dict()
        save_state(tree, directory, shardings=shardings)
        sd = step.state_dict()
        return {"params": _np(sd["params"]),
                "opt_state": _np({k: v for k, v in sd["opt_state"].items()
                                  if isinstance(v, dict)}),
                "count": sd["count"]}
    finally:
        set_mesh(None)


def ckpt_load(job, directory, steps, save_to=None):
    """Build ``job``'s step on its mesh, restore ``directory`` through
    ``load_state(shardings=)`` (then, with ``save_to``, save the restored
    state there from every rank), train the next ``steps`` batches: the
    gathered state right after the restore and the losses after it."""
    from paddle_tpu_torch.distributed.checkpoint import (last_load_stats,
                                                         load_state,
                                                         save_state)

    m = init_mesh(job["mesh"])
    try:
        step = _make_step(job)
        _, shardings = step.sharded_state_dict()
        flat = load_state(directory, shardings=shardings)
        step.set_sharded_state_dict(flat)
        if save_to is not None:
            tree, shardings = step.sharded_state_dict()
            save_state(tree, save_to, shardings=shardings)
        sd = step.state_dict()
        out = {"params": _np(sd["params"]),
               "opt_state": _np({k: v for k, v in sd["opt_state"].items()
                                 if isinstance(v, dict)}),
               "count": sd["count"],
               "local": {k: tuple(v.shape) for k, v in flat.items()
                         if isinstance(v, torch.Tensor)},
               "stats": last_load_stats()}
        done = out["count"]
        out["losses"] = [float(step(b))
                         for b in job["batches"][done:done + steps]]
        return out
    finally:
        set_mesh(None)


def prefetch_sharded(batches, spec):
    """Every batch through prefetch_to_device(mesh=, spec=) on the CPU:
    this rank's slices."""
    from paddle_tpu_torch.distributed.mesh import PartitionSpec
    from paddle_tpu_torch.io.device_prefetch import prefetch_to_device

    m = init_mesh(dp=2)
    try:
        it = prefetch_to_device(iter(batches), mesh=m,
                                spec=PartitionSpec(*spec), device="cpu")
        got = [_np(b) for b in it]
        it.close()
        return got
    finally:
        set_mesh(None)


def supervised_save(job, root, steps):
    """Train ``steps`` batches of ``job`` and cut a checkpoint through
    ``TrainingSupervisor.save_now`` (a collective: every rank gathers the
    full state; process 0 writes it): the gathered parameters."""
    from paddle_tpu_torch.framework.supervisor import (RecoveryPolicy,
                                                       TrainingSupervisor)

    m = init_mesh(job["mesh"])
    try:
        step = _make_step(job)
        for b in job["batches"][:steps]:
            step(b)
        sup = TrainingSupervisor(step, RecoveryPolicy(
            checkpoint_dir=root, save_interval_steps=1, async_save=False))
        sup.save_now()
        sup.checkpoint.wait()
        return _np(step.state_dict()["params"])
    finally:
        set_mesh(None)

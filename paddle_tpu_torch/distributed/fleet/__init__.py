"""Fleet — the high-level distributed facade (port of
``paddle_tpu/distributed/fleet/__init__.py``).

``init`` joins the world (``env.init_parallel_env``) and builds the mesh
from ``strategy.hybrid_configs``; ``distributed_model`` returns a
:class:`~paddle_tpu_torch.distributed.shard.DistributedTrainStep`
configured from the strategy (ZeRO stage, gradient merge,
fp16_allreduce); ``distributed_optimizer`` applies the LARS/DGC rewrites.
The parameter-server functions (``init_server``, ``run_server``,
``init_worker``, ``stop_worker``, ``save_persistables``) drive
:func:`~paddle_tpu_torch.distributed.ps.get_ps_context`, and
``fleet.metrics`` reduces metrics across trainers.
"""
from __future__ import annotations

from typing import Optional

from .. import env as _env
from ..mesh import HybridCommunicateGroup, get_mesh, init_mesh
from . import metrics  # noqa: F401  (fleet.metrics.sum/auc/... namespace)
from .strategy import DistributedStrategy

__all__ = ["DistributedStrategy", "init", "get_hybrid_communicate_group",
           "worker_index", "worker_num", "is_first_worker", "barrier_worker",
           "distributed_model", "distributed_optimizer", "init_server",
           "run_server", "init_worker", "stop_worker", "save_persistables"]

_fleet_state = {"strategy": None, "hcg": None, "initialized": False}


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, *, backend=None,
         device=None):
    """``fleet.init``: join the world (``backend``/``device`` as
    ``init_parallel_env`` takes them) and build the mesh from
    ``strategy.hybrid_configs`` (the reference builds its
    HybridCommunicateGroup from the same dict). ``is_collective=False``
    (the parameter-server mode) does the same, as the reference does; the
    PS communicator mode follows ``strategy.a_sync``."""
    del role_maker, is_collective
    strategy = strategy or DistributedStrategy()
    _env.init_parallel_env(backend=backend, device=device)
    hc = strategy.hybrid_configs
    shape = {}
    mapping = {"pp_degree": "pp", "dp_degree": "dp", "sharding_degree": "sdp",
               "mp_degree": "mp", "sp_degree": "sp", "ep_degree": "ep"}
    for key, axis in mapping.items():
        deg = hc.get(key, 1)
        if deg and deg != 1:
            shape[axis] = deg
    if not shape:
        shape = {"dp": -1}
    elif "dp" not in shape and hc.get("dp_degree", 1) == 1:
        # absorb remaining ranks into dp
        n = _env.get_world_size()
        used = 1
        for v in shape.values():
            used *= v
        if n % used == 0 and n // used > 1:
            shape["dp"] = n // used
    mesh = init_mesh(shape)
    _fleet_state.update(strategy=strategy, hcg=HybridCommunicateGroup(mesh),
                        initialized=True)
    # PS communicator mode (sync/async/geo), derived from
    # a_sync/a_sync_configs the way the_one_ps.py does — applied
    # UNCONDITIONALLY so a later plain init resets a prior async mode
    from ..ps import get_ps_context

    get_ps_context().configure_mode(strategy)
    return mesh


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    return _fleet_state["hcg"]


def worker_index() -> int:
    return _env.get_rank()


def worker_num() -> int:
    return _env.get_world_size()


def is_first_worker() -> bool:
    return _env.get_rank() == 0


def barrier_worker():
    _env.barrier()


def distributed_model(model, optimizer=None, loss_fn=None, inputs_fn=None,
                      **kw):
    """Wrap model + optimizer into a ``DistributedTrainStep`` configured
    from the active strategy (the reference dispatches to DataParallel /
    TensorParallel / PipelineParallel wrappers; one step covers data,
    tensor and ZeRO parallelism here), or a ``LocalSGDStep`` under
    ``strategy.localsgd``."""
    from ..shard import DistributedTrainStep

    strategy: DistributedStrategy = (_fleet_state["strategy"]
                                     or DistributedStrategy())
    if strategy.localsgd:
        from ..parallel.localsgd import LocalSGDStep

        cfg = strategy.localsgd_configs or {}
        return LocalSGDStep(model, optimizer, loss_fn=loss_fn,
                            mesh=get_mesh(),
                            k_steps=int(cfg.get("k_steps", 4)),
                            inputs_fn=inputs_fn)
    if strategy.pipeline:
        raise NotImplementedError(
            "strategy.pipeline: the pipeline schedule is not ported "
            "(ROADMAP A8, pipeline)")
    stage = strategy.sharding_stage
    if strategy.gradient_merge and "grad_accum_steps" not in kw:
        cfg = strategy.gradient_merge_configs or {}
        kw["grad_accum_steps"] = int(cfg.get("k_steps", 1))
        kw["grad_accum_avg"] = bool(cfg.get("avg", True))
    if strategy.fp16_allreduce and "grad_transform" not in kw:
        # reference fp16_allreduce_optimizer: gradients lose what a float16
        # reduction would; cast them to float16 and back before the update
        import torch

        kw["grad_transform"] = lambda grads: {
            k: None if g is None else g.to(torch.float16).to(g.dtype)
            for k, g in grads.items()}
    return DistributedTrainStep(model, optimizer, loss_fn=loss_fn,
                                inputs_fn=inputs_fn, mesh=get_mesh(),
                                sharding_stage=stage, **kw)


def distributed_optimizer(optimizer, strategy=None):
    """A pass-through (the step reduces gradients and shards the optimizer
    state) except for the reference's kept rewrites: ``strategy.lars``
    wraps Momentum into LarsMomentum and ``strategy.dgc`` into
    DGCMomentum."""
    if strategy is not None:
        _fleet_state["strategy"] = strategy
    strategy = _fleet_state["strategy"]
    if strategy is not None and strategy.dgc:
        from ...optimizer import DGCMomentum, Momentum

        if isinstance(optimizer, Momentum) and \
                not isinstance(optimizer, DGCMomentum):
            cfg = strategy.dgc_configs or {}
            optimizer = DGCMomentum(
                learning_rate=optimizer._learning_rate,
                momentum=optimizer.momentum,
                rampup_begin_step=cfg.get("rampup_begin_step", 0),
                rampup_step=cfg.get("rampup_step", 1),
                sparsity=cfg.get("sparsity", [0.999]),
                parameters=optimizer._parameters,
                grad_clip=optimizer.grad_clip,
                multi_precision=optimizer.multi_precision)
    if strategy is not None and strategy.lars:
        from ...optimizer import LarsMomentum, Momentum

        if isinstance(optimizer, Momentum) and \
                not isinstance(optimizer, LarsMomentum):
            cfg = strategy.lars_configs or {}
            optimizer = LarsMomentum(
                learning_rate=optimizer._learning_rate,
                momentum=optimizer.momentum,
                lars_coeff=cfg.get("lars_coeff", 0.001),
                lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
                epsilon=cfg.get("epsilon", 1e-8),
                exclude_from_weight_decay=cfg.get(
                    "exclude_from_weight_decay"),
                parameters=optimizer._parameters,
                multi_precision=optimizer.multi_precision,
                grad_clip=optimizer.grad_clip)
    return optimizer


# ------------------------------------------------------------------ PS mode
# Reference: fleet.init_server/init_worker/run_server/stop_worker
# (python/paddle/distributed/fleet/fleet.py) backed by the_one_ps.py. Here
# the PS is the in-proc local client (distributed/ps/__init__.py).
def init_server(*model_dir, **kw):
    from ..ps import get_ps_context

    ctx = get_ps_context()
    ctx.init_server()
    if model_dir:
        ctx.load_persistables(model_dir[0])
    return ctx


def run_server():
    from ..ps import get_ps_context

    return get_ps_context()


def init_worker():
    from ..ps import get_ps_context

    get_ps_context().init_worker()


def stop_worker():
    from ..ps import get_ps_context

    get_ps_context().stop_server()


def save_persistables(dirname: str, *a, **kw):
    from ..ps import get_ps_context

    get_ps_context().save_persistables(dirname)

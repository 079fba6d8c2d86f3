"""DistributedStrategy (port of
``paddle_tpu/distributed/fleet/strategy.py:70``; host-only, copied and
adapted).

Every reference strategy field is CLASSIFIED, as in the reference:

- ``_CONSUMED`` — drives behavior (mesh axes through ``hybrid_configs``,
  the ZeRO stage through ``sharding`` / ``sharding_configs``, gradient
  merge, fp16_allreduce, LARS/DGC optimizer wrapping, ...). Of these the
  port's ``fleet`` acts on the mesh, ZeRO, gradient merge,
  fp16_allreduce and LocalSGD; the pipeline mode raises where it is used
  (ROADMAP A8);
- ``_COLLAPSED`` — knobs of the reference's NCCL/brpc/cuDNN runtime that
  this framework accepts and stores so ported configs keep working, with
  the reason on record;
- anything else — raises AttributeError at assignment, so a typo'd or
  unsupported knob is never silently ignored.
"""
from __future__ import annotations

from typing import Any, Dict

# reference knobs accepted and stored without effect; the value is the
# reason (also the user-facing documentation, via `explain`)
_COLLAPSED: Dict[str, str] = {
    "sync_nccl_allreduce": "the step waits for each bucket before the update",
    "nccl_comm_num": "one communicator per mesh axis",
    "use_hierarchical_allreduce": "one process group per mesh axis; NCCL "
                                  "picks its own algorithm",
    "hierarchical_allreduce_inter_nranks": "see use_hierarchical_allreduce",
    "sync_batch_norm": "use nn.SyncBatchNorm / mesh-axis BN explicitly",
    "fuse_all_reduce_ops": "buckets fuse gradients (overlap_grad_reduce)",
    "fuse_grad_size_in_MB": "use bucket_size_mb on DistributedTrainStep",
    "fuse_grad_size_in_num": "use bucket_count on DistributedTrainStep",
    "fuse_grad_merge": "the accumulators are per parameter",
    "calc_comm_same_stream": "collectives run on the backend's own streams",
    "cudnn_exhaustive_search": "no cuDNN convolutions on this path",
    "conv_workspace_size_limit": "no cuDNN workspaces",
    "cudnn_batchnorm_spatial_persistent": "no cuDNN",
    "without_graph_optimization": "eager execution: no graph passes",
    "heter_ccl_mode": "one SPMD program; no heterogeneous CCL",
    "split_data": "DistributedTrainStep splits the global batch itself",
    "adam_d2sum": "server-side accessor detail; see ps accessors",
    "semi_auto": "specs are declared by the layers",
    "auto_search": "auto_parallel is not ported",
    "build_strategy": "SSA-graph build options have no eager analogue",
    "execution_strategy": "executor knobs collapse to the eager step",
    "gradient_scale_configs": "loss scaling lives in amp.GradScaler",
    "trainer_desc_configs": "no TrainerDesc proto; the step is the trainer",
    "downpour_table_param": "tables configure via ps accessors",
    "fs_client_param": "no HDFS client; use filesystem paths",
    "qat": "use paddle_tpu_torch.quantization directly",
    "qat_configs": "use paddle_tpu_torch.quantization directly",
    "auto": "auto_parallel is not ported",
    "elastic": "elastic membership lives in the launcher",
    "asp": "apply pruning masks explicitly",
    "tensor_parallel": "declare mp_degree in hybrid_configs instead",
    "tensor_parallel_configs": "declare mp_degree in hybrid_configs instead",
    "is_fl_ps_mode": "the parameter server is not ported",
    "with_coordinator": "the parameter server is not ported",
}

# accepted as fields but raising when ENABLED: not implemented, and
# pretending otherwise would silently train without the feature
_UNSUPPORTED_WHEN_TRUE = {
    "adaptive_localsgd": "use localsgd with an explicit k_steps schedule",
}


class DistributedStrategy:
    # fields this framework CONSUMES (set + read by fleet/TrainStep/PS)
    _CONSUMED = {
        "hybrid_configs", "sharding", "sharding_configs",
        "amp", "amp_configs", "recompute", "recompute_configs",
        "gradient_merge", "gradient_merge_configs",
        "pipeline", "pipeline_configs",
        "a_sync", "a_sync_configs",
        "find_unused_parameters",
        "lamb", "lamb_configs", "lars", "lars_configs",
        "localsgd", "localsgd_configs",
        "adaptive_localsgd_configs",
        "dgc", "dgc_configs",
        "fp16_allreduce",
        "mode",
    }

    def __init__(self):
        # mesh topology (reference hybrid_configs)
        self.hybrid_configs: Dict[str, int] = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sp_degree": 1, "ep_degree": 1,
        }
        # ZeRO stage 0-3 (reference sharding_configs / group_sharded levels)
        self.sharding = False
        self.sharding_configs: Dict[str, Any] = {"stage": 1}
        # AMP
        self.amp = False
        self.amp_configs: Dict[str, Any] = {"level": "O1", "dtype": "bfloat16",
                                            "init_loss_scaling": 2.0 ** 15}
        # recompute
        self.recompute = False
        self.recompute_configs: Dict[str, Any] = {"checkpoints": [], "policy": None}
        # gradient merge / accumulation
        self.gradient_merge = False
        self.gradient_merge_configs: Dict[str, Any] = {"k_steps": 1, "avg": True}
        # pipeline
        self.pipeline = False
        self.pipeline_configs: Dict[str, Any] = {"accumulate_steps": 1,
                                                 "schedule_mode": "1F1B"}
        # parameter server mode (reference a_sync / a_sync_configs)
        self.a_sync = False
        self.a_sync_configs: Dict[str, Any] = {"k_steps": 0, "geo": False}
        self.find_unused_parameters = False
        self.lamb = False
        self.lamb_configs: Dict[str, Any] = {}
        # LARS (consumed: distributed_optimizer wraps Momentum into
        # LarsMomentum with these knobs)
        self.lars = False
        self.lars_configs: Dict[str, Any] = {
            "lars_coeff": 0.001, "lars_weight_decay": 0.0005,
            "epsilon": 1e-8}
        # LocalSGD (consumed: distributed_model returns a LocalSGDStep)
        self.localsgd = False
        self.localsgd_configs: Dict[str, Any] = {"k_steps": 4}
        self.adaptive_localsgd_configs: Dict[str, Any] = {"init_k_steps": 1}
        # deep gradient compression (consumed: distributed_optimizer wraps
        # Momentum into DGCMomentum — top-k sparsified, residual-corrected)
        self.dgc = False
        self.dgc_configs: Dict[str, Any] = {"rampup_begin_step": 0,
                                            "rampup_step": 1,
                                            "sparsity": [0.999]}
        # cast grads to fp16 for the reduction, restore after (consumed:
        # distributed_model installs the cast as a grad transform)
        self.fp16_allreduce = False
        self.mode = "collective"

    @property
    def sharding_stage(self) -> int:
        if not self.sharding:
            return 0
        return int(self.sharding_configs.get("stage", 1))

    def __setattr__(self, name, value):
        if name in _UNSUPPORTED_WHEN_TRUE and value:
            raise NotImplementedError(
                f"strategy.{name} is not implemented: "
                f"{_UNSUPPORTED_WHEN_TRUE[name]}")
        if name.startswith("_") or name in self._CONSUMED \
                or name in _COLLAPSED or name in _UNSUPPORTED_WHEN_TRUE:
            object.__setattr__(self, name, value)
            return
        raise AttributeError(
            f"DistributedStrategy has no field {name!r}: it is neither "
            f"consumed by this framework nor a documented collapsed-by-"
            f"design knob (see strategy.explain()). Refusing to silently "
            f"ignore it.")

    def __getattr__(self, name):
        # collapsed knobs read back their default-ish falsy value;
        # unsupported knobs read False (only truthy WRITES raise)
        if name in _COLLAPSED:
            return None
        if name in _UNSUPPORTED_WHEN_TRUE:
            return False
        raise AttributeError(name)

    @staticmethod
    def explain(name: str = None):
        """Why a reference knob is accepted-but-inert here; with no name,
        the whole collapsed-by-design table."""
        if name is None:
            return dict(_COLLAPSED)
        return _COLLAPSED.get(name)

    def __repr__(self):
        fields = {k: v for k, v in self.__dict__.items()}
        return f"DistributedStrategy({fields})"

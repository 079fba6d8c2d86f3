"""Distributed training over ``torch.distributed`` (port of
``paddle_tpu/distributed``): the process world (``env``), the named mesh
(``mesh``), collectives over mesh axes (``collective``), the
tensor-parallel layers (``parallel.mp_layers``), the bucketed gradient
reduction (``overlap``), the hybrid-parallel ``DistributedTrainStep``
(``shard``) and ``fleet``; plus checkpoints, fault tolerance, rpc, the
parameter-server and graph services, the launcher (``launch``), the
elastic mesh (``elastic_mesh``), LocalSGD (``parallel.localsgd``) and the
API's long tail (``api_compat``: groups, P2P, ``group_sharded_parallel``;
``stream``). The reference's names are kept, and its submodules
``checkpoint``, ``elastic_mesh``, ``ps``, ``resilience``, ``rpc`` and
``stream`` are bound here as they are there. Importing this package
builds and loads nothing: the native runtime is built by its first
use."""
from . import checkpoint, collective, env, fleet, overlap  # noqa: F401
from . import ps, resilience, rpc  # noqa: F401
from . import api_compat, elastic_mesh, stream  # noqa: F401
from .api_compat import (  # noqa: F401
    CountFilterEntry, Group, P2POp, ParallelEnv, ParallelMode,
    ProbabilityEntry, ShowClickEntry, all_gather_object, alltoall_single,
    batch_isend_irecv, destroy_process_group, get_group,
    group_sharded_parallel, irecv, isend, new_group, recv, reduce,
    save_group_sharded_model, scatter, send, split, wait,
)
from .elastic_mesh import (  # noqa: F401
    plan_mesh_shape, rescale_batch, reshaped_mesh,
)
from ..io.slot_dataset import BoxPSDataset, QueueDataset  # noqa: F401
from .checkpoint import (  # noqa: F401
    AsyncSaver, AutoCheckpoint, CheckpointCorruptError, last_load_stats,
    latest_checkpoint, load_state, mesh_info, save_state,
    validate_checkpoint,
)
from .collective import (  # noqa: F401
    ReduceOp, all_gather, all_reduce, all_reduce_buckets, alltoall,
    broadcast, ppermute, reduce_scatter, shift_left, shift_right,
)
from .env import (  # noqa: F401
    barrier, get_rank, get_world_size, init_parallel_env, is_initialized,
)
from .mesh import (  # noqa: F401
    HybridCommunicateGroup, P, PartitionSpec, axis_size, get_mesh,
    init_mesh, mesh_scope, require_mesh, set_mesh,
)
from .overlap import (  # noqa: F401
    BucketedReduce, GradBucket, bucket_order, bucketed_reduce,
    build_buckets, shard_first_free_dim, weight_update_specs,
)
from .parallel import DataParallel, mp_layers  # noqa: F401
from .parallel import recompute as recompute_mod  # noqa: F401
from .ps.graph import GraphDataGenerator, GraphTable  # noqa: F401
from .parallel.recompute import recompute  # noqa: F401
from .resilience import (  # noqa: F401
    FaultPlan, FaultRule, InjectedFault, RetryPolicy, fault_point,
    with_timeout,
)
from .shard import (  # noqa: F401
    DistributedTrainStep, opt_state_specs, param_specs, shard_model,
    shard_params,
)

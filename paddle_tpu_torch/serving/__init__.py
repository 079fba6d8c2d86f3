"""Continuous-batching serving (port of ``paddle_tpu/serving``): the
scheduler, metrics, prefix block pool, engine and server, and the fleet
around them — ``ReplicaRouter`` over local and remote replicas
(``RemoteReplica``, an ``InferenceServer`` in another process over
``distributed.rpc``) and disaggregated prefill/decode (``DisaggClient``)
moving KV blocks between pools in the reference's wire format.
Multi-tenant LoRA serving takes ``adapter_store=`` on the server (or
engine) and ``adapter_id=`` per request; see :mod:`paddle_tpu_torch.lora`.
``Autoscaler`` grows and drains a router's fleet on SLO burn, spawning
replicas through ``ProcessReplicaSpawner``."""
from ..lora.store import AdapterError, AdapterStore
from .autoscaler import Autoscaler, ProcessReplicaSpawner
from .disagg import DisaggClient, PrefixIndex, warm_boot_env
from .engine import ContinuousBatchingEngine, SlotEvent
from .metrics import LatencyHistogram, ServingMetrics
from .prefix_cache import BlockPool, PrefixHit, StorePlan, chain_digests
from .remote import RemoteHandle, RemoteReplica, ReplicaUnreachable
from .router import (ACTIVE, DEAD, DRAINING, SUSPECT, NoReplicasAvailable,
                     ReplicaRouter, RouterHandle)
from .scheduler import (BASE_TENANT, Backpressure, Deadline, FifoScheduler,
                        Overloaded, QueueFull, RateLimited, Request,
                        SchedulerClosed, TokenBucket)
from .server import InferenceServer, RequestHandle

__all__ = ["AdapterError", "AdapterStore", "Autoscaler",
           "ProcessReplicaSpawner", "DisaggClient", "PrefixIndex",
           "warm_boot_env", "ContinuousBatchingEngine", "SlotEvent",
           "LatencyHistogram", "ServingMetrics", "BlockPool", "PrefixHit", "StorePlan", "chain_digests",
           "RemoteHandle", "RemoteReplica", "ReplicaUnreachable", "ACTIVE", "DEAD", "DRAINING", "SUSPECT",
           "NoReplicasAvailable", "ReplicaRouter", "RouterHandle",
           "BASE_TENANT", "Backpressure", "Deadline", "FifoScheduler",
           "Overloaded", "QueueFull", "RateLimited", "Request",
           "SchedulerClosed", "TokenBucket", "InferenceServer",
           "RequestHandle"]

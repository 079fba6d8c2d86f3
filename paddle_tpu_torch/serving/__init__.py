"""Continuous-batching serving (port of ``paddle_tpu/serving``: the
scheduler, metrics, prefix block pool, engine and server). Multi-tenant
LoRA serving takes ``adapter_store=`` on the server (or engine) and
``adapter_id=`` per request; see :mod:`paddle_tpu_torch.lora`."""
from ..lora.store import AdapterError, AdapterStore
from .engine import ContinuousBatchingEngine, SlotEvent
from .metrics import LatencyHistogram, ServingMetrics
from .prefix_cache import BlockPool, PrefixHit, StorePlan, chain_digests
from .scheduler import (BASE_TENANT, Backpressure, Deadline, FifoScheduler,
                        Overloaded, QueueFull, RateLimited, Request,
                        SchedulerClosed, TokenBucket)
from .server import InferenceServer, RequestHandle

__all__ = ["AdapterError", "AdapterStore", "ContinuousBatchingEngine",
           "SlotEvent", "LatencyHistogram", "ServingMetrics", "BlockPool", "PrefixHit", "StorePlan",
           "chain_digests", "BASE_TENANT", "Backpressure", "Deadline",
           "FifoScheduler", "Overloaded", "QueueFull", "RateLimited",
           "Request", "SchedulerClosed", "TokenBucket", "InferenceServer",
           "RequestHandle"]

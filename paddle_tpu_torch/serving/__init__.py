"""Continuous-batching serving (port of ``paddle_tpu/serving``: the
scheduler, metrics, prefix block pool, engine and server)."""
from .engine import ContinuousBatchingEngine, SlotEvent
from .metrics import LatencyHistogram, ServingMetrics
from .prefix_cache import BlockPool, PrefixHit, StorePlan, chain_digests
from .scheduler import (BASE_TENANT, Backpressure, Deadline, FifoScheduler,
                        Overloaded, QueueFull, RateLimited, Request,
                        SchedulerClosed, TokenBucket)
from .server import InferenceServer, RequestHandle

__all__ = ["ContinuousBatchingEngine", "SlotEvent", "LatencyHistogram",
           "ServingMetrics", "BlockPool", "PrefixHit", "StorePlan",
           "chain_digests", "BASE_TENANT", "Backpressure", "Deadline",
           "FifoScheduler", "Overloaded", "QueueFull", "RateLimited",
           "Request", "SchedulerClosed", "TokenBucket", "InferenceServer",
           "RequestHandle"]

"""Continuous-batching serving (port of ``paddle_tpu/serving``: the
scheduler, metrics, engine and server)."""
from .engine import ContinuousBatchingEngine, SlotEvent
from .metrics import LatencyHistogram, ServingMetrics
from .scheduler import (Backpressure, Deadline, FifoScheduler, QueueFull,
                        Request, SchedulerClosed)
from .server import InferenceServer, RequestHandle

__all__ = ["ContinuousBatchingEngine", "SlotEvent", "LatencyHistogram",
           "ServingMetrics", "Backpressure", "Deadline", "FifoScheduler",
           "QueueFull", "Request", "SchedulerClosed", "InferenceServer",
           "RequestHandle"]

"""FIFO request queue with admission control for the serving loop (port of
``paddle_tpu/serving/scheduler.py:73-468``: the FIFO path).

The queue has a hard depth cap, and an over-capacity ``submit`` raises
:class:`QueueFull` at once: a bounded, observable reject beats an
unbounded queue whose tail latency quietly grows. :class:`QueueFull`
subclasses ``ConnectionError`` (via :class:`Backpressure`), so a client
that wants to wait retries it like any transport failure. A per-request
:class:`Deadline` bounds queue wait: expired requests are handed back to
the server to fail with ``TimeoutError`` instead of being prefilled.

``max_prefills_per_step`` bounds how many admissions (each one prefill)
run between two decode steps, so a burst of arrivals cannot starve the
inter-token latency of requests already decoding.

Overload shedding, per-tenant token buckets and fair queueing of the
reference are not ported yet.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = ["Backpressure", "QueueFull", "SchedulerClosed", "Deadline",
           "Request", "FifoScheduler"]

_req_serial = itertools.count()


class Backpressure(ConnectionError):
    """The server is over capacity right now; retrying later is expected
    to succeed."""


class QueueFull(Backpressure):
    """The admission queue is at its depth cap."""


class SchedulerClosed(RuntimeError):
    """Submit after shutdown began — not retryable."""


class Deadline:
    """A monotonic time budget stamped at creation."""

    def __init__(self, seconds: float):
        self.total = float(seconds)
        self._end = time.monotonic() + self.total

    def remaining(self) -> float:
        return self._end - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0


@dataclass
class Request:
    """One generation request plus its per-slot sampling state.
    ``attempts`` counts admissions (the crash-recovery requeue budget)."""

    prompt: object
    max_new_tokens: int = 32
    greedy: bool = True
    temperature: float = 1.0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: Optional[int] = None
    deadline: Optional[Deadline] = None
    id: int = field(default_factory=lambda: next(_req_serial))
    attempts: int = 0
    handle: object = None  # back-pointer set by the server


class FifoScheduler:
    """Thread-safe bounded FIFO with deadline expiry and an admission-rate
    cap. Any thread may submit; the serving worker is the only consumer."""

    def __init__(self, max_queue_depth: int = 64,
                 max_prefills_per_step: int = 2):
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if max_prefills_per_step < 1:
            raise ValueError("max_prefills_per_step must be >= 1")
        self.max_queue_depth = int(max_queue_depth)
        self.max_prefills_per_step = int(max_prefills_per_step)
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._closed = False

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def submit(self, request: Request) -> None:
        with self._lock:
            if self._closed:
                raise SchedulerClosed("scheduler is shut down")
            if len(self._q) >= self.max_queue_depth:
                raise QueueFull(
                    f"admission queue full ({self.max_queue_depth} "
                    f"requests waiting); retry with backoff")
            self._q.append(request)

    def requeue(self, request: Request) -> None:
        """Put a request BACK at the head (crash recovery). Bypasses the
        depth cap: the request was already admitted once."""
        with self._lock:
            self._q.appendleft(request)

    def take(self, free_slots: int) -> Tuple[List[Request], List[Request]]:
        """Pop up to ``min(free_slots, max_prefills_per_step)`` admittable
        requests. Returns ``(admit, expired)``: expired requests are popped
        and handed back for the caller to fail, never admitted."""
        admit: List[Request] = []
        expired: List[Request] = []
        budget = min(int(free_slots), self.max_prefills_per_step)
        with self._lock:
            while self._q and len(admit) < budget:
                req = self._q.popleft()
                if req.deadline is not None and req.deadline.expired():
                    expired.append(req)
                else:
                    admit.append(req)
        return admit, expired

    def pop_expired(self) -> List[Request]:
        """Sweep expired requests out of the queue without admitting any
        (so a doomed request fails at its deadline, not at its turn)."""
        with self._lock:
            expired = [r for r in self._q
                       if r.deadline is not None and r.deadline.expired()]
            if expired:
                gone = {id(r) for r in expired}
                self._q = deque(r for r in self._q if id(r) not in gone)
        return expired

    def seal(self) -> None:
        """Refuse new submits but keep the queue (graceful drain)."""
        with self._lock:
            self._closed = True

    def close(self) -> List[Request]:
        """Refuse new submits; return whatever is still queued."""
        with self._lock:
            self._closed = True
            rest = list(self._q)
            self._q.clear()
        return rest

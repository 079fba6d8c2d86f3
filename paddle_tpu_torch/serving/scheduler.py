"""Request queue with admission control for the serving loop (port of
``paddle_tpu/serving/scheduler.py:73-468``).

The queue has a hard depth cap, and an over-capacity ``submit`` raises
:class:`QueueFull` at once: a bounded, observable reject beats an
unbounded queue whose tail latency quietly grows. :class:`QueueFull`
subclasses ``ConnectionError`` (via :class:`Backpressure`), so a client
that wants to wait retries it like any transport failure. A per-request
:class:`Deadline` bounds queue wait: expired requests are handed back to
the server to fail with ``TimeoutError`` instead of being prefilled.

Overload shedding (``shed_on_overload=True``) is the deadline-aware half
of admission control: the scheduler keeps an EWMA of its admission
cadence (seconds between pops while work was waiting), so it can predict
each queued request's wait from its position. A request whose predicted
wait already exceeds its remaining deadline is shed with
:class:`Overloaded`, at submit or swept out of the queue body later. The
head of the queue is never shed, and requests without deadlines never
are. Default off.

``max_prefills_per_step`` bounds how many admissions (each one prefill)
run between two decode steps, so a burst of arrivals cannot starve the
inter-token latency of requests already decoding.

Per-tenant fairness (both knobs default off): a token bucket per tenant
(``tenant_rate``/``tenant_burst``, or overrides via ``tenant_limits``)
fast-fails an over-rate submit with :class:`RateLimited` (retryable
``Backpressure``), and ``fair_queueing=True`` turns ``take()`` into
deficit round-robin over tenant queues (weights via ``fair_weights``).
The buckets read the injected ``clock`` (``time.monotonic`` by
default), as in the reference.

The tenant of a request is its ``tenant`` field where set (the port's
server also names tenants with ``submit(tenant=...)``), else its LoRA
``adapter_id`` (the reference's key), else :data:`BASE_TENANT`.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Backpressure", "QueueFull", "Overloaded", "RateLimited",
           "SchedulerClosed", "Deadline", "Request", "FifoScheduler",
           "TokenBucket", "BASE_TENANT"]

#: tenant key for requests with no tenant or adapter (the base model is a
#: tenant too, otherwise unnamed traffic would be exempt from fairness)
BASE_TENANT = "__base__"

_req_serial = itertools.count()


class Backpressure(ConnectionError):
    """The server is over capacity right now; retrying later is expected
    to succeed."""


class QueueFull(Backpressure):
    """The admission queue is at its depth cap."""


class Overloaded(Backpressure):
    """Deadline-aware shed: the predicted queue wait already exceeds the
    request's remaining deadline, so it was failed FAST instead of being
    left to time out. Retryable (``ConnectionError`` via
    :class:`Backpressure`): this replica, a moment later, or another
    may have the headroom. Distinct from :class:`QueueFull`
    (depth cap) and from the ``TimeoutError`` of a deadline that
    actually lapsed in queue."""


class RateLimited(Backpressure):
    """Per-tenant token-bucket reject: this TENANT is over its admission
    rate right now, independent of queue depth. Retryable
    (``ConnectionError`` via :class:`Backpressure`): the bucket refills
    at ``rate`` tokens/s, so a client that backs off ``retry_after``
    seconds is expected to get in. Carries ``tenant`` so the reject can
    be attributed without parsing the message."""

    def __init__(self, message: str, tenant: str = "?",
                 retry_after: float = 0.0):
        super().__init__(message)
        self.tenant = tenant
        self.retry_after = float(retry_after)


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


class TokenBucket:
    """Classic token bucket over an injected monotonic clock reading.

    Not itself thread-safe: the scheduler serializes every touch under
    its own lock, and the caller passes ``now`` in so one lock-held
    clock read covers every bucket consulted in that submit."""

    __slots__ = ("rate", "burst", "_tokens", "_t")

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError("token bucket rate and burst must be > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._t is not None:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, now: float, n: float = 1.0) -> bool:
        self._refill(now)
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def level(self, now: float) -> float:
        """Current token count (refilled to ``now``)."""
        self._refill(now)
        return self._tokens

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0 if already)."""
        return max(0.0, (n - self._tokens) / self.rate)


@dataclass
class Request:
    """One generation request plus its per-slot sampling state.
    ``tenant`` and ``adapter_id`` name its fairness tenant (see
    :meth:`FifoScheduler.tenant_of`); ``attempts`` counts admissions
    (the crash-recovery requeue budget). ``corr_id`` is the tracing
    correlation id minted at the front door (router or server submit):
    every span the request touches is keyed by it, across replicas and
    requeues."""

    prompt: object
    max_new_tokens: int = 32
    greedy: bool = True
    temperature: float = 1.0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: Optional[int] = None
    deadline: Optional[Deadline] = None
    adapter_id: Optional[str] = None
    tenant: Optional[str] = None
    corr_id: Optional[str] = None
    id: int = field(default_factory=lambda: next(_req_serial))
    attempts: int = 0
    handle: object = None  # back-pointer set by the server


class FifoScheduler:
    """Thread-safe bounded FIFO with deadline expiry and an admission-rate
    cap. Any thread may submit; the serving worker is the only
    consumer."""

    #: EWMA smoothing for the admission-cadence estimate (seconds per
    #: admitted request); small enough to follow a degrading replica
    #: within a handful of pops, large enough not to chase one slow tick
    EWMA_ALPHA = 0.25

    def __init__(self, max_queue_depth: int = 64,
                 max_prefills_per_step: int = 2,
                 shed_on_overload: bool = False,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 tenant_limits: Optional[Dict[str, Tuple[float, float]]] = None,
                 fair_queueing: bool = False,
                 fair_weights: Optional[Dict[str, float]] = None,
                 clock=time.monotonic):
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if max_prefills_per_step < 1:
            raise ValueError("max_prefills_per_step must be >= 1")
        if tenant_rate is not None and tenant_rate <= 0:
            raise ValueError("tenant_rate must be > 0 when set")
        self.max_queue_depth = int(max_queue_depth)
        self.max_prefills_per_step = int(max_prefills_per_step)
        self.shed_on_overload = bool(shed_on_overload)
        # per-tenant admission rate limiting: default rate/burst for every
        # tenant, with (rate, burst) overrides per tenant name. Both None
        # and no overrides => no buckets, bit-identical admission.
        self.tenant_rate = None if tenant_rate is None else float(tenant_rate)
        self.tenant_burst = (float(tenant_burst) if tenant_burst is not None
                             else (max(1.0, self.tenant_rate)
                                   if self.tenant_rate is not None else None))
        self._tenant_limits = dict(tenant_limits or {})
        self.fair_queueing = bool(fair_queueing)
        self._fair_weights = dict(fair_weights or {})
        self._clock = clock          # buckets only; cadence EWMA stays on
        self._buckets: Dict[str, TokenBucket] = {}   # time.monotonic
        self._drr_deficit: Dict[str, float] = {}
        self._drr_next: Optional[str] = None
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._closed = False
        # admission cadence: seconds per admitted request, measured only
        # across intervals where work was actually waiting (an idle gap
        # says nothing about service speed). None until the first sample
        # — no shedding decision is made on zero evidence.
        self._svc_ewma: Optional[float] = None
        self._last_admit_t: Optional[float] = None

    @staticmethod
    def tenant_of(request: Request) -> str:
        """The fairness key: the request's ``tenant``, else its adapter
        id, else :data:`BASE_TENANT`."""
        for key in (request.tenant, request.adapter_id):
            if key is not None:
                return key
        return BASE_TENANT

    def _bucket_locked(self, tenant: str) -> Optional[TokenBucket]:
        bucket = self._buckets.get(tenant)
        if bucket is not None:
            return bucket
        if tenant in self._tenant_limits:
            rate, burst = self._tenant_limits[tenant]
        elif self.tenant_rate is not None:
            rate, burst = self.tenant_rate, self.tenant_burst
        else:
            return None   # rate limiting off for this tenant
        bucket = TokenBucket(rate, burst)
        self._buckets[tenant] = bucket
        return bucket

    def bucket_levels(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant token-bucket fill — only tenants that have
        submitted since startup appear (buckets are lazy)."""
        now = self._clock()
        with self._lock:
            return {t: {"tokens": round(b.level(now), 3),
                        "rate": b.rate, "burst": b.burst}
                    for t, b in sorted(self._buckets.items())}

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def predicted_wait(self, position: int) -> Optional[float]:
        """Predicted queue wait (seconds) for a request at ``position``
        (0 = next to pop), from the admission-cadence EWMA; ``None``
        before any cadence evidence exists."""
        with self._lock:
            return self._predicted_wait_locked(position)

    def _predicted_wait_locked(self, position: int) -> Optional[float]:
        if self._svc_ewma is None:
            return None
        return max(0, int(position)) * self._svc_ewma

    def submit(self, request: Request) -> None:
        with self._lock:
            if self._closed:
                raise SchedulerClosed("scheduler is shut down")
            tenant = self.tenant_of(request)
            bucket = self._bucket_locked(tenant)
            if bucket is not None and not bucket.try_take(self._clock()):
                # checked BEFORE the depth cap: an over-rate tenant gets
                # the reject attributed to ITS rate, not to fleet
                # capacity — and burns none of the shared queue
                retry_after = bucket.retry_after()
                raise RateLimited(
                    f"tenant {tenant!r} over its admission rate "
                    f"({bucket.rate:.3g}/s, burst {bucket.burst:.3g}); "
                    f"retry in {retry_after:.3f}s",
                    tenant=tenant, retry_after=retry_after)
            if len(self._q) >= self.max_queue_depth:
                raise QueueFull(
                    f"admission queue full ({self.max_queue_depth} "
                    f"requests waiting); retry with backoff")
            if self.shed_on_overload and request.deadline is not None:
                wait = self._predicted_wait_locked(len(self._q))
                if wait is not None and wait > request.deadline.remaining():
                    raise Overloaded(
                        f"request shed at admission: predicted queue wait "
                        f"{wait:.3f}s exceeds its remaining "
                        f"{max(0.0, request.deadline.remaining()):.3f}s "
                        f"deadline (queue depth {len(self._q)}); retry "
                        f"against another replica")
            if not self._q:
                # queue was idle: the admission clock starts with this
                # arrival — an idle gap must never be mistaken for
                # service time in the cadence EWMA
                self._last_admit_t = time.monotonic()
            self._q.append(request)

    def requeue(self, request: Request) -> None:
        """Put a request BACK at the head (crash recovery / preemption).
        Bypasses the depth cap — the request was already admitted once and
        rejecting it now would turn a recoverable fault into data loss."""
        with self._lock:
            self._q.appendleft(request)

    def take(self, free_slots: int) -> Tuple[List[Request], List[Request]]:
        """Pop up to ``min(free_slots, max_prefills_per_step)`` admittable
        requests. Returns ``(admit, expired)`` — expired requests (queue
        wait exceeded their deadline) are popped but handed back for the
        caller to fail, never admitted."""
        admit: List[Request] = []
        expired: List[Request] = []
        budget = min(int(free_slots), self.max_prefills_per_step)
        now = time.monotonic()
        with self._lock:
            if not self._q:
                # idle: reset the cadence clock so the NEXT admission
                # interval measures service, not the lull before it
                self._last_admit_t = now
            if self.fair_queueing:
                self._take_fair_locked(budget, admit, expired)
            else:
                while self._q and len(admit) < budget:
                    req = self._q.popleft()
                    if req.deadline is not None and req.deadline.expired():
                        expired.append(req)
                        continue
                    admit.append(req)
            if admit and self._last_admit_t is not None:
                per = max(0.0, now - self._last_admit_t) / len(admit)
                self._svc_ewma = (per if self._svc_ewma is None else
                                  (1.0 - self.EWMA_ALPHA) * self._svc_ewma
                                  + self.EWMA_ALPHA * per)
            if admit:
                self._last_admit_t = now
        return admit, expired

    def _take_fair_locked(self, budget: int, admit: List[Request],
                          expired: List[Request]) -> None:
        """Deficit round-robin over per-tenant FIFO views of the queue.

        Each round, every tenant with queued work earns ``weight``
        deficit (default 1.0) and admits its oldest requests while the
        deficit covers them (cost 1 each); a tenant whose queue empties
        forfeits its unspent deficit — idle time must not bank credit a
        returning flood could spend all at once. Service resumes after
        the tenant served last (``_drr_next``), so fairness holds across
        ``take()`` calls, not just within one. FIFO order is preserved
        within each tenant, and expired requests are popped for the
        caller to fail (costing no deficit) exactly as the plain path
        does."""
        per_tenant: "OrderedDict[str, deque]" = OrderedDict()
        for req in self._q:
            per_tenant.setdefault(self.tenant_of(req), deque()).append(req)
        names = list(per_tenant)
        if self._drr_next in per_tenant:
            i = names.index(self._drr_next)
            names = names[i:] + names[:i]
        for t in list(self._drr_deficit):
            if t not in per_tenant:   # no queued work: forfeit credit
                del self._drr_deficit[t]
        taken = set()
        last_served: Optional[str] = None
        while len(admit) < budget and any(per_tenant.values()):
            for name in names:
                q = per_tenant[name]
                if not q:
                    self._drr_deficit.pop(name, None)
                    continue
                self._drr_deficit[name] = (
                    self._drr_deficit.get(name, 0.0)
                    + max(1e-3, self._fair_weights.get(name, 1.0)))
                while q and self._drr_deficit[name] >= 1.0 \
                        and len(admit) < budget:
                    req = q.popleft()
                    taken.add(id(req))
                    if req.deadline is not None and req.deadline.expired():
                        expired.append(req)
                        continue
                    admit.append(req)
                    last_served = name
                    self._drr_deficit[name] -= 1.0
                if len(admit) >= budget:
                    break
        if taken:
            self._q = deque(r for r in self._q if id(r) not in taken)
        if last_served is not None:
            self._drr_next = names[(names.index(last_served) + 1)
                                   % len(names)]

    def pop_expired(self) -> List[Request]:
        """Sweep expired requests out of the queue without admitting
        anything (called even when no slot is free, so a doomed request
        fails at its deadline, not at its turn)."""
        expired: List[Request] = []
        with self._lock:
            keep = deque()
            for req in self._q:
                if req.deadline is not None and req.deadline.expired():
                    expired.append(req)
                else:
                    keep.append(req)
            self._q = keep
        return expired

    def pop_predicted_misses(self) -> List[Request]:
        """Sweep out queued requests whose PREDICTED wait (position x
        admission-cadence EWMA) exceeds their remaining deadline — the
        post-admission half of overload shedding, for when service
        degrades after a request was accepted. The queue head is never
        shed (position 0 predicts zero wait: it is next), so this only
        ever trims the doomed tail; the caller fails the returned
        requests with :class:`Overloaded`. No-op unless
        ``shed_on_overload`` and a cadence estimate exists."""
        if not self.shed_on_overload:
            return []
        shed: List[Request] = []
        with self._lock:
            if self._svc_ewma is None or not self._q:
                return []
            keep: deque = deque()
            for req in self._q:
                pos = len(keep)   # position among the requests kept ahead
                if (pos > 0 and req.deadline is not None
                        and pos * self._svc_ewma
                        > req.deadline.remaining()):
                    shed.append(req)
                else:
                    keep.append(req)
            self._q = keep
        return shed

    def seal(self) -> None:
        """Refuse new submits but KEEP the queue — the graceful-shutdown
        first half (the worker drains what was already accepted)."""
        with self._lock:
            self._closed = True

    def close(self) -> List[Request]:
        """Refuse new submits; return whatever is still queued (the
        caller decides: drain them or fail them)."""
        with self._lock:
            self._closed = True
            rest = list(self._q)
            self._q.clear()
        return rest

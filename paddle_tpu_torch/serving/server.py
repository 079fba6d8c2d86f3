"""Threaded serving front end: submit / stream / drain / survive faults
(port of ``paddle_tpu/serving/server.py``).

One daemon worker thread owns the engine (all device work is
single-threaded by construction); any number of client threads
``submit()`` and consume per-request streams. The loop per iteration:
sweep deadline-expired queue entries, admit up to
``max_prefills_per_step`` requests into free slots (each one bucketed
prefill), then run ONE decode step for the whole live batch and fan its
tokens out to the request handles. Finished slots free immediately — a
new request admits into the hole while everyone else keeps decoding.

Failure story:

- **backpressure**: an over-depth queue rejects at ``submit`` with
  :class:`~paddle_tpu_torch.serving.scheduler.QueueFull` (a
  ``ConnectionError``), an over-rate tenant with ``RateLimited``
  (``tenant_rate``/``tenant_burst``/``tenant_limits``), and, with
  ``shed_on_overload``, a request predicted to miss its deadline with
  ``Overloaded``, at submit or later from the queue body; sheds and
  rate-limit rejects are counted apart from failures;
- **deadlines**: a per-request deadline expires requests still in the
  queue (their handles raise ``TimeoutError``);
- **worker faults**: any exception in the serve loop (including
  ``fault_point("serve.admit")`` / ``("serve.step")`` injections from a
  ``FaultPlan``) resets the engine and requeues in-flight requests at the
  queue head, up to
  ``max_request_retries`` re-admissions each. Regeneration restarts from
  the request's seed, so a recovered request's ``result()`` is identical,
  but a live ``stream()`` may re-emit its prefix (at-least-once);
- **graceful shutdown**: ``shutdown(drain=True)`` seals admission, lets
  the loop finish every accepted request, then joins the worker;
  ``drain=False`` fails the backlog with ``SchedulerClosed``.

``prefix_cache=``, ``kv_dtype=`` and ``adapter_store=`` go to the
engine (block-pool prefix reuse, the int8 cache, multi-tenant LoRA;
``handle.cache_hit_tokens`` reports the reuse, ``submit(adapter_id=...)``
names the request's adapter), ``fair_queueing``/``fair_weights`` to the
scheduler (deficit round-robin over tenants: ``submit(tenant=...)``,
else the adapter id). An unknown adapter, or a store whose every row is
pinned, fails only that request at admission
(:class:`~paddle_tpu_torch.lora.AdapterError`), without an engine reset.

Observability, as the reference places it: every request carries a
tracing correlation id (``submit(correlation_id=...)`` or a fresh one) and
leaves ``submit`` / ``queue_wait`` / ``prefill`` / ``decode`` /
``stream_end`` spans and events in its lane (``shed``, ``expired``,
``rejected``, ``rate_limited`` where it ends early); an engine reset
notes and dumps the flight recorder with the in-flight ids; the server's
gauges feed the process metrics registry, which ``metrics_text()``,
``statusz()`` and ``probe()`` serve to the router and the remote host.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import time
import warnings
from typing import Iterator, Optional

import numpy as np

from .. import default_device
from ..distributed.resilience import fault_point
from ..lora.store import AdapterError, normalize_adapter_id
from ..observability import flight as _flight
from ..observability import registry as _obs_registry
from ..observability import tracing as _tracing
from ..profiler import RecordEvent
from .engine import ContinuousBatchingEngine
from .metrics import ServingMetrics
from .scheduler import (Deadline, FifoScheduler, Overloaded, QueueFull,
                        RateLimited, Request, SchedulerClosed)

__all__ = ["InferenceServer", "RequestHandle"]

_server_serial = itertools.count()


class RequestHandle:
    """Client-side view of one submitted request.

    ``stream()`` yields token ids as they are generated; ``result()``
    blocks for the full generated sequence. Thread-safe: the worker
    pushes, any client thread consumes."""

    def __init__(self, request: Request):
        self.request = request
        self._q: "queue.Queue" = queue.Queue()
        self._tokens = []
        self._lock = threading.Lock()
        self._done_evt = threading.Event()
        self.error: Optional[BaseException] = None
        self.ttft_s: Optional[float] = None
        #: prompt tokens served from the prefix cache at admission (0
        #: without a pool)
        self.cache_hit_tokens: int = 0
        self._submit_t = time.monotonic()
        # wall-clock twin of _submit_t: trace spans use time.time() so
        # fleet replicas merge onto one timeline (tools/trace_view.py)
        self._submit_wall = time.time()
        self._last_token_t: Optional[float] = None
        self._last_token_wall: Optional[float] = None

    # ---- worker-side (single writer: the serve loop) ----
    def _push(self, tok: int) -> None:
        with self._lock:
            self._tokens.append(int(tok))
        self._q.put(("tok", int(tok)))

    def _restart(self) -> None:
        with self._lock:
            self._tokens = []
        self._last_token_t = None
        self._q.put(("restart", None))

    def _finish(self) -> None:
        self._done_evt.set()
        self._q.put(("end", None))

    def _fail(self, exc: BaseException) -> None:
        self.error = exc
        self._done_evt.set()
        self._q.put(("err", exc))

    def _count(self) -> int:
        with self._lock:
            return len(self._tokens)

    # ---- client-side ----
    @property
    def done(self) -> bool:
        return self._done_evt.is_set()

    @property
    def adapter_id(self):
        """The tenant adapter this request decodes under (None = base)."""
        return self.request.adapter_id

    @property
    def correlation_id(self) -> Optional[str]:
        """The request's tracing correlation id — the key into
        ``observability.tracing.spans()`` / flight-recorder dumps."""
        return self.request.corr_id

    def tokens(self) -> np.ndarray:
        """Tokens generated SO FAR (snapshot; may grow)."""
        with self._lock:
            return np.asarray(self._tokens, np.int32)

    def stream(self) -> Iterator[int]:
        """Yield token ids as the worker emits them; ends when the
        request finishes, raises its error if it failed. After a
        crash-recovery restart the regenerated stream is re-emitted from
        the beginning (at-least-once delivery)."""
        while True:
            kind, val = self._q.get()
            if kind == "tok":
                yield val
            elif kind == "restart":
                continue
            elif kind == "end":
                return
            else:
                raise val

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request completes; returns the generated ids
        ``[n]`` (``n <= max_new_tokens``). Raises ``TimeoutError`` after
        ``timeout`` seconds, or the request's failure."""
        if not self._done_evt.wait(timeout):
            raise TimeoutError(
                f"request {self.request.id} not finished within "
                f"{timeout}s ({self._count()} tokens so far)")
        if self.error is not None:
            raise self.error
        return self.tokens()


class InferenceServer:
    """Continuous-batching server around a causal LM exposing
    ``cache_spec()`` and the cached forward (the GPT and Llama families).

    ``slots`` fixes the decode batch geometry; ``top_k``/``allow_top_p``
    are server-wide sampling settings; every other sampling knob is per
    request. The serving options take the reference's defaults (all
    off). ``device=None`` means ``cuda`` (``RuntimeError`` without a
    GPU); the model's parameters must already live on that device."""

    def __init__(self, network, slots: int = 4,
                 max_length: Optional[int] = None,
                 prefill_buckets=None,
                 max_queue_depth: int = 64,
                 max_prefills_per_step: int = 2,
                 top_k: int = 0, allow_top_p: bool = True,
                 max_request_retries: int = 1,
                 prefix_cache=None, adapter_store=None,
                 shed_on_overload: bool = False,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: Optional[float] = None,
                 tenant_limits=None,
                 fair_queueing: bool = False,
                 fair_weights=None, kv_dtype=None, device=None):
        device = default_device(device)
        if network.device.type != device.type or (
                device.index is not None and network.device != device):
            raise ValueError(f"the model lives on {network.device}, the "
                             f"server was asked for {device}")
        self.device = device
        self.engine = ContinuousBatchingEngine(
            network, slots=slots, max_length=max_length,
            prefill_buckets=prefill_buckets, top_k=top_k,
            allow_top_p=allow_top_p, prefix_cache=prefix_cache,
            adapter_store=adapter_store, kv_dtype=kv_dtype)
        self.scheduler = FifoScheduler(
            max_queue_depth=max_queue_depth,
            max_prefills_per_step=max_prefills_per_step,
            shed_on_overload=shed_on_overload,
            tenant_rate=tenant_rate, tenant_burst=tenant_burst,
            tenant_limits=tenant_limits, fair_queueing=fair_queueing,
            fair_weights=fair_weights)
        self.metrics = ServingMetrics(slots)
        self.max_request_retries = int(max_request_retries)
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._drain = True
        # this server's live state rides every registry scrape: queue
        # depth, slot occupancy, call counters, and the pool/store
        # occupancy blocks. Weak (bound-method) collector: a collected
        # server drops out of the scrape instead of raising.
        self._obs_label = f"srv{next(_server_serial)}"
        _obs_registry.default_registry().register_collector(
            self._obs_collect, labels={"server": self._obs_label},
            name=f"serving.{self._obs_label}")

    # ------------------------------------------------------------ client
    def start(self) -> "InferenceServer":
        with self._cv:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="pt-serve", daemon=True)
                self._thread.start()
        return self

    def submit(self, prompt, max_new_tokens: int = 32,
               do_sample: bool = False, temperature: float = 1.0,
               top_p: float = 1.0, eos_token_id: Optional[int] = None,
               seed: Optional[int] = None,
               deadline: Optional[float] = None,
               adapter_id: Optional[str] = None,
               tenant: Optional[str] = None,
               correlation_id: Optional[str] = None) -> RequestHandle:
        """Queue one generation request; returns at once with a
        :class:`RequestHandle`. Raises ``ValueError`` on an impossible
        request (too long for the cache), :class:`QueueFull` when the
        admission queue is at depth, ``RateLimited`` when ``tenant`` is
        over its admission rate, ``Overloaded`` when shedding predicts a
        missed deadline (all retryable backpressure), and
        :class:`SchedulerClosed` after shutdown.

        A ``seed`` makes the request's sampled stream deterministic and
        equal to a solo ``generate(..., seed=s)`` run; ``seed=None``
        draws fresh randomness per request. ``deadline`` (seconds) bounds
        QUEUE WAIT: a request that cannot start in time fails with
        ``TimeoutError``.

        ``adapter_id`` decodes the request under that tenant's LoRA
        adapter (the server's engine must carry an ``adapter_store`` that
        knows the name; ``None`` or ``"base"``: the base model); mixing
        adapters across the live batch is free. ``tenant`` names the
        request's tenant for the rate limits and fair queueing (``None``:
        the adapter id, else the base tenant).

        ``correlation_id`` keys the request's trace lane (queue wait →
        prefill → per-token decode → stream end); ``None`` mints a fresh
        one. The router passes its own id through here so a rerouted
        request keeps ONE lane across replicas."""
        prompt = np.asarray(prompt, np.int64).ravel()
        self.engine.validate(int(prompt.shape[0]), int(max_new_tokens))
        if top_p < 1.0 and not self.engine.allow_top_p:
            raise ValueError(
                "this server was built with allow_top_p=False; top_p "
                "requests would be silently ignored — construct the "
                "server with allow_top_p=True")
        adapter_id = normalize_adapter_id(adapter_id)
        if adapter_id is not None:
            store = self.engine.store
            if store is None:
                raise ValueError(
                    f"request names adapter {adapter_id!r} but this "
                    f"server has no adapter_store; construct it with "
                    f"InferenceServer(..., adapter_store=AdapterStore("
                    f"model, ...))")
            if not store.known(adapter_id):
                raise ValueError(
                    f"unknown adapter {adapter_id!r}; AdapterStore."
                    f"register()/load() it before submitting")
        corr = correlation_id or _tracing.new_correlation_id()
        req = Request(
            prompt=prompt, max_new_tokens=int(max_new_tokens),
            greedy=not do_sample, temperature=float(temperature),
            top_p=float(top_p), eos_token_id=eos_token_id,
            seed=None if seed is None else int(seed),
            deadline=Deadline(deadline) if deadline is not None else None,
            adapter_id=adapter_id, tenant=tenant, corr_id=corr)
        handle = RequestHandle(req)
        req.handle = handle
        self.start()
        with RecordEvent("serve:admit"):
            try:
                self.scheduler.submit(req)
            except Overloaded:
                # the fast-fail half of overload control: the request
                # learns now, not after its whole deadline
                self.metrics.inc("requests_shed")
                self._adapter_fail(req)
                _tracing.record_event("shed", corr=corr,
                                      queue_depth=self.scheduler.depth)
                raise
            except RateLimited as e:
                # one tenant over ITS rate: the server working as
                # designed, counted apart from sheds and failures; the
                # flight note carries the tenant into every later dump
                self.metrics.inc("requests_rate_limited")
                _tracing.record_event("rate_limited", corr=corr,
                                      tenant=e.tenant)
                _flight.note("rate_limited", corr=corr, tenant=e.tenant,
                             retry_after_s=round(e.retry_after, 3))
                raise
            except QueueFull:
                self.metrics.inc("requests_rejected")
                _tracing.record_event("rejected", corr=corr,
                                      queue_depth=self.scheduler.depth)
                raise
        self.metrics.inc("requests_submitted")
        _tracing.record_event("submit", corr=corr, request_id=req.id,
                              prompt_len=int(prompt.shape[0]))
        self.metrics.set_queue_depth(self.scheduler.depth)
        with self._cv:
            self._cv.notify_all()
        return handle

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the worker. ``drain=True`` finishes every accepted
        request first; ``drain=False`` fails the backlog with
        ``SchedulerClosed``. Idempotent. Raises ``TimeoutError`` if the
        drain does not finish in ``timeout`` seconds."""
        self.scheduler.seal()
        with self._cv:
            self._stop = True
            self._drain = drain
            self._cv.notify_all()
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"serve loop still draining after {timeout}s "
                    f"({self.engine.active_count} active, "
                    f"{self.scheduler.depth} queued)")

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.shutdown(drain=exc == (None, None, None))
        return False

    def snapshot(self) -> dict:
        """Metrics snapshot (see ``ServingMetrics.snapshot``) with the
        engine's call counters and, when attached, the block pool's
        occupancy and eviction numbers and the adapter store's residency
        and eviction numbers."""
        pool = self.engine.pool
        store = self.engine.store
        return self.metrics.snapshot(
            self.engine.cache_stats(),
            prefix_cache=None if pool is None else pool.stats(),
            adapter_store=None if store is None else store.stats())

    def metrics_text(self) -> str:
        """Prometheus text exposition of the process metrics registry —
        the ``/metrics`` handle (this server's gauges carry its
        ``server=<label>`` labels; co-hosted replicas and the training
        side share the same page)."""
        return _obs_registry.default_registry().prometheus_text()

    def statusz(self) -> dict:
        """Introspection snapshot — the ``/statusz`` handle: live
        engine/scheduler state, the full metrics snapshot, and the
        flight-recorder/trace-buffer health."""
        return {
            "time": round(time.time(), 3),
            "pid": os.getpid(),
            "server": self._obs_label,
            "active_slots": self.engine.active_count,
            "slots": self.engine.slots,
            "queue_depth": self.scheduler.depth,
            "prefill_buckets": list(self.engine.prefill_buckets),
            "snapshot": self.snapshot(),
            # per-tenant token-bucket fill (empty when rate limiting is
            # off or no tenant has submitted yet)
            "token_buckets": self.scheduler.bucket_levels(),
            "flight": _flight.flight_recorder().stats(),
            "trace": _tracing.stats(),
        }

    def probe(self) -> dict:
        """Cheap liveness/load probe — the payload the router's heartbeat
        failure detector polls. Host-side attribute reads only (no device
        sync, no histogram math), so a probe's latency measures the
        REPLICA's responsiveness. The ``serve.probe`` fault site lets
        chaos drills fail or slow the probe path in isolation."""
        fault_point("serve.probe")
        depth = self.scheduler.depth
        return {
            "time": round(time.time(), 3),
            "pid": os.getpid(),
            "active": self.engine.active_count,
            "slots": self.engine.slots,
            "queue_depth": depth,
            "max_queue_depth": self.scheduler.max_queue_depth,
            # what a request arriving NOW should expect to wait (None
            # until the scheduler has cadence evidence)
            "predicted_queue_wait": self.scheduler.predicted_wait(depth),
        }

    def _obs_collect(self) -> dict:
        """Registry collector: the occupancy/queue/call numbers an
        autoscaler polls, read from live state (no histogram math)."""
        eng = self.engine
        cc = eng.cache_stats()
        gauges = {
            "serving.queue_depth": self.scheduler.depth,
            "serving.active_slots": eng.active_count,
            "serving.slots": eng.slots,
            "serving.prefill_compiles": cc["prefill"]["compiles"],
            "serving.decode_compiles": cc["decode"]["compiles"],
        }
        out = {"gauges": gauges}
        if eng.pool is not None:
            gauges["serving.prefix_cache"] = eng.pool.stats()
        if eng.store is not None:
            gauges["serving.adapter_store"] = eng.store.stats()
        return out

    # ------------------------------------------------------------ worker
    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._stop and self.engine.active_count == 0
                       and self.scheduler.depth == 0):
                    self._cv.wait(0.1)
                if self._stop:
                    if not self._drain or (self.engine.active_count == 0
                                           and self.scheduler.depth == 0):
                        break
            try:
                self._tick()
            except Exception as e:  # a fault must never kill the loop
                self._recover(e)
        self._fail_backlog()

    def _fail_backlog(self) -> None:
        """Shutdown tail: terminate whatever was not drained (queued
        requests whose deadline lapsed expire; the rest fail with
        ``SchedulerClosed``)."""
        err = SchedulerClosed("server shut down before completion")
        for req in self.scheduler.close():
            if req.deadline is not None and req.deadline.expired():
                self._expire(req)
            else:
                self.metrics.inc("requests_failed")
                self._adapter_fail(req)
                req.handle._fail(err)
        for slot, req in enumerate(list(self.engine.requests)):
            if req is not None:
                self.engine.release(slot)
                self.metrics.inc("requests_failed")
                self._adapter_fail(req)
                req.handle._fail(err)
        self.metrics.set_active_slots(0)
        self.metrics.set_queue_depth(0)

    def _tick(self) -> None:
        for req in self.scheduler.pop_expired():
            self._expire(req)
        for req in self.scheduler.pop_predicted_misses():
            self._shed(req)
        free = self.engine.free_slots()
        if free:
            admits, expired = self.scheduler.take(len(free))
            for req in expired:
                self._expire(req)
            for i, req in enumerate(admits):
                try:
                    self._admit(req, self.engine.free_slots()[0])
                except AdapterError as e:
                    # raised on the host before any device work: the
                    # engine is untouched, so only this request fails (no
                    # reset, no requeue of the others)
                    self.metrics.inc("requests_failed")
                    self._adapter_fail(req)
                    req.handle._fail(e)
                except Exception as e:
                    # the failing request AND the rest of this admission
                    # batch (popped but not yet admitted) reach recovery
                    self._recover(e, extra=admits[i:])
                    return
        self.metrics.set_queue_depth(self.scheduler.depth)
        self.metrics.set_active_slots(self.engine.active_count)
        if self.engine.active_count == 0:
            return
        fault_point("serve.step")
        events = self.engine.step()
        self.metrics.inc("decode_steps")
        per_adapter = self.engine.store is not None
        now = time.monotonic()
        now_wall = time.time()
        for ev in events:
            req = self.engine.requests[ev.slot]
            h = req.handle
            h._push(ev.token)
            self.metrics.inc("tokens_emitted")
            if per_adapter:
                self.metrics.adapter_tokens(req.adapter_id)
            if h._last_token_t is not None:
                self.metrics.observe_inter_token(now - h._last_token_t)
            h._last_token_t = now
            # per-token decode span in the request's lane, bracketed by
            # the step's read-back (no extra sync): one "decode" slice per
            # emitted token, spanning since its previous token
            _tracing.record_span(
                "decode", h._last_token_wall or now_wall, now_wall,
                corr=req.corr_id, tags={"slot": ev.slot})
            h._last_token_wall = now_wall
            if ev.done or h._count() >= req.max_new_tokens:
                self._finish(req, ev.slot)

    def _admit(self, req: Request, slot: int) -> None:
        req.attempts += 1   # count BEFORE any fault: a failed admission
        fault_point("serve.admit")  # spends retry budget, never loops
        self.metrics.observe_queue_wait(
            time.monotonic() - req.handle._submit_t)
        # the queue-wait lane slice: submit wall-time -> this admission (a
        # requeued request's later admissions re-enter the lane as fresh
        # queue_wait slices after the engine_reset marker)
        _tracing.record_span("queue_wait", req.handle._submit_wall,
                             time.time(), corr=req.corr_id,
                             tags={"attempt": req.attempts})
        first, fin, hit_tokens = self.engine.admit(req, slot)
        self.metrics.inc("prefills")
        if self.engine.pool is not None:
            req.handle.cache_hit_tokens = hit_tokens
            self.metrics.inc("prefix_hit_tokens", hit_tokens)
            self.metrics.inc("prefix_miss_tokens",
                             len(req.prompt) - hit_tokens)
        h = req.handle
        h._push(first)
        self.metrics.inc("tokens_emitted")
        t1 = time.monotonic()
        if self.engine.store is not None:
            self.metrics.adapter_tokens(req.adapter_id)
        if h.ttft_s is None:  # a requeued request keeps its FIRST ttft
            h.ttft_s = t1 - h._submit_t
            self.metrics.observe_ttft(h.ttft_s)
            if self.engine.store is not None:
                # under the first-admission guard, like TTFT: a requeued
                # request is one request, not one per attempt
                self.metrics.adapter_request(req.adapter_id)
                self.metrics.observe_adapter_ttft(req.adapter_id, h.ttft_s)
        h._last_token_t = t1
        h._last_token_wall = time.time()
        if fin or req.max_new_tokens == 1:
            # eos straight out of prefill: zero decode iterations
            self._finish(req, slot)

    def _finish(self, req: Request, slot: int) -> None:
        self.engine.release(slot)
        self.metrics.inc("requests_completed")
        self.metrics.set_active_slots(self.engine.active_count)
        _tracing.record_event("stream_end", corr=req.corr_id,
                              tokens=req.handle._count())
        req.handle._finish()

    def _adapter_fail(self, req: Request) -> None:
        """Per-tenant failure accounting, recorded only when the engine
        serves through an adapter store, like every per-tenant metric."""
        if self.engine.store is not None:
            self.metrics.adapter_failure(req.adapter_id)

    def _expire(self, req: Request) -> None:
        self.metrics.inc("requests_expired")
        self._adapter_fail(req)
        _tracing.record_event("expired", corr=req.corr_id)
        req.handle._fail(TimeoutError(
            f"request {req.id} expired in queue after "
            f"{req.deadline.total:.3f}s deadline"))

    def _shed(self, req: Request) -> None:
        """Post-admission shed: service degraded after this request was
        queued and its predicted wait now exceeds its deadline, so it
        fails retryably now (``Overloaded``, a ``ConnectionError``)
        instead of riding the queue into a certain ``TimeoutError``."""
        self.metrics.inc("requests_shed")
        self._adapter_fail(req)
        _tracing.record_event("shed", corr=req.corr_id)
        req.handle._fail(Overloaded(
            f"request {req.id} shed from queue: predicted wait exceeds "
            f"its {req.deadline.total:.3f}s deadline; retry against "
            f"another replica"))

    def _recover(self, exc: BaseException, extra=()) -> None:
        """Crash-safe worker: reset the engine (the cache may be
        half-written mid-fault) and requeue every in-flight request at
        the queue head, bounded by ``max_request_retries``
        re-admissions; over-budget requests fail with the fault."""
        inflight = [r for r in self.engine.requests if r is not None]
        inflight.extend(extra)
        warnings.warn(
            f"serve loop fault ({type(exc).__name__}: {exc}); resetting "
            f"engine, requeueing {len(inflight)} in-flight request(s)",
            RuntimeWarning)
        # crash artifact FIRST, while the ring still holds the lead-up:
        # the flight dump carries the failing requests' correlation ids,
        # their span tails, and the metric state at the moment of death
        corrs = [r.corr_id for r in inflight]
        for c in corrs:
            _tracing.record_event("engine_reset", corr=c)
        _flight.note("engine_reset", corr=corrs[0] if corrs else None,
                     error=f"{type(exc).__name__}: {exc}",
                     inflight=list(corrs))
        _flight.dump("engine_reset", corr=corrs[0] if corrs else None,
                     extra={"error": f"{type(exc).__name__}: {exc}",
                            "inflight": list(corrs),
                            "server": self._obs_label})
        try:
            self.engine.reset()
        except Exception as reset_exc:  # pragma: no cover
            for req in inflight:
                self.metrics.inc("requests_failed")
                self._adapter_fail(req)
                req.handle._fail(reset_exc)
            return
        # requeue newest-first via appendleft so the OLDEST submission
        # ends at the queue head
        for req in sorted(inflight, key=lambda r: r.id, reverse=True):
            if req.attempts > self.max_request_retries:
                self.metrics.inc("requests_failed")
                self._adapter_fail(req)
                req.handle._fail(exc)
            else:
                self.metrics.inc("requests_requeued")
                req.handle._restart()
                self.scheduler.requeue(req)
        self.metrics.set_active_slots(0)
        self.metrics.set_queue_depth(self.scheduler.depth)

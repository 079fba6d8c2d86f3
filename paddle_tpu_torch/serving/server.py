"""Threaded serving front end: submit / stream / drain / survive faults
(port of ``paddle_tpu/serving/server.py:59-656``).

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
  ``ConnectionError``);
- **deadlines**: a per-request deadline expires requests still in the
  queue (their handles raise ``TimeoutError``);
- **worker faults**: any exception in the serve loop resets the engine
  and requeues in-flight requests at the queue head, up to
  ``max_request_retries`` re-admissions each. Regeneration restarts from
  the request's seed, so a recovered request's ``result()`` is identical,
  but a live ``stream()`` may re-emit its prefix (at-least-once);
- **graceful shutdown**: ``shutdown(drain=True)`` seals admission, lets
  the loop finish every accepted request, then joins the worker;
  ``drain=False`` fails the backlog with ``SchedulerClosed``.

Not ported yet: overload shedding, per-tenant rate limits and fair
queueing, LoRA adapters, the prefix cache, the observability hooks
(registry, flight recorder, tracing) and fault-injection points.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Iterator, Optional

import numpy as np

from .. import default_device
from .engine import ContinuousBatchingEngine
from .metrics import ServingMetrics
from .scheduler import (Deadline, FifoScheduler, QueueFull, Request,
                        SchedulerClosed)

__all__ = ["InferenceServer", "RequestHandle"]


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
        self._submit_t = time.monotonic()
        self._last_token_t: Optional[float] = None

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
    request. ``device=None`` means ``cuda`` (``RuntimeError`` without a
    GPU); the model's parameters must already live on that device."""

    def __init__(self, network, slots: int = 4,
                 max_length: Optional[int] = None,
                 prefill_buckets=None,
                 max_queue_depth: int = 64,
                 max_prefills_per_step: int = 2,
                 top_k: int = 0, allow_top_p: bool = True,
                 max_request_retries: int = 1, device=None):
        device = default_device(device)
        if network.device.type != device.type or (
                device.index is not None and network.device != device):
            raise ValueError(f"the model lives on {network.device}, the "
                             f"server was asked for {device}")
        self.device = device
        self.engine = ContinuousBatchingEngine(
            network, slots=slots, max_length=max_length,
            prefill_buckets=prefill_buckets, top_k=top_k,
            allow_top_p=allow_top_p)
        self.scheduler = FifoScheduler(
            max_queue_depth=max_queue_depth,
            max_prefills_per_step=max_prefills_per_step)
        self.metrics = ServingMetrics(slots)
        self.max_request_retries = int(max_request_retries)
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._drain = True

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
               deadline: Optional[float] = None) -> RequestHandle:
        """Queue one generation request; returns at once with a
        :class:`RequestHandle`. Raises ``ValueError`` on an impossible
        request (too long for the cache), :class:`QueueFull` when the
        admission queue is at depth (retryable backpressure), and
        :class:`SchedulerClosed` after shutdown.

        A ``seed`` makes the request's sampled stream deterministic and
        equal to a solo ``generate(..., seed=s)`` run; ``seed=None``
        draws fresh randomness per request. ``deadline`` (seconds) bounds
        QUEUE WAIT: a request that cannot start in time fails with
        ``TimeoutError``."""
        prompt = np.asarray(prompt, np.int64).ravel()
        self.engine.validate(int(prompt.shape[0]), int(max_new_tokens))
        if top_p < 1.0 and not self.engine.allow_top_p:
            raise ValueError(
                "this server was built with allow_top_p=False; top_p "
                "requests would be silently ignored — construct the "
                "server with allow_top_p=True")
        req = Request(
            prompt=prompt, max_new_tokens=int(max_new_tokens),
            greedy=not do_sample, temperature=float(temperature),
            top_p=float(top_p), eos_token_id=eos_token_id,
            seed=None if seed is None else int(seed),
            deadline=Deadline(deadline) if deadline is not None else None)
        handle = RequestHandle(req)
        req.handle = handle
        self.start()
        try:
            self.scheduler.submit(req)
        except QueueFull:
            self.metrics.inc("requests_rejected")
            raise
        self.metrics.inc("requests_submitted")
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
        """Metrics snapshot (see ``ServingMetrics.snapshot``)."""
        return self.metrics.snapshot()

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
                req.handle._fail(err)
        for slot, req in enumerate(list(self.engine.requests)):
            if req is not None:
                self.engine.release(slot)
                self.metrics.inc("requests_failed")
                req.handle._fail(err)
        self.metrics.set_active_slots(0)
        self.metrics.set_queue_depth(0)

    def _tick(self) -> None:
        for req in self.scheduler.pop_expired():
            self._expire(req)
        free = self.engine.free_slots()
        if free:
            admits, expired = self.scheduler.take(len(free))
            for req in expired:
                self._expire(req)
            for i, req in enumerate(admits):
                try:
                    self._admit(req, self.engine.free_slots()[0])
                except Exception as e:
                    # the failing request AND the rest of this admission
                    # batch (popped but not yet admitted) reach recovery
                    self._recover(e, extra=admits[i:])
                    return
        self.metrics.set_queue_depth(self.scheduler.depth)
        self.metrics.set_active_slots(self.engine.active_count)
        if self.engine.active_count == 0:
            return
        events = self.engine.step()
        self.metrics.inc("decode_steps")
        now = time.monotonic()
        for ev in events:
            req = self.engine.requests[ev.slot]
            h = req.handle
            h._push(ev.token)
            self.metrics.inc("tokens_emitted")
            if h._last_token_t is not None:
                self.metrics.observe_inter_token(now - h._last_token_t)
            h._last_token_t = now
            if ev.done or h._count() >= req.max_new_tokens:
                self._finish(req, ev.slot)

    def _admit(self, req: Request, slot: int) -> None:
        req.attempts += 1   # count BEFORE any fault: a failed admission
        self.metrics.observe_queue_wait(  # spends retry budget
            time.monotonic() - req.handle._submit_t)
        first, fin = self.engine.admit(req, slot)
        self.metrics.inc("prefills")
        h = req.handle
        h._push(first)
        self.metrics.inc("tokens_emitted")
        t1 = time.monotonic()
        if h.ttft_s is None:  # a requeued request keeps its FIRST ttft
            h.ttft_s = t1 - h._submit_t
            self.metrics.observe_ttft(h.ttft_s)
        h._last_token_t = t1
        if fin or req.max_new_tokens == 1:
            self._finish(req, slot)

    def _finish(self, req: Request, slot: int) -> None:
        self.engine.release(slot)
        self.metrics.inc("requests_completed")
        self.metrics.set_active_slots(self.engine.active_count)
        req.handle._finish()

    def _expire(self, req: Request) -> None:
        self.metrics.inc("requests_expired")
        req.handle._fail(TimeoutError(
            f"request {req.id} expired in queue after "
            f"{req.deadline.total:.3f}s deadline"))

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
        try:
            self.engine.reset()
        except Exception as reset_exc:  # pragma: no cover
            for req in inflight:
                self.metrics.inc("requests_failed")
                req.handle._fail(reset_exc)
            return
        # requeue newest-first via appendleft so the OLDEST submission
        # ends at the queue head
        for req in sorted(inflight, key=lambda r: r.id, reverse=True):
            if req.attempts > self.max_request_retries:
                self.metrics.inc("requests_failed")
                req.handle._fail(exc)
            else:
                self.metrics.inc("requests_requeued")
                req.handle._restart()
                self.scheduler.requeue(req)
        self.metrics.set_active_slots(0)
        self.metrics.set_queue_depth(self.scheduler.depth)

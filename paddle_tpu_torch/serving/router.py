"""Load-aware multi-replica router: one front door over N engines (port of
``paddle_tpu/serving/router.py``; framework-free, so copied).

A single :class:`~paddle_tpu_torch.serving.server.InferenceServer` is one
decode batch on one card. Fleet traffic needs N of them plus a
placement policy, and this module is that policy plus the membership
bookkeeping around it:

- **placement** scores every ACTIVE replica per request:
  ``affinity_weight * prefix_affinity - load``, where load is slot
  occupancy plus normalized queue depth (from the replica's live
  engine/scheduler state — the same numbers ``ServingMetrics.snapshot``
  reports) and prefix affinity is the fraction of the prompt the
  replica's block pool could serve right now (``BlockPool.match``).
  Shared-prefix traffic therefore lands where its blocks are warm
  instead of re-prefilling on a cold replica, but a hot replica's queue
  eventually outweighs its warm cache and traffic spills;
- **backpressure** composes: a replica at queue depth raises
  ``QueueFull`` and the router tries the next-best; only when EVERY
  active replica rejects does the router re-raise ``QueueFull`` — still
  a ``ConnectionError``, so callers wrap submits in the stack's
  ``RetryPolicy`` exactly as for a single server. Zero live replicas
  raises :class:`NoReplicasAvailable` (also retryable — a drain may be
  about to finish or an add may be in flight);
- **membership** follows the supervisor-style lifecycle the training
  stack uses: replicas are ACTIVE → DRAINING (placement stops,
  accepted work finishes, then the server shuts down) → DEAD, plus a
  SUSPECT state for gray failures. A replica that rejects with
  ``SchedulerClosed``/``ReplicaUnreachable`` or whose handles fail is
  marked DEAD in place — the traffic itself is a probe;
- **failure detection** (``health_check_interval=``): a heartbeat
  thread probes every live replica (``InferenceServer.probe`` locally,
  the rpc probe for :class:`~paddle_tpu_torch.serving.remote.RemoteReplica`)
  with phi-accrual-style suspicion — consecutive-miss count plus a
  probe-latency EWMA. One miss (or a probe slower than
  ``suspect_latency_factor`` x its EWMA) moves an ACTIVE replica to
  SUSPECT: new placements stop, in-flight work continues — a gray
  replica is quarantined before it is condemned. ``dead_misses``
  consecutive misses declare it DEAD: the flight recorder dumps an
  artifact carrying every affected correlation id, and remote replicas
  ``abandon()`` their live handles so streams reroute NOW instead of
  waiting out their own poll retries. A healthy probe revives a SUSPECT
  back to ACTIVE. Every transition is counted in the metrics registry
  (the router registers a collector) and flight-recorded;
- **crash recovery**: a :class:`RouterHandle` that sees its replica die
  mid-stream resubmits the SAME request to a survivor, bounded by
  ``max_reroutes``. The router assigns every sampled request a concrete
  seed at the front door, so the rerouted run replays the identical
  token stream (the per-request PRNG derivation is placement-invariant)
  — delivery is at-least-once, content is exactly-once. ``Overloaded``
  sheds are NOT deaths: they re-raise to the client untouched (retry is
  the client's call, and the replica that shed is perfectly healthy);
- **hedged retries** (``hedge_multiplier=``): when a live stream's
  next-token gap blows past ``hedge_multiplier`` x the fleet's
  inter-token EWMA (floored at ``hedge_min_s``), the handle re-submits
  the SAME request — same router-assigned seed — to a second replica
  and takes whichever finishes first. Token identity makes the hedge
  winner indistinguishable from the original; the loser's slot frees
  when its stream completes (bounded waste, never wrong answers). Each
  fire is counted, traced, and flight-dumped with the affected
  correlation id.

- **fleet observability** (``fleet_scrape_interval=``): a scrape
  thread pulls every remote replica's unified-registry snapshot over
  rpc (Deadline-bounded, never under the router lock, never on the
  placement path) into a fleet-level roll-up with ``replica=`` labels
  — ``fleet_metrics_text()`` is Prometheus text for the whole fleet
  from one endpoint, ``fleet_statusz()`` the detector + scrape + SLO
  view, ``collect_fleet_trace()`` the cross-host span stitcher with
  probe-RTT-midpoint clock alignment. A replica that stops answering
  degrades to a stale-marked partial roll-up, never an error. With an
  ``slo_policy``, each scrape feeds a per-tenant multi-window burn-rate
  tracker whose fast-window burn flight-dumps its own evidence.

The router is in-process and thread-safe: any number of client threads
submit; each replica keeps its own single serving worker (local
replicas) or rpc poller threads (remote ones). Defaults keep the plain
router's behavior: no detector thread unless
``health_check_interval`` is set, no hedging unless
``hedge_multiplier`` is set, no scrape thread unless
``fleet_scrape_interval`` is set.
"""
from __future__ import annotations

import itertools
import os
import queue as _queue
import threading
import time
import weakref
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..observability import fleet as _fleet
from ..observability import flight as _flight
from ..observability import registry as _obs_registry
from ..observability import tracing as _tracing
from .prefix_cache import BlockPool  # noqa: F401  (re-export convenience)
from .remote import ReplicaUnreachable
from .scheduler import (Backpressure, QueueFull, RateLimited,
                        SchedulerClosed)
from .server import InferenceServer, RequestHandle

__all__ = ["ReplicaRouter", "RouterHandle", "NoReplicasAvailable",
           "ACTIVE", "SUSPECT", "DRAINING", "DEAD"]

ACTIVE = "active"
#: alive but misbehaving (a missed probe, or probes far slower than the
#: replica's own latency EWMA): new placements stop, in-flight work
#: continues, a healthy probe revives it — the gray-failure quarantine
SUSPECT = "suspect"
DRAINING = "draining"
DEAD = "dead"

_name_serial = itertools.count()
_router_serial = itertools.count()

# RouterHandle._hedge sentinel: a hedge was attempted for the current
# attachment and cannot/need not fire again (placement failed, or the
# hedge itself died) — distinct from None ("not fired yet")
_HEDGE_UNAVAILABLE = object()


class NoReplicasAvailable(Backpressure):
    """Every replica is draining or dead. Retryable (``ConnectionError``
    via :class:`~paddle_tpu_torch.serving.scheduler.Backpressure`): membership
    changes — an add or a finished drain — are expected to clear it."""


class _Replica:
    __slots__ = ("name", "server", "state", "routed", "misses",
                 "lat_ewma", "inflight")

    def __init__(self, name: str, server: InferenceServer):
        self.name = name
        self.server = server
        self.state = ACTIVE
        self.routed = 0
        self.misses = 0                  # consecutive probe failures
        self.lat_ewma: Optional[float] = None   # probe latency EWMA (s)
        # live RouterHandles placed here — the corr ids a death dump
        # carries; weak so finished handles vanish on their own
        self.inflight: "weakref.WeakSet" = weakref.WeakSet()


class RouterHandle:
    """Client-side handle that survives its replica.

    Wraps the current :class:`RequestHandle`; when that handle fails
    with a replica-death error (``SchedulerClosed`` — the replica shut
    down under the request — or transport-style ``ConnectionError``),
    the router resubmits to a survivor and the wait continues, up to
    ``max_reroutes`` times. A reroute restarts the stream from the
    first token (at-least-once delivery; the seeded replay makes the
    tokens themselves identical)."""

    _REROUTABLE = (SchedulerClosed, ConnectionError)

    def __init__(self, router: "ReplicaRouter", submit_kwargs: dict):
        self._router = router
        self._kwargs = submit_kwargs
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._rerouting = False
        self._inner: Optional[RequestHandle] = None
        self.replica: Optional[str] = None
        self.reroutes = 0
        # hedge state: None = not fired; a RouterHandle = the live
        # hedge; _HEDGE_UNAVAILABLE = attempted, don't re-fire
        self._hedge = None
        self._submit_t = time.monotonic()

    # ---- router-side ----
    def _attach(self, replica: str, inner: RequestHandle) -> None:
        with self._lock:
            self.replica = replica
            self._inner = inner

    def _current(self) -> RequestHandle:
        with self._lock:
            return self._inner

    def _reroute(self, cause: BaseException,
                 failed_inner: RequestHandle) -> RequestHandle:
        """Resubmit after a replica death; raises ``cause`` when the
        reroute budget is spent or no replica can take the request.
        Single-flight per death: concurrent ``result()``/``stream()``
        consumers who observe the same dead inner handle trigger ONE
        resubmission — losers wait for the winner's placement and pick
        up its handle (the in-flight flag is held across the placement,
        not just the budget check)."""
        with self._cv:
            while self._rerouting and self._inner is failed_inner:
                self._cv.wait(1.0)
            if self._inner is not failed_inner:
                return self._inner      # another consumer already rerouted
            failed = self.replica
            if self.reroutes >= self._router.max_reroutes:
                raise cause
            self.reroutes += 1
            self._rerouting = True
        try:
            self._router._mark_dead(failed)
            with self._router._lock:
                self._router.requests_rerouted += 1
            _tracing.record_event(
                "reroute", corr=self.correlation_id,
                failed_replica=failed, cause=type(cause).__name__,
                reroutes=self.reroutes)
            try:
                self._router._place(self)
            except Exception:
                raise cause
        finally:
            with self._cv:
                self._rerouting = False
                self._cv.notify_all()
        return self._current()

    # ---- client-side (mirrors RequestHandle) ----
    @property
    def done(self) -> bool:
        return self._current().done

    @property
    def cache_hit_tokens(self) -> int:
        return self._current().cache_hit_tokens

    @property
    def correlation_id(self) -> Optional[str]:
        """The request's tracing correlation id — minted ONCE at the
        router front door and carried across reroutes, so every
        replica's spans for this request share one lane."""
        return self._kwargs.get("correlation_id")

    @property
    def adapter_id(self):
        """The tenant adapter this request decodes under (None = base);
        a reroute carries it to the survivor unchanged."""
        return self._kwargs.get("adapter_id")

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token measured from the ROUTER submit — a
        rerouted request keeps paying for its time on the dead replica
        (the per-attempt server handle restarts its own clock)."""
        inner = self._current()
        if inner.ttft_s is None:
            return None
        return inner.ttft_s + (inner._submit_t - self._submit_t)

    @property
    def request(self):
        return self._current().request

    @property
    def error(self) -> Optional[BaseException]:
        return self._current().error

    def tokens(self) -> np.ndarray:
        return self._current().tokens()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the full generated sequence, transparently
        rerouting across replica deaths. ``timeout`` applies per
        attempt (a reroute restarts the clock — the request restarts
        too). With hedging enabled on the router, a stalled wait fires
        one hedge submission and this returns whichever copy finishes
        first (token-identical by seeded replay). ``Overloaded`` sheds
        re-raise untouched: a shed is backpressure from a HEALTHY
        replica, not a death — retrying is the client's decision."""
        while True:
            inner = self._current()
            try:
                return self._await(inner, timeout)
            except self._REROUTABLE as e:
                if isinstance(e, Backpressure):
                    raise
                # reroute keyed on the handle WE were waiting on — a
                # concurrent consumer may already have moved _inner, and
                # passing the current handle would defeat the
                # single-flight guard (and kill the healthy survivor)
                self._reroute(e, inner)

    def _await(self, inner: RequestHandle,
               timeout: Optional[float]) -> np.ndarray:
        """``inner.result()`` with the hedge watchdog: poll the done
        event in slices, measure progress via the token count, fire a
        hedge when the stall crosses the router's EWMA-derived
        threshold, and adopt whichever copy completes first."""
        router = self._router
        if router.hedge_multiplier is None:
            return inner.result(timeout)
        deadline = None if timeout is None else time.monotonic() + timeout
        last_n = inner._count()
        last_t = time.monotonic()
        chosen: Optional[RequestHandle] = None
        while chosen is None:
            if inner._done_evt.wait(router.hedge_poll_interval):
                chosen = inner
                break
            now = time.monotonic()
            n = inner._count()
            if n > last_n:
                if last_n > 0:
                    # only genuine inter-token gaps feed the EWMA: the
                    # first token's gap is queue wait + prefill and
                    # would drag the hedge threshold up by seconds
                    router._note_inter_token((now - last_t) / (n - last_n),
                                             count=n - last_n)
                last_n, last_t = n, now
            # hedge only on a STALLED LIVE STREAM (a next-token gap):
            # pre-first-token delay is queue wait + prefill — the
            # detector's territory, and hedging on it would double
            # offered load exactly when the fleet is congested
            hedge = (self._maybe_hedge(now - last_t) if last_n > 0
                     else None)
            if hedge is not None:
                hinner = hedge._current()
                if hinner is not None and hinner._done_evt.is_set():
                    if hinner.error is None:
                        with router._lock:
                            router.hedge_wins += 1
                        self._attach(hedge.replica, hinner)
                        router._track(self, hedge.replica)
                        with self._cv:
                            self._hedge = None
                        chosen = hinner
                        break
                    with self._cv:   # hedge died; primary carries on
                        self._hedge = _HEDGE_UNAVAILABLE
            if deadline is not None and now >= deadline:
                raise TimeoutError(
                    f"request not finished within {timeout}s "
                    f"({inner._count()} tokens so far)")
        if chosen.error is not None:
            raise chosen.error
        return chosen.tokens()

    def stream(self) -> Iterator[int]:
        """Yield token ids as they are generated. After a reroute the
        regenerated stream is re-emitted from its first token
        (at-least-once), matching the single-server crash-recovery
        restart semantics. With hedging enabled, a mid-stream stall
        fires one hedge and the stream SWITCHES to the hedge copy,
        re-emitting from its first token — same at-least-once contract,
        and seeded replay keeps the tokens themselves identical."""
        while True:
            inner = self._current()
            # one-cell box: _hedged_stream records which handle it was
            # actually consuming when an error escaped (primary or an
            # adopted hedge), so the reroute is keyed on the real
            # casualty, not on whatever _inner points at by then
            consumed = [inner]
            try:
                if self._router.hedge_multiplier is None:
                    yield from inner.stream()
                else:
                    yield from self._hedged_stream(inner, consumed)
                return
            except self._REROUTABLE as e:
                if isinstance(e, Backpressure):
                    raise
                self._reroute(e, consumed[0])

    def _hedged_stream(self, inner: RequestHandle,
                       consumed: list) -> Iterator[int]:
        router = self._router
        # EWMA/stall bookkeeping observes token ARRIVALS via the count
        # (the _await discipline), never queue-consumption gaps: a
        # consumer that thinks for a second between tokens must not
        # inflate the fleet inter-token EWMA, and tokens that piled up
        # during its pause must not read as a stall
        last_n = inner._count()
        last_t = time.monotonic()

        def observe() -> None:
            nonlocal last_n, last_t
            now = time.monotonic()
            n = inner._count()
            if n > last_n:
                if last_n > 0:   # first gap = queue+prefill, not ITL
                    router._note_inter_token(
                        (now - last_t) / (n - last_n), count=n - last_n)
                last_n, last_t = n, now

        while True:
            observe()
            try:
                kind, val = inner._q.get(
                    timeout=router.hedge_poll_interval)
            except _queue.Empty:
                if last_n == 0:
                    # no stream to measure yet: pre-first-token delay is
                    # queue wait + prefill, the detector's territory —
                    # hedging on it would double offered load exactly
                    # when the fleet is congested
                    continue
                hedge = self._maybe_hedge(time.monotonic() - last_t)
                if hedge is None:
                    continue
                hinner = hedge._current()
                if hinner is None or (hinner._count() == 0
                                      and not hinner.done):
                    continue   # hedge placed but not producing yet
                if hinner.done and hinner.error is not None:
                    # a FAILED hedge is never adopted — tokens or not:
                    # switching to a corpse would abandon a live
                    # primary and book the loss as a win
                    with self._cv:
                        self._hedge = _HEDGE_UNAVAILABLE
                    continue
                # the hedge is producing: adopt it (stream re-emits
                # from its first token; tokens are seed-identical)
                with router._lock:
                    router.hedge_wins += 1
                self._attach(hedge.replica, hinner)
                router._track(self, hedge.replica)
                with self._cv:
                    self._hedge = None
                consumed[0] = hinner
                yield from hinner.stream()
                return
            if kind == "tok":
                yield val
            elif kind == "restart":
                continue
            elif kind == "end":
                return
            else:
                raise val

    def _maybe_hedge(self, stall: float) -> Optional["RouterHandle"]:
        """The live hedge handle, firing one if ``stall`` crossed the
        router's threshold; ``None`` when hedging is off/warming/spent."""
        h = self._hedge
        if h is _HEDGE_UNAVAILABLE:
            return None
        if isinstance(h, RouterHandle):
            return h
        thr = self._router._hedge_threshold()
        if thr is None or stall <= thr:
            return None
        return self._fire_hedge(stall, thr)

    def _fire_hedge(self, stall: float,
                    threshold: float) -> Optional["RouterHandle"]:
        """Submit the hedge copy to a second replica (single-flight per
        attachment; the slow replica is excluded, NOT marked dead — it
        may merely be gray). Placement and telemetry run outside the
        handle lock: only the claim/publish of ``_hedge`` sits under
        it."""
        router = self._router
        with self._cv:
            if self._hedge is not None:
                h = self._hedge
                return h if isinstance(h, RouterHandle) else None
            self._hedge = _HEDGE_UNAVAILABLE   # claim (pessimistic)
            slow = self.replica
        hedge = RouterHandle(router, dict(self._kwargs))
        try:
            router._place(hedge, exclude={slow} if slow else ())
        except Exception:
            return None    # stays unavailable for this attachment
        with router._lock:
            router.requests_hedged += 1
        corr = self.correlation_id
        detail = {"slow_replica": slow, "hedge_replica": hedge.replica,
                  "stall_s": round(stall, 4),
                  "threshold_s": round(threshold, 4)}
        _tracing.record_event("hedge_fire", corr=corr, **detail)
        _flight.note("hedge_fire", corr=corr, **detail)
        _flight.dump("hedge_fire", corr=corr,
                     extra=dict(detail, corrs=[corr]))
        with self._cv:
            self._hedge = hedge
        return hedge


class ReplicaRouter:
    """Front door over N replicas — local :class:`InferenceServer` and
    :class:`~paddle_tpu_torch.serving.remote.RemoteReplica` alike (one duck
    type, one placement/reroute policy)."""

    def __init__(self, replicas=(), *, affinity_weight: float = 0.75,
                 adapter_affinity_weight: float = 0.5,
                 max_reroutes: int = 2,
                 health_check_interval: Optional[float] = None,
                 suspect_misses: int = 1, dead_misses: int = 3,
                 suspect_latency_factor: float = 4.0,
                 min_suspect_latency: float = 0.05,
                 hedge_multiplier: Optional[float] = None,
                 hedge_min_s: float = 0.25,
                 hedge_warmup_tokens: int = 16,
                 hedge_poll_interval: float = 0.02,
                 fleet_scrape_interval: Optional[float] = None,
                 fleet_stale_after_s: Optional[float] = None,
                 slo_policy=None,
                 prefix_index=None, remote_hit_weight: float = 0.5,
                 max_skew_correction_s: float =
                 _fleet.DEFAULT_MAX_SKEW_CORRECTION_S):
        self.affinity_weight = float(affinity_weight)
        # --- fleet prefix tier (None = off: scoring bit-identical) ---
        # a prefix resident ANYWHERE in the fleet is reachable from any
        # replica via KV-block migration (serving.disagg); the remote
        # term is the local affinity discounted by remote_hit_weight —
        # the migration-cost : recompute-cost price ratio
        self.prefix_index = prefix_index
        self.remote_hit_weight = float(remote_hit_weight)
        self.prefix_remote_hits = 0
        # a tenant placed where its adapter pages are already resident
        # skips a host->device page load (and an LRU eviction somewhere
        # else); like prefix affinity, load eventually outweighs warmth
        self.adapter_affinity_weight = float(adapter_affinity_weight)
        self.max_reroutes = int(max_reroutes)
        # --- failure detector (None = off: plain router unchanged) ---
        self.health_check_interval = health_check_interval
        self.suspect_misses = int(suspect_misses)
        self.dead_misses = int(dead_misses)
        self.suspect_latency_factor = float(suspect_latency_factor)
        self.min_suspect_latency = float(min_suspect_latency)
        # --- hedging (None = off) ---
        self.hedge_multiplier = (None if hedge_multiplier is None
                                 else float(hedge_multiplier))
        self.hedge_min_s = float(hedge_min_s)
        self.hedge_warmup_tokens = int(hedge_warmup_tokens)
        self.hedge_poll_interval = float(hedge_poll_interval)
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {}
        self.requests_routed = 0
        self.requests_rerouted = 0
        self.requests_hedged = 0
        self.hedge_wins = 0
        self.replicas_failed = 0          # all deaths (traffic + probe)
        self.replicas_suspected = 0
        self.replicas_revived = 0
        self._itl_ewma: Optional[float] = None   # observed inter-token s
        self._itl_samples = 0
        self._health_stop: Optional[threading.Event] = None
        self._health_thread: Optional[threading.Thread] = None
        # detector/hedge counters + per-state membership gauges ride the
        # process metrics registry (weak collector, like the servers')
        self._obs_label = f"router{next(_router_serial)}"
        _obs_registry.default_registry().register_collector(
            self._obs_collect, labels={"router": self._obs_label},
            name=f"router.{self._obs_label}")
        # --- fleet observability plane (scrape thread off by default:
        # no scrape until an interval is set) ---
        self.fleet_scrape_interval = fleet_scrape_interval
        self.max_skew_correction_s = float(max_skew_correction_s)
        self.fleet = _fleet.FleetAggregator(
            stale_after_s=(fleet_stale_after_s
                           if fleet_stale_after_s is not None
                           else max(10.0, 3.0 * (fleet_scrape_interval
                                                 or 0.0))))
        self._slo = None
        if slo_policy is not None:
            from ..observability.slo import SloTracker

            self._slo = SloTracker(slo_policy)
        self._scrape_stop: Optional[threading.Event] = None
        self._scrape_thread: Optional[threading.Thread] = None
        # --- autoscaler (attached by an autoscaler's constructor;
        # None = off) ---
        self._autoscaler = None
        for r in replicas:
            self.add_replica(r)
        if self.health_check_interval:
            self._health_stop = threading.Event()
            self._health_thread = threading.Thread(
                target=self._health_loop, name="pt-router-health",
                daemon=True)
            self._health_thread.start()
        if self.fleet_scrape_interval:
            self._scrape_stop = threading.Event()
            self._scrape_thread = threading.Thread(
                target=self._scrape_loop, name="pt-router-fleet-scrape",
                daemon=True)
            self._scrape_thread.start()

    def _obs_collect(self) -> dict:
        with self._lock:
            states = {ACTIVE: 0, SUSPECT: 0, DRAINING: 0, DEAD: 0}
            for r in self._replicas.values():
                states[r.state] = states.get(r.state, 0) + 1
            counters = {
                "router.requests_routed": self.requests_routed,
                "router.requests_rerouted": self.requests_rerouted,
                "router.requests_hedged": self.requests_hedged,
                "router.hedge_wins": self.hedge_wins,
                "router.replicas_failed": self.replicas_failed,
                "router.replicas_suspected": self.replicas_suspected,
                "router.replicas_revived": self.replicas_revived,
            }
            gauges = {f"router.replicas_{s}": n
                      for s, n in states.items()}
        return {"counters": counters, "gauges": gauges}

    # -------------------------------------------------- failure detector
    def _health_loop(self) -> None:
        while not self._health_stop.wait(self.health_check_interval):
            try:
                self.check_health()
            except Exception:   # pragma: no cover - detector never dies
                pass

    @staticmethod
    def _probe_replica(server) -> dict:
        probe = getattr(server, "probe", None)
        if probe is not None:
            return probe()
        # minimal duck-typed fallback: live load reads double as probe
        return {"active": server.engine.active_count,
                "queue_depth": server.scheduler.depth}

    def check_health(self) -> None:
        """One probe round over every ACTIVE/SUSPECT replica (the
        heartbeat thread's body; public so tests and ops tooling can
        drive the detector synchronously). Probes run OUTSIDE the
        router lock — a hung remote peer stalls this round, never a
        placement."""
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state in (ACTIVE, SUSPECT)]
        for rep in reps:
            t0 = time.monotonic()
            try:
                self._probe_replica(rep.server)
            except Exception as e:
                self._probe_miss(rep, e)
            else:
                self._probe_ok(rep, time.monotonic() - t0)

    def _note_transition(self, kind: str, rep_name: str,
                         detail: str) -> None:
        _tracing.record_event(f"replica_{kind}", corr=None,
                              replica=rep_name, detail=detail)
        _flight.note(f"replica_{kind}", replica=rep_name, detail=detail)

    def _probe_ok(self, rep: _Replica, latency: float) -> None:
        transition = None
        with self._lock:
            if rep.state not in (ACTIVE, SUSPECT):
                return
            rep.misses = 0
            prev = rep.lat_ewma
            # phi-accrual-style gray detection: compare this probe to
            # the replica's OWN history before folding it in, so a
            # sudden stall stands out instead of dragging the baseline
            slow = (prev is not None
                    and latency > max(self.min_suspect_latency,
                                      prev * self.suspect_latency_factor))
            rep.lat_ewma = (latency if prev is None
                            else 0.8 * prev + 0.2 * latency)
            if slow and rep.state == ACTIVE:
                rep.state = SUSPECT
                self.replicas_suspected += 1
                transition = ("suspect",
                              f"probe {latency * 1e3:.1f}ms vs ewma "
                              f"{prev * 1e3:.1f}ms")
            elif not slow and rep.state == SUSPECT:
                rep.state = ACTIVE
                self.replicas_revived += 1
                transition = ("revive", f"probe {latency * 1e3:.1f}ms")
        if transition is not None:
            self._note_transition(transition[0], rep.name, transition[1])

    def _probe_miss(self, rep: _Replica, exc: BaseException) -> None:
        transition = None
        dead = False
        with self._lock:
            if rep.state not in (ACTIVE, SUSPECT):
                return
            rep.misses += 1
            misses = rep.misses
            if misses >= self.dead_misses:
                dead = True
            elif misses >= self.suspect_misses and rep.state == ACTIVE:
                rep.state = SUSPECT
                self.replicas_suspected += 1
                transition = ("suspect",
                              f"{misses} probe miss(es): "
                              f"{type(exc).__name__}: {exc}")
        if dead:
            self._mark_dead(rep.name,
                            cause=f"{rep.misses} consecutive probe "
                                  f"misses: {type(exc).__name__}: {exc}")
        elif transition is not None:
            self._note_transition(transition[0], rep.name, transition[1])

    # ------------------------------------------- fleet observability
    def _scrape_loop(self) -> None:
        while not self._scrape_stop.wait(self.fleet_scrape_interval):
            try:
                self.fleet_scrape_now()
            except Exception:   # pragma: no cover - scraping never dies
                pass

    def fleet_scrape_now(self) -> dict:
        """One metrics-scrape round over the membership (the scrape
        thread's body; public so tools/tests drive it synchronously).
        Every rpc runs OUTSIDE the router lock and is Deadline-bounded
        by the replica's own ``rpc_timeout`` — a hung peer stalls a
        scrape round, never a placement. A failed scrape degrades that
        replica to stale-marked-with-last-known-numbers in the roll-up;
        it is NEVER an error (partial fleet visibility during an
        incident is the whole point). Local (in-process) replicas share
        this process's registry, which is scraped once under the
        ``_local`` label. With an ``slo_policy`` configured, each round
        also feeds the burn-rate tracker from the fleet snapshot
        roll-up. Returns :meth:`FleetAggregator.statusz`."""
        with self._lock:
            reps = [(r.name, r.server, r.state)
                    for r in self._replicas.values()]
        saw_local = False
        # per-replica serving snapshots for the SLO ingest, harvested
        # from the SAME payloads the metrics scrape already fetched
        # (remote `_host_metrics` piggybacks its server's snapshot) —
        # no second rpc fan-out per round
        slo_replicas: Dict[str, dict] = {}
        for name, server, state in reps:
            fn = getattr(server, "metrics_snapshot", None)
            if fn is None:
                saw_local = True
                if self._slo is not None and state != DEAD:
                    try:
                        slo_replicas[name] = server.snapshot()
                    except Exception:
                        pass
                continue
            if state == DEAD:
                # no rpc to a corpse: keep its last numbers, refresh
                # only the stale marking
                self.fleet.observe_scrape(name, error=f"replica {state}")
                continue
            try:
                snap = fn()
            except Exception as e:
                self.fleet.observe_scrape(name, error=e)
                continue
            self.fleet.observe_scrape(
                name, snapshot=snap,
                clock_offset_s=getattr(server, "clock_offset_s", None),
                rtt_s=getattr(server, "rtt_ewma_s", None))
            serving = snap.get("serving_snapshot") if isinstance(
                snap, dict) else None
            if isinstance(serving, dict):
                slo_replicas[name] = serving
        if saw_local:
            self.fleet.observe_scrape(
                "_local",
                snapshot=_obs_registry.default_registry().snapshot(),
                clock_offset_s=0.0)
        if self._slo is not None:
            self._slo.ingest({"replicas": slo_replicas})
        if self.prefix_index is not None:
            # same round, same bounded-rpc discipline: refresh the
            # fleet prefix tier from each replica's committed digests.
            # A failed fetch REMOVES the replica's entry — absent only
            # forfeits a warm-source preference, stale would misroute
            for name, server, state in reps:
                if state == DEAD:
                    self.prefix_index.remove(name)
                    continue
                try:
                    fetch = getattr(server, "prefix_digests", None)
                    if fetch is not None:
                        self.prefix_index.publish(
                            name, fetch()["digests"])
                    else:
                        pool = server.engine.pool
                        if pool is not None:
                            self.prefix_index.publish(name,
                                                      pool.digests())
                except Exception:
                    self.prefix_index.remove(name)
        return self.fleet.statusz()

    def fleet_metrics_text(self) -> str:
        """Prometheus text for the WHOLE FLEET from one endpoint: every
        replica's registry snapshot re-labeled ``replica=<name>``, plus
        the ``fleet.*`` staleness/skew meta-series. Scrapes on demand
        if no scrape was ever ATTEMPTED (so the call works with the
        ``fleet_scrape_interval`` knob off) — but a fleet that is
        currently all-unreachable serves its stale-marked roll-up
        instead of re-blocking a full rpc round on every poll."""
        if self.fleet.scrapes == 0 and self.fleet.scrape_errors == 0:
            self.fleet_scrape_now()
        return self.fleet.metrics_text()

    def fleet_statusz(self) -> dict:
        """Fleet-wide ``/statusz``: the membership + failure-detector
        view (per-replica state, consecutive probe misses, probe-latency
        EWMA), the scrape plane's per-replica staleness/clock metadata,
        hedge/reroute counters, and the SLO report when a policy is
        configured — a gray replica is diagnosable from this one
        endpoint."""
        return {
            "time": round(time.time(), 3),
            "pid": os.getpid(),
            "detector": self.detector_statusz(),
            "scrape": self.fleet.statusz(),
            **({"slo": self._slo.report()}
               if self._slo is not None else {}),
            **({"prefix_index": {
                    **self.prefix_index.statusz(),
                    "remote_hit_weight": self.remote_hit_weight,
                    "score_remote_hits": self.prefix_remote_hits}}
               if self.prefix_index is not None else {}),
        }

    def detector_statusz(self) -> dict:
        """Per-replica failure-detector + traffic state (the satellite
        block ``statusz()`` embeds): lifecycle state, consecutive probe
        misses, probe-latency EWMA, routed/in-flight counts — plus the
        router's transition and hedge counters."""
        with self._lock:
            replicas = {
                r.name: {
                    "state": r.state,
                    "misses": r.misses,
                    "probe_latency_ewma_ms": (
                        None if r.lat_ewma is None
                        else round(r.lat_ewma * 1e3, 3)),
                    "routed": r.routed,
                    "inflight": len(r.inflight),
                }
                for r in self._replicas.values()}
            servers = {r.name: r.server for r in self._replicas.values()}
            counters = {
                "requests_routed": self.requests_routed,
                "requests_rerouted": self.requests_rerouted,
                "requests_hedged": self.requests_hedged,
                "hedge_wins": self.hedge_wins,
                "replicas_failed": self.replicas_failed,
                "replicas_suspected": self.replicas_suspected,
                "replicas_revived": self.replicas_revived,
            }
        config = {
            "health_check_interval": self.health_check_interval,
            "suspect_misses": self.suspect_misses,
            "dead_misses": self.dead_misses,
            "hedge_multiplier": self.hedge_multiplier,
            "fleet_scrape_interval": self.fleet_scrape_interval,
        }
        # client-side clock/link stats for remote replicas (what the
        # peer can't know about itself) — read OUTSIDE the router lock
        for name, entry in replicas.items():
            stats = getattr(servers.get(name), "clock_stats", None)
            if stats is not None:
                entry["remote_client"] = stats()
        return {"replicas": replicas, "counters": counters,
                "config": config}

    def collect_fleet_trace(self, corr: Optional[str] = None):
        """Pull every live replica's span ring over rpc, align each
        host's wall clock via its probe-RTT-midpoint offset estimate
        (skew beyond ``max_skew_correction_s`` is reported, not
        applied), and merge with this process's own spans into ONE
        time-sorted span list — the request-lane view, no dump files
        shipped. Returns ``(spans, skew_reports)``; feed the spans to
        ``tools/trace_view.py`` (span-list input) or
        ``tracing.chrome_trace`` to render."""
        with self._lock:
            reps = [(r.name, r.server, r.state)
                    for r in self._replicas.values()]
        remotes: Dict[str, dict] = {}
        for name, server, state in reps:
            fn = getattr(server, "trace_export", None)
            if fn is None or state == DEAD:
                continue
            try:
                remotes[name] = fn(corr=corr)
            except Exception as e:
                remotes[name] = {"spans": [], "offset_s": 0.0,
                                 "error": e}
        local = _tracing.spans(corr=corr)
        return _fleet.stitch_traces(
            local, remotes, max_correction_s=self.max_skew_correction_s)

    def slo_report(self) -> Optional[dict]:
        """The SLO tracker's per-tenant burn-rate report (``None`` when
        no ``slo_policy`` was configured)."""
        return None if self._slo is None else self._slo.report()

    # ---------------------------------------------------------- hedging
    def _note_inter_token(self, dt: float, count: int = 1) -> None:
        """Feed an observed inter-token gap into the fleet EWMA the
        hedge threshold derives from. ``count`` > 1 means the observer
        saw ``count`` tokens land across a window averaging ``dt`` per
        token (remote pollers deliver bursts between observations) —
        one EWMA update, ``count`` warmup credits, so fast replicas
        still clear ``hedge_warmup_tokens``."""
        with self._lock:
            self._itl_ewma = (dt if self._itl_ewma is None
                              else 0.9 * self._itl_ewma + 0.1 * dt)
            self._itl_samples += max(1, int(count))

    def _hedge_threshold(self) -> Optional[float]:
        """Stall threshold (seconds without a next token) that fires a
        hedge: ``hedge_multiplier`` x the fleet inter-token EWMA,
        floored at ``hedge_min_s``; ``None`` while hedging is off or the
        EWMA hasn't seen ``hedge_warmup_tokens`` samples (no hedging on
        zero evidence)."""
        if self.hedge_multiplier is None:
            return None
        with self._lock:
            if (self._itl_ewma is None
                    or self._itl_samples < self.hedge_warmup_tokens):
                return None
            return max(self.hedge_min_s,
                       self._itl_ewma * self.hedge_multiplier)

    # ---------------------------------------------------- control loop
    def _attach_autoscaler(self, autoscaler) -> None:
        """Register the autoscaler driving this fleet (the reference's
        :class:`~paddle_tpu_torch.serving.autoscaler.Autoscaler` calls
        this from its constructor):
        ``statusz()`` embeds its block and ``shutdown()`` stops its loop
        first."""
        self._autoscaler = autoscaler

    def register_adapter(self, name: str, state) -> Dict[str, bool]:
        """Hot-swap one tenant's adapter fleet-wide: re-register
        ``name`` on every live replica's :class:`AdapterStore`. The
        store's version-salt machinery does the heavy lifting — new
        requests acquire the new version (fresh salt, so prefix pages
        can never serve stale weights) while
        live streams finish on their pinned rows, which free when the
        last pin drops. Returns ``{replica: True}`` per updated replica
        (``False`` where the replica has no adapter store or the rpc
        failed — placement keeps avoiding those via adapter affinity).
        Store registration runs OUTSIDE the router lock: a remote
        replica's store call is an rpc."""
        with self._lock:
            reps = [(r.name, r.server) for r in self._replicas.values()
                    if r.state != DEAD]
        out: Dict[str, bool] = {}
        for rep_name, server in reps:
            store = getattr(getattr(server, "engine", None), "store", None)
            if store is None:
                out[rep_name] = False
                continue
            try:
                store.register(name, state)
                out[rep_name] = True
            except Exception:
                out[rep_name] = False
        _flight.note("adapter_swap", adapter=name,
                     replicas=sum(out.values()))
        return out

    # ------------------------------------------------------- membership
    def add_replica(self, server: InferenceServer,
                    name: Optional[str] = None) -> str:
        """Register (and start) a replica; returns its name. New
        replicas are immediately placeable — growing the fleet under
        load is one call."""
        name = name or f"replica-{next(_name_serial)}"
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            self._replicas[name] = _Replica(name, server)
        server.start()
        return name

    def drain(self, name: str, timeout: Optional[float] = None) -> None:
        """Graceful removal: placement stops immediately, the replica
        finishes every accepted request (its queue AND its live slots),
        then shuts down and is marked DEAD. Raises ``TimeoutError`` if
        the backlog outlives ``timeout`` (state stays DRAINING; call
        again to keep waiting)."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                raise KeyError(f"unknown replica {name!r}")
            if rep.state == DEAD:
                return
            rep.state = DRAINING
        rep.server.shutdown(drain=True, timeout=timeout)
        with self._lock:
            rep.state = DEAD

    def _mark_dead(self, name: Optional[str],
                   cause: str = "traffic failure") -> None:
        """Declare a replica DEAD — from traffic (a submit/handle died
        with a closed-scheduler or transport error) or from the failure
        detector (probe misses). The flight recorder dumps an artifact
        carrying every affected in-flight correlation id (the thread
        ``tools/trace_view.py`` pulls a reroute together by), and a
        remote replica ``abandon()``\\ s its live handles so their
        ``RouterHandle`` consumers reroute immediately. All telemetry
        runs OUTSIDE the router lock."""
        with self._lock:
            rep = self._replicas.get(name) if name else None
            if rep is None or rep.state == DEAD:
                return
            rep.state = DEAD
            self.replicas_failed += 1
            handles = list(rep.inflight)
        affected = []
        for h in handles:
            inner = h._current()
            finished = (inner is not None
                        and getattr(inner, "error", None) is None
                        and getattr(inner, "done", False))
            if not finished and h.correlation_id is not None:
                affected.append(h.correlation_id)
        corr = affected[0] if affected else None
        _tracing.record_event("replica_dead", corr=corr, replica=name,
                              cause=cause, inflight=len(affected))
        _flight.note("replica_dead", corr=corr, replica=name,
                     cause=cause, inflight=list(affected))
        _flight.dump("replica_dead", corr=corr,
                     extra={"replica": name, "cause": str(cause),
                            "inflight": list(affected)})
        abandon = getattr(rep.server, "abandon", None)
        if abandon is not None:
            try:
                abandon(f"router declared {name} dead: {cause}")
            except Exception:   # abandoning must never mask the death
                pass

    def replicas(self) -> Dict[str, str]:
        """``{name: state}`` — the membership table."""
        with self._lock:
            return {n: r.state for n, r in self._replicas.items()}

    def _track(self, handle: "RouterHandle", replica: str) -> None:
        """Move a handle's inflight membership to ``replica`` (and off
        every other replica): a rerouted or hedge-adopted request must
        appear in the death dump of the replica actually RUNNING it,
        not of one it left — trace_view reconstructs reroutes from
        those correlation-id sets."""
        with self._lock:
            for r in self._replicas.values():
                r.inflight.discard(handle)
            rep = self._replicas.get(replica)
            if rep is not None:
                rep.inflight.add(handle)

    # -------------------------------------------------------- placement
    def _score(self, rep: _Replica, prompt: np.ndarray,
               digest_cache: dict, adapter_id: Optional[str]) -> float:
        srv = rep.server
        occupancy = srv.engine.active_count / srv.engine.slots
        queue = srv.scheduler.depth / srv.scheduler.max_queue_depth
        affinity = 0.0
        pool = srv.engine.pool
        store = getattr(srv.engine, "store", None)
        if pool is not None and prompt.shape[0] > 0:
            # hash the prompt ONCE per (block size, adapter namespace),
            # not once per replica — placement is the submit hot path.
            # The salt comes from the replica's own AdapterStore (the
            # SAME source its engine stamps blocks with, version
            # included), so affinity reflects blocks this TENANT could
            # actually hit on this replica
            bs = pool.block_tokens
            salt = (store.salt(adapter_id)
                    if adapter_id is not None and store is not None
                    else b"")
            digests = digest_cache.get((bs, salt))
            if digests is None:
                from .prefix_cache import chain_digests

                digests = digest_cache[(bs, salt)] = chain_digests(
                    prompt, bs, salt)
            affinity = (self.affinity_weight * pool.match_digests(digests)
                        / float(prompt.shape[0]))
            if self.prefix_index is not None and adapter_id is None:
                # fleet tier: blocks resident on ANOTHER replica are
                # reachable here via migration, priced below a local
                # hit by remote_hit_weight (ship bytes vs recompute).
                # max, not sum — the migration only helps for chain
                # blocks the local pool would otherwise recompute
                blocks, _src = self.prefix_index.match(
                    digests, exclude=rep.name)
                remote = (self.remote_hit_weight * self.affinity_weight
                          * blocks * bs / float(prompt.shape[0]))
                if remote > affinity:
                    affinity = remote
                    self.prefix_remote_hits += 1
                    _obs_registry.default_registry().inc(
                        "fleet.prefix_remote_hits", source="router")
        if adapter_id is not None and store is not None \
                and store.resident(adapter_id):
            affinity += self.adapter_affinity_weight
        return affinity - occupancy - queue

    def _candidates(self, prompt: np.ndarray, prefer: Optional[str],
                    adapter_id: Optional[str] = None) -> List[_Replica]:
        with self._lock:
            active = [r for r in self._replicas.values()
                      if r.state == ACTIVE]
            if not active:
                # degraded fallback: when EVERY live replica is merely
                # SUSPECT (slow but answering), serving slowly beats
                # rejecting the fleet's whole offered load
                active = [r for r in self._replicas.values()
                          if r.state == SUSPECT]
        if not active:
            raise NoReplicasAvailable(
                "no ACTIVE replica (all draining or dead); add_replica() "
                "or retry after a drain completes")
        if adapter_id is not None:
            # only replicas whose registry KNOWS the tenant can serve it
            # — an unfiltered pick would abort placement on the replica's
            # submit-time ValueError instead of failing over (e.g. a
            # freshly added replica whose adapters haven't synced yet)
            able = [r for r in active
                    if (st := getattr(r.server.engine, "store", None))
                    is not None and st.known(adapter_id)]
            if not able:
                raise ValueError(
                    f"no ACTIVE replica knows adapter {adapter_id!r}; "
                    f"AdapterStore.register()/load() it on at least one "
                    f"replica")
            active = able
        digest_cache: dict = {}
        scored = sorted(
            active,
            key=lambda r: (r.name != prefer,
                           -self._score(r, prompt, digest_cache,
                                        adapter_id),
                           r.name))
        return scored

    def _place(self, handle: RouterHandle,
               prefer: Optional[str] = None, exclude=()) -> None:
        kwargs = handle._kwargs
        prompt = kwargs["prompt"]
        saw_full = False
        rate_limited = None
        for rep in self._candidates(prompt, prefer,
                                    kwargs.get("adapter_id")):
            if rep.name in exclude:
                continue             # hedges skip the stalled replica
            try:
                inner = rep.server.submit(**kwargs)
            except RateLimited as e:
                # the TENANT is over its per-replica allowance — another
                # replica's bucket may still have tokens, so keep
                # failing over; remember the verdict in case none does
                rate_limited = e
                continue
            except Backpressure:
                # QueueFull (at depth) or Overloaded (deadline-aware
                # shed): the replica is alive, just over capacity —
                # fail over to the next candidate before propagating
                saw_full = True
                continue
            except (SchedulerClosed, ReplicaUnreachable):
                # shut down / unreachable behind our back — dead, keep
                # going (ReplicaUnreachable is how a RemoteReplica's
                # transport classification surfaces a lost peer)
                self._mark_dead(rep.name, cause="submit failed")
                continue
            handle._attach(rep.name, inner)
            self._track(handle, rep.name)
            with self._lock:
                rep.routed += 1
                self.requests_routed += 1
            return
        if rate_limited is not None and not saw_full:
            # EVERY rejection was this tenant's own rate limit: surface
            # it (tenant + retry_after intact) — "no replicas" advice
            # would send the client chasing membership instead of
            # backing off its own traffic
            raise rate_limited
        if saw_full or rate_limited is not None:
            # at least one LIVE replica exists and rejected on
            # depth/deadline: backpressure, not a fleet-down condition
            raise QueueFull(
                "every live replica is over capacity (queue depth or "
                "deadline-aware shed); retry with backoff (RetryPolicy "
                "treats this like any transport failure)")
        # every candidate was closed (marked DEAD above) or none existed:
        # the retryable membership error, NOT the non-retryable
        # SchedulerClosed — an add_replica()/finished drain may be a
        # moment away and RetryPolicy callers must survive the race
        raise NoReplicasAvailable(
            "no ACTIVE replica accepted (all dead or draining); "
            "add_replica() or retry after membership settles")

    # ------------------------------------------------------------ client
    def submit(self, prompt, max_new_tokens: int = 32,
               do_sample: bool = False, temperature: float = 1.0,
               top_p: float = 1.0, eos_token_id: Optional[int] = None,
               seed: Optional[int] = None,
               deadline: Optional[float] = None,
               prefer: Optional[str] = None,
               adapter_id: Optional[str] = None) -> RouterHandle:
        """Place one request on the best replica; returns a
        :class:`RouterHandle`. Same contract as
        :meth:`InferenceServer.submit`, plus:

        - unseeded sampled requests get a fresh concrete seed HERE, so a
          mid-stream replica death replays the identical stream on the
          survivor (still fresh randomness per request — the solo
          semantics);
        - ``prefer`` pins the first placement attempt to a named replica
          (ops escape hatch; failover still applies);
        - ``adapter_id`` adds adapter-affinity to placement: the tenant
          lands where its pages are already device-resident when load
          allows, and a reroute carries the adapter to the survivor;
        - the router mints the request's tracing **correlation id** here
          (``RouterHandle.correlation_id``): the placement span and every
          downstream replica span — queue wait, prefill, per-token
          decode, stream end, even across a crash reroute — share one
          trace lane keyed by it."""
        from ..lora.store import normalize_adapter_id

        prompt = np.asarray(prompt, np.int32).ravel()
        adapter_id = normalize_adapter_id(adapter_id)
        if do_sample and seed is None:
            seed = int.from_bytes(os.urandom(7), "little")
        corr = _tracing.new_correlation_id()
        t0 = time.time()
        handle = RouterHandle(self, dict(
            prompt=prompt, max_new_tokens=int(max_new_tokens),
            do_sample=bool(do_sample), temperature=float(temperature),
            top_p=float(top_p), eos_token_id=eos_token_id, seed=seed,
            deadline=deadline, adapter_id=adapter_id,
            correlation_id=corr))
        self._place(handle, prefer=prefer)
        tags = {"replica": handle.replica,
                "prompt_len": int(prompt.shape[0])}
        if adapter_id is not None:
            tags["adapter"] = adapter_id
        _tracing.record_span("router:submit", t0, time.time(), corr=corr,
                             tags=tags)
        return handle

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop every replica (see ``InferenceServer.shutdown``)."""
        if self._autoscaler is not None:
            # the controller first: a scaling decision mid-shutdown
            # would race the membership teardown below
            self._autoscaler.stop()
        if self._health_stop is not None:
            self._health_stop.set()
            if self._health_thread is not None:
                self._health_thread.join(timeout=5.0)
        if self._scrape_stop is not None:
            self._scrape_stop.set()
            if self._scrape_thread is not None:
                self._scrape_thread.join(timeout=5.0)
        with self._lock:
            reps = list(self._replicas.values())
        errs = []
        for rep in reps:
            if rep.state == DEAD:
                continue   # already declared dead: nothing to stop
            try:
                rep.server.shutdown(drain=drain, timeout=timeout)
            except ReplicaUnreachable:
                # the peer is gone — which is exactly the state
                # shutdown wants; a corpse must not fail the fleet exit
                pass
            except Exception as e:  # keep shutting the rest down
                errs.append(e)
            with self._lock:
                rep.state = DEAD
        if errs:
            raise errs[0]

    def __enter__(self) -> "ReplicaRouter":
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown(drain=exc == (None, None, None))
        return False

    # ------------------------------------------------------------- stats
    def statusz(self) -> dict:
        """Fleet ``/statusz``: membership table + the roll-up snapshot
        (per-replica ``InferenceServer.statusz()`` is one hop away),
        plus the failure-detector block (per-replica state / miss
        counts / probe-latency EWMA and the hedge counters) so a gray
        replica is diagnosable from this one endpoint."""
        return {"time": round(time.time(), 3), "pid": os.getpid(),
                "replicas": self.replicas(), "snapshot": self.snapshot(),
                "detector": self.detector_statusz(),
                **({"autoscaler": self._autoscaler.statusz()}
                   if self._autoscaler is not None else {})}

    def metrics_text(self) -> str:
        """Prometheus text for the whole process (all replicas share the
        registry; per-server labels keep them apart)."""
        from ..observability import default_registry

        return default_registry().prometheus_text()

    def snapshot(self) -> dict:
        """Fleet roll-up: per-replica server snapshots plus the router's
        own placement counters and the fleet-wide prefix hit rate."""
        with self._lock:
            reps = list(self._replicas.items())
            routed = self.requests_routed
            rerouted = self.requests_rerouted
            hedged = self.requests_hedged
            hedge_wins = self.hedge_wins
            failed = self.replicas_failed
            suspected = self.replicas_suspected
            revived = self.replicas_revived
        per_replica = {}
        hit = miss = completed = tokens = 0
        per_adapter: Dict[str, dict] = {}
        for name, rep in reps:
            snap = (rep.server.snapshot() if rep.state != DEAD
                    else {"state": DEAD})
            snap["state"] = rep.state
            snap["routed"] = rep.routed
            per_replica[name] = snap
            hit += snap.get("prefix_hit_tokens", 0)
            miss += snap.get("prefix_miss_tokens", 0)
            completed += snap.get("requests_completed", 0)
            tokens += snap.get("tokens_emitted", 0)
            for a_name, e in snap.get("per_adapter", {}).items():
                agg = per_adapter.setdefault(
                    a_name, {"requests": 0, "tokens": 0, "failures": 0,
                             "ttft_count": 0, "ttft_sum_ms": 0.0})
                agg["requests"] += e.get("requests", 0)
                agg["tokens"] += e.get("tokens", 0)
                agg["failures"] += e.get("failures", 0)
                agg["ttft_count"] += e.get("ttft_count", 0)
                agg["ttft_sum_ms"] = round(
                    agg["ttft_sum_ms"] + e.get("ttft_sum_ms", 0.0), 3)
        seen = hit + miss
        return {
            "replicas": per_replica,
            "requests_routed": routed,
            "requests_rerouted": rerouted,
            "requests_hedged": hedged,
            "hedge_wins": hedge_wins,
            "replicas_failed": failed,
            "replicas_suspected": suspected,
            "replicas_revived": revived,
            "requests_completed": completed,
            "tokens_emitted": tokens,
            "prefix_hit_tokens": hit,
            "prefix_miss_tokens": miss,
            "prefix_hit_rate": round(hit / seen, 4) if seen else 0.0,
            **({"per_adapter": per_adapter} if per_adapter else {}),
        }

"""Burn-rate-driven autoscaler: the actuation half of the SLO loop (port
of ``paddle_tpu/serving/autoscaler.py``; host-only, copied and adapted).

``ReplicaRouter.slo_report()`` computes per-tenant fast/slow burn rates
from the scrape plane; :class:`Autoscaler` acts on them:

- **scale out** on SUSTAINED slow-window burn: some tenant (or the
  ``__fleet__`` pseudo-tenant) has been over its slow-window burn
  threshold for ``sustain_ticks`` consecutive evaluations. The slow
  window is deliberate: the fast window pages humans, and feeding it to
  an actuator would thrash the fleet on every transient spike. New
  capacity arrives via the ``spawn`` callable (typically a
  :class:`ProcessReplicaSpawner` launching a child host process, a fresh
  interpreter and never a fork, through the rpc fabric:
  ``remote.host_server`` on the far side) and joins placement through
  the ordinary ``router.add_replica()``;
- **scale in** on SUSTAINED headroom: burn quiet AND mean replica load
  (slot occupancy + queue fraction, the placement score's load term)
  under ``scale_in_load`` for ``sustain_ticks`` evaluations. The victim
  is DRAINED (``router.drain()`` finishes every accepted request before
  the server stops), never killed, so scale-in can not lose a request;
- **hysteresis + cooldown + bounds** make the loop flap-proof: the
  sustain counters reset whenever the signal flips, ``cooldown_s``
  blocks back-to-back actions, and ``min_replicas``/``max_replicas``
  bound the fleet no matter what the detector claims;
- **abuse-proof by construction**: rate-limited rejects (``RateLimited``
  at admission) are booked as the system working, not as tenant
  failures, so a tenant hammering its token bucket generates no burn.

Every decision is counted, traced and flight-dumped with the triggering
tenant and its burn evidence under its own ``scale-...`` correlation id.

Threading: the loop is a daemon thread (default OFF: no ``interval``,
no thread), every rpc / spawn / drain runs OUTSIDE the router lock, the
autoscaler's own lock guards only its counters and decision state, and
telemetry publishes with no lock held. The router's hook
(``ReplicaRouter._attach_autoscaler``) embeds :meth:`Autoscaler.statusz`
in ``router.statusz()`` and stops the loop in ``router.shutdown()``.
"""
from __future__ import annotations

import itertools
import os
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

from ..observability import flight as _flight
from ..observability import tracing as _tracing

__all__ = ["Autoscaler", "ProcessReplicaSpawner"]

_decision_serial = itertools.count(1)


class ProcessReplicaSpawner:
    """Spawn replica host processes through the rpc fabric.

    ``command`` is the child argv (it must ``rpc.init_rpc`` as
    ``peer`` / rank ``peer_rank``, build its server, and call
    ``remote.host_server``). Calling the spawner launches the child,
    performs THIS process's (deferred) ``rpc.init_rpc`` via ``init``
    on first use, wraps the peer in a
    :class:`~paddle_tpu_torch.serving.remote.RemoteReplica`, and blocks in
    ``wait_ready`` until the far server answers probes — the cold-start
    window. Keeps ``procs`` so the owner
    can stop the children (``remote._host_request_stop`` + ``wait``) at
    teardown; the autoscaler itself never kills what it spawned."""

    def __init__(self, command: List[str], peer: str, *,
                 init: Optional[Callable[[], None]] = None,
                 rpc_timeout: float = 30.0, connect_deadline: float = 2.0,
                 poll_interval: float = 0.01, ready_timeout: float = 300.0,
                 env: Optional[dict] = None):
        self.command = list(command)
        self.peer = peer
        self._init = init
        self._init_done = False
        self.rpc_timeout = float(rpc_timeout)
        self.connect_deadline = float(connect_deadline)
        self.poll_interval = float(poll_interval)
        self.ready_timeout = float(ready_timeout)
        self.env = dict(env) if env is not None else None
        self.procs: List[subprocess.Popen] = []

    def __call__(self, name: str):
        from .remote import RemoteReplica

        proc = subprocess.Popen(self.command, env=self.env)
        self.procs.append(proc)
        try:
            if self._init is not None and not self._init_done:
                self._init()          # rendezvous blocks until the child
                self._init_done = True  # registers — one fabric, once
            replica = RemoteReplica(
                self.peer, rpc_timeout=self.rpc_timeout,
                connect_deadline=self.connect_deadline,
                poll_interval=self.poll_interval)
            if not replica.wait_ready(timeout=self.ready_timeout):
                raise TimeoutError(
                    f"spawned replica {self.peer!r} not hosting after "
                    f"{self.ready_timeout:.0f}s")
        except BaseException:
            if proc.poll() is None:   # a failed spawn must not leak the
                proc.terminate()      # half-started child process
            raise
        return replica


class Autoscaler:
    """SLO-driven scale-out/scale-in controller for one
    :class:`~paddle_tpu_torch.serving.router.ReplicaRouter`.

    ``spawn`` is any callable ``(name) -> server-like`` producing a
    replica the router can ``add_replica()`` (a
    :class:`ProcessReplicaSpawner`, or a stub in tests). With
    ``interval`` set, ``start()`` runs :meth:`tick` on its own daemon
    thread; ``interval=None`` (the default) spawns NO thread — drive
    :meth:`tick` yourself (benches and tests do). Constructing an
    autoscaler registers it on the router: ``router.statusz()`` embeds
    :meth:`statusz` and ``router.shutdown()`` stops the loop."""

    def __init__(self, router, spawn: Callable[[str], object], *,
                 interval: Optional[float] = None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 scale_out_burn: Optional[float] = None,
                 scale_in_burn: float = 0.5,
                 scale_in_load: float = 0.25,
                 sustain_ticks: int = 2,
                 cooldown_s: float = 60.0,
                 drain_timeout: Optional[float] = 120.0,
                 replica_prefix: str = "auto",
                 burn_signal: Optional[str] = None,
                 clock=time.monotonic):
        if burn_signal not in (None, "ttft", "itl"):
            raise ValueError(
                f"burn_signal must be None, 'ttft' or 'itl', got "
                f"{burn_signal!r}")
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}")
        if sustain_ticks < 1:
            raise ValueError("sustain_ticks must be >= 1")
        self._router = router
        self._spawn = spawn
        self.interval = interval
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        #: slow-window burn that counts as "hot"; ``None`` defers to the
        #: report's own ``slow_breached`` verdict (the SloPolicy line)
        self.scale_out_burn = (None if scale_out_burn is None
                               else float(scale_out_burn))
        #: which burn track drives scaling: ``None`` = the combined
        #: availability+TTFT burn; ``"ttft"`` / ``"itl"`` read the per-signal burns an
        #: ``SloPolicy(target_itl_s=...)`` tracker reports — a
        #: disaggregated fleet runs TWO autoscalers over one router,
        #: the prefill pool's on TTFT burn, the decode pool's on ITL
        self.burn_signal = burn_signal
        self.scale_in_burn = float(scale_in_burn)
        self.scale_in_load = float(scale_in_load)
        self.sustain_ticks = int(sustain_ticks)
        self.cooldown_s = float(cooldown_s)
        self.drain_timeout = drain_timeout
        self.replica_prefix = str(replica_prefix)
        self._clock = clock
        self._lock = threading.Lock()
        self._stopping: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._serial = itertools.count(1)
        self._hot_ticks = 0
        self._idle_ticks = 0
        self._last_action_t: Optional[float] = None
        self._last_decision: Optional[dict] = None
        self._spawned: List[str] = []
        self.ticks = 0
        self.scale_outs = 0
        self.scale_ins = 0
        self.spawn_failures = 0
        router._attach_autoscaler(self)

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "Autoscaler":
        """Start the evaluation thread (no-op without ``interval``)."""
        if self.interval is None:
            return self
        with self._lock:
            if self._thread is None:
                self._stopping = threading.Event()
                self._thread = threading.Thread(
                    target=self._loop, name="pt-autoscaler", daemon=True)
                self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the evaluation thread (idempotent; the fleet keeps its
        current size — stopping the controller never drains anything)."""
        with self._lock:
            stop, thread = self._stopping, self._thread
        if stop is not None:
            stop.set()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=max(5.0, 2.0 * (self.interval or 0.0)))

    def _loop(self) -> None:
        with self._lock:
            stop = self._stopping   # published by start() under this lock
        while not stop.wait(self.interval):
            try:
                self.tick()
            except Exception:   # pragma: no cover - the loop never dies
                pass

    # --------------------------------------------------------- evaluation
    def _fleet_view(self):
        """(live replica names, mean load) — load is the placement
        score's own measure (slot occupancy + queue fraction), read from
        live attributes outside the router lock like ``_score`` does."""
        with self._router._lock:
            live = [(r.name, r.server)
                    for r in self._router._replicas.values()
                    if r.state in ("active", "suspect")]
        loads = []
        for _, srv in live:
            try:
                eng, sched = srv.engine, srv.scheduler
                loads.append(eng.active_count / max(1, eng.slots)
                             + sched.depth / max(1, sched.max_queue_depth))
            except Exception:
                pass   # a remote view mid-refresh never stalls a tick
        mean = (sum(loads) / len(loads)) if loads else None
        return [name for name, _ in live], mean

    def _burn_evidence(self, report: Optional[dict]):
        """(hot tenant evidence or None, worst slow burn) — the tenant
        whose slow window burns hottest above the scale-out line. With
        a ``burn_signal`` the per-signal burn track is read instead of
        the combined one (and ``slow_breached`` — a combined-burn
        verdict — no longer applies, so the signal is judged against
        ``scale_out_burn`` or the policy's slow threshold)."""
        sig = self.burn_signal
        key = "burn_slow" if sig is None else f"burn_slow_{sig}"
        fast_key = "burn_fast" if sig is None else f"burn_fast_{sig}"
        threshold = self.scale_out_burn
        if threshold is None and sig is not None:
            threshold = float(((report or {}).get("policy") or {})
                              .get("slow_burn_threshold") or 2.0)
        worst = None
        hot = None
        for name, ten in ((report or {}).get("tenants") or {}).items():
            burn = float(ten.get(key) or 0.0)
            if worst is None or burn > worst[1]:
                worst = (name, burn)
            if threshold is None:
                breached = bool(ten.get("slow_breached"))
            else:
                breached = (burn >= threshold
                            and (ten.get("window_slow") or {})
                            .get("total", 0) > 0)
            if breached and (hot is None or burn > hot["burn_slow"]):
                hot = {"tenant": name, "burn_slow": burn,
                       "burn_fast": float(ten.get(fast_key) or 0.0),
                       **({"signal": sig} if sig else {})}
        return hot, (worst[1] if worst else 0.0)

    def tick(self) -> Optional[dict]:
        """One evaluation round (the thread's body; public so benches
        and tests drive it synchronously). Returns the decision record
        when this tick scaled, else ``None``. When the router tracks an
        SLO but runs no scrape thread of its own, the tick scrapes
        first so the burn windows are current — every rpc in that round
        is Deadline-bounded by each replica's ``rpc_timeout`` and runs
        outside the router lock (``fleet_scrape_now`` discipline)."""
        router = self._router
        if router._slo is not None and router._scrape_thread is None:
            try:
                router.fleet_scrape_now()
            except Exception:
                pass
        report = router.slo_report()
        live, load = self._fleet_view()
        hot, worst_burn = self._burn_evidence(report)
        now = self._clock()
        decision = None
        with self._lock:
            self.ticks += 1
            cooling = (self._last_action_t is not None
                       and now - self._last_action_t < self.cooldown_s)
            if hot is not None and len(live) < self.max_replicas:
                self._hot_ticks += 1
                self._idle_ticks = 0
                if not cooling and self._hot_ticks >= self.sustain_ticks:
                    decision = dict(
                        action="scale_out", tenant=hot["tenant"],
                        burn_slow=round(hot["burn_slow"], 4),
                        burn_fast=round(hot["burn_fast"], 4),
                        replicas=len(live),
                        sustained_ticks=self._hot_ticks,
                        # which burn track fired (per-pool scaling
                        # evidence); absent on the combined signal
                        **({"signal": hot["signal"]}
                           if "signal" in hot else {}))
            elif (hot is None and len(live) > self.min_replicas
                  and worst_burn <= self.scale_in_burn
                  and load is not None and load <= self.scale_in_load):
                self._idle_ticks += 1
                self._hot_ticks = 0
                if not cooling and self._idle_ticks >= self.sustain_ticks:
                    decision = dict(
                        action="scale_in", tenant=None,
                        burn_slow=round(worst_burn, 4),
                        load=round(load, 4), replicas=len(live),
                        sustained_ticks=self._idle_ticks)
            else:
                self._hot_ticks = 0
                self._idle_ticks = 0
            if decision is not None:
                # stamp the cooldown at DECISION time, not completion:
                # a slow spawn must not let a second tick double-fire
                self._last_action_t = now
                self._hot_ticks = 0
                self._idle_ticks = 0
        if decision is None:
            return None
        if decision["action"] == "scale_out":
            return self._scale_out(decision)
        return self._scale_in(decision, live)

    # ------------------------------------------------------------ actions
    def _record(self, decision: dict) -> dict:
        """Publish one scaling decision — counter + trace event + flight
        note + flight DUMP, all outside every lock, each carrying the
        tenant/burn evidence under a dedicated correlation id (visible
        as its own lane in ``trace_view.py --list``)."""
        corr = f"scale-{os.getpid()}-{next(_decision_serial):04d}"
        decision = dict(decision, corr=corr, t=round(time.time(), 3))
        kind = decision["action"]
        tags = {k: v for k, v in decision.items()
                if k not in ("action", "corr", "t") and v is not None}
        _tracing.record_event(kind, corr=corr, **tags)
        _flight.note(kind, corr=corr, **{
            k: v for k, v in tags.items()
            if isinstance(v, (str, int, float, bool))})
        _flight.dump(kind, corr=corr, extra=decision)
        with self._lock:
            self._last_decision = decision
        return decision

    def _scale_out(self, decision: dict) -> dict:
        name = f"{self.replica_prefix}-{next(self._serial)}"
        decision["replica"] = name
        t0 = self._clock()
        try:
            server = self._spawn(name)    # rpc fabric / child process —
            self._router.add_replica(server, name)   # no lock held here
        except Exception as e:
            decision = dict(decision, action="scale_out_failed",
                            error=f"{type(e).__name__}: {e}")
            with self._lock:
                self.spawn_failures += 1
            return self._record(decision)
        decision["spawn_s"] = round(self._clock() - t0, 3)
        with self._lock:
            self.scale_outs += 1
            self._spawned.append(name)
        return self._record(decision)

    def _scale_in(self, decision: dict, live: List[str]) -> dict:
        victim = self._pick_victim(live)
        if victim is None:
            return decision   # membership changed under us: no-op tick
        decision["replica"] = victim
        try:
            # drain, never kill: placement stops, accepted work
            # finishes, THEN the server stops (router.drain lifecycle)
            self._router.drain(victim, timeout=self.drain_timeout)
        except TimeoutError:
            # still draining — the router keeps it DRAINING (placement
            # already stopped); record the decision as issued
            decision["drain_timeout"] = True
        except KeyError:
            return decision   # raced a concurrent removal
        with self._lock:
            self.scale_ins += 1
            if victim in self._spawned:
                self._spawned.remove(victim)
        return self._record(decision)

    def _pick_victim(self, live: List[str]) -> Optional[str]:
        """Newest autoscaler-spawned replica first (LIFO keeps the
        operator's hand-built fleet intact); otherwise the live replica
        with the fewest in-flight requests (cheapest drain)."""
        with self._lock:
            spawned = [n for n in reversed(self._spawned) if n in live]
        if spawned:
            return spawned[0]
        det = self._router.detector_statusz()["replicas"]
        candidates = [(det[n].get("inflight", 0), n)
                      for n in live if n in det]
        return min(candidates)[1] if candidates else None

    # ------------------------------------------------------------- status
    def statusz(self) -> dict:
        """The ``autoscaler`` block ``ReplicaRouter.statusz()`` embeds:
        controller state, the last decision and its reason/evidence,
        cooldown remaining, and every replica's per-tenant token-bucket
        levels (local replicas with rate limiting configured)."""
        now = self._clock()
        with self._lock:
            cooldown = 0.0
            if self._last_action_t is not None:
                cooldown = max(0.0, self.cooldown_s
                               - (now - self._last_action_t))
            running = self._thread is not None and self._thread.is_alive()
            if running:
                state = "cooldown" if cooldown > 0 else (
                    "sustaining" if (self._hot_ticks or self._idle_ticks)
                    else "watching")
            else:
                state = "manual" if self.interval is None else "stopped"
            status = {
                "state": state,
                "ticks": self.ticks,
                "scale_outs": self.scale_outs,
                "scale_ins": self.scale_ins,
                "spawn_failures": self.spawn_failures,
                "hot_ticks": self._hot_ticks,
                "idle_ticks": self._idle_ticks,
                "cooldown_remaining_s": round(cooldown, 3),
                "last_decision": (dict(self._last_decision)
                                  if self._last_decision else None),
                "spawned": list(self._spawned),
                "config": {
                    "interval": self.interval,
                    "min_replicas": self.min_replicas,
                    "max_replicas": self.max_replicas,
                    "burn_signal": self.burn_signal,
                    "scale_out_burn": self.scale_out_burn,
                    "scale_in_burn": self.scale_in_burn,
                    "scale_in_load": self.scale_in_load,
                    "sustain_ticks": self.sustain_ticks,
                    "cooldown_s": self.cooldown_s,
                },
            }
        status["token_buckets"] = self._bucket_levels()
        return status

    def _bucket_levels(self) -> Dict[str, dict]:
        """Per-replica per-tenant token-bucket fill — local replicas
        whose scheduler rate-limits (remote views don't export buckets;
        their own ``statusz`` rpc carries them host-side)."""
        with self._router._lock:
            servers = [(r.name, r.server)
                       for r in self._router._replicas.values()
                       if r.state != "dead"]
        out: Dict[str, dict] = {}
        for name, srv in servers:    # outside the router lock (R7)
            fn = getattr(getattr(srv, "scheduler", None),
                         "bucket_levels", None)
            if fn is None:
                continue
            try:
                levels = fn()
            except Exception:
                continue
            if levels:
                out[name] = levels
        return out

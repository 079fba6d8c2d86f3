"""Remote replicas: drive an :class:`InferenceServer` in another process
over ``distributed.rpc``, behind the same interface the router already
speaks (port of ``paddle_tpu/serving/remote.py``; framework-free, so
copied).

A :class:`~paddle_tpu_torch.serving.router.ReplicaRouter` over local
servers holds direct python references to its replicas, so the only
failures it can survive are in-process ones. This module splits that
boundary across processes and hosts:

- **host side** — the process that owns the card calls
  :func:`host_server` on its started ``InferenceServer`` (after
  ``rpc.init_rpc``); the module-level ``_host_*`` functions are the rpc
  surface (submit / stream-poll / probe / snapshot / statusz / drain,
  plus the observability plane's metrics-snapshot and trace-export
  reads), pickled by reference so any peer that imports this module can
  call them;
- **client side** — :class:`RemoteReplica` adapts that surface back into
  the duck type ``ReplicaRouter`` scores and submits to: a ``.engine`` /
  ``.scheduler`` load view refreshed from health probes, ``submit()``
  returning a :class:`RemoteHandle` whose background poller mirrors the
  remote token stream into a local :class:`RequestHandle` (same
  ``result()``/``stream()`` contract, same at-least-once restart
  semantics across the remote server's crash recovery).

Failure classification is the resilience layer's: every call is bounded
by a per-call :class:`~paddle_tpu_torch.distributed.resilience.Deadline`
and
transport failures surface as :class:`ReplicaUnreachable` (a retryable
``ConnectionError``), while application errors the host raises —
``QueueFull``, ``Overloaded``, ``SchedulerClosed``, ``ValueError`` —
cross the wire unwrapped, so the router's failover logic cannot tell a
remote replica from a local one. Idempotent calls (poll / probe /
snapshot / shutdown) retry transport blips through a ``RetryPolicy``;
``submit`` is NEVER retried at this layer (a lost response would make a
duplicate admission undecidable) — a transport-failed submit reports
``ReplicaUnreachable`` and the router fails over to another replica,
where the router-assigned seed keeps the replayed stream token-identical.

Everything crosses the wire as host numpy and plain python: prompts,
token lists, the KV payloads of the migration surface. A host process on
the card keeps its tensors there; nothing device-resident is pickled.
"""
from __future__ import annotations

import itertools
import os
import socket
import threading
import time
import weakref
from typing import Dict, Optional

import numpy as np

from ..distributed import rpc
from ..distributed.resilience import Deadline, FaultPlan, RetryPolicy
from ..distributed.rpc import RpcTransportError
from ..observability import fleet as _fleet
from ..observability import tracing as _tracing
from .scheduler import Request
from .server import RequestHandle

__all__ = ["RemoteReplica", "RemoteHandle", "ReplicaUnreachable",
           "host_server", "unhost_server", "hosted_names",
           "wait_for_stop", "stop_requested"]


class ReplicaUnreachable(ConnectionError):
    """The remote replica's host cannot be reached (connect refused,
    connection dropped mid-call, retry budget spent). Retryable by
    classification, but the router treats it like ``SchedulerClosed``:
    mark the replica DEAD and fail over — a peer that stopped answering
    is indistinguishable from a crashed one until an operator re-adds
    it."""


# ---------------------------------------------------------------------------
# host side: the rpc surface (module-level functions pickle by reference)
# ---------------------------------------------------------------------------
_host_lock = threading.Lock()
_hosted: Dict[str, object] = {}            # name -> server
_live: Dict[str, object] = {}              # rid  -> RequestHandle
_retired_at: Dict[str, float] = {}         # rid  -> done wall-time
_rid_serial = itertools.count()
_RETIRE_TTL = 60.0                         # keep done handles pollable
_stop_event = threading.Event()


def host_server(server, name: str = "default") -> str:
    """Expose ``server`` (started if it is not yet) to rpc peers under
    ``name``. One process can host several servers; each is addressed by
    ``(rpc worker, name)``."""
    with _host_lock:
        if name in _hosted:
            raise ValueError(f"server {name!r} already hosted here")
        _hosted[name] = server
    server.start()
    return name


def unhost_server(name: str = "default") -> None:
    with _host_lock:
        _hosted.pop(name, None)


def hosted_names():
    with _host_lock:
        return sorted(_hosted)


def _get_server(name: str):
    with _host_lock:
        srv = _hosted.get(name)
    if srv is None:
        raise RuntimeError(f"no hosted serving replica {name!r} in this "
                           f"process; call remote.host_server() first")
    return srv


def _sweep_retired_locked(now: float) -> None:
    # stamp completions the client never saw (its poller died / it
    # rerouted away mid-blip): without this, an unpolled-to-done handle
    # would sit in _live forever and a long-running host would leak
    for rid, handle in _live.items():
        if rid not in _retired_at and handle.done:
            _retired_at[rid] = now
    for rid in [r for r, t in _retired_at.items()
                if now - t > _RETIRE_TTL]:
        _retired_at.pop(rid, None)
        _live.pop(rid, None)


def _host_submit(name: str, kwargs: dict) -> str:
    """Admit one request on the hosted server; returns a request id the
    client polls. Admission errors (``QueueFull``/``Overloaded``/
    ``SchedulerClosed``/``ValueError``) propagate to the caller
    unwrapped."""
    srv = _get_server(name)
    handle = srv.submit(**dict(kwargs))
    rid = f"{name}-{next(_rid_serial)}"
    now = time.monotonic()
    with _host_lock:
        _sweep_retired_locked(now)
        _live[rid] = handle
    return rid


def _host_poll(rid: str, cursor: int) -> dict:
    """Read-only stream poll: tokens beyond ``cursor``, completion state,
    and the error (the exception object itself — it pickles back to the
    client and re-raises with its real type). ``restarted`` flags a
    crash-recovery requeue on the host (its token list shrank below the
    client's cursor), telling the client to replay from the start — the
    same at-least-once contract a local ``stream()`` has. Idempotent:
    done handles stay pollable for a grace TTL so a lost response can be
    re-asked."""
    with _host_lock:
        handle = _live.get(rid)
    if handle is None:
        raise KeyError(f"unknown or expired remote request {rid!r}")
    # read DONE first, tokens second: the worker pushes the final token
    # before setting the done event, so this order can never pair
    # done=True with a token list missing the tail (the reverse order
    # could, truncating the stream on the race)
    done = handle.done
    toks = handle.tokens()
    restarted = len(toks) < cursor
    out = {
        "tokens": [int(t) for t in (toks if restarted else toks[cursor:])],
        "count": int(len(toks)),
        "restarted": restarted,
        "done": done,
        "error": handle.error if done else None,
        "ttft_s": handle.ttft_s,
        "cache_hit_tokens": int(handle.cache_hit_tokens),
    }
    if done:
        with _host_lock:
            _retired_at.setdefault(rid, time.monotonic())
    return out


def _host_probe(name: str) -> dict:
    # probes are the host's periodic heartbeat: piggyback the retired-
    # handle sweep so a submit-quiet host still reclaims its registry
    with _host_lock:
        _sweep_retired_locked(time.monotonic())
    return _get_server(name).probe()


def _host_snapshot(name: str) -> dict:
    return _get_server(name).snapshot()


def _host_statusz(name: str) -> dict:
    return _get_server(name).statusz()


def _host_metrics(name: str) -> dict:
    """This PROCESS's unified-registry snapshot — the payload the
    router's fleet scrape rolls up under a ``replica=`` label. The
    hosted ``name`` is only an existence check (a peer that never
    hosted anything should fail the scrape loudly, not export an empty
    registry as if healthy); the registry itself is process-wide, so
    co-hosted servers ride along under their own ``server=`` labels.
    The wall-clock stamp lets the scraper refresh its clock-offset
    estimate from the scrape's own RTT midpoint. The hosted server's
    own ``snapshot()`` rides along under ``serving_snapshot`` so the
    router's SLO ingest doesn't need a second rpc fan-out per scrape
    round."""
    srv = _get_server(name)
    from ..observability import default_registry

    snap = default_registry().snapshot()
    snap["host"] = socket.gethostname()
    snap["pid"] = os.getpid()
    snap["time"] = time.time()
    snap["serving_snapshot"] = srv.snapshot()
    return snap


def _host_trace_export(name: str, corr: Optional[str] = None,
                       tail: Optional[int] = None) -> dict:
    """Export this process's bounded span ring (optionally filtered to
    one correlation id, optionally only the newest ``tail`` spans) —
    remote trace collection with no dump files shipped between hosts.
    Timestamps stay in THIS host's wall clock; the caller aligns them
    with its clock-offset estimate (``observability.fleet``)."""
    _get_server(name)
    spans = _tracing.spans(corr=corr)
    if tail is not None and tail >= 0:
        spans = spans[-int(tail):]
    return {"host": socket.gethostname(), "pid": os.getpid(),
            "time": time.time(), "spans": spans,
            "stats": _tracing.stats()}


def _host_shutdown(name: str, drain: bool = True,
                   timeout: Optional[float] = None) -> bool:
    srv = _get_server(name)
    srv.shutdown(drain=drain, timeout=timeout)
    return True


# -- chaos-drill helpers (tools/fleet_chaos.py drives these over rpc) -------
_chaos_plan: Optional[FaultPlan] = None
_chaos_lock = threading.Lock()


def _host_install_plan(plan_json: str) -> bool:
    """Install a :class:`FaultPlan` in THIS process (replacing any prior
    chaos plan) — how the fleet soak turns a healthy remote replica into
    a slow/faulty one mid-run without restarting it."""
    global _chaos_plan
    plan = FaultPlan.from_json(plan_json)
    with _chaos_lock:
        if _chaos_plan is not None:
            _chaos_plan.uninstall()
        plan.install(env=False)
        _chaos_plan = plan
    return True


def _host_clear_plan() -> bool:
    global _chaos_plan
    with _chaos_lock:
        if _chaos_plan is not None:
            _chaos_plan.uninstall()
            _chaos_plan = None
    return True


def _host_request_stop() -> bool:
    """Ask the hosting process to wind down (its main thread typically
    sits in :func:`wait_for_stop`)."""
    _stop_event.set()
    return True


def stop_requested() -> bool:
    return _stop_event.is_set()


def wait_for_stop(timeout: Optional[float] = None) -> bool:
    """Block the host's main thread until a peer calls
    ``_host_request_stop`` (or ``timeout`` elapses); returns whether the
    stop was requested."""
    return _stop_event.wait(timeout)


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------
class _EngineView:
    """Load numbers the router's placement scorer reads, refreshed from
    probes. ``pool``/``store`` stay ``None``: prefix/adapter affinity is
    a local-replica signal (the block pool lives across the wire)."""

    __slots__ = ("active_count", "slots")
    pool = None
    store = None

    def __init__(self):
        self.active_count = 0
        self.slots = 1


class _SchedulerView:
    __slots__ = ("depth", "max_queue_depth")

    def __init__(self):
        self.depth = 0
        self.max_queue_depth = 1


class RemoteHandle(RequestHandle):
    """Client-side mirror of a request running on a remote replica.

    A daemon poller thread stream-polls the host and replays what it
    learns into the inherited :class:`RequestHandle` machinery, so
    ``result()``/``stream()``/``tokens()``/``done`` behave exactly like
    a local handle's. A host-side crash-recovery restart surfaces as the
    usual at-least-once replay; a transport failure (retry budget spent)
    fails the handle with :class:`ReplicaUnreachable`, which the
    ``RouterHandle`` above it treats as a replica death and reroutes."""

    def __init__(self, replica: "RemoteReplica", req: Request, rid: str):
        super().__init__(req)
        self._replica = replica
        self._rid = rid
        self._cursor = 0
        self._poller = threading.Thread(
            target=self._poll_loop, daemon=True,
            name=f"pt-remote-poll-{rid}")
        self._poller.start()

    def _poll_loop(self) -> None:
        interval = self._replica.poll_interval
        while not self._done_evt.is_set():
            try:
                out = self._replica._call(
                    _host_poll, self._rid, self._cursor,
                    what="remote poll")
            except ReplicaUnreachable as e:
                self._fail(e)
                return
            except KeyError as e:
                # the host forgot us (it restarted, or the grace TTL
                # lapsed): the stream cannot resume — same remedy as a
                # dead peer, reroute via the handle failure
                self._fail(ReplicaUnreachable(
                    f"replica {self._replica.peer!r} lost request "
                    f"{self._rid!r}: {e}"))
                return
            except BaseException as e:   # unexpected: surface, never hang
                self._fail(e)
                return
            if out["restarted"]:
                self._cursor = 0
                self._restart()
            if out["tokens"]:
                now = time.monotonic()
                if self.ttft_s is None:
                    # client-observed TTFT (includes the wire) — the
                    # consistent basis for RouterHandle's reroute-aware
                    # TTFT arithmetic, which offsets by _submit_t
                    self.ttft_s = now - self._submit_t
                for tok in out["tokens"]:
                    self._push(tok)
                self._last_token_t = now
            self._cursor = out["count"]
            self.cache_hit_tokens = out["cache_hit_tokens"]
            if out["done"]:
                if out["error"] is not None:
                    self._fail(out["error"])
                else:
                    self._finish()
                return
            time.sleep(interval)


class RemoteReplica:
    """An ``InferenceServer`` in another process, addressed by its rpc
    worker name, wearing the local-server duck type the router drives
    (``engine``/``scheduler`` load views, ``submit``/``start``/
    ``shutdown``/``snapshot``/``statusz``/``probe``).

    Every rpc is bounded by a per-call :class:`Deadline` derived from
    ``rpc_timeout`` (and a sub-window ``connect_deadline`` so a DEAD
    peer is classified fast, not at the transport's leisurely default);
    idempotent calls retry transport failures through ``retry``. The
    router's heartbeat detector calls :meth:`probe`, which doubles as
    the load-view refresh. :meth:`abandon` fails every live handle with
    :class:`ReplicaUnreachable` — the detector invokes it when it
    declares this replica dead, so in-flight streams reroute
    immediately instead of waiting out their own poll retries."""

    def __init__(self, peer: str, hosted_name: str = "default", *,
                 rpc_timeout: float = 10.0,
                 connect_deadline: float = 1.0,
                 poll_interval: float = 0.02,
                 retry: Optional[RetryPolicy] = None):
        self.peer = peer
        self.hosted_name = hosted_name
        self.rpc_timeout = float(rpc_timeout)
        self.connect_deadline = float(connect_deadline)
        self.poll_interval = float(poll_interval)
        # transport-only retry: RpcTransportError is ours to absorb;
        # remote application exceptions pass through untouched
        self._retry = retry or RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=0.5,
            retryable=(RpcTransportError,))
        self._no_retry = RetryPolicy(
            max_attempts=1, retryable=(RpcTransportError,))
        self.engine = _EngineView()
        self.scheduler = _SchedulerView()
        self._handles: "weakref.WeakSet[RemoteHandle]" = weakref.WeakSet()
        # clock alignment state, refreshed from every timestamped
        # response (probe / metrics / trace export): the remote clock's
        # offset vs ours, estimated at each call's RTT midpoint
        # (observability.fleet.estimate_clock_offset), EWMA-smoothed
        self._clock_lock = threading.Lock()
        self._clock_offset_s: Optional[float] = None
        self._rtt_ewma_s: Optional[float] = None
        self._clock_samples = 0

    # ---------------------------------------------------- clock tracking
    def _note_clock(self, t0_wall: float, t1_wall: float,
                    remote_t) -> None:
        """Fold one timestamped round trip into the clock-offset/RTT
        EWMAs the fleet trace stitcher aligns remote spans with."""
        if not isinstance(remote_t, (int, float)):
            return
        off = _fleet.estimate_clock_offset(t0_wall, t1_wall, remote_t)
        rtt = max(0.0, t1_wall - t0_wall)
        with self._clock_lock:
            self._clock_offset_s = (
                off if self._clock_offset_s is None
                else 0.8 * self._clock_offset_s + 0.2 * off)
            self._rtt_ewma_s = (rtt if self._rtt_ewma_s is None
                                else 0.8 * self._rtt_ewma_s + 0.2 * rtt)
            self._clock_samples += 1

    @property
    def clock_offset_s(self) -> Optional[float]:
        """Estimated remote-minus-local wall-clock offset (seconds;
        ``None`` until a timestamped response has been seen)."""
        with self._clock_lock:
            return self._clock_offset_s

    @property
    def rtt_ewma_s(self) -> Optional[float]:
        with self._clock_lock:
            return self._rtt_ewma_s

    def clock_stats(self) -> dict:
        with self._clock_lock:
            return {
                "clock_offset_ms": (
                    None if self._clock_offset_s is None
                    else round(self._clock_offset_s * 1e3, 3)),
                "rtt_ewma_ms": (None if self._rtt_ewma_s is None
                                else round(self._rtt_ewma_s * 1e3, 3)),
                "clock_samples": self._clock_samples,
            }

    # ------------------------------------------------------------ plumbing
    def _call(self, fn, *args, what: str = "remote call",
              deadline: Optional[Deadline] = None, retry=None,
              rpc_timeout: Optional[float] = None):
        timeout = rpc_timeout if rpc_timeout is not None else self.rpc_timeout
        if deadline is not None:
            timeout = max(0.05, min(timeout, deadline.remaining()))

        def once():
            return rpc.rpc_sync(
                self.peer, fn, args=args, timeout=timeout,
                connect_deadline=min(self.connect_deadline, timeout))

        try:
            return (retry or self._retry).call(
                once, what=f"{what} {self.peer}")
        except RpcTransportError as e:
            # transport only: the attempt-capped policies re-raise the
            # original RpcTransportError on exhaustion, so application
            # exceptions from the remote fn — including a drain
            # TimeoutError from the hosted server — pass through
            # UNWRAPPED, exactly like a local replica's would
            raise ReplicaUnreachable(
                f"replica {self.peer!r} unreachable ({what}): {e}") from e

    # ----------------------------------------------------- server surface
    def start(self) -> "RemoteReplica":
        """Best-effort initial probe to seed the load view. Never raises
        — an unreachable or still-booting peer (its ``host_server`` call
        may be seconds away behind a model build) is membership's
        problem: the router's detector or first placement attempt will
        classify it."""
        try:
            self.probe()
        except Exception:
            pass
        return self

    def wait_ready(self, timeout: float = 120.0,
                   interval: float = 0.25) -> bool:
        """Poll until the peer actually hosts ``hosted_name`` (rpc up
        AND ``host_server`` called); returns readiness. Operators call
        this between spawning a replica process and handing it to a
        router whose failure detector would otherwise count the boot
        window as probe misses."""
        deadline = Deadline(timeout)
        while True:
            try:
                self.probe()
                return True
            except Exception:
                if deadline.expired():
                    return False
                time.sleep(interval)

    def submit(self, **kwargs) -> RemoteHandle:
        kwargs = dict(kwargs)
        prompt = np.asarray(kwargs["prompt"], np.int32).ravel()
        kwargs["prompt"] = prompt
        # no transport retry (see module docstring): a lost submit
        # response must surface, not double-admit
        rid = self._call(_host_submit, self.hosted_name, kwargs,
                         what="remote submit", retry=self._no_retry,
                         deadline=Deadline(self.rpc_timeout))
        req = Request(
            prompt=prompt,
            max_new_tokens=int(kwargs.get("max_new_tokens", 32)),
            greedy=not kwargs.get("do_sample", False),
            temperature=float(kwargs.get("temperature", 1.0)),
            top_p=float(kwargs.get("top_p", 1.0)),
            eos_token_id=kwargs.get("eos_token_id"),
            seed=kwargs.get("seed"),
            adapter_id=kwargs.get("adapter_id"),
            corr_id=kwargs.get("correlation_id"))
        handle = RemoteHandle(self, req, rid)
        req.handle = handle
        self._handles.add(handle)
        return handle

    def probe(self) -> dict:
        """One health probe (rpc ``InferenceServer.probe``), refreshing
        the load view the router's placement scorer reads. Single rpc
        attempt, no transport retry: the failure detector calling this
        aggregates misses itself — stacking transport retries under
        each probe would only multiply its time-to-detection."""
        t0 = time.time()
        out = self._call(_host_probe, self.hosted_name,
                         what="remote probe", retry=self._no_retry,
                         deadline=Deadline(self.rpc_timeout))
        # probes double as clock-sync samples: small payload, single
        # attempt, steady cadence — the tightest RTT-midpoint offset
        # estimate the fleet trace stitcher can get for free
        self._note_clock(t0, time.time(), out.get("time"))
        self.engine.active_count = int(out.get("active", 0))
        self.engine.slots = max(1, int(out.get("slots", 1)))
        self.scheduler.depth = int(out.get("queue_depth", 0))
        self.scheduler.max_queue_depth = max(
            1, int(out.get("max_queue_depth", 1)))
        return out

    def snapshot(self) -> dict:
        try:
            return self._call(_host_snapshot, self.hosted_name,
                              what="remote snapshot",
                              deadline=Deadline(self.rpc_timeout))
        except ReplicaUnreachable:
            return {"state": "unreachable", "peer": self.peer}

    def statusz(self) -> dict:
        try:
            out = self._call(_host_statusz, self.hosted_name,
                             what="remote statusz",
                             deadline=Deadline(self.rpc_timeout))
        except ReplicaUnreachable:
            out = {"state": "unreachable", "peer": self.peer}
        # the client-side view rides along: what THIS process knows
        # about the peer (wire latency, clock skew) that the peer
        # cannot know about itself — one endpoint diagnoses a gray link
        out["remote_client"] = {"peer": self.peer, **self.clock_stats()}
        return out

    def metrics_snapshot(self) -> dict:
        """The remote PROCESS's unified-registry snapshot (rpc
        ``_host_metrics``) — what the router's fleet scrape rolls up
        under this replica's label. Idempotent, transport-retried, and
        Deadline-bounded like every other read; the response's
        timestamp refreshes the clock-offset estimate."""
        t0 = time.time()
        out = self._call(_host_metrics, self.hosted_name,
                         what="remote metrics",
                         deadline=Deadline(self.rpc_timeout))
        self._note_clock(t0, time.time(), out.get("time"))
        return out

    def trace_export(self, corr: Optional[str] = None,
                     tail: Optional[int] = None) -> dict:
        """The remote process's span ring (rpc ``_host_trace_export``),
        annotated with this client's current clock-offset estimate so
        the caller can align the spans onto the local timeline
        (``observability.fleet.stitch_traces``)."""
        t0 = time.time()
        out = self._call(_host_trace_export, self.hosted_name, corr,
                         tail, what="remote trace export",
                         deadline=Deadline(self.rpc_timeout))
        self._note_clock(t0, time.time(), out.get("time"))
        out["offset_s"] = self.clock_offset_s or 0.0
        out["rtt_s"] = self.rtt_ewma_s
        return out

    # ------------------------------------------- disagg migration surface
    def kv_prefill(self, prompt, *, timeout_s: Optional[float] = None,
                   correlation_id: Optional[str] = None) -> dict:
        """Run an admission-only prefill on the peer, leaving the
        prompt's blocks committed in its pool (rpc
        ``disagg._host_kv_prefill``). Idempotent at the pool level
        (content-addressed chain), so transport blips retry; the call
        is bounded by ``timeout_s`` on BOTH sides of the wire."""
        from . import disagg

        budget = float(timeout_s if timeout_s is not None
                       else self.rpc_timeout)
        return self._call(
            disagg._host_kv_prefill, self.hosted_name,
            np.asarray(prompt, np.int32).ravel(),
            {"timeout_s": budget, "correlation_id": correlation_id},
            what="remote kv prefill",
            rpc_timeout=budget + 2.0, deadline=Deadline(budget + 2.0))

    def kv_export(self, prompt, *, corr: Optional[str] = None,
                  max_chunk_bytes: Optional[int] = None):
        """Pull the peer's matched KV blocks for ``prompt`` as a
        versioned payload (``None`` on a pool miss)."""
        from . import disagg

        return self._call(
            disagg._host_kv_export, self.hosted_name,
            np.asarray(prompt, np.int32).ravel(), corr, max_chunk_bytes,
            what="remote kv export", deadline=Deadline(self.rpc_timeout))

    def kv_import(self, payload: dict, *,
                  corr: Optional[str] = None) -> int:
        """Push an exported payload into the peer's pool; returns
        matchable tokens added there. Idempotent by digest — a
        duplicate delivery after a lost response is a no-op."""
        from . import disagg

        return self._call(
            disagg._host_kv_import, self.hosted_name, payload, corr,
            what="remote kv import", deadline=Deadline(self.rpc_timeout))

    def prefix_digests(self) -> dict:
        """The peer pool's committed digest listing (hex) for the
        fleet :class:`~paddle_tpu_torch.serving.disagg.PrefixIndex`."""
        from . import disagg

        return self._call(
            disagg._host_prefix_digests, self.hosted_name,
            what="remote prefix digests",
            deadline=Deadline(self.rpc_timeout))

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        self._call(_host_shutdown, self.hosted_name, drain, timeout,
                   what="remote shutdown",
                   rpc_timeout=(timeout or self.rpc_timeout) + 5.0,
                   deadline=Deadline((timeout or self.rpc_timeout) + 5.0))

    def abandon(self, reason: str) -> int:
        """Fail every live handle with :class:`ReplicaUnreachable` —
        called by the router's failure detector on declaring this
        replica dead, so in-flight ``RouterHandle`` consumers reroute
        NOW rather than after their own poll retries. Returns how many
        handles were abandoned."""
        n = 0
        for h in list(self._handles):
            if not h.done:
                h._fail(ReplicaUnreachable(
                    f"replica {self.peer!r} abandoned: {reason}"))
                n += 1
        return n

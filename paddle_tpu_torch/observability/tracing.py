"""Request-scoped tracing: correlation ids + structured host spans (port of
``paddle_tpu/observability/tracing.py``; framework-free, so copied).

One request (or one training step) crosses many layers — router submit,
scheduler queue, engine admit, per-token decode, stream end; or
supervisor before/after-batch, watchdog flush, rollback. Each layer
records what it sees into a bounded per-process span buffer, keyed by a
**correlation id** minted at the front door (``ReplicaRouter.submit`` /
``InferenceServer.submit`` / the ``Model.fit`` step boundary) and
threaded through as plain request/thread-local state. The result is ONE
queryable timeline per request, exportable as a chrome://tracing JSON
where every correlation id is its own named lane.

Hot-path discipline: recording a span is two ``time.time()`` reads and
a deque append under a small lock — no device sync, no allocation
beyond the tuple. Every record site sits on the host side of an
EXISTING dispatch point (the server's per-token fan-out loop, the
engine's admission read-back, the generate() loop), so tracing adds
zero host↔device round-trips and no device work. ``PT_TRACE=0``
disables recording entirely; the buffer is bounded (``PT_TRACE_BUFFER``,
default 65536 spans) and counts what it drops.

Timestamps are wall-clock (``time.time()``) on purpose: spans from
different processes (fleet replicas) must merge onto one timeline in
``tools/trace_view.py``.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = [
    "enabled", "enable", "new_correlation_id", "current", "set_current",
    "correlate", "record_span", "record_event", "span", "spans", "clear",
    "stats", "chrome_trace", "export_chrome_trace",
]


def _env_capacity() -> int:
    try:
        return max(1, int(os.environ.get("PT_TRACE_BUFFER", "65536")))
    except ValueError:
        return 65536


class _TraceBuffer:
    """Bounded span store. All mutation happens under ``self.lock``;
    ``enabled`` is a plain flag read lock-free on the hot path (a torn
    read costs one span, not correctness)."""

    def __init__(self, capacity: Optional[int] = None):
        self.lock = threading.Lock()
        self.spans: deque = deque(maxlen=capacity or _env_capacity())
        self.dropped = 0
        self.recorded = 0
        self.enabled = os.environ.get("PT_TRACE", "1").lower() not in (
            "0", "false", "off")


_buf = _TraceBuffer()
_tls = threading.local()
_corr_serial = itertools.count()
# default sentinel distinguishing "inherit the thread's current id"
# (the default) from an explicit corr=None ("the untraced lane")
_INHERIT = object()
# distinguishes processes that share a pid namespace epoch (fork-heavy
# launchers recycle pids fast enough to collide within one trace dir)
_proc_token = os.urandom(3).hex()


def enabled() -> bool:
    return _buf.enabled


def enable(on: bool = True) -> None:
    """Turn span recording on/off process-wide (``PT_TRACE=0`` sets the
    initial state). Off = every record call is a single flag check."""
    _buf.enabled = bool(on)


def new_correlation_id(prefix: str = "req") -> str:
    """Mint a process-unique correlation id (``req-<pid><token>-NNNNNN``)."""
    return f"{prefix}-{os.getpid():x}{_proc_token}-{next(_corr_serial):06d}"


def current() -> Optional[str]:
    """This thread's active correlation id (None outside any scope)."""
    return getattr(_tls, "corr", None)


def set_current(corr: Optional[str]) -> None:
    """Install ``corr`` as this thread's correlation id (un-scoped: the
    training loop stamps each step boundary and never restores)."""
    _tls.corr = corr


@contextmanager
def correlate(corr: Optional[str]):
    """Scoped correlation id: spans recorded inside resolve to ``corr``."""
    prev = current()
    _tls.corr = corr
    try:
        yield corr
    finally:
        _tls.corr = prev


def record_span(name: str, t0: float, t1: float,
                corr=_INHERIT,
                tags: Optional[dict] = None) -> None:
    """Record one completed span (caller-supplied wall-clock bounds —
    the hot-path form: the caller already holds both timestamps from
    its existing dispatch bracketing). Omitting ``corr`` inherits the
    thread's current correlation id; an explicit ``corr=None`` pins the
    span to the untraced lane regardless of thread state."""
    b = _buf
    if not b.enabled:
        return
    if corr is _INHERIT:
        corr = current()
    with b.lock:
        if len(b.spans) == b.spans.maxlen:
            b.dropped += 1
        b.recorded += 1
        b.spans.append((str(name), corr, float(t0), float(t1), tags))


def record_event(name: str, corr=_INHERIT, **tags) -> None:
    """Record an instant event (zero-duration span); ``corr`` follows
    :func:`record_span` semantics."""
    t = time.time()
    record_span(name, t, t, corr=corr, tags=tags or None)


@contextmanager
def span(name: str, corr=_INHERIT, **tags):
    """Context manager recording the wrapped block as one span;
    ``corr`` follows :func:`record_span` semantics."""
    if not _buf.enabled:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        record_span(name, t0, time.time(), corr=corr, tags=tags or None)


def spans(corr: Optional[str] = None,
          name: Optional[str] = None) -> List[dict]:
    """Buffered spans (oldest first) as dicts, optionally filtered by
    exact correlation id and/or span name."""
    with _buf.lock:
        items = list(_buf.spans)
    out = []
    for n, c, t0, t1, tags in items:
        if corr is not None and c != corr:
            continue
        if name is not None and n != name:
            continue
        out.append({"name": n, "corr": c, "t0": t0, "t1": t1,
                    "tags": dict(tags) if tags else {}})
    return out


def clear() -> None:
    with _buf.lock:
        _buf.spans.clear()
        _buf.dropped = 0
        _buf.recorded = 0


def stats() -> dict:
    with _buf.lock:
        return {"enabled": _buf.enabled, "buffered": len(_buf.spans),
                "recorded": _buf.recorded, "dropped": _buf.dropped,
                "capacity": _buf.spans.maxlen}


# ------------------------------------------------------- chrome export
def chrome_trace(span_records: Optional[List[dict]] = None,
                 corr: Optional[str] = None,
                 pid: Optional[int] = None,
                 process_name: Optional[str] = None) -> dict:
    """Build a chrome://tracing JSON object (``traceEvents``) from span
    dicts (default: this process's buffer). Every correlation id gets
    its own named lane (``tid`` + ``thread_name`` metadata), so one
    request reads top-to-bottom as a single timeline; spans without a
    correlation id share the ``untraced`` lane 0."""
    recs = span_records if span_records is not None else spans()
    pid = os.getpid() if pid is None else int(pid)
    lanes: Dict[Optional[str], int] = {}
    events: List[dict] = []
    if process_name:
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": process_name}})

    def lane(c: Optional[str]) -> int:
        tid = lanes.get(c)
        if tid is None:
            # lane 0 is reserved for untraced spans; correlation ids get
            # lanes 1.. in encounter order
            tid = lanes[c] = (0 if c is None else
                              1 + sum(1 for k in lanes if k is not None))
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": c or "untraced"}})
            events.append({"ph": "M", "name": "thread_sort_index",
                           "pid": pid, "tid": tid,
                           "args": {"sort_index": tid}})
        return tid

    for rec in recs:
        c = rec.get("corr")
        if corr is not None and c != corr:
            continue
        t0, t1 = float(rec["t0"]), float(rec["t1"])
        args = dict(rec.get("tags") or {})
        if c is not None:
            args["correlation_id"] = c
        ev = {"name": rec["name"], "pid": pid, "tid": lane(c),
              "ts": t0 * 1e6, "args": args}
        if t1 > t0:
            ev.update(ph="X", dur=(t1 - t0) * 1e6)
        else:
            ev.update(ph="i", s="t")
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str, corr: Optional[str] = None,
                        span_records: Optional[List[dict]] = None) -> str:
    """Write :func:`chrome_trace` to ``path`` (dirs created); returns
    the path — open it in ``chrome://tracing`` / Perfetto."""
    trace = chrome_trace(span_records=span_records, corr=corr)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path

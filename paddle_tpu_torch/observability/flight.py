"""Crash flight recorder: a bounded ring of recent events, dumped as an
artifact when something dies (port of ``paddle_tpu/observability/
flight.py``; framework-free, so copied).

The serving loop resets its engine, the supervisor rolls back or hangs,
a preemption lands — by the time an operator looks, the interesting
state (which requests were in flight, what compiled, which spans led up
to it) is gone. The flight recorder keeps the last ``capacity`` events
(engine resets, compiles, faults, rollbacks — anything ``note()``-d) in
a per-process ring, and on a crash path ``dump()`` writes ONE JSON
artifact combining:

- the event ring,
- the recent span tail from :mod:`~paddle_tpu_torch.observability.tracing`
  (so the failing request's correlation id and timeline ride along),
- the profiler's monotonic counters and the metrics-registry snapshot.

Dumps are crash-safe (tmp + fsync + ``os.replace``, the checkpoint
discipline) and bounded per process (``PT_FLIGHT_MAX_DUMPS``) so a
crash-looping worker cannot fill the disk. The directory comes from
``PT_FLIGHT_DIR`` (default ``./flight_records``); ``tools/trace_view.py``
merges dumps from many replicas by correlation id.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["FlightRecorder", "flight_recorder", "configure", "note",
           "dump"]

_SAFE = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-"


def _sanitize(reason: str) -> str:
    return "".join(c if c in _SAFE else "_" for c in str(reason))[:48]


def _default_dir() -> str:
    return os.environ.get("PT_FLIGHT_DIR") or os.path.join(
        ".", "flight_records")


def _host_token() -> str:
    """Short sanitized hostname for dump filenames: hosts sharing a
    ``PT_FLIGHT_DIR`` (NFS, a bind-mounted artifact volume) must not
    collide on pid alone — pids repeat across machines."""
    return _sanitize(socket.gethostname())[:24] or "host"


class FlightRecorder:
    """Per-process bounded event ring + crash-artifact writer."""

    def __init__(self, capacity: int = 4096,
                 dump_dir: Optional[str] = None,
                 max_dumps: Optional[int] = None):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(1, int(capacity)))
        self.dump_dir = dump_dir or _default_dir()
        if max_dumps is None:
            try:
                max_dumps = int(os.environ.get("PT_FLIGHT_MAX_DUMPS", "200"))
            except ValueError:
                max_dumps = 200
        self.max_dumps = int(max_dumps)
        self.events_recorded = 0
        self.dumps_written = 0
        self.dumps_skipped = 0
        self.last_dump_path: Optional[str] = None

    # ----------------------------------------------------------- ring
    def note(self, kind: str, corr: Optional[str] = None,
             **fields) -> None:
        """Append one event to the ring (cheap: dict build + deque
        append under the lock — safe from any thread, including crash
        handlers)."""
        ev = {"t": round(time.time(), 6), "kind": str(kind)}
        if corr is not None:
            ev["corr"] = corr
        for k, v in fields.items():
            ev.setdefault(k, v)
        with self._lock:
            self.events_recorded += 1
            self._events.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def stats(self) -> dict:
        with self._lock:
            return {"buffered": len(self._events),
                    "capacity": self._events.maxlen,
                    "events_recorded": self.events_recorded,
                    "dumps_written": self.dumps_written,
                    "dumps_skipped": self.dumps_skipped,
                    "dump_dir": self.dump_dir,
                    "last_dump_path": self.last_dump_path}

    # ----------------------------------------------------------- dump
    def dump(self, reason: str, corr: Optional[str] = None,
             extra: Optional[dict] = None,
             spans_tail: int = 4096) -> Optional[str]:
        """Write the crash artifact; returns its path (or None once the
        per-process dump budget is spent). Never raises — a failing
        flight dump must not mask the fault it is documenting."""
        with self._lock:
            if self.dumps_written >= self.max_dumps:
                self.dumps_skipped += 1
                return None
            self.dumps_written += 1
            serial = self.dumps_written
            events = list(self._events)
        from . import tracing

        counters: dict = {}
        try:
            from .. import profiler

            counters = profiler.counter_values()
        except Exception:
            pass
        metrics = None
        try:
            from .registry import default_registry

            metrics = default_registry().snapshot()
        except Exception:
            pass
        artifact = {
            "format": "flight_recorder",
            "version": 1,
            "reason": str(reason),
            "time": round(time.time(), 6),
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "correlation_id": corr,
            "events": events,
            "spans": (tracing.spans()[-int(spans_tail):]
                      if int(spans_tail) > 0 else []),
            "counters": counters,
            "metrics": metrics,
        }
        if extra:
            artifact["extra"] = extra
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                f"flight_{_host_token()}_{os.getpid()}_{serial:04d}_"
                f"{_sanitize(reason)}.json")
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(artifact, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except Exception:
            with self._lock:
                # a failed write must not burn the dump budget or
                # over-report artifacts: a recovered disk still gets
                # its postmortem
                self.dumps_written -= 1
                self.dumps_skipped += 1
            return None
        with self._lock:
            self.last_dump_path = path
        try:
            from .. import profiler

            profiler.bump_counter("flight.dumps")
        except Exception:
            pass
        return path


# --------------------------------------------------------------- global
_global: Optional[FlightRecorder] = None
_global_lock = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process-wide recorder (created on first use)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = FlightRecorder()
        return _global


def configure(dump_dir: Optional[str] = None,
              capacity: Optional[int] = None,
              max_dumps: Optional[int] = None) -> FlightRecorder:
    """(Re)configure the global recorder — tests and embedders point the
    dump dir somewhere owned. A capacity change rebuilds the ring,
    keeping the newest events."""
    rec = flight_recorder()
    with rec._lock:
        if dump_dir is not None:
            rec.dump_dir = dump_dir
        if max_dumps is not None:
            rec.max_dumps = int(max_dumps)
        if capacity is not None and capacity != rec._events.maxlen:
            rec._events = deque(rec._events, maxlen=max(1, int(capacity)))
    return rec


def note(kind: str, corr: Optional[str] = None, **fields) -> None:
    flight_recorder().note(kind, corr=corr, **fields)


def dump(reason: str, corr: Optional[str] = None,
         extra: Optional[dict] = None) -> Optional[str]:
    return flight_recorder().dump(reason, corr=corr, extra=extra)

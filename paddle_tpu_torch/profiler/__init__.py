"""paddle_tpu_torch.profiler — tracing, host event spans, throughput timing
(port of ``paddle_tpu/profiler/__init__.py``).

``Profiler`` keeps the reference's scheduler states, ``RecordEvent``, the
host-event summary and the ``Timer`` throughput benchmarker. Device
tracing is ``torch.profiler`` (CPU and, where there is a card, CUDA
activities; Kineto over CUPTI) where the reference starts
``jax.profiler``; a stopped capture writes its Chrome trace
(``<worker>_<ms>.pt.trace.json``) into the trace directory, as
``jax.profiler.stop_trace`` writes its own, and stays readable as
``Profiler.last_profile`` (``key_averages()``, ``events()``).
``RecordEvent`` opens a ``torch.profiler.record_function`` range where the
reference opens ``jax.profiler.TraceAnnotation``, and only while a
capture records (a ``Profiler`` of this module, which records every
thread, as a serving worker's ranges need, or a torch profiler on the
calling thread): with none running it costs two clock reads and two flag
tests. Host spans are recorded by a lightweight in-process recorder and
feed the summary table.
"""
from __future__ import annotations

import enum
import os
import socket
import threading as _threading
import time
from collections import defaultdict
from typing import Callable, Iterable, Optional

import torch

from ..framework import flags as _flags

__all__ = [
    "ProfilerState", "ProfilerTarget", "Profiler", "RecordEvent",
    "make_scheduler", "export_chrome_tracing", "host_event_summary",
    "benchmark", "Timer",
]


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1      # the card: CUDA activities
    TPU = 2      # accepted for compat; means the card here


# ------------------------------------------------------------- host events
# Bounded: a long-lived process with spans enabled (a serving loop emits
# serve:prefill/serve:decode per admission/step, indefinitely) must not
# grow the recorder without bound — oldest spans roll off past the cap.
_MAX_HOST_SPANS = 200_000


class _HostEventRecorder:
    """Lock-guarded per-process span store (HostEventRecorder analogue,
    ``host_event_recorder.h``). Bounded: when the deque is full the
    OLDEST span rolls off — silently losing data is a telemetry bug, so
    every eviction is counted (``dropped`` here, plus the monotonic
    ``profiler.spans_dropped`` counter) and surfaced by
    :func:`host_event_summary`."""

    def __init__(self, capacity: int = _MAX_HOST_SPANS):
        from collections import deque

        self.lock = _threading.Lock()
        self.spans = deque(maxlen=capacity)  # (name, t0, t1)
        self.enabled = False
        self.dropped = 0

    def record(self, name, t0, t1):
        with self.lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
                evicted = True
            else:
                evicted = False
            self.spans.append((name, t0, t1))
        if evicted:
            bump_counter("profiler.spans_dropped")

    def clear(self):
        with self.lock:
            self.spans.clear()
            self.dropped = 0


_recorder = _HostEventRecorder()


# captures of this module's Profiler now recording (they record every
# thread: the serving worker opens its ranges on its own thread)
_captures = 0


def _profiling() -> bool:
    """True while a capture records: a ``Profiler`` of this module, or a
    ``torch.profiler`` capture on the calling thread."""
    return _captures > 0 or torch._C._autograd._profiler_enabled()


class RecordEvent:
    """Context manager / decorator marking a named span.

    Shows up in (a) the host-event summary table and (b) the device trace
    timeline as a ``torch.profiler.record_function`` range (the reference
    opens ``jax.profiler.TraceAnnotation``), whose children are the kernel
    launches made inside it. The range is opened only while a torch
    profiler records, so an idle ``RecordEvent`` costs next to nothing.
    """

    def __init__(self, name: str):
        self.name = name
        self._t0 = None
        self._range = None

    def begin(self):
        self._t0 = time.perf_counter()
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()

    def end(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._t0 is not None and _recorder.enabled:
            _recorder.record(self.name, self._t0, time.perf_counter())
        self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with RecordEvent(self.name):
                return fn(*a, **kw)

        return wrapped


# ------------------------------------------------------------- counters
# Monotonic event counters for rare-but-important events (numerics
# anomalies, rollbacks, preemptions, hang detections, scaler skips) — the
# self-healing layer bumps these so operators can alert on them without
# parsing logs. Unlike spans they are always on: a counter bump is a dict
# update under a lock, cheap even in the train loop's rare branches.
_counters_lock = _threading.Lock()
_counters: dict = defaultdict(int)


def bump_counter(name: str, n: int = 1) -> int:
    """Increment and return the named monotonic counter."""
    with _counters_lock:
        _counters[name] += n
        return _counters[name]


def counter_values() -> dict:
    """Snapshot of every counter bumped so far."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


__all__ += ["bump_counter", "counter_values", "reset_counters"]


def host_event_summary(sort_by: str = "total", percentiles=None):
    """Aggregate host spans: {name: (calls, total_s, avg_s, max_s)} —
    the op-summary table of ``profiler_statistic.py`` for host phases.

    ``percentiles=(50, 99)`` appends one per-event percentile column per
    requested value (nearest-rank over the recorded durations), so the
    tuple becomes ``(calls, total_s, avg_s, max_s, p50_s, p99_s)``.
    Spans evicted from the bounded recorder are surfaced as a
    ``"(dropped spans)"`` row (count in the calls column) so a summary
    over a long-lived server is never silently partial."""
    from ..observability.registry import nearest_rank

    with _recorder.lock:
        items = list(_recorder.spans)
        dropped = _recorder.dropped
    pcts = tuple(float(p) for p in (percentiles or ()))
    agg = defaultdict(list)
    for name, t0, t1 in items:
        agg[name].append(t1 - t0)
    rows = {}
    for name, ts in agg.items():
        srt = sorted(ts)
        rows[name] = (len(ts), sum(ts), sum(ts) / len(ts), srt[-1],
                      *(nearest_rank(srt, p) for p in pcts))
    key = {"total": 1, "calls": 0, "avg": 2, "max": 3}[sort_by]
    out = dict(sorted(rows.items(), key=lambda kv: -kv[1][key]))
    if dropped:
        out["(dropped spans)"] = (dropped, 0.0, 0.0, 0.0,
                                  *(0.0 for _ in pcts))
    return out


# ------------------------------------------------------------- scheduler
def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Step-state machine identical to the reference
    (``profiler.py:make_scheduler``): skip_first, then cycles of
    closed -> ready -> record (last record step returns
    RECORD_AND_RETURN)."""
    if record < 1:
        raise ValueError("make_scheduler requires record >= 1")
    if closed < 0 or ready < 0 or repeat < 0 or skip_first < 0:
        raise ValueError("make_scheduler arguments must be non-negative")
    period = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready factory (API parity): each stopped capture's Chrome
    trace lands in ``dir_name`` as ``<worker>_<ms>.pt.trace.json``
    (``chrome://tracing`` / Perfetto read it)."""

    def handler(prof: "Profiler"):
        prof.last_trace_dir = dir_name

    handler.dir_name = dir_name
    handler.worker_name = worker_name
    return handler


def _torch_profile():
    """A ``torch.profiler.profile`` of CPU and (where there is a card) CUDA
    activities that records every thread where this torch can."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):   # older torch: this thread only
        return torch.profiler.profile(activities=acts)
    return torch.profiler.profile(activities=acts,
                                  experimental_config=config)


class Profiler:
    """Scheduled profiler driving ``torch.profiler`` trace capture.

    Usage (same shape as the reference)::

        p = Profiler(scheduler=make_scheduler(closed=1, ready=1, record=3),
                     on_trace_ready=export_chrome_tracing('./prof'))
        p.start()
        for batch in loader:
            train_step(batch)
            p.step()
        p.stop()
        p.summary()
    """

    def __init__(self, *, targets: Iterable[ProfilerTarget] = (),
                 scheduler=None, on_trace_ready=None, timer_only: bool = False,
                 trace_dir: Optional[str] = None):
        self.scheduler = scheduler or (lambda step: ProfilerState.RECORD)
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.trace_dir = trace_dir or getattr(on_trace_ready, "dir_name",
                                              None) or "./profiler_log"
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self.last_trace_dir = None
        #: the last stopped capture (``torch.profiler.profile``) and the
        #: path its Chrome trace was written to
        self.last_profile = None
        self.last_trace_path = None
        self._profile = None
        self._tracing = False
        self._timer = Timer()

    # -- trace control
    def _ensure_tracing(self, want: bool):
        global _captures
        if self.timer_only:
            return
        if want and not self._tracing:
            os.makedirs(self.trace_dir, exist_ok=True)
            self._profile = _torch_profile()
            self._profile.__enter__()
            _captures += 1
            _recorder.enabled = _flags.flag("FLAGS_profile_host_events")
            self._tracing = True
        elif not want and self._tracing:
            prof, self._profile = self._profile, None
            _captures -= 1
            prof.__exit__(None, None, None)
            worker = (getattr(self.on_trace_ready, "worker_name", None)
                      or f"{socket.gethostname()}_{os.getpid()}")
            path = os.path.join(
                self.trace_dir,
                f"{worker}_{int(time.time() * 1000)}.pt.trace.json")
            prof.export_chrome_trace(path)
            self.last_profile = prof
            self.last_trace_path = path
            _recorder.enabled = False
            self._tracing = False
            if self.on_trace_ready is not None:
                self.on_trace_ready(self)

    def start(self):
        # fresh session: a lingering previous session's spans must not
        # leak into this capture's export
        _recorder.clear()
        self.current_state = self.scheduler(self.step_num)
        self._ensure_tracing(self.current_state in
                             (ProfilerState.RECORD,
                              ProfilerState.RECORD_AND_RETURN))
        self._timer.begin()
        return self

    def step(self, num_samples: Optional[int] = None):
        self._timer.step(num_samples)
        prev = self.current_state
        self.step_num += 1
        self.current_state = self.scheduler(self.step_num)
        want = self.current_state in (ProfilerState.RECORD,
                                      ProfilerState.RECORD_AND_RETURN)
        if prev == ProfilerState.RECORD_AND_RETURN:
            # cycle boundary: flush this capture, then (possibly) start the
            # next cycle's capture immediately
            self._ensure_tracing(False)
        self._ensure_tracing(want)

    def stop(self):
        self._ensure_tracing(False)
        self._timer.end()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- reporting
    def summary(self, sort_by: str = "total", percentiles=None) -> str:
        pcts = tuple(percentiles or ())
        rows = host_event_summary(sort_by, percentiles=pcts)
        header = (f"{'event':<40}{'calls':>8}{'total(s)':>12}"
                  f"{'avg(ms)':>12}{'max(ms)':>12}")
        for p in pcts:
            header += f"{f'p{p:g}(ms)':>12}"
        lines = [header]
        for name, (calls, total, avg, mx, *tail) in rows.items():
            line = (f"{name:<40}{calls:>8}{total:>12.4f}"
                    f"{avg * 1e3:>12.3f}{mx * 1e3:>12.3f}")
            for v in tail:
                line += f"{v * 1e3:>12.3f}"
            lines.append(line)
        lines.append("")
        lines.append(self._timer.report())
        text = "\n".join(lines)
        print(text)
        return text

    def benchmark(self) -> "Timer":
        return self._timer


# ------------------------------------------------------------- throughput
class Timer:
    """Steps/s + samples/s (ips) benchmarker —
    ``python/paddle/profiler/timer.py`` ``benchmark()`` analogue."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t_begin = None
        self._t_end = None
        self._steps = 0
        self._samples = 0
        self._step_times = []
        self._last = None

    def begin(self):
        self._t_begin = time.perf_counter()
        self._last = self._t_begin

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._last is not None:
            self._step_times.append(now - self._last)
        self._last = now
        self._steps += 1
        if num_samples:
            self._samples += num_samples

    def end(self):
        self._t_end = time.perf_counter()

    @property
    def elapsed(self) -> float:
        end = self._t_end or time.perf_counter()
        return (end - self._t_begin) if self._t_begin else 0.0

    def steps_per_second(self) -> float:
        if not self._step_times:
            return 0.0
        return len(self._step_times) / sum(self._step_times)

    def ips(self) -> float:
        """Samples/sec over the timed window (0 if samples not reported)."""
        return self._samples / self.elapsed if self.elapsed and self._samples else 0.0

    def report(self) -> str:
        return (f"steps: {self._steps}  elapsed: {self.elapsed:.3f}s  "
                f"steps/s: {self.steps_per_second():.2f}  "
                f"ips: {self.ips():.2f}")


_global_timer = Timer()


def benchmark() -> Timer:
    """Module-level benchmarker (reference ``paddle.profiler.utils`` style)."""
    return _global_timer


class SortedKeys(enum.Enum):
    """Summary-table sort keys (reference ``profiler_statistic.SortedKeys``)."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(enum.Enum):
    """Summary-table views (reference ``SummaryView``)."""

    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready callback writing the raw span record (reference
    exports its EventNode tree as protobuf; the host-span JSON here is the
    same data and :func:`load_profiler_result` reads it back)."""
    import json
    import os
    import socket
    import time as _time

    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"{socket.gethostname()}_{os.getpid()}"
        path = os.path.join(dir_name,
                            f"{name}_{int(_time.time() * 1000)}.pb.json")
        with _recorder.lock:
            spans = list(_recorder.spans)
        with open(path, "w") as f:
            json.dump([{"name": n, "start": t0, "end": t1}
                       for n, t0, t1 in spans], f)
        prof.last_protobuf_path = path

    return handler


def load_profiler_result(filename: str):
    """Load a record written by :func:`export_protobuf`: a list of span
    dicts (name/start/end/tid)."""
    import json

    with open(filename) as f:
        return json.load(f)


__all__ += ["SortedKeys", "SummaryView", "export_protobuf",
            "load_profiler_result"]

"""Unified metrics registry: labeled counters / gauges / histograms (port
of ``paddle_tpu/observability/registry.py``; framework-free, so copied).

One process-wide, thread-safe registry replaces the fragmented telemetry
the stack grew organically — bespoke ``ServingMetrics`` dicts,
``profiler.bump_counter`` totals, ``compile_cache.cache_stats()``,
``BlockPool``/``AdapterStore`` occupancy, scheduler queue depths — with
a single queryable substrate, WITHOUT changing any of those existing
APIs. The absorption mechanism is the **collector**: a component
registers a zero-arg callable (held via weakref for bound methods, so a
dead server vanishes from the scrape instead of raising) that yields its
current numbers at snapshot time; intrinsic metrics (``inc`` /
``set_gauge`` / ``observe``) live in the registry itself.

Outputs:

- :meth:`MetricsRegistry.snapshot` — one plain JSON-able dict
  (``{"counters", "gauges", "histograms"}``, label-qualified keys like
  ``serving.queue_depth{server="srv0"}``) — the shape the bench tools
  embed in their artifacts;
- :meth:`MetricsRegistry.prometheus_text` — the Prometheus text
  exposition format (``# TYPE`` lines, sanitized names, ``quantile``
  labels for histogram summaries) served by
  ``InferenceServer.metrics_text()``.

Import-light on purpose (stdlib only): the profiler, the serving layer
and the framework all feed it, so it must sit below every one of them
in the import graph.
"""
from __future__ import annotations

import json
import random
import re
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["MetricsRegistry", "default_registry", "labels_key",
           "nearest_rank", "parse_qualified"]

LabelsKey = Tuple[Tuple[str, str], ...]


def nearest_rank(sorted_values, p: float) -> float:
    """Nearest-rank percentile over an ASCENDING-sorted sequence — the
    one definition every histogram in the stack shares (this registry,
    ``serving.metrics.LatencyHistogram``, ``profiler``), so summary
    tables and Prometheus quantiles agree on the same data."""
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1,
              max(0, int(round((p / 100.0) * (len(sorted_values) - 1)))))
    return sorted_values[idx]


def labels_key(labels: Optional[dict]) -> LabelsKey:
    """Canonical hashable form of a label set (sorted ``(k, v)`` pairs)."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _qualified(name: str, lk: LabelsKey) -> str:
    if not lk:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in lk)
    return f"{name}{{{inner}}}"


_LABEL_RE = re.compile(r'([\w.:/-]+)="([^"]*)"')


def parse_qualified(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of the label qualification snapshot keys carry:
    ``'depth{replica="r1",server="s0"}' -> ("depth", {...})``. The fleet
    roll-up uses it to re-label a scraped remote snapshot."""
    if "{" not in key:
        return key, {}
    name, rest = key.split("{", 1)
    return name, dict(_LABEL_RE.findall(rest.rstrip("}")))


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _PROM_BAD.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _flatten_numbers(prefix: str, d: dict, out: Dict[str, float]) -> None:
    """``{"a": {"b": 1}} -> {"a.b": 1}`` — strings and other non-numeric
    leaves are dropped (a scrape wants numbers; the source dicts keep
    their full shape in their own APIs)."""
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten_numbers(key + ".", v, out)
        elif _is_number(v):
            out[key] = v
        elif isinstance(v, bool):
            out[key] = int(v)


class _Hist:
    """Reservoir-sampled distribution with exact count/sum/max (Vitter's
    algorithm R — the ``ServingMetrics`` discipline, duplicated here so
    the registry stays import-light below the serving layer)."""

    __slots__ = ("count", "total", "max", "_samples", "_cap", "_rng")

    def __init__(self, cap: int = 1024, seed: int = 0):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._cap = int(cap)
        self._samples: List[float] = []
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v
        if len(self._samples) < self._cap:
            self._samples.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self._cap:
                self._samples[j] = v

    def percentile(self, p: float) -> float:
        return nearest_rank(sorted(self._samples), p)

    def summary(self) -> dict:
        mean = self.total / self.count if self.count else 0.0
        return {"count": self.count, "sum": round(self.total, 6),
                "mean": round(mean, 6),
                "p50": round(self.percentile(50), 6),
                "p99": round(self.percentile(99), 6),
                "max": round(self.max, 6)}


class _FrozenHist:
    """An already-summarized histogram absorbed from another process's
    snapshot (the reservoir itself never crosses the wire); quacks just
    enough of :class:`_Hist` for the export paths."""

    __slots__ = ("_summary",)

    def __init__(self, summary: dict):
        self._summary = {k: v for k, v in summary.items()
                         if _is_number(v)}

    def summary(self) -> dict:
        return dict(self._summary)


class MetricsRegistry:
    """Thread-safe labeled counters/gauges/histograms + collectors.

    Intrinsic metrics mutate under one re-entrant lock; collectors are
    invoked OUTSIDE the lock at snapshot time (they commonly take their
    owner's lock — holding ours across theirs would order locks both
    ways and invite deadlock)."""

    def __init__(self, histogram_samples: int = 1024):
        self._lock = threading.RLock()
        self._counters: Dict[Tuple[str, LabelsKey], float] = {}
        self._gauges: Dict[Tuple[str, LabelsKey], float] = {}
        self._hists: Dict[Tuple[str, LabelsKey], _Hist] = {}
        self._hist_samples = int(histogram_samples)
        # (name, labels_key, callable-or-weakref, is_weak)
        self._collectors: List[tuple] = []
        self.collector_errors = 0

    # ------------------------------------------------------- intrinsic
    def inc(self, name: str, value: float = 1.0, **labels) -> float:
        """Increment (and return) the labeled monotonic counter."""
        key = (str(name), labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value
            return self._counters[key]

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[(str(name), labels_key(labels))] = float(value)

    def set_counter(self, name: str, value: float, **labels) -> None:
        """Set a counter to an ABSOLUTE value — the roll-up form: a
        scraped remote counter is already cumulative, re-``inc``-ing it
        on every scrape would double-count."""
        with self._lock:
            self._counters[(str(name), labels_key(labels))] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        key = (str(name), labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist(self._hist_samples)
            h.observe(value)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def absorb_snapshot(self, snap: dict,
                        labels: Optional[dict] = None) -> None:
        """Merge another registry's :meth:`snapshot` dict into this one,
        qualifying every metric with ``labels`` on top of whatever labels
        the source keys already carry — how the fleet roll-up turns N
        per-process scrapes into one registry with ``replica=`` labels.
        Counters are set absolutely (the source values are cumulative);
        histograms arrive as frozen summaries (reservoirs don't cross
        the wire)."""
        extra = {str(k): str(v) for k, v in (labels or {}).items()}

        def merged_key(qual: str):
            name, lk = parse_qualified(qual)
            lk.update(extra)
            return name, labels_key(lk)

        with self._lock:
            for qual, v in (snap.get("counters") or {}).items():
                if _is_number(v):
                    self._counters[merged_key(qual)] = float(v)
            for qual, v in (snap.get("gauges") or {}).items():
                if _is_number(v):
                    self._gauges[merged_key(qual)] = float(v)
            for qual, summ in (snap.get("histograms") or {}).items():
                if isinstance(summ, dict):
                    self._hists[merged_key(qual)] = _FrozenHist(summ)

    # ------------------------------------------------------ collectors
    def register_collector(self, fn: Callable[[], dict],
                           labels: Optional[dict] = None,
                           name: Optional[str] = None) -> str:
        """Register ``fn() -> {"counters": {...}, "gauges": {...},
        "histograms": {...}}`` (or a flat numeric dict, treated as
        gauges). Bound methods are held via ``weakref.WeakMethod`` so a
        collected owner silently drops out of the scrape; plain
        callables are held strongly. Returns the collector name (usable
        with :meth:`unregister_collector`). Nested numeric dicts are
        flattened with dotted keys; ``labels`` qualify every metric the
        collector emits."""
        is_weak = hasattr(fn, "__self__")
        ref = weakref.WeakMethod(fn) if is_weak else fn
        cname = name or getattr(fn, "__qualname__", "collector")
        with self._lock:
            self._collectors.append((cname, labels_key(labels), ref,
                                     is_weak))
        return cname

    def unregister_collector(self, name: str) -> int:
        with self._lock:
            before = len(self._collectors)
            self._collectors = [c for c in self._collectors
                                if c[0] != name]
            return before - len(self._collectors)

    def _live_collectors(self) -> List[tuple]:
        """Resolve weakrefs and prune the dead, under the lock; the
        resolved callables are invoked by the caller OUTSIDE it."""
        live, keep = [], []
        with self._lock:
            for cname, lk, ref, is_weak in self._collectors:
                fn = ref() if is_weak else ref
                if fn is None:
                    continue          # owner was GC'd: prune
                keep.append((cname, lk, ref, is_weak))
                live.append((cname, lk, fn))
            self._collectors = keep
        return live

    # -------------------------------------------------------- exports
    def snapshot(self) -> dict:
        """Everything, one plain dict: intrinsic metrics plus every live
        collector's contribution, keys qualified with their labels."""
        with self._lock:
            counters = {_qualified(n, lk): v
                        for (n, lk), v in self._counters.items()}
            gauges = {_qualified(n, lk): v
                      for (n, lk), v in self._gauges.items()}
            hists = {_qualified(n, lk): h.summary()
                     for (n, lk), h in self._hists.items()}
        for cname, lk, fn in self._live_collectors():
            try:
                got = fn() or {}
            except Exception:
                with self._lock:
                    self.collector_errors += 1
                continue
            if not isinstance(got, dict):
                continue
            sections = (got if ("counters" in got or "gauges" in got
                                or "histograms" in got)
                        else {"gauges": got})
            for section, sink in (("counters", counters),
                                  ("gauges", gauges)):
                flat: Dict[str, float] = {}
                _flatten_numbers("", sections.get(section, {}) or {}, flat)
                for n, v in flat.items():
                    sink[_qualified(n, lk)] = v
            for n, summ in (sections.get("histograms", {}) or {}).items():
                if isinstance(summ, dict):
                    hists[_qualified(n, lk)] = {
                        k: v for k, v in summ.items() if _is_number(v)}
        return {"time": round(time.time(), 3), "counters": counters,
                "gauges": gauges, "histograms": hists}

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def prometheus_text(self) -> str:
        """Prometheus text exposition of :meth:`snapshot` (names
        sanitized, one ``# TYPE`` per family, histogram summaries as
        ``quantile``-labeled series + ``_count``/``_sum``)."""
        snap = self.snapshot()
        lines: List[str] = []
        typed: set = set()

        def _split(qual: str) -> Tuple[str, str]:
            if "{" in qual:
                base, rest = qual.split("{", 1)
                return _prom_name(base), "{" + rest
            return _prom_name(qual), ""

        def _merge(labels: str, extra: str) -> str:
            if not labels:
                return "{" + extra + "}"
            return labels[:-1] + "," + extra + "}"

        for kind, section in (("counter", "counters"), ("gauge", "gauges")):
            for qual in sorted(snap[section]):
                name, labels = _split(qual)
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name}{labels} {snap[section][qual]}")
        for qual in sorted(snap["histograms"]):
            name, labels = _split(qual)
            summ = snap["histograms"][qual]
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} summary")
            for q, key in (("0.5", "p50"), ("0.99", "p99")):
                if key in summ:
                    qlabel = 'quantile="%s"' % q
                    lines.append(
                        f"{name}{_merge(labels, qlabel)} {summ[key]}")
            if "count" in summ:
                lines.append(f"{name}_count{labels} {summ['count']}")
            if "sum" in summ:
                lines.append(f"{name}_sum{labels} {summ['sum']}")
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------- default
_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def _profiler_collector() -> dict:
    from .. import profiler

    return {"counters": dict(profiler.counter_values())}


def _compile_cache_collector() -> dict:
    # The port traces and compiles nothing (no ``framework/compile_cache``):
    # the reference's three gauges are kept, at 0, so a scrape carries the
    # same series in both packages.
    return {"gauges": {"compile_cache.compiles": 0,
                       "compile_cache.calls": 0,
                       "compile_cache.cache_hits": 0}}


def default_registry() -> MetricsRegistry:
    """The process-wide registry. Created on first use with the two
    built-in absorbers wired: ``profiler.counter_values()`` (every
    ``bump_counter`` total) and the compile-cache gauges (0 here)."""
    global _default
    with _default_lock:
        if _default is None:
            reg = MetricsRegistry()
            reg.register_collector(_profiler_collector, name="profiler")
            reg.register_collector(_compile_cache_collector,
                                   name="compile_cache")
            _default = reg
        return _default

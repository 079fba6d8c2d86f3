"""Serving counters, gauges and latency histograms (port of
``paddle_tpu/serving/metrics.py``).

- **queue depth / slot occupancy** (gauges plus a time-weighted
  occupancy integral),
- **TTFT** (time to first token: queue wait + prefill),
- **inter-token latency** (the decode-loop heartbeat users feel),
- **goodput** (tokens/s, requests/s, and the reject/expire/requeue counts
  that explain the gap from offered load; overload sheds and per-tenant
  rate-limit rejects apart from failures),
- **prefix reuse** (prompt tokens served from the block pool against
  tokens prefilled, and their hit rate),
- **per adapter** (requests, tokens, failures and TTFT per LoRA tenant,
  recorded when the engine serves through an ``AdapterStore``; the base
  model books under ``"base"``).

Histograms keep a bounded reservoir sample with exact count, sum and max;
their percentiles are the registry's ``nearest_rank``, as in the
reference. Every ``ServingMetrics`` feeds the process metrics registry
(``observability.registry``) through a weak collector labeled
``metrics=<m#>``, so ``prometheus_text()`` carries its counters, gauges
and histograms beside every other layer's.
"""
from __future__ import annotations

import itertools
import random
import threading
import time
from typing import Dict, List, Optional

from ..observability import registry as _obs_registry

__all__ = ["LatencyHistogram", "ServingMetrics"]

_metrics_serial = itertools.count()


class LatencyHistogram:
    """Reservoir-sampled latency distribution (Vitter's algorithm R) with
    exact count/sum/max; memory stays ``O(max_samples)``."""

    def __init__(self, max_samples: int = 4096, seed: int = 0):
        self.max_samples = int(max_samples)
        self._rng = random.Random(seed)
        self._samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def observe(self, seconds: float) -> None:
        s = float(seconds)
        self.count += 1
        self.total += s
        self.max = max(self.max, s)
        if len(self._samples) < self.max_samples:
            self._samples.append(s)
        else:
            j = self._rng.randrange(self.count)
            if j < self.max_samples:
                self._samples[j] = s

    def percentile(self, p: float) -> float:
        return _obs_registry.nearest_rank(sorted(self._samples), p)

    def summary(self) -> Dict[str, float]:
        mean = self.total / self.count if self.count else 0.0
        return {"count": self.count,
                "mean_ms": mean * 1e3,
                "p50_ms": self.percentile(50) * 1e3,
                "p99_ms": self.percentile(99) * 1e3,
                "max_ms": self.max * 1e3}

    @classmethod
    def merge(cls, hists: List["LatencyHistogram"]) -> "LatencyHistogram":
        """Fleet roll-up: pool the replicas' reservoirs into one histogram
        (exact count/sum/max; percentiles over the combined sample)."""
        out = cls(max_samples=max([h.max_samples for h in hists] or [1]))
        for h in hists:
            out.count += h.count
            out.total += h.total
            out.max = max(out.max, h.max)
            out._samples.extend(h._samples)
        return out


class ServingMetrics:
    """Thread-safe counters/gauges/histograms for one serving loop."""

    # requests_shed: deadline-aware overload sheds (Overloaded,
    # retryable), apart from expiries (TimeoutError) and failures;
    # requests_rate_limited: per-tenant token-bucket rejects
    # (RateLimited), apart from sheds: one tenant over its allowance, not
    # the server over capacity; prefix_*_tokens: prompt tokens served
    # from the block pool / prefilled (both 0 without a pool)
    COUNTERS = ("requests_submitted", "requests_completed",
                "requests_rejected", "requests_expired", "requests_shed",
                "requests_rate_limited", "requests_failed",
                "requests_requeued", "tokens_emitted", "prefills",
                "decode_steps", "prefix_hit_tokens", "prefix_miss_tokens")

    def __init__(self, slots: int):
        self.slots = int(slots)
        self._lock = threading.Lock()
        self.reset()
        # a weak (bound-method) collector feeds the counters/histograms
        # into every registry scrape, labeled per instance so co-hosted
        # replicas stay apart
        self._obs_label = f"m{next(_metrics_serial)}"
        _obs_registry.default_registry().register_collector(
            self._obs_collect, labels={"metrics": self._obs_label},
            name=f"serving_metrics.{self._obs_label}")

    def _obs_collect(self) -> dict:
        with self._lock:
            counters = {f"serving.{name}": getattr(self, name)
                        for name in self.COUNTERS}
            hists = {}
            for hname, h in (("serving.ttft_s", self.ttft),
                             ("serving.inter_token_s", self.inter_token),
                             ("serving.queue_wait_s", self.queue_wait)):
                hists[hname] = {"count": h.count,
                                "sum": round(h.total, 6),
                                "p50": round(h.percentile(50), 6),
                                "p99": round(h.percentile(99), 6),
                                "max": round(h.max, 6)}
            return {"counters": counters,
                    "gauges": {"serving.metrics_queue_depth":
                               self.queue_depth,
                               "serving.metrics_active_slots":
                               self.active_slots},
                    "histograms": hists}

    def reset(self) -> None:
        with self._lock:
            self._t0 = time.monotonic()
            for name in self.COUNTERS:
                setattr(self, name, 0)
            self.queue_depth = 0
            self.active_slots = 0
            self._occ_integral = 0.0     # slot-seconds of occupancy
            self._occ_last_t = self._t0
            self.ttft = LatencyHistogram()
            self.inter_token = LatencyHistogram()
            self.queue_wait = LatencyHistogram()
            self._per_adapter: Dict[str, dict] = {}

    def _advance_occupancy(self, now: float) -> None:
        self._occ_integral += self.active_slots * (now - self._occ_last_t)
        self._occ_last_t = now

    def inc(self, name: str, by: int = 1) -> None:
        if name not in self.COUNTERS:
            raise KeyError(f"unknown counter {name!r}")
        with self._lock:
            setattr(self, name, getattr(self, name) + by)

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = int(depth)

    def set_active_slots(self, active: int) -> None:
        with self._lock:
            self._advance_occupancy(time.monotonic())
            self.active_slots = int(active)

    def observe_ttft(self, seconds: float) -> None:
        with self._lock:
            self.ttft.observe(seconds)

    def observe_inter_token(self, seconds: float) -> None:
        with self._lock:
            self.inter_token.observe(seconds)

    def observe_queue_wait(self, seconds: float) -> None:
        with self._lock:
            self.queue_wait.observe(seconds)

    # ------------------------------------------------------- per adapter
    def _adapter_locked(self, adapter_id) -> dict:
        name = "base" if adapter_id is None else str(adapter_id)
        e = self._per_adapter.get(name)
        if e is None:
            # a smaller reservoir than the global histograms: one exists
            # per tenant, and a p50 settles long before 4096 samples
            e = self._per_adapter[name] = {
                "requests": 0, "tokens": 0, "failures": 0,
                "ttft": LatencyHistogram(max_samples=512)}
        return e

    def adapter_request(self, adapter_id) -> None:
        with self._lock:
            self._adapter_locked(adapter_id)["requests"] += 1

    def adapter_failure(self, adapter_id, n: int = 1) -> None:
        """Book a failed, expired or shed request against its tenant."""
        with self._lock:
            self._adapter_locked(adapter_id)["failures"] += int(n)

    def adapter_tokens(self, adapter_id, n: int = 1) -> None:
        with self._lock:
            self._adapter_locked(adapter_id)["tokens"] += int(n)

    def observe_adapter_ttft(self, adapter_id, seconds: float) -> None:
        with self._lock:
            self._adapter_locked(adapter_id)["ttft"].observe(seconds)

    def snapshot(self, compile_stats: Optional[dict] = None,
                 prefix_cache: Optional[dict] = None,
                 adapter_store: Optional[dict] = None) -> dict:
        """One plain dict of everything (times in ms, rates per second).
        ``compile_stats`` (the engine's ``cache_stats()``),
        ``prefix_cache`` (a ``BlockPool.stats()`` dict) and
        ``adapter_store`` (an ``AdapterStore.stats()`` dict) ride along
        under their own keys when given; the ``per_adapter`` block
        (requests, tokens, failures and TTFT per tenant) appears whenever
        adapter traffic was recorded."""
        with self._lock:
            now = time.monotonic()
            self._advance_occupancy(now)
            elapsed = max(now - self._t0, 1e-9)
            seen = self.prefix_hit_tokens + self.prefix_miss_tokens
            out = {"elapsed_s": elapsed,
                   "slots": self.slots,
                   "queue_depth": self.queue_depth,
                   "active_slots": self.active_slots,
                   "slot_occupancy":
                       self._occ_integral / (elapsed * self.slots)}
            out.update({name: getattr(self, name) for name in self.COUNTERS})
            out.update({
                "prefix_hit_rate": (round(self.prefix_hit_tokens / seen, 4)
                                    if seen else 0.0),
                "tokens_per_sec": self.tokens_emitted / elapsed,
                "requests_per_sec": self.requests_completed / elapsed,
                "ttft": self.ttft.summary(),
                "inter_token": self.inter_token.summary(),
                "queue_wait": self.queue_wait.summary(),
            })
            if compile_stats is not None:
                out["compile_stats"] = compile_stats
            if prefix_cache is not None:
                out["prefix_cache"] = prefix_cache
            if adapter_store is not None:
                out["adapter_store"] = adapter_store
            if self._per_adapter:
                out["per_adapter"] = {
                    name: {"requests": e["requests"],
                           "tokens": e["tokens"],
                           "failures": e["failures"],
                           "ttft_p50_ms": round(
                               e["ttft"].percentile(50) * 1e3, 3),
                           # exact count and sum, so that a window's mean
                           # TTFT can be diffed across snapshots
                           "ttft_count": e["ttft"].count,
                           "ttft_sum_ms": round(e["ttft"].total * 1e3, 3)}
                    for name, e in sorted(self._per_adapter.items())}
            return out

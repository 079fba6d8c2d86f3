"""Serving counters, gauges and latency histograms (the part of
``paddle_tpu/serving/metrics.py`` that ``server.py`` needs).

- **queue depth / slot occupancy** (gauges plus a time-weighted
  occupancy integral),
- **TTFT** (time to first token: queue wait + prefill),
- **inter-token latency** (the decode-loop heartbeat users feel),
- **goodput** (tokens/s, requests/s, and the reject/expire/requeue counts
  that explain the gap from offered load).

Histograms keep a bounded reservoir sample with exact count, sum and max.
Export to the reference's observability registry is not ported yet.
"""
from __future__ import annotations

import math
import random
import threading
import time
from typing import Dict, List

__all__ = ["LatencyHistogram", "ServingMetrics"]


def _nearest_rank(sorted_samples: List[float], p: float) -> float:
    if not sorted_samples:
        return 0.0
    rank = max(1, math.ceil(p / 100.0 * len(sorted_samples)))
    return sorted_samples[min(rank, len(sorted_samples)) - 1]


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
        return _nearest_rank(sorted(self._samples), p)

    def summary(self) -> Dict[str, float]:
        mean = self.total / self.count if self.count else 0.0
        return {"count": self.count,
                "mean_ms": mean * 1e3,
                "p50_ms": self.percentile(50) * 1e3,
                "p99_ms": self.percentile(99) * 1e3,
                "max_ms": self.max * 1e3}


class ServingMetrics:
    """Thread-safe counters/gauges/histograms for one serving loop."""

    COUNTERS = ("requests_submitted", "requests_completed",
                "requests_rejected", "requests_expired", "requests_failed",
                "requests_requeued", "tokens_emitted", "prefills",
                "decode_steps")

    def __init__(self, slots: int):
        self.slots = int(slots)
        self._lock = threading.Lock()
        self.reset()

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

    def snapshot(self) -> dict:
        """One plain dict of everything (times in ms, rates per second)."""
        with self._lock:
            now = time.monotonic()
            self._advance_occupancy(now)
            elapsed = max(now - self._t0, 1e-9)
            out = {"elapsed_s": elapsed,
                   "slots": self.slots,
                   "queue_depth": self.queue_depth,
                   "active_slots": self.active_slots,
                   "slot_occupancy":
                       self._occ_integral / (elapsed * self.slots)}
            out.update({name: getattr(self, name) for name in self.COUNTERS})
            out.update({
                "tokens_per_sec": self.tokens_emitted / elapsed,
                "requests_per_sec": self.requests_completed / elapsed,
                "ttft": self.ttft.summary(),
                "inter_token": self.inter_token.summary(),
                "queue_wait": self.queue_wait.summary(),
            })
            return out

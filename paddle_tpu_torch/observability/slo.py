"""Per-tenant SLO tracking: multi-window burn-rate monitoring over
aggregated serving snapshots (port of ``paddle_tpu/observability/slo.py``;
framework-free, so copied).

An SLO is a promise ("99.9% of tenantA's requests start streaming
within 500ms"); a **burn rate** is how fast the fleet is spending that
promise's error budget — burn 1.0 means exactly on budget, burn 10
means the budget for the period is gone in a tenth of it. Following the
multi-window discipline (Google SRE workbook ch.5), :class:`SloTracker`
evaluates every tenant over a FAST window (default 1 minute — pages
quickly on a hard outage) and a SLOW window (default 30 minutes —
confirms a sustained problem without flapping), both fed from the same
cumulative counters the serving layer already exports:

- ``ingest()`` takes a serving snapshot — either one
  ``InferenceServer.snapshot()`` or a ``ReplicaRouter.snapshot()``
  fleet roll-up — and diffs the per-tenant cumulative counters
  (``per_adapter`` requests / failures / TTFT sums, plus a
  ``__fleet__`` pseudo-tenant from the global counters) against the
  previous ingest into time-bucketed good/bad deltas;
- a request is **bad** if it failed/expired, or if it landed in an
  ingest interval whose mean TTFT exceeded ``target_ttft_s``
  (reservoir percentiles aren't delta-able across snapshots; the
  interval mean is, and it is computed from exact count/sum);
- burn rates land in the metrics registry as labeled gauges
  (``slo.burn_rate_fast{tenant=...}`` etc.), and a fast-window burn
  crossing ``fast_burn_threshold`` triggers ONE flight-recorder dump
  per breach episode (edge-triggered) carrying the tenant label — an
  SLO violation ships its own evidence.

The tracker is registry- and transport-agnostic: the router's fleet
scrape loop feeds it from rpc roll-ups, ``tools/serve_bench.py`` feeds
it start/end snapshots for its ``slo_report`` block, and tests feed it
synthetic dicts with a fake clock.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["SloPolicy", "SloTracker", "FLEET_TENANT"]

#: pseudo-tenant aggregating the whole fleet's traffic — SLO tracking
#: works with no adapter store at all (every request books here)
FLEET_TENANT = "__fleet__"


class SloPolicy:
    """One tenant-facing service-level objective.

    ``target_ttft_s`` is the latency promise (time to first token);
    ``target_availability`` the success-fraction promise whose
    complement is the error budget burn rates are measured against.
    ``fast_window_s`` / ``slow_window_s`` are the two evaluation
    windows; ``fast_burn_threshold`` is the paging line (and the
    flight-dump trigger), ``slow_burn_threshold`` the sustained-burn
    line surfaced in reports/gauges."""

    def __init__(self, target_ttft_s: float = 0.5,
                 target_availability: float = 0.999, *,
                 target_itl_s: Optional[float] = None,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 1800.0,
                 fast_burn_threshold: float = 10.0,
                 slow_burn_threshold: float = 2.0):
        if not 0.0 < target_availability < 1.0:
            raise ValueError(
                f"target_availability must be in (0, 1), got "
                f"{target_availability} (1.0 leaves a zero error budget "
                f"— burn rate would be undefined)")
        if target_ttft_s <= 0:
            raise ValueError(f"target_ttft_s must be > 0, got "
                             f"{target_ttft_s}")
        if not 0 < fast_window_s <= slow_window_s:
            raise ValueError(
                f"windows must satisfy 0 < fast ({fast_window_s}) <= "
                f"slow ({slow_window_s})")
        if target_itl_s is not None and target_itl_s <= 0:
            raise ValueError(f"target_itl_s must be > 0, got "
                             f"{target_itl_s}")
        self.target_ttft_s = float(target_ttft_s)
        # inter-token latency promise (None = untracked). TTFT and ITL
        # burn are ALSO tracked as separate signals (burn_*_ttft /
        # burn_*_itl in reports) so a disaggregated fleet can scale its
        # prefill pool on TTFT burn and its decode pool on ITL burn —
        # the two pools bottleneck independently
        self.target_itl_s = (None if target_itl_s is None
                             else float(target_itl_s))
        self.target_availability = float(target_availability)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn_threshold = float(fast_burn_threshold)
        self.slow_burn_threshold = float(slow_burn_threshold)

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target_availability

    def as_dict(self) -> dict:
        return {"target_ttft_s": self.target_ttft_s,
                "target_itl_s": self.target_itl_s,
                "target_availability": self.target_availability,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "fast_burn_threshold": self.fast_burn_threshold,
                "slow_burn_threshold": self.slow_burn_threshold}


def _cum_from_snapshot(snapshot: dict) -> Dict[str, dict]:
    """Cumulative per-tenant counters from a serving snapshot (single
    server or router roll-up): ``{tenant: {total, bad, ttft_count,
    ttft_sum_s}}``. ``total`` counts admitted requests, ``bad`` the
    failed/expired ones; TTFT count/sum feed the interval-mean latency
    judgment."""
    servers: List[dict] = []
    if "replicas" in snapshot and isinstance(snapshot["replicas"], dict):
        # router roll-up: per-replica server snapshots (DEAD replicas
        # contribute only {"state": ...} — their counters vanish, which
        # the delta clamp in ingest() absorbs)
        servers = [s for s in snapshot["replicas"].values()
                   if isinstance(s, dict)]
    else:
        servers = [snapshot]
    fleet = {"total": 0.0, "bad": 0.0, "ttft_count": 0.0,
             "ttft_sum_s": 0.0, "itl_count": 0.0, "itl_sum_s": 0.0}
    tenants: Dict[str, dict] = {FLEET_TENANT: fleet}
    for s in servers:
        shed = s.get("requests_shed", 0) or 0
        # sheds are budget-burning unavailability too (the request was
        # not served), and door sheds never reach requests_submitted —
        # add them to both sides. Queue sheds DO sit in
        # requests_submitted, so they count twice in the denominator: a
        # small conservative bias (burn reads slightly low), far better
        # than a shed storm reading as 100% availability.
        fleet["total"] += (s.get("requests_submitted", 0) or 0) + shed
        fleet["bad"] += ((s.get("requests_failed", 0) or 0)
                         + (s.get("requests_expired", 0) or 0)
                         + shed)
        ttft = s.get("ttft") or {}
        cnt = ttft.get("count", 0) or 0
        fleet["ttft_count"] += cnt
        fleet["ttft_sum_s"] += cnt * (ttft.get("mean_ms", 0.0) or 0.0) / 1e3
        itl = s.get("inter_token") or {}
        icnt = itl.get("count", 0) or 0
        fleet["itl_count"] += icnt
        fleet["itl_sum_s"] += icnt * (itl.get("mean_ms", 0.0) or 0.0) / 1e3
        for name, e in (s.get("per_adapter") or {}).items():
            t = tenants.setdefault(name, {"total": 0.0, "bad": 0.0,
                                          "ttft_count": 0.0,
                                          "ttft_sum_s": 0.0,
                                          "itl_count": 0.0,
                                          "itl_sum_s": 0.0})
            t["total"] += e.get("requests", 0) or 0
            t["bad"] += e.get("failures", 0) or 0
            t["ttft_count"] += e.get("ttft_count", 0) or 0
            t["ttft_sum_s"] += (e.get("ttft_sum_ms", 0.0) or 0.0) / 1e3
    return tenants


class SloTracker:
    """Multi-window burn-rate evaluation over successive snapshots.

    Feed :meth:`ingest` the latest aggregated serving snapshot each
    scrape; read :meth:`report` (or the registry gauges) for the
    verdicts. The first ingest is the baseline — it produces no
    buckets. ``registry=None`` uses the process default registry;
    ``registry=False`` disables gauges. ``dump_on_burn=False`` disables
    the flight dump (benches evaluating historical windows don't want
    crash artifacts)."""

    def __init__(self, policy: SloPolicy, registry=None,
                 dump_on_burn: bool = True,
                 clock=time.monotonic):
        self.policy = policy
        self.dump_on_burn = bool(dump_on_burn)
        self._clock = clock
        if registry is None:
            from .registry import default_registry

            registry = default_registry()
        self._registry = registry or None
        self._lock = threading.Lock()
        self._last: Optional[Dict[str, dict]] = None
        # tenant -> deque of (t, total, bad) ingest-interval buckets,
        # pruned past the slow window
        self._buckets: Dict[str, deque] = {}
        self._alerting: Dict[str, bool] = {}
        self.burn_alerts = 0
        self.ingests = 0

    # ------------------------------------------------------------ feed
    def ingest(self, snapshot: dict,
               now: Optional[float] = None) -> Optional[dict]:
        """Diff ``snapshot`` against the previous ingest and fold the
        interval into every tenant's burn windows; returns the fresh
        :meth:`report` (``None`` on the baseline ingest). Counter
        regressions (a replica died and its cumulative counts left the
        roll-up) clamp to zero rather than booking negative traffic."""
        now = self._clock() if now is None else float(now)
        cum = _cum_from_snapshot(snapshot)
        fired: List[dict] = []
        with self._lock:
            self.ingests += 1
            prev = self._last
            if prev is None:
                self._last = cum
                return None
            # the baseline is the field-wise MAX of what we've seen: a
            # DEAD replica's counters leave the roll-up (regression,
            # clamped below), and taking the lowered totals as the new
            # baseline would re-book its entire history as one
            # interval's traffic when it revives — a false burn burst.
            # The max-baseline instead counts only genuinely NEW events
            # after the dip (a genuine counter reset undercounts until
            # cum catches back up: conservative, never a false page).
            merged: Dict[str, dict] = {}
            for name in set(prev) | set(cum):
                p = prev.get(name)
                c = cum.get(name)
                if p is None or c is None:
                    merged[name] = dict(c if p is None else p)
                else:
                    merged[name] = {k: max(p.get(k, 0.0), c.get(k, 0.0))
                                    for k in set(p) | set(c)}
            self._last = merged
            horizon = now - self.policy.slow_window_s
            for name, c in cum.items():
                p = prev.get(name) or {}
                d_total = max(0.0, c["total"] - p.get("total", 0.0))
                d_bad = max(0.0, c["bad"] - p.get("bad", 0.0))
                d_cnt = max(0.0, c["ttft_count"]
                            - p.get("ttft_count", 0.0))
                d_sum = max(0.0, c["ttft_sum_s"]
                            - p.get("ttft_sum_s", 0.0))
                d_icnt = max(0.0, c.get("itl_count", 0.0)
                             - p.get("itl_count", 0.0))
                d_isum = max(0.0, c.get("itl_sum_s", 0.0)
                             - p.get("itl_sum_s", 0.0))
                ttft_bad = 0.0
                if d_cnt > 0 and (d_sum / d_cnt
                                  > self.policy.target_ttft_s):
                    # the interval's mean TTFT broke the latency
                    # promise: its requests count against the budget
                    d_bad += d_cnt
                    ttft_bad = d_cnt
                # inter-token latency is a SEPARATE signal with its own
                # denominator (token gaps, not requests) — it never
                # feeds the combined burn, so existing verdicts are
                # unchanged whether or not a target_itl_s is set
                itl_bad = 0.0
                if (self.policy.target_itl_s is not None and d_icnt > 0
                        and d_isum / d_icnt > self.policy.target_itl_s):
                    itl_bad = d_icnt
                # a failed request that never reached admission (shed,
                # expired in queue) is bad traffic that the admission
                # counters never saw — widen the interval total so
                # availability can't read 100% on pure failures
                d_total = max(d_total, d_bad)
                buckets = self._buckets.setdefault(name, deque())
                buckets.append((now, d_total, d_bad,
                                d_cnt, ttft_bad, d_icnt, itl_bad))
                while buckets and buckets[0][0] < horizon:
                    buckets.popleft()
            report = self._report_locked(now)
            for name, ten in report["tenants"].items():
                breached = (ten["burn_fast"]
                            >= self.policy.fast_burn_threshold
                            and ten["window_fast"]["total"] > 0)
                was = self._alerting.get(name, False)
                self._alerting[name] = breached
                ten["alerting"] = breached
                if breached and not was:
                    self.burn_alerts += 1
                    fired.append({"tenant": name, **ten})
            report["burn_alerts"] = self.burn_alerts
        # telemetry OUTSIDE the tracker lock: the registry and the
        # flight recorder take their own locks (and the dump does file
        # I/O) — holding ours across them would order locks both ways
        self._publish(report, fired)
        return report

    def _publish(self, report: dict, fired: List[dict]) -> None:
        reg = self._registry
        if reg is not None:
            for name, ten in report["tenants"].items():
                reg.set_gauge("slo.burn_rate_fast", ten["burn_fast"],
                              tenant=name)
                reg.set_gauge("slo.burn_rate_slow", ten["burn_slow"],
                              tenant=name)
                reg.set_gauge("slo.availability_fast",
                              ten["window_fast"]["availability"],
                              tenant=name)
                reg.set_gauge("slo.burn_alerting",
                              1.0 if ten["alerting"] else 0.0,
                              tenant=name)
                if self.policy.target_itl_s is not None:
                    # per-signal gauges only under an ITL policy — the
                    # registry's series set is unchanged without one
                    reg.set_gauge("slo.burn_rate_slow_ttft",
                                  ten["burn_slow_ttft"], tenant=name)
                    reg.set_gauge("slo.burn_rate_slow_itl",
                                  ten["burn_slow_itl"], tenant=name)
            reg.set_counter("slo.burn_alerts", self.burn_alerts)
        for alert in fired:
            from . import flight as _flight

            _flight.note("slo_burn", tenant=alert["tenant"],
                         burn_fast=alert["burn_fast"],
                         burn_slow=alert["burn_slow"])
            if self.dump_on_burn:
                # the violation carries its own evidence: ring + span
                # tail + metrics at the moment the budget caught fire
                _flight.dump("slo_burn", extra={
                    "tenant": alert["tenant"],
                    "burn_fast": alert["burn_fast"],
                    "burn_slow": alert["burn_slow"],
                    "window_fast": alert["window_fast"],
                    "window_slow": alert["window_slow"],
                    "policy": self.policy.as_dict()})

    # ---------------------------------------------------------- report
    def _window(self, buckets, now: float, span: float) -> dict:
        total = bad = 0.0
        tcnt = tbad = icnt = ibad = 0.0
        for b in buckets:
            if b[0] >= now - span:
                total += b[1]
                bad += b[2]
                tcnt += b[3]
                tbad += b[4]
                icnt += b[5]
                ibad += b[6]
        avail = 1.0 - (bad / total) if total > 0 else 1.0
        burn = ((bad / total) / self.policy.error_budget
                if total > 0 else 0.0)
        return {"total": round(total, 3), "bad": round(bad, 3),
                "availability": round(avail, 6),
                "burn_rate": round(burn, 4),
                # per-signal burns over their OWN denominators: TTFT
                # over admitted requests, ITL over token gaps — the
                # disagg autoscaler's per-pool scaling signals
                "burn_ttft": round(
                    (tbad / tcnt) / self.policy.error_budget, 4)
                if tcnt > 0 else 0.0,
                "burn_itl": round(
                    (ibad / icnt) / self.policy.error_budget, 4)
                if icnt > 0 else 0.0}

    def _report_locked(self, now: float) -> dict:
        tenants = {}
        for name, buckets in self._buckets.items():
            fast = self._window(buckets, now, self.policy.fast_window_s)
            slow = self._window(buckets, now, self.policy.slow_window_s)
            tenants[name] = {
                "window_fast": fast, "window_slow": slow,
                "burn_fast": fast["burn_rate"],
                "burn_slow": slow["burn_rate"],
                "burn_fast_ttft": fast["burn_ttft"],
                "burn_slow_ttft": slow["burn_ttft"],
                "burn_fast_itl": fast["burn_itl"],
                "burn_slow_itl": slow["burn_itl"],
                "fast_breached": (fast["burn_rate"]
                                  >= self.policy.fast_burn_threshold
                                  and fast["total"] > 0),
                "slow_breached": (slow["burn_rate"]
                                  >= self.policy.slow_burn_threshold
                                  and slow["total"] > 0),
                "alerting": self._alerting.get(name, False),
            }
        return {"policy": self.policy.as_dict(), "tenants": tenants,
                "burn_alerts": self.burn_alerts,
                "ingests": self.ingests}

    def report(self, now: Optional[float] = None) -> dict:
        """Current per-tenant verdicts: fast/slow window totals,
        availability, burn rates, breach flags — the ``slo_report``
        block ``serve_bench.py`` emits."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            return self._report_locked(now)

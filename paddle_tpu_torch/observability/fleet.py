"""Fleet-wide observability plane: cross-host metrics aggregation and
remote trace collection with clock-skew alignment (port of
``paddle_tpu/observability/fleet.py``; framework-free, so copied).

Every process has its own :class:`~.registry.MetricsRegistry`, span
buffer and flight recorder, and the serving fleet stretches across
processes over rpc. This module makes that fleet observable as ONE
system from the router's process:

- **metrics aggregation** — :class:`FleetAggregator` holds the latest
  registry snapshot scraped from every replica (the router's scrape
  loop feeds it via :meth:`FleetAggregator.observe_scrape`) and rolls
  them up into a fleet-level :class:`MetricsRegistry` where every metric
  carries a ``replica=<name>`` label. A replica that stops answering
  degrades to a **stale-marked partial roll-up** (its last snapshot
  stays visible, ``fleet.replica_stale`` flips to 1) — never an error:
  a scrape that throws when one host dies would blind the operator at
  exactly the moment the telemetry matters;
- **clock alignment** — span timestamps are per-host wall clocks.
  :func:`estimate_clock_offset` derives each host's offset from the RTT
  midpoint of a bounded request/response (the NTP symmetric-delay
  assumption: the remote stamped its reply halfway through the round
  trip), and :func:`align_spans` maps remote timestamps onto the local
  timeline. Skew is RECORDED in the returned report, and never silently
  corrected beyond ``max_correction_s`` — a wildly wrong clock shifted
  blindly would reorder causality worse than the raw data;
- **trace stitching** — :func:`stitch_traces` merges the local span
  buffer with every replica's exported span ring into one list, aligned
  and sorted, keyed by the correlation ids that already cross the rpc
  wire — the input shape ``tools/trace_view.py`` renders as one lane
  per request, with no dump files shipped between hosts.

Import-light (stdlib only), like the rest of the package: the serving
layer feeds it, so it sits below serving in the import graph.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from .registry import MetricsRegistry

__all__ = ["FleetAggregator", "estimate_clock_offset", "align_spans",
           "stitch_traces", "DEFAULT_MAX_SKEW_CORRECTION_S"]

#: largest clock offset (seconds) that is silently applied when mapping
#: a remote host's span timestamps onto the local timeline; anything
#: beyond it is reported as skew and left UNCORRECTED
DEFAULT_MAX_SKEW_CORRECTION_S = 0.25


def estimate_clock_offset(local_send_t: float, local_recv_t: float,
                          remote_t: float) -> float:
    """Offset of the REMOTE wall clock relative to ours, from one
    bounded request/response: assuming the remote stamped ``remote_t``
    at the RTT midpoint, ``offset = remote_t - (send + recv) / 2``.
    Positive = the remote clock runs ahead. The estimate's error is
    bounded by half the RTT asymmetry — probes (small payloads on a
    quiet path) give the tightest bound, which is why the router reuses
    its existing probe cadence for this."""
    return float(remote_t) - 0.5 * (float(local_send_t)
                                    + float(local_recv_t))


def align_spans(spans: List[dict], offset_s: float,
                max_correction_s: float = DEFAULT_MAX_SKEW_CORRECTION_S,
                host: Optional[str] = None) -> Tuple[List[dict], dict]:
    """Map remote-clock span dicts onto the local timeline.

    ``offset_s`` is the remote host's clock offset (its clock minus
    ours, from :func:`estimate_clock_offset`); every ``t0``/``t1``
    shifts by ``-offset_s`` so the spans line up with locally recorded
    ones. When ``|offset_s|`` exceeds ``max_correction_s`` the spans
    are returned UNSHIFTED and the report flags ``clamped=True`` —
    skew is recorded, never silently corrected beyond the bound (an
    operator must see a broken clock, not a quietly rewritten one).
    Returns ``(aligned_spans, report)``; the input list is not
    mutated."""
    offset = float(offset_s or 0.0)
    clamped = abs(offset) > float(max_correction_s)
    applied = 0.0 if clamped else offset
    out = []
    for s in spans:
        s2 = dict(s)
        s2["t0"] = float(s["t0"]) - applied
        s2["t1"] = float(s["t1"]) - applied
        if host is not None:
            s2.setdefault("host", host)
        out.append(s2)
    report = {"host": host, "offset_s": round(offset, 6),
              "applied_s": round(applied, 6), "clamped": clamped,
              "max_correction_s": float(max_correction_s)}
    return out, report


def stitch_traces(local_spans: List[dict], remotes: Dict[str, dict],
                  max_correction_s: float = DEFAULT_MAX_SKEW_CORRECTION_S
                  ) -> Tuple[List[dict], List[dict]]:
    """Merge the local span list with every remote replica's exported
    spans into ONE time-sorted list keyed by the correlation ids the
    spans already carry.

    ``remotes`` maps replica name to ``{"spans": [...], "offset_s":
    float, "host": str}`` (the shape ``RemoteReplica.trace_export``
    returns); each remote set is clock-aligned via :func:`align_spans`
    before the merge. Returns ``(merged_spans, skew_reports)`` — one
    report per remote, including the clamped-skew ones, so the caller
    can surface clocks that could not be corrected."""
    merged = [dict(s) for s in local_spans]
    reports = []
    for name in sorted(remotes):
        entry = remotes[name] or {}
        aligned, rep = align_spans(
            entry.get("spans") or [], entry.get("offset_s") or 0.0,
            max_correction_s=max_correction_s,
            host=entry.get("host") or name)
        rep["replica"] = name
        if entry.get("error"):
            rep["error"] = str(entry["error"])
        for s in aligned:
            s.setdefault("src", name)
        merged.extend(aligned)
        reports.append(rep)
    merged.sort(key=lambda s: (float(s.get("t0", 0.0)),
                               float(s.get("t1", 0.0))))
    return merged, reports


class FleetAggregator:
    """Latest-scrape store + fleet-level registry roll-up.

    The aggregator does NO I/O of its own: the owner (the router's
    scrape loop, a drill, a test) fetches each replica's registry
    snapshot however it likes — rpc for remote replicas, an in-process
    read for local ones — and reports the outcome through
    :meth:`observe_scrape`. Keeping the transport out means the
    aggregator can never stall a caller: :meth:`rollup` /
    :meth:`metrics_text` only format state already in hand.

    Staleness: a replica is stale when its last scrape FAILED or its
    last good snapshot is older than ``stale_after_s``. Stale replicas
    keep contributing their last-known numbers to the roll-up (marked
    by the ``fleet.replica_stale`` gauge) — a partial fleet view beats
    a blank one during exactly the incident that made it partial."""

    def __init__(self, stale_after_s: float = 10.0):
        self.stale_after_s = float(stale_after_s)
        self._lock = threading.Lock()
        self._replicas: Dict[str, dict] = {}
        self.scrapes = 0
        self.scrape_errors = 0

    # ------------------------------------------------------------ feed
    def observe_scrape(self, name: str, snapshot: Optional[dict] = None,
                       error: Optional[object] = None,
                       clock_offset_s: Optional[float] = None,
                       rtt_s: Optional[float] = None,
                       now: Optional[float] = None) -> None:
        """Record one scrape attempt. Success replaces the replica's
        snapshot and clears its error; failure KEEPS the last good
        snapshot and marks the record stale (``error`` + a failure
        count) — the partial-roll-up contract."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            rec = self._replicas.setdefault(name, {
                "name": name, "snapshot": None, "scraped_at": None,
                "error": None, "failures": 0,
                "clock_offset_s": None, "rtt_s": None})
            if error is None:
                rec["snapshot"] = snapshot
                rec["scraped_at"] = now
                rec["error"] = None
                rec["failures"] = 0
                self.scrapes += 1
            else:
                rec["error"] = f"{type(error).__name__}: {error}" \
                    if isinstance(error, BaseException) else str(error)
                rec["failures"] += 1
                self.scrape_errors += 1
            if clock_offset_s is not None:
                rec["clock_offset_s"] = float(clock_offset_s)
            if rtt_s is not None:
                rec["rtt_s"] = float(rtt_s)

    def forget(self, name: str) -> None:
        """Drop a replica from the roll-up (an operator removed it for
        good — distinct from stale, which is 'should be there')."""
        with self._lock:
            self._replicas.pop(name, None)

    # ---------------------------------------------------------- export
    def _is_stale(self, rec: dict, now: float) -> bool:
        return (rec["scraped_at"] is None
                or rec["error"] is not None
                or now - rec["scraped_at"] > self.stale_after_s)

    def _records(self) -> Tuple[List[dict], int, int]:
        with self._lock:
            return ([dict(r) for r in self._replicas.values()],
                    self.scrapes, self.scrape_errors)

    def rollup(self) -> MetricsRegistry:
        """A fresh fleet-level :class:`MetricsRegistry` built from the
        latest scrape state: every replica's snapshot absorbed under a
        ``replica=<name>`` label, plus the ``fleet.*`` meta-series
        (staleness flag, scrape age, failure count, clock offset)."""
        reg = MetricsRegistry()
        now = time.monotonic()
        recs, scrapes, errors = self._records()
        for rec in recs:
            labels = {"replica": rec["name"]}
            if rec["snapshot"]:
                reg.absorb_snapshot(rec["snapshot"], labels=labels)
            reg.set_gauge("fleet.replica_stale",
                          1.0 if self._is_stale(rec, now) else 0.0,
                          **labels)
            reg.set_gauge("fleet.scrape_failures", rec["failures"],
                          **labels)
            if rec["scraped_at"] is not None:
                reg.set_gauge("fleet.scrape_age_s",
                              round(now - rec["scraped_at"], 3), **labels)
            if rec["clock_offset_s"] is not None:
                reg.set_gauge("fleet.clock_offset_s",
                              round(rec["clock_offset_s"], 6), **labels)
        reg.set_counter("fleet.scrapes", scrapes)
        reg.set_counter("fleet.scrape_errors", errors)
        return reg

    def metrics_text(self) -> str:
        """Prometheus text for the WHOLE fleet from one endpoint — the
        roll-up registry's exposition."""
        return self.rollup().prometheus_text()

    def snapshot(self) -> dict:
        """The roll-up registry's plain-dict snapshot."""
        return self.rollup().snapshot()

    def statusz(self) -> dict:
        """Per-replica scrape metadata only (no metric payload): stale
        flag, age, error, failure count, clock offset/RTT — the block
        ``ReplicaRouter.fleet_statusz()`` embeds."""
        now = time.monotonic()
        recs, scrapes, errors = self._records()
        out = {}
        for rec in recs:
            out[rec["name"]] = {
                "stale": self._is_stale(rec, now),
                "scrape_age_s": (None if rec["scraped_at"] is None
                                 else round(now - rec["scraped_at"], 3)),
                "error": rec["error"],
                "failures": rec["failures"],
                "clock_offset_ms": (
                    None if rec["clock_offset_s"] is None
                    else round(rec["clock_offset_s"] * 1e3, 3)),
                "rtt_ms": (None if rec["rtt_s"] is None
                           else round(rec["rtt_s"] * 1e3, 3)),
                "has_snapshot": rec["snapshot"] is not None,
            }
        return {"replicas": out, "scrapes": scrapes,
                "scrape_errors": errors,
                "stale_after_s": self.stale_after_s}

"""paddle_tpu_torch.observability — unified runtime telemetry for train +
serve (port of ``paddle_tpu/observability``; framework-free, so copied and
adapted).

Three pieces, one substrate (README "Observability"):

- **metrics** (:mod:`.registry`): a thread-safe
  :class:`~paddle_tpu_torch.observability.registry.MetricsRegistry` of labeled
  counters/gauges/histograms with a single :meth:`snapshot` and
  Prometheus-text/JSON exporters. Existing telemetry —
  ``ServingMetrics``, ``profiler.bump_counter`` totals, the
  ``compile_cache`` gauges (0 in the port, which traces nothing), ``BlockPool``/``AdapterStore`` occupancy,
  scheduler queue depths — is absorbed via collectors behind its
  existing APIs; nothing callers already consume changed shape.
- **tracing** (:mod:`.tracing`): request-scoped correlation ids minted
  at ``ReplicaRouter.submit`` / ``InferenceServer.submit`` / the
  ``Model.fit`` step boundary and threaded through
  scheduler→engine→stream (and supervisor→rollback), recording host-side
  structured spans exportable as chrome://tracing JSON — one request =
  one named lane. ``tools/trace_view.py`` merges fleet-replica dumps by
  correlation id.
- **flight recorder** (:mod:`.flight`): a bounded per-process ring of
  recent events + span tail + metric snapshot, dumped as a crash
  artifact on engine reset, supervisor rollback/hang/preemption.
- **fleet plane** (:mod:`.fleet`): cross-host aggregation of the above
  — per-replica registry snapshots scraped over rpc roll up into one
  fleet-level ``MetricsRegistry`` with ``replica=`` labels (stale
  replicas marked, never dropped), and remote span rings stitch into
  one timeline with probe-RTT-midpoint clock alignment (skew recorded,
  never silently corrected beyond a bound).
- **SLO tracking** (:mod:`.slo`): per-tenant multi-window (1m/30m)
  burn-rate monitoring over the aggregated snapshots; a fast-window
  burn triggers a flight dump carrying the tenant label.

Import-light (stdlib only at module scope): every layer of the stack
feeds this package, so it sits at the bottom of the import graph.
"""
from . import fleet, flight, slo, tracing  # noqa: F401
from .fleet import (FleetAggregator, align_spans,  # noqa: F401
                    estimate_clock_offset, stitch_traces)
from .flight import FlightRecorder, flight_recorder  # noqa: F401
from .registry import MetricsRegistry, default_registry  # noqa: F401
from .slo import FLEET_TENANT, SloPolicy, SloTracker  # noqa: F401
from .tracing import (chrome_trace, correlate, current,  # noqa: F401
                      enable, enabled, export_chrome_trace,
                      new_correlation_id, record_event, record_span,
                      set_current, span, spans)

__all__ = [
    "MetricsRegistry", "default_registry", "FlightRecorder",
    "flight_recorder", "tracing", "flight", "new_correlation_id",
    "correlate", "current", "set_current", "span", "spans",
    "record_span", "record_event", "enable", "enabled", "chrome_trace",
    "export_chrome_trace", "fleet", "slo", "FleetAggregator",
    "align_spans", "estimate_clock_offset", "stitch_traces",
    "SloPolicy", "SloTracker", "FLEET_TENANT",
]

"""The port's observability (``paddle_tpu_torch.observability`` and
``paddle_tpu_torch.profiler``) against the JAX package's.

The registry, tracing, flight recorder, SLO tracker and fleet plane are
framework-free copies, so most tests here run the same scenario through
both packages (``pk`` is parametrized over them) and, where the output is
text or JSON, hold the port's to the reference's byte for byte. The
profiler is the one rewrite (``torch.profiler`` where the reference
starts ``jax.profiler``); its host-event half is held to the same
scenarios, its capture to the port's own contract. The serving hooks are
held end to end: one request through the port's router leaves one trace
lane, and an engine-reset drill dumps the failing request's id.
"""
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu.observability as jax_obs
import paddle_tpu.profiler as jax_profiler
import paddle_tpu_torch.observability as torch_obs
import paddle_tpu_torch.profiler as torch_profiler
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

GEO = dict(max_length=64, prefill_buckets=(16,))


def _pkg(obs, profiler):
    import importlib

    return types.SimpleNamespace(
        obs=obs, profiler=profiler,
        registry=importlib.import_module(obs.__name__ + ".registry"),
        tracing=obs.tracing, flight=obs.flight, slo=obs.slo,
        fleet=obs.fleet)


PKGS = {"jax": lambda: _pkg(jax_obs, jax_profiler),
        "torch": lambda: _pkg(torch_obs, torch_profiler)}


@pytest.fixture(params=sorted(PKGS))
def pk(request):
    return PKGS[request.param]()


@pytest.fixture(autouse=True)
def _restore_flight_dirs():
    """Tests repoint both packages' global flight recorders at their tmp
    dirs; later tests get the defaults back."""
    saved = [(obs.flight, obs.flight.flight_recorder().dump_dir)
             for obs in (jax_obs, torch_obs)]
    yield
    for flight, d in saved:
        flight.configure(dump_dir=d)


# ------------------------------------------------------------- registry
def _series(reg):
    """The same series in any registry: counters, labels, gauges, a
    histogram, a collector with nested and non-numeric leaves, an absorbed
    replica snapshot."""
    reg.inc("serving.requests_completed", 4, server="s0")
    reg.inc("req", 2)
    reg.inc("req", 3)
    reg.set_gauge("queue-depth", 2)
    reg.set_counter("fleet.scrapes", 7)
    for v in range(1, 40):
        reg.observe("ttft", v / 997.0, replica="r1")
    reg.register_collector(
        lambda: {"gauges": {"pool": {"occupancy": 0.5, "name": "x"}},
                 "counters": {"hits": 3}},
        labels={"server": "s1"}, name="c")
    reg.absorb_snapshot(
        {"counters": {'req{server="s0"}': 7},
         "gauges": {"depth": 3},
         "histograms": {"lat": {"count": 4, "p50": 0.1, "note": "x"}}},
        labels={"replica": "r2"})
    return reg


def test_prometheus_text_equals_the_reference_byte_for_byte():
    ours = _series(torch_obs.MetricsRegistry()).prometheus_text()
    ref = _series(jax_obs.MetricsRegistry()).prometheus_text()
    assert ours == ref
    assert "# TYPE serving_requests_completed counter" in ours
    assert 'ttft{replica="r1",quantile="0.5"}' in ours


def test_snapshot_and_json_equal_the_reference(monkeypatch):
    # both snapshots stamp time.time(): one clock reading for both, so a
    # millisecond between the two calls cannot part them
    monkeypatch.setattr(time, "time", lambda: 1760000000.123456)
    ours = _series(torch_obs.MetricsRegistry())
    ref = _series(jax_obs.MetricsRegistry())
    assert ours.snapshot() == ref.snapshot()
    assert ours.to_json() == ref.to_json()


def test_serving_metrics_collector_text_equals_the_reference():
    """Both packages' ServingMetrics fed the same observations scrape to
    the same Prometheus text (the reference's percentile definition, its
    rounding, its series names)."""
    from paddle_tpu.serving.metrics import ServingMetrics as JaxMetrics
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    texts = []
    for cls, obs in ((ServingMetrics, torch_obs), (JaxMetrics, jax_obs)):
        m = cls(slots=2)
        for name, n in (("requests_submitted", 5), ("tokens_emitted", 40),
                        ("prefix_hit_tokens", 16), ("requests_shed", 1)):
            m.inc(name, n)
        for v in (0.011, 0.052, 0.013, 0.3, 0.024):
            m.observe_ttft(v)
            m.observe_inter_token(v / 10)
            m.observe_queue_wait(v / 3)
        m.set_queue_depth(3)
        reg = obs.MetricsRegistry()
        reg.register_collector(m._obs_collect, labels={"metrics": "mX"})
        texts.append(reg.prometheus_text())
    assert texts[0] == texts[1]
    assert 'serving_ttft_s{metrics="mX",quantile="0.99"} 0.3' in texts[0]


def test_registry_counters_gauges_labels(pk):
    r = pk.registry.MetricsRegistry()
    assert r.inc("req", 2) == 2
    assert r.inc("req", 3) == 5
    r.inc("req", 1, replica="a")
    r.set_gauge("depth", 7, replica="a")
    snap = r.snapshot()
    assert snap["counters"]["req"] == 5
    assert snap["counters"]['req{replica="a"}'] == 1
    assert snap["gauges"]['depth{replica="a"}'] == 7


def test_registry_histogram_percentiles(pk):
    r = pk.registry.MetricsRegistry()
    for v in range(100):
        r.observe("lat", v / 1000.0)
    s = r.snapshot()["histograms"]["lat"]
    assert s["count"] == 100
    assert s["p50"] == pytest.approx(0.0495, abs=0.002)
    assert s["p99"] == pytest.approx(0.099, abs=0.002)
    assert s["max"] == pytest.approx(0.099)


def test_registry_collector_absorbs_flattens_and_unregisters(pk):
    r = pk.registry.MetricsRegistry()
    r.register_collector(
        lambda: {"gauges": {"pool": {"occupancy": 0.5, "name": "x"}},
                 "counters": {"hits": 3}},
        labels={"server": "s0"}, name="c")
    snap = r.snapshot()
    assert snap["gauges"]['pool.occupancy{server="s0"}'] == 0.5
    assert snap["counters"]['hits{server="s0"}'] == 3
    assert not any("pool.name" in k for k in snap["gauges"])
    assert r.unregister_collector("c") == 1
    assert 'hits{server="s0"}' not in r.snapshot()["counters"]


def test_registry_weak_collector_prunes_dead_owner(pk):
    import gc

    r = pk.registry.MetricsRegistry()

    class Owner:
        def collect(self):
            return {"gauges": {"alive": 1}}

    o = Owner()
    r.register_collector(o.collect, name="owner")
    assert r.snapshot()["gauges"].get("alive") == 1
    del o
    gc.collect()
    assert "alive" not in r.snapshot()["gauges"]


def test_registry_collector_errors_do_not_break_the_scrape(pk):
    r = pk.registry.MetricsRegistry()
    r.set_gauge("queue-depth", 2)
    r.register_collector(lambda: 1 / 0, name="boom")
    assert "queue_depth 2" in r.prometheus_text()
    assert r.collector_errors >= 1


def test_default_registry_absorbs_profiler_counters_and_compile_gauges(pk):
    pk.profiler.bump_counter("obs.test_counter", 5)
    snap = pk.obs.default_registry().snapshot()
    assert snap["counters"]["obs.test_counter"] >= 5
    assert "compile_cache.compiles" in snap["gauges"]
    json.dumps(snap)


def test_port_compile_gauges_read_zero():
    """The port traces nothing, so its compile-cache gauges are 0 (the
    series stay, as the reference's scrape carries them)."""
    g = torch_obs.default_registry().snapshot()["gauges"]
    assert (g["compile_cache.compiles"], g["compile_cache.calls"],
            g["compile_cache.cache_hits"]) == (0, 0, 0)


def test_parse_qualified_and_labels_key_match_the_reference():
    for qual in ("plain", 'serving.queue_depth{replica="r1",server="s0"}'):
        assert (torch_obs.registry.parse_qualified(qual)
                == jax_obs.registry.parse_qualified(qual))
    for vals in ([], [3.0], [1.0, 2.0, 9.0, 4.0], list(range(17))):
        srt = sorted(vals)
        for p in (0, 50, 90, 99, 100):
            assert (torch_obs.registry.nearest_rank(srt, p)
                    == jax_obs.registry.nearest_rank(srt, p))


# -------------------------------------------------------------- tracing
def test_correlation_ids_unique_and_scoped(pk):
    tr = pk.tracing
    a, b = tr.new_correlation_id(), tr.new_correlation_id()
    assert a != b and a.startswith("req-")
    # names of its own: the buffer is process-wide, and the reference's
    # test of the same behaviour may run later in this process
    with tr.correlate("corr-twin"):
        assert tr.current() == "corr-twin"
        with tr.span("inner-twin", tag=1):
            pass
    spans = tr.spans(corr="corr-twin", name="inner-twin")
    assert len(spans) == 1 and spans[0]["tags"] == {"tag": 1}


def test_trace_buffer_bounded_counts_drops(pk):
    tr = pk.tracing
    saved = tr._buf
    tr._buf = tr._TraceBuffer(capacity=4)
    try:
        for i in range(10):
            tr.record_event(f"e{i}")
        st = tr.stats()
        assert st["buffered"] == 4 and st["dropped"] == 6
        assert st["recorded"] == 10
        assert [s["name"] for s in tr.spans()] == ["e6", "e7", "e8", "e9"]
    finally:
        tr._buf = saved


def test_tracing_disabled_records_nothing(pk):
    tr = pk.tracing
    tr.enable(False)
    try:
        before = tr.stats()["recorded"]
        tr.record_event("nope")
        with tr.span("nope2"):
            pass
        assert tr.stats()["recorded"] == before
    finally:
        tr.enable(True)


SPAN_RECORDS = [
    {"name": "a", "corr": "c1", "t0": 1.0, "t1": 2.0, "tags": {}},
    {"name": "b", "corr": "c1", "t0": 2.0, "t1": 2.0, "tags": {"k": 1}},
    {"name": "c", "corr": "c2", "t0": 1.5, "t1": 1.8, "tags": {}},
    {"name": "d", "corr": None, "t0": 0.0, "t1": 0.5, "tags": {}},
]


def test_chrome_trace_equals_the_reference():
    ours = torch_obs.chrome_trace(span_records=[dict(r) for r in
                                                SPAN_RECORDS])
    ref = jax_obs.chrome_trace(span_records=[dict(r) for r in SPAN_RECORDS])
    assert json.dumps(ours, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)


def test_chrome_trace_one_lane_per_correlation(pk):
    ct = pk.tracing.chrome_trace(span_records=[dict(r) for r in
                                               SPAN_RECORDS])
    data = [e for e in ct["traceEvents"] if e["ph"] in ("X", "i")]
    lanes = {e["args"].get("correlation_id", "untraced"): e["tid"]
             for e in data}
    assert lanes["c1"] != lanes["c2"] != lanes["untraced"]
    assert lanes["untraced"] == 0
    a = next(e for e in data if e["name"] == "a")
    assert a["ph"] == "X" and a["dur"] == pytest.approx(1e6)
    assert next(e for e in data if e["name"] == "b")["ph"] == "i"


def test_export_chrome_trace_writes_file(pk, tmp_path):
    tr = pk.tracing
    with tr.correlate(tr.new_correlation_id("exp")) as corr:
        with tr.span("phase"):
            pass
    path = tr.export_chrome_trace(str(tmp_path / "trace.json"), corr=corr)
    with open(path) as f:
        obj = json.load(f)
    assert any(e.get("name") == "phase" for e in obj["traceEvents"])


# ------------------------------------------------------ flight recorder
def test_flight_recorder_ring_and_dump(pk, tmp_path):
    rec = pk.flight.FlightRecorder(capacity=3, dump_dir=str(tmp_path))
    for i in range(5):
        rec.note("ev", corr=f"c{i}", detail=i)
    evs = rec.events()
    assert len(evs) == 3 and evs[0]["detail"] == 2
    path = rec.dump("unit_test", corr="c4", extra={"k": "v"})
    with open(path) as f:
        dump = json.load(f)
    assert dump["format"] == "flight_recorder"
    assert dump["reason"] == "unit_test"
    assert dump["correlation_id"] == "c4"
    assert dump["extra"] == {"k": "v"}
    assert [e["corr"] for e in dump["events"]] == ["c2", "c3", "c4"]
    assert isinstance(dump["spans"], list)
    assert isinstance(dump["counters"], dict)
    assert rec.stats()["dumps_written"] == 1
    fname = os.path.basename(path)
    assert fname.startswith(f"flight_{pk.flight._host_token()}_"
                            f"{os.getpid()}_")


def test_flight_dump_schema_equals_the_reference(tmp_path):
    """The same notes dumped by both packages: the same keys at every
    level, the same events and extra (times and pids aside)."""
    dumps = []
    for obs in (torch_obs, jax_obs):
        rec = obs.flight.FlightRecorder(capacity=8,
                                        dump_dir=str(tmp_path / obs.__name__))
        rec.note("engine_reset", corr="c1", error="boom", inflight=["c1"])
        with open(rec.dump("engine_reset", corr="c1",
                           extra={"inflight": ["c1"]})) as f:
            dumps.append(json.load(f))
    ours, ref = dumps
    assert sorted(ours) == sorted(ref)
    assert ours["format"] == ref["format"] and ours["version"] == ref[
        "version"]
    assert sorted(ours["events"][0]) == sorted(ref["events"][0])
    assert ([{k: v for k, v in e.items() if k != "t"} for e in
             ours["events"]] == [{k: v for k, v in e.items() if k != "t"}
                                 for e in ref["events"]])
    assert ours["extra"] == ref["extra"]


def test_flight_recorder_dump_budget(pk, tmp_path):
    rec = pk.flight.FlightRecorder(dump_dir=str(tmp_path), max_dumps=2)
    assert rec.dump("a") and rec.dump("b")
    assert rec.dump("c") is None
    st = rec.stats()
    assert st["dumps_written"] == 2 and st["dumps_skipped"] == 1


# ------------------------------------------------------------- profiler
def test_record_event_summary_and_decorator(pk):
    prof = pk.profiler
    saved = prof._recorder
    prof._recorder = prof._HostEventRecorder()
    prof._recorder.enabled = True

    @prof.RecordEvent("fn_span")
    def fn(x):
        return x + 1

    try:
        with prof.RecordEvent("phase_a"):
            pass
        with prof.RecordEvent("phase_a"):
            pass
        assert fn(1) == 2
    finally:
        prof._recorder.enabled = False
    rows = prof.host_event_summary()
    prof._recorder = saved
    assert rows["phase_a"][0] == 2 and rows["fn_span"][0] == 1


def test_profiler_counts_dropped_spans_and_surfaces_them(pk):
    prof = pk.profiler
    saved = prof._recorder
    rec = prof._HostEventRecorder(capacity=4)
    rec.enabled = True
    prof._recorder = rec
    try:
        base = prof.counter_values().get("profiler.spans_dropped", 0)
        for _ in range(10):
            with prof.RecordEvent("spin"):
                pass
        assert rec.dropped == 6
        assert prof.counter_values()["profiler.spans_dropped"] == base + 6
        assert prof.host_event_summary()["(dropped spans)"][0] == 6
    finally:
        prof._recorder = saved


def test_host_event_summary_percentiles_equal_the_reference():
    rows = []
    for prof in (torch_profiler, jax_profiler):
        saved = prof._recorder
        prof._recorder = prof._HostEventRecorder()
        try:
            for i in range(1, 11):
                prof._recorder.record("op", 0.0, i / 100.0)
            prof._recorder.record("op2", 1.0, 1.5)
            rows.append(prof.host_event_summary(percentiles=(50, 99)))
            assert len(prof.host_event_summary()["op"]) == 4
        finally:
            prof._recorder = saved
    assert rows[0] == rows[1]
    assert rows[0]["op"][4] == pytest.approx(0.06, abs=0.011)


def test_make_scheduler_states_equal_the_reference():
    kw = dict(closed=1, ready=1, record=2, repeat=1, skip_first=1)
    ours = torch_profiler.make_scheduler(**kw)
    ref = jax_profiler.make_scheduler(**kw)
    assert [ours(i).name for i in range(8)] == [ref(i).name
                                                for i in range(8)]
    with pytest.raises(ValueError):
        torch_profiler.make_scheduler(closed=0, ready=0, record=0)


def test_timer_and_benchmark(pk):
    t = pk.profiler.Timer()
    t.begin()
    for _ in range(3):
        time.sleep(0.002)
        t.step(num_samples=8)
    t.end()
    assert t.steps_per_second() > 0 and t.ips() > 0
    assert "steps/s" in t.report()
    assert isinstance(pk.profiler.benchmark(), pk.profiler.Timer)


def test_export_protobuf_roundtrip(pk, tmp_path):
    prof = pk.profiler
    saved = prof._recorder
    prof._recorder = prof._HostEventRecorder()
    try:
        prof._recorder.record("x", 1.0, 2.0)

        class P:
            pass

        p = P()
        prof.export_protobuf(str(tmp_path), worker_name="w")(p)
        got = prof.load_profiler_result(p.last_protobuf_path)
    finally:
        prof._recorder = saved
    assert got == [{"name": "x", "start": 1.0, "end": 2.0}]


def test_record_event_opens_no_range_without_a_capture():
    """With no capture running, RecordEvent opens no torch range (it costs
    two clock reads and two flag tests)."""
    ev = torch_profiler.RecordEvent("idle")
    ev.begin()
    assert ev._range is None
    ev.end()


def test_profiler_capture_writes_chrome_trace_with_worker_ranges(tmp_path):
    """The port's Profiler drives torch.profiler: a stopped capture writes
    its Chrome trace into the trace dir, keeps the profile readable, and
    a RecordEvent opened on ANOTHER thread (as the serving worker opens
    serve:prefill) lands in it with the ops run inside it."""
    tdir = str(tmp_path / "prof")
    p = torch_profiler.Profiler(
        scheduler=torch_profiler.make_scheduler(closed=0, ready=1, record=2,
                                                repeat=1),
        on_trace_ready=torch_profiler.export_chrome_tracing(tdir),
        trace_dir=tdir)
    p.start()

    def worker():
        with torch_profiler.RecordEvent("serve:prefill"):
            torch.ones(8, 8) @ torch.ones(8, 8)

    for _ in range(4):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        p.step(num_samples=8)
    p.stop()
    assert "steps/s" in p.summary()
    assert p.last_trace_dir == tdir and os.path.isfile(p.last_trace_path)
    with open(p.last_trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ranges = [e for e in events if e["name"] == "serve:prefill"]
    assert len(ranges) == 2          # the two RECORD steps
    mm = [e for e in events if e["name"] in ("aten::mm", "aten::matmul")]
    assert any(r["tid"] == e["tid"] and r["ts"] <= e["ts"] <= r["ts"]
               + r["dur"] for r in ranges for e in mm)
    assert torch_profiler.host_event_summary()["serve:prefill"][0] == 2
    assert p.last_profile is not None


def test_profile_host_events_flag_is_ported():
    from paddle_tpu.framework import flags as jax_flags
    from paddle_tpu_torch.framework import flags

    name = "FLAGS_profile_host_events"
    assert flags.flag(name) == jax_flags.flag(name) is True
    flags.set_flags({name: False})
    try:
        assert flags.get_flags(name) == {name: False}
    finally:
        flags.set_flags({name: True})


# ------------------------------------------------------------- SLO
def _server_snap(submitted=0, failed=0, expired=0, ttft_count=0,
                 ttft_mean_ms=0.0, per_adapter=None, **extra):
    return {"requests_submitted": submitted, "requests_failed": failed,
            "requests_expired": expired,
            "ttft": {"count": ttft_count, "mean_ms": ttft_mean_ms},
            **({"per_adapter": per_adapter} if per_adapter else {}),
            **extra}


def _slo_run(slo, policy_kw, steps, **tracker_kw):
    clk = [0.0]
    tr = slo.SloTracker(slo.SloPolicy(**policy_kw), registry=False,
                        dump_on_burn=False, clock=lambda: clk[0],
                        **tracker_kw)
    reports = []
    for t, snap in steps:
        clk[0] = t
        reports.append(tr.ingest(snap))
    return reports


SLO_SCENARIOS = {
    "availability_window": (
        dict(target_ttft_s=10.0, target_availability=0.9,
             fast_window_s=10.0, slow_window_s=100.0,
             fast_burn_threshold=2.0),
        [(0.0, _server_snap()), (5.0, _server_snap(submitted=10, failed=5)),
         (30.0, _server_snap(submitted=10, failed=5))]),
    "ttft_per_tenant": (
        dict(target_ttft_s=0.1, target_availability=0.9,
             fast_burn_threshold=2.0),
        [(0.0, _server_snap(per_adapter={"tA": {
            "requests": 0, "failures": 0, "ttft_count": 0,
            "ttft_sum_ms": 0.0}})),
         (10.0, _server_snap(submitted=6, ttft_count=6, ttft_mean_ms=50.0,
                             per_adapter={"tA": {
                                 "requests": 6, "failures": 0,
                                 "ttft_count": 6, "ttft_sum_ms": 1200.0}}))]),
    "counter_regression": (
        dict(target_availability=0.9),
        [(0.0, {"replicas": {"a": _server_snap(submitted=10),
                             "b": _server_snap(submitted=8, failed=4)}}),
         (5.0, {"replicas": {"a": _server_snap(submitted=12),
                             "b": {"state": "dead"}}}),
         (10.0, {"replicas": {"a": _server_snap(submitted=13),
                              "b": _server_snap(submitted=8, failed=4)}})]),
    "sheds": (
        dict(target_availability=0.9, fast_burn_threshold=2.0),
        [(0.0, _server_snap()),
         (5.0, _server_snap(submitted=2, ttft_count=2, ttft_mean_ms=1.0,
                            requests_shed=18))]),
    "itl_signal": (
        dict(target_ttft_s=0.5, target_itl_s=0.02),
        [(0.0, _server_snap(inter_token={"count": 0, "mean_ms": 1.0})),
         (10.0, _server_snap(submitted=20, ttft_count=20, ttft_mean_ms=1.0,
                             inter_token={"count": 200, "mean_ms": 50.0}))]),
}


@pytest.mark.parametrize("scenario", sorted(SLO_SCENARIOS))
def test_slo_reports_equal_the_reference(scenario):
    policy_kw, steps = SLO_SCENARIOS[scenario]
    ours = _slo_run(torch_obs.slo, policy_kw, steps)
    ref = _slo_run(jax_obs.slo, policy_kw, steps)
    assert ours == ref


def test_slo_fast_burn_dumps_with_tenant_label(pk, tmp_path):
    pk.flight.configure(dump_dir=str(tmp_path))
    clk = [0.0]
    tr = pk.slo.SloTracker(
        pk.slo.SloPolicy(target_ttft_s=0.1, target_availability=0.9,
                         fast_window_s=60.0, slow_window_s=600.0,
                         fast_burn_threshold=2.0),
        registry=False, clock=lambda: clk[0])
    policy_kw, steps = SLO_SCENARIOS["ttft_per_tenant"]
    assert tr.ingest(steps[0][1]) is None
    clk[0] = 10.0
    rep = tr.ingest(steps[1][1])
    ten = rep["tenants"]["tA"]
    assert ten["burn_fast"] == pytest.approx(10.0) and ten["alerting"]
    assert rep["tenants"][pk.slo.FLEET_TENANT]["burn_fast"] == 0.0
    dumps = [f for f in os.listdir(tmp_path) if "slo_burn" in f]
    assert len(dumps) == 1
    with open(tmp_path / dumps[0]) as f:
        assert json.load(f)["extra"]["tenant"] == "tA"
    clk[0] = 20.0
    tr.ingest(_server_snap(submitted=12, ttft_count=12, ttft_mean_ms=50.0,
                           per_adapter={"tA": {
                               "requests": 12, "failures": 0,
                               "ttft_count": 12, "ttft_sum_ms": 2400.0}}))
    assert tr.burn_alerts == 1


@pytest.mark.parametrize("kw", [dict(target_availability=1.0),
                                dict(target_ttft_s=0.0),
                                dict(fast_window_s=100.0,
                                     slow_window_s=10.0),
                                dict(target_itl_s=0.0)])
def test_slo_policy_validation(pk, kw):
    with pytest.raises(ValueError):
        pk.slo.SloPolicy(**kw)


def test_slo_burn_gauges_land_in_the_registry(pk):
    reg = pk.registry.MetricsRegistry()
    clk = [0.0]
    tr = pk.slo.SloTracker(pk.slo.SloPolicy(target_availability=0.9),
                           registry=reg, dump_on_burn=False,
                           clock=lambda: clk[0])
    tr.ingest(_server_snap())
    clk[0] = 5.0
    tr.ingest(_server_snap(submitted=10, failed=5))
    text = reg.prometheus_text()
    assert f'slo_burn_rate_fast{{tenant="{pk.slo.FLEET_TENANT}"}}' in text


# ------------------------------------------------------------- fleet
def test_clock_alignment_and_stitching_equal_the_reference():
    corr = "req-x"
    local = [{"name": "router:submit", "corr": corr,
              "t0": 0.00, "t1": 0.01}]
    remotes = {"a": {"spans": [{"name": "prefill", "corr": corr,
                                "t0": 0.07, "t1": 0.10}],
                     "offset_s": 0.05, "host": "hostA"},
               "b": {"spans": [{"name": "decode", "corr": corr,
                                "t0": 0.01, "t1": 0.03}],
                     "offset_s": -0.05, "host": "hostB"},
               "z": {"spans": [{"name": "bad", "corr": corr,
                                "t0": 100.0, "t1": 100.1}],
                     "offset_s": 99.0, "host": "hostZ"}}
    ours = torch_obs.stitch_traces(local, remotes)
    ref = jax_obs.stitch_traces(local, remotes)
    assert ours == ref
    merged, reports = ours
    assert [s["name"] for s in merged][:3] == ["router:submit", "prefill",
                                               "decode"]
    assert next(r for r in reports if r["replica"] == "z")["clamped"]
    assert torch_obs.estimate_clock_offset(10.0, 10.02, 10.07) == \
        pytest.approx(0.06)
    for args in (([{"name": "a", "corr": "c", "t0": 1.05, "t1": 1.1}], 0.05),
                 ([{"name": "a", "corr": "c", "t0": 5.0, "t1": 5.1}], 0.4)):
        assert (torch_obs.align_spans(*args, max_correction_s=0.25)
                == jax_obs.align_spans(*args, max_correction_s=0.25))


def test_fleet_aggregator_text_equals_the_reference():
    texts = []
    for obs in (torch_obs, jax_obs):
        agg = obs.FleetAggregator(stale_after_s=10.0)
        snap = {"counters": {'serving.requests_completed{server="s0"}': 5},
                "gauges": {"g": 1.5}, "histograms": {}}
        agg.observe_scrape("r1", snapshot=snap, clock_offset_s=0.002,
                           now=100.0)
        agg.observe_scrape("r2", snapshot=snap, now=100.0)
        agg.observe_scrape("r2", error=ConnectionError("partitioned"),
                           now=101.0)
        st = agg.statusz()
        assert st["replicas"]["r2"]["stale"] is True
        assert "partitioned" in st["replicas"]["r2"]["error"]
        texts.append("\n".join(line for line in
                               agg.metrics_text().splitlines()
                               if "scrape_age" not in line))
    assert texts[0] == texts[1]
    assert 'fleet_replica_stale{replica="r2"} 1.0' in texts[0]


# ------------------------------------------------------ serving hooks
@pytest.fixture(scope="module")
def lm():
    cfg = gpt_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(7)).eval()
    return model, cfg


@pytest.fixture(scope="module")
def fleet(lm):
    from paddle_tpu_torch.serving import InferenceServer, ReplicaRouter

    model, _ = lm
    srv = InferenceServer(model, slots=2, max_queue_depth=8,
                          max_request_retries=1, device="cpu", **GEO)
    router = ReplicaRouter()
    router.add_replica(srv, "r0")
    yield router, srv
    router.shutdown(drain=False, timeout=30)


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n,)).astype(np.int32)


def test_served_request_yields_one_trace_lane(lm, fleet):
    """Router submit -> queue wait -> prefill (bucket tag) -> per-token
    decode -> stream end: one lane, one correlation id, as the reference
    records it; the batch-level decode_step spans ride the untraced lane."""
    tr = torch_obs.tracing
    model, cfg = lm
    router, srv = fleet
    h = router.submit(_prompt(cfg, 9, seed=1), max_new_tokens=5)
    assert h.result(timeout=300).shape[0] == 5
    corr = h.correlation_id
    assert corr and corr == h._current().correlation_id
    spans = tr.spans(corr=corr)
    names = [s["name"] for s in spans]
    for expected in ("submit", "router:submit", "queue_wait", "prefill",
                     "decode", "stream_end"):
        assert expected in names, f"missing {expected} in {names}"
    assert names.count("decode") == 4
    prefill = next(s for s in spans if s["name"] == "prefill")
    assert prefill["tags"] == {"bucket": 16, "prompt_len": 9, "slot": 0}
    assert tr.spans(name="decode_step")
    ct = tr.chrome_trace(corr=corr)
    assert len({e["tid"] for e in ct["traceEvents"]
                if e["ph"] in ("X", "i")}) == 1
    h2 = router.submit(_prompt(cfg, 6, seed=2), max_new_tokens=3)
    h2.result(timeout=300)
    assert h2.correlation_id != corr
    assert tr.spans(corr=h2.correlation_id, name="stream_end")


def test_registry_scrape_carries_serving_and_introspection(lm, fleet):
    model, cfg = lm
    router, srv = fleet
    router.submit(_prompt(cfg, 5, seed=3), max_new_tokens=2).result(
        timeout=300)
    snap = torch_obs.default_registry().snapshot()
    completed = [v for k, v in snap["counters"].items()
                 if k.startswith("serving.requests_completed")]
    assert completed and max(completed) >= 1
    label = srv._obs_label
    assert snap["gauges"][f'serving.slots{{server="{label}"}}'] == 2
    assert snap["gauges"][f'serving.prefill_compiles{{server="{label}"}}'] \
        == 0
    text = srv.metrics_text()
    assert "# TYPE serving_requests_completed counter" in text
    assert f'server="{label}"' in text
    sz = srv.statusz()
    assert sz["queue_depth"] == 0 and sz["server"] == label
    assert sz["snapshot"]["requests_completed"] >= 1
    assert sz["trace"]["enabled"] is True
    assert sorted(sz) == sorted(
        ["time", "pid", "server", "active_slots", "slots", "queue_depth",
         "prefill_buckets", "snapshot", "token_buckets", "flight", "trace"])
    rz = router.statusz()
    assert rz["replicas"] == {"r0": "active"}
    probe = srv.probe()
    assert sorted(probe) == sorted(
        ["time", "pid", "active", "slots", "queue_depth",
         "max_queue_depth", "predicted_queue_wait"])


def test_pool_and_store_gauges_ride_the_scrape(lm):
    from paddle_tpu_torch.lora import AdapterStore, LoraConfig, apply_lora
    from paddle_tpu_torch.serving import InferenceServer

    cfg = gpt_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3)).eval()
    apply_lora(model, LoraConfig(rank=2, alpha=4))
    store = AdapterStore(model, max_loaded=2)
    srv = InferenceServer(model, slots=1, device="cpu", adapter_store=store,
                          prefix_cache=dict(block_tokens=8,
                                            max_bytes=1 << 20), **GEO)
    label = srv._obs_label
    g = torch_obs.default_registry().snapshot()["gauges"]
    assert f'serving.prefix_cache.blocks_total{{server="{label}"}}' in g
    assert f'serving.adapter_store.max_loaded{{server="{label}"}}' in g \
        or any(k.startswith("serving.adapter_store.")
               and f'server="{label}"' in k for k in g)
    srv.shutdown(drain=False, timeout=30)


def test_shed_and_rate_limit_leave_their_events(lm, tmp_path):
    from paddle_tpu_torch.serving import (InferenceServer, Overloaded,
                                          RateLimited)

    model, cfg = lm
    tr = torch_obs.tracing
    torch_obs.flight.configure(dump_dir=str(tmp_path))
    srv = InferenceServer(model, slots=1, shed_on_overload=True,
                          tenant_rate=0.001, tenant_burst=1.0, device="cpu",
                          **GEO)
    srv.engine.free_slots = lambda: []      # nothing admits
    with srv.scheduler._lock:
        srv.scheduler._svc_ewma = 5.0
    h1 = srv.submit(_prompt(cfg, 4), max_new_tokens=2, tenant="t0")
    with pytest.raises(RateLimited):
        srv.submit(_prompt(cfg, 4), max_new_tokens=2, tenant="t0")
    with pytest.raises(Overloaded):
        srv.submit(_prompt(cfg, 4), max_new_tokens=2, deadline=1.0,
                   tenant="t1")
    kinds = [e["kind"] for e in torch_obs.flight.flight_recorder().events()]
    assert "rate_limited" in kinds
    assert tr.spans(name="shed") and tr.spans(name="rate_limited")
    assert tr.spans(corr=h1.correlation_id, name="submit")
    srv.shutdown(drain=False, timeout=30)


def test_crash_drill_dump_carries_failing_corr(lm, tmp_path):
    """A FaultPlan drop at serve.step resets the engine: the flight dump
    names the failing request in its inflight list, carries its span
    tail, and the request still completes on its retry."""
    from paddle_tpu_torch.distributed.resilience import FaultPlan
    from paddle_tpu_torch.serving import InferenceServer

    model, cfg = lm
    torch_obs.flight.configure(dump_dir=str(tmp_path))
    srv = InferenceServer(model, slots=1, max_request_retries=1,
                          device="cpu", **GEO)
    p = _prompt(cfg, 7, seed=4)
    solo = model.generate(p[None], max_new_tokens=5, **GEO)[0]
    with FaultPlan([{"site": "serve.step", "kind": "drop", "after": 1,
                     "times": 1}], seed=0):
        with pytest.warns(RuntimeWarning, match="serve loop fault"):
            h = srv.submit(p, max_new_tokens=5)
            out = h.result(timeout=300)
    np.testing.assert_array_equal(out, solo)
    assert srv.snapshot()["requests_requeued"] == 1
    path = torch_obs.flight.flight_recorder().stats()["last_dump_path"]
    with open(path) as f:
        dump = json.load(f)
    assert dump["reason"] == "engine_reset"
    assert h.correlation_id in dump["extra"]["inflight"]
    assert dump["extra"]["server"] == srv._obs_label
    assert any(s["corr"] == h.correlation_id for s in dump["spans"])
    assert "engine_reset" in [e["kind"] for e in dump["events"]]
    assert torch_obs.tracing.spans(corr=h.correlation_id,
                                   name="engine_reset")
    srv.shutdown(drain=False, timeout=30)


def test_trace_view_reads_the_ports_artifacts(lm, fleet, tmp_path):
    """tools/trace_view.py reads the port's flight dumps and span lists as
    they are and merges a request into one lane."""
    import trace_view

    model, cfg = lm
    router, _ = fleet
    h = router.submit(_prompt(cfg, 8, seed=5), max_new_tokens=3)
    h.result(timeout=300)
    rec = torch_obs.flight.FlightRecorder(dump_dir=str(tmp_path))
    dump_path = rec.dump("snapshot", corr=h.correlation_id)
    spans_path = str(tmp_path / "spans.json")
    with open(spans_path, "w") as f:
        json.dump(torch_obs.tracing.spans(corr=h.correlation_id), f)
    got, kind = trace_view.load_spans(dump_path)
    assert kind == "flight"
    rows = {e["corr"]: e for e in trace_view.list_correlations(got)}
    assert h.correlation_id in rows
    out = str(tmp_path / "merged.json")
    assert trace_view.main([dump_path, spans_path, "-o", out, "--corr",
                            h.correlation_id]) == 0
    with open(out) as f:
        merged = json.load(f)
    data = [e for e in merged["traceEvents"] if e["ph"] in ("X", "i")]
    assert {"submit", "prefill", "stream_end"} <= {e["name"] for e in data}
    assert len({e["tid"] for e in data}) == 1


def test_serve_ranges_open_under_a_capture(lm, tmp_path):
    """A Profiler capture of one served request holds the engine's
    serve:prefill and serve:decode ranges (opened on the serving worker's
    thread) with the model's ops inside them, and the host-event table
    counts them."""
    from paddle_tpu_torch.serving import InferenceServer

    model, cfg = lm
    srv = InferenceServer(model, slots=1, device="cpu", **GEO)
    srv.submit(_prompt(cfg, 6), max_new_tokens=2).result(timeout=300)
    p = torch_profiler.Profiler(trace_dir=str(tmp_path))
    p.start()
    srv.submit(_prompt(cfg, 6, seed=9), max_new_tokens=4).result(
        timeout=300)
    p.stop()
    srv.shutdown(drain=False, timeout=30)
    with open(p.last_trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    for name, calls in (("serve:prefill", 1), ("serve:decode", 3)):
        ranges = [e for e in events if e["name"] == name]
        assert len(ranges) == calls
        inside = [e for e in events if e["name"].startswith("aten::")
                  and any(r["tid"] == e["tid"] and r["ts"] <= e["ts"]
                          <= r["ts"] + r["dur"] for r in ranges)]
        assert inside, name
    rows = torch_profiler.host_event_summary()
    assert rows["serve:prefill"][0] == 1 and rows["serve:decode"][0] == 3
    assert rows["serve:admit"][0] == 1

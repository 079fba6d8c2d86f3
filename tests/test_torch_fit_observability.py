"""The fit loop's observability calls in the port (``framework/
supervisor.py``, ``hapi/model.py``, ``io/device_prefetch.py``) against
the JAX package's: the same profiler counters, ``RecordEvent`` ranges,
tracing spans and events, and flight-recorder notes and dump reasons,
byte for byte.

First by the source: every name the reference's three files pass to
``bump_counter``, ``RecordEvent``, ``record_event``, ``span``,
``_flight.note`` and ``_flight.dump`` is passed by the port's, except the
cross-replica integrity vote's (not ported: ROADMAP A8). Then by a run:
the same supervised fit (two poisoned batches, a rollback, device
prefetch) through both packages records the same counter values, range
names, span and event names, correlation-id forms and dump reasons.
"""
import os
import re
import warnings

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("framework/supervisor.py", "hapi/model.py",
         "io/device_prefetch.py")
PATTERNS = {
    "counter": r'bump_counter\(\s*"([^"]+)"',
    "range": r'RecordEvent\(\s*"([^"]+)"',
    "event": r'record_event\(\s*"([^"]+)"',
    "span": r'\bspan\(\s*"([^"]+)"',
    "note": r'_flight\.note\(\s*"([^"]+)"',
    "dump": r'_flight\.dump\(\s*"([^"]+)"',
}
# the integrity vote's names (distributed/integrity.py, ROADMAP A8)
INTEGRITY = {"train.integrity_replay", "train.integrity_evicted",
             "integrity_sync", "integrity_replay",
             "train:integrity_mismatch", "integrity_mismatch",
             "integrity_conviction"}


def _names(pkg, rel):
    with open(os.path.join(REPO, pkg, rel)) as f:
        src = f.read()
    return {kind: set(re.findall(p, src)) for kind, p in PATTERNS.items()}


@pytest.mark.parametrize("rel", FILES)
def test_call_sites_name_the_reference(rel):
    ref, port = _names("paddle_tpu", rel), _names("paddle_tpu_torch", rel)
    for kind in PATTERNS:
        want = ref[kind] - INTEGRITY
        if rel == "hapi/model.py" and kind == "range":
            # the reference's compiled-step "step" ranges wrap its jit
            # dispatch; the port's step has no dispatch to mark
            want -= {"step"}
        assert port[kind] == want, (rel, kind)


def test_correlation_ids_take_the_reference_forms():
    for rel, form in (("framework/supervisor.py",
                       'f"train-{os.getpid():x}-s{int(self.step._count)}"'),
                      ("hapi/model.py",
                       'f"fit-{os.getpid():x}-e{epoch}-b{step_i}"')):
        for pkg in ("paddle_tpu", "paddle_tpu_torch"):
            with open(os.path.join(REPO, pkg, rel)) as f:
                assert form in f.read(), (pkg, rel)


def _pkg(port):
    from importlib import import_module

    root = "paddle_tpu_torch" if port else "paddle_tpu"
    return {m: import_module(f"{root}.{m}") for m in (
        "profiler", "observability.tracing", "observability.flight")}


def _observe(port, d):
    """The rollback scenario of ``test_torch_supervisor.py`` with device
    prefetch, recording everything the fit loop emits."""
    from test_torch_supervisor import _side

    mods = _pkg(port)
    prof, tracing, flight = (mods["profiler"], mods["observability.tracing"],
                             mods["observability.flight"])
    prof.reset_counters()
    prof._recorder.clear()
    tracing.clear()
    saved_dir = flight.flight_recorder().dump_dir
    saved_on = prof._recorder.enabled
    flight.configure(dump_dir=os.path.join(d, "flight"))
    prof._recorder.enabled = True
    side = _side(port, "mlp")
    plan = side["FaultPlan"]([{"site": "train.data", "kind": "drop",
                               "times": 2, "after": 5}], seed=0)
    m = side["make"]()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            plan.install()
            try:
                m.fit(side["data"], batch_size=4, epochs=2, shuffle=False,
                      verbose=0, prefetch_depth=2,
                      recovery=side["Policy"](
                          checkpoint_dir=os.path.join(d, "ckpt"),
                          save_interval_steps=4, check_interval=4,
                          max_consecutive=2, async_save=False))
            finally:
                plan.uninstall()
        counters = {k: v for k, v in prof.counter_values().items()
                    if k.startswith("train.")}
        ranges = set(prof.host_event_summary())
        spans = tracing.spans()
        dumps = sorted(f.split("-")[0] if "-" in f else f
                       for f in os.listdir(os.path.join(d, "flight")))
    finally:
        prof._recorder.enabled = saved_on
        flight.configure(dump_dir=saved_dir)
    names = {s["name"] for s in spans}
    step_corrs = {re.sub(r"-[0-9a-f]+-", "-PID-", s["corr"] or "")
                  for s in spans if s["name"] == "train:step"}
    return dict(counters=counters,
                ranges=ranges & {"watchdog_sync", "rollback",
                                 "h2d_prefetch", "preempt_ckpt"},
                names=names & {"train:step", "train:anomaly",
                               "train:rollback"},
                corr_forms={re.sub(r"s\d+$", "sN", c) for c in step_corrs},
                dumps=dumps)


def test_supervised_fit_emits_what_the_reference_emits(tmp_path):
    ref = _observe(False, str(tmp_path / "ref"))
    port = _observe(True, str(tmp_path / "port"))
    assert port["counters"] == ref["counters"]
    assert ref["counters"]["train.anomaly"] == 2
    assert ref["counters"]["train.rollback"] == 1
    assert port["ranges"] == ref["ranges"] == {
        "watchdog_sync", "rollback", "h2d_prefetch"}
    assert port["names"] == ref["names"] == {
        "train:step", "train:anomaly", "train:rollback"}
    assert port["corr_forms"] == ref["corr_forms"] == {"train-PID-sN"}
    assert len(port["dumps"]) == len(ref["dumps"]) >= 1
    assert all("rollback" in f for f in port["dumps"])

"""The port's autoscaler (``paddle_tpu_torch.serving.autoscaler``) against
the JAX package's: twins of the autoscaler half of
``tests/test_slo_control_loop.py`` and of the per-pool autoscaling tests
of ``tests/test_disagg.py``.

Every case runs twice, once per package (``pkg``), on the same stub
replicas, burn reports and injected clock, and asserts the reference
test's decisions for both; the decision records of the two packages are
also compared key by key where both are driven the same way. Last, a real
scale-out through the port's ``ProcessReplicaSpawner``: a fresh child
interpreter hosts a ``gpt_tiny`` replica over rpc and serves a request
equal to the local model's greedy stream.
"""
import json
import os
import sys
import textwrap
import types
from importlib import import_module

import numpy as np
import pytest
import torch

from test_slo_control_loop import _StubServer, _burning, _quiet

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, os.path.join(REPO, "tools"))


def _ns(pkg):
    root = "paddle_tpu_torch" if pkg == "torch" else "paddle_tpu"
    serving = import_module(root + ".serving")
    return types.SimpleNamespace(
        Autoscaler=serving.Autoscaler, ReplicaRouter=serving.ReplicaRouter,
        flight=import_module(root + ".observability.flight"))


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    ns = _ns(request.param)
    saved = ns.flight.flight_recorder().dump_dir
    yield ns
    ns.flight.configure(dump_dir=saved)


def _fleet(pkg, n=1, spawn_log=None, **kw):
    router = pkg.ReplicaRouter([_StubServer() for _ in range(n)])
    clock = [0.0]

    def spawn(name):
        if spawn_log is not None:
            spawn_log.append(name)
        return _StubServer()

    kw.setdefault("sustain_ticks", 2)
    kw.setdefault("cooldown_s", 60.0)
    auto = pkg.Autoscaler(router, spawn, clock=lambda: clock[0], **kw)
    return router, auto, clock


def _decision(d):
    return None if d is None else {k: v for k, v in d.items()
                                   if k not in ("corr", "t", "spawn_s")}


def test_decisions_match_the_reference():
    """One scripted trace (burn, spike, quiet, cooldown) through both
    packages' autoscalers: the same decision at every tick."""
    trace = [_burning(), _burning(), _quiet(), _burning(), _quiet(),
             _quiet(), _quiet(), _burning(), _burning(), _burning()]
    times = [0, 1, 2, 3, 100, 101, 102, 103, 200, 201]
    got = {}
    for name in ("jax", "torch"):
        ns = _ns(name)
        router, auto, clock = _fleet(ns, max_replicas=3, scale_in_load=0.5)
        reports = list(trace)
        router.slo_report = lambda: reports.pop(0)
        out = []
        for t in times:
            clock[0] = float(t)
            out.append(_decision(auto.tick()))
        got[name] = (out, auto.scale_outs, auto.scale_ins,
                     sorted(router.replicas().values()))
    assert got["torch"] == got["jax"]
    assert [d["action"] for d in got["jax"][0] if d] == [
        "scale_out", "scale_in", "scale_out"]


def test_scale_out_is_edge_triggered_on_sustained_burn(pkg):
    spawned = []
    router, auto, clock = _fleet(pkg, 1, spawn_log=spawned, max_replicas=3)
    router.slo_report = _burning
    assert auto.tick() is None          # 1 hot tick: sustaining, no act
    d = auto.tick()
    assert d["action"] == "scale_out" and d["tenant"] == "spike"
    assert d["burn_slow"] == pytest.approx(5.0)
    assert spawned == ["auto-1"]
    assert router.replicas()["auto-1"] == "active"
    assert auto.scale_outs == 1


def test_one_window_spike_does_not_scale(pkg):
    router, auto, clock = _fleet(pkg, 1, max_replicas=3)
    reports = [_burning(), _quiet(), _burning(), _quiet()]
    router.slo_report = lambda: reports.pop(0)
    for _ in range(4):
        assert auto.tick() is None
    assert auto.scale_outs == 0


def test_cooldown_suppresses_flap(pkg):
    router, auto, clock = _fleet(pkg, 1, max_replicas=4, cooldown_s=60.0)
    router.slo_report = _burning
    auto.tick()
    assert auto.tick()["action"] == "scale_out"
    clock[0] = 59.0
    for _ in range(5):
        assert auto.tick() is None
    assert auto.scale_outs == 1
    clock[0] = 121.0
    assert auto.tick()["action"] == "scale_out"
    assert auto.scale_outs == 2


def test_max_replicas_bounds_scale_out(pkg):
    router, auto, clock = _fleet(pkg, 2, max_replicas=2)
    router.slo_report = _burning
    for _ in range(6):
        assert auto.tick() is None
    assert auto.scale_outs == 0


def test_scale_in_drains_never_kills(pkg):
    router, auto, clock = _fleet(pkg, 1, max_replicas=2, scale_in_load=0.5)
    router.slo_report = _burning
    auto.tick()
    auto.tick()
    grown = router._replicas["auto-1"].server
    router.slo_report = _quiet
    clock[0] = 100.0
    assert auto.tick() is None          # sustained headroom required
    d = auto.tick()
    assert d["action"] == "scale_in" and d["replica"] == "auto-1"
    assert grown.shutdowns == [True]    # drained, never killed
    assert router.replicas()["auto-1"] == "dead"
    assert auto.scale_ins == 1


def test_min_replicas_bounds_scale_in(pkg):
    router, auto, clock = _fleet(pkg, 1, min_replicas=1, max_replicas=2,
                                 scale_in_load=0.5)
    router.slo_report = _quiet
    for _ in range(6):
        assert auto.tick() is None
    assert auto.scale_ins == 0


def test_spawn_failure_is_counted_not_fatal(pkg):
    router = pkg.ReplicaRouter([_StubServer()])

    def bad_spawn(name):
        raise RuntimeError("boom")

    auto = pkg.Autoscaler(router, bad_spawn, sustain_ticks=1,
                          cooldown_s=0.0, max_replicas=2, clock=lambda: 0.0)
    router.slo_report = _burning
    d = auto.tick()
    assert d["action"] == "scale_out_failed" and "boom" in d["error"]
    assert auto.spawn_failures == 1 and auto.scale_outs == 0
    assert len(router.replicas()) == 1


def test_statusz_autoscaler_block_and_token_buckets(pkg):
    router = pkg.ReplicaRouter(
        [_StubServer(buckets={"abuser": {"tokens": 0.5, "rate": 1.0,
                                         "burst": 2.0}})])
    auto = pkg.Autoscaler(router, lambda name: _StubServer(),
                          sustain_ticks=1, cooldown_s=60.0, max_replicas=2,
                          clock=lambda: 0.0)
    router.slo_report = _burning
    auto.tick()
    block = router.statusz()["autoscaler"]
    assert block["state"] == "manual"       # no interval -> no thread
    assert block["scale_outs"] == 1
    assert block["last_decision"]["tenant"] == "spike"
    assert block["cooldown_remaining_s"] == pytest.approx(60.0)
    assert block["config"]["max_replicas"] == 2
    name = next(iter(router.replicas()))
    assert block["token_buckets"][name]["abuser"]["tokens"] == 0.5


def test_statusz_has_no_autoscaler_block_by_default(pkg):
    assert "autoscaler" not in pkg.ReplicaRouter([_StubServer()]).statusz()


def test_router_shutdown_stops_autoscaler_thread(pkg):
    router = pkg.ReplicaRouter([_StubServer()])
    auto = pkg.Autoscaler(router, lambda name: _StubServer(), interval=30.0)
    auto.start()
    assert auto._thread is not None and auto._thread.is_alive()
    router.shutdown()
    assert not auto._thread.is_alive()


def test_scale_out_dump_lists_in_trace_view(pkg, tmp_path):
    pkg.flight.configure(dump_dir=str(tmp_path))
    router, auto, clock = _fleet(pkg, 1, max_replicas=2, sustain_ticks=1)
    router.slo_report = _burning
    d = auto.tick()
    assert d["action"] == "scale_out" and d["corr"].startswith("scale-")
    dumps = [f for f in os.listdir(tmp_path) if "scale_out" in f]
    assert dumps
    from trace_view import list_correlations, load_spans

    spans, _ = load_spans(os.path.join(str(tmp_path), dumps[0]))
    assert d["corr"] in {e["corr"] for e in list_correlations(spans)}
    ev = [s for s in spans if s["name"] == "event:scale_out"
          and s["corr"] == d["corr"]]
    assert ev and ev[0]["tags"]["tenant"] == "spike"
    with open(os.path.join(str(tmp_path), dumps[0])) as f:
        extra = json.load(f)["extra"]
    assert extra["tenant"] == "spike"
    assert extra["burn_slow"] == pytest.approx(5.0)


# -------------------------------------------------- per-pool autoscaling
def _signal_report(**burns):
    ten = {"burn_slow": 0.0, "burn_fast": 0.0,
           "burn_slow_ttft": 0.0, "burn_fast_ttft": 0.0,
           "burn_slow_itl": 0.0, "burn_fast_itl": 0.0,
           "slow_breached": False, "fast_breached": False,
           "alerting": False, "window_slow": {"total": 10},
           "window_fast": {"total": 10}}
    ten.update(burns)
    return {"policy": {"slow_burn_threshold": 2.0},
            "tenants": {"spike": ten}}


def _auto_fleet(pkg, **kw):
    router = pkg.ReplicaRouter([_StubServer()])
    auto = pkg.Autoscaler(router, lambda name: _StubServer(),
                          sustain_ticks=1, cooldown_s=0.0, max_replicas=3,
                          clock=lambda: 0.0, **kw)
    return router, auto


def test_autoscaler_scales_decode_pool_on_itl_burn_only(pkg):
    router, auto = _auto_fleet(pkg, burn_signal="itl")
    router.slo_report = lambda: _signal_report(burn_slow_itl=5.0,
                                               burn_fast_itl=6.0)
    d = auto.tick()
    assert d["action"] == "scale_out"
    assert d["signal"] == "itl" and d["burn_slow"] == pytest.approx(5.0)
    for kw in ({"burn_signal": "ttft"}, {}):
        router2, auto2 = _auto_fleet(pkg, **kw)
        router2.slo_report = lambda: _signal_report(burn_slow_itl=5.0,
                                                    burn_fast_itl=6.0)
        assert auto2.tick() is None


def test_autoscaler_rejects_unknown_burn_signal(pkg):
    router = pkg.ReplicaRouter([_StubServer()])
    with pytest.raises(ValueError, match="burn_signal"):
        pkg.Autoscaler(router, lambda name: _StubServer(),
                       burn_signal="goodput")
    assert "autoscaler" not in router.statusz()


def test_autoscaler_statusz_names_its_signal(pkg):
    router, auto = _auto_fleet(pkg, burn_signal="ttft")
    router.slo_report = _signal_report
    auto.tick()
    assert router.statusz()["autoscaler"]["config"]["burn_signal"] == "ttft"


# ------------------------------------------- a real spawned replica (port)
CHILD = textwrap.dedent("""
    import sys
    import torch
    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.serving import InferenceServer, remote

    rpc.init_rpc("auto-child", rank=1, world_size=2,
                 master_endpoint=sys.argv[2])
    blob = torch.load(sys.argv[1], weights_only=False)
    model = GPTForCausalLM(blob["cfg"], device="cpu")
    model.load_state_dict(blob["state"])
    model.eval()
    srv = InferenceServer(model, slots=2, device="cpu", max_length=64,
                          prefill_buckets=(32,))
    remote.host_server(srv, "default")
    remote.wait_for_stop()
    srv.shutdown(drain=True, timeout=30)
    rpc.shutdown(timeout=10.0)
""")


def _store():
    """The rpc store, bound by this process before anyone is told its
    port: a probed free port, closed and handed on, can be taken by
    another test process before ``init_rpc`` binds it, and rank 0 then
    takes the squatter for an external store and its rendezvous fails.
    Rank 0's ``init_rpc`` finds this port in use and joins the store."""
    from paddle_tpu_torch.distributed.launch.kv_server import KVServer

    kv = KVServer(0).start()
    return kv, f"127.0.0.1:{kv.port}"


def test_process_replica_spawner_scales_out_a_fresh_interpreter(tmp_path):
    """Scale-out through ``ProcessReplicaSpawner``: the child is a fresh
    interpreter (``subprocess``), the parent's rpc starts on first use,
    the replica joins the router and serves the local model's greedy
    stream; scale-in drains it."""
    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.serving import (Autoscaler, ProcessReplicaSpawner,
                                          ReplicaRouter)
    from paddle_tpu_torch.serving import remote

    cfg = gpt_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                   num_layers=1)
    model = GPTForCausalLM(cfg, device="cpu").eval()
    weights = tmp_path / "w.pt"
    torch.save({"cfg": cfg, "state": model.state_dict()}, weights)
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    kv, ep = _store()
    spawner = ProcessReplicaSpawner(
        [sys.executable, str(script), str(weights), ep], "auto-child",
        init=lambda: rpc.init_rpc("parent", rank=0, world_size=2,
                                  master_endpoint=ep),
        ready_timeout=120.0, env=dict(os.environ, PYTHONPATH=REPO))
    router = ReplicaRouter([_StubServer()])
    auto = Autoscaler(router, spawner, sustain_ticks=1, cooldown_s=0.0,
                      max_replicas=2, scale_in_load=10.0,
                      clock=lambda: 0.0)
    try:
        router.slo_report = _burning
        d = auto.tick()
        assert d["action"] == "scale_out", d
        assert router.replicas()[d["replica"]] == "active"
        replica = router._replicas[d["replica"]].server
        prompt = np.random.default_rng(0).integers(0, 1024, 12)
        got = list(replica.submit(prompt=prompt, max_new_tokens=6)
                   .result(timeout=60))
        want = model.generate(torch.as_tensor(prompt)[None],
                              max_new_tokens=6)[0, -6:].tolist()
        assert got == want
        router.slo_report = _quiet
        d = auto.tick()
        assert d["action"] == "scale_in" and d["replica"] == "auto-1"
        assert router.replicas()["auto-1"] == "dead"
    finally:
        for proc in spawner.procs:
            if proc.poll() is None:
                try:
                    rpc.rpc_sync("auto-child", remote._host_request_stop,
                                 timeout=10)
                except Exception:
                    pass
                try:
                    proc.wait(timeout=60)
                except Exception:
                    proc.kill()
                    proc.wait(timeout=30)
        rpc.shutdown(timeout=4.0)
        kv.stop()

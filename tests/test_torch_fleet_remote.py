"""The port's rpc and remote replicas (``paddle_tpu_torch.distributed.rpc``,
``paddle_tpu_torch.serving.remote``) against the JAX package's.

Both are framework-free copies. The rpc agent runs its two-process
cluster script in each package; the remote-replica tests run over real
rpc sockets in each package (``rw`` is parametrized over a world per
package: the port's is the module's two-process world, the reference's a
world of one) with stub servers built on the package's own request
handles. Last, the port's own fleet across processes: a child process
hosts a ``gpt_tiny`` replica of the port, the router serves through it
and a local replica, the child is SIGKILLed mid-stream, and every stream
still equals the JAX router's greedy stream.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEO = dict(max_length=64, prefill_buckets=(32,))


@pytest.fixture(autouse=True)
def _restore_flight_dirs():
    from paddle_tpu.observability import flight as jax_flight
    from paddle_tpu_torch.observability import flight

    saved = [(f, f.flight_recorder().dump_dir) for f in (jax_flight, flight)]
    yield
    for f, d in saved:
        f.configure(dump_dir=d)


def _endpoint() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


# ------------------------------------------------------------ rpc agent
WORKER = textwrap.dedent("""
    import sys
    from {pkg}.distributed import rpc

    def add(a, b):
        return a + b

    def whoami():
        return rpc.get_current_worker_info().name

    def boom():
        raise ValueError("rpc boom")

    rank = int(sys.argv[1])
    rpc.init_rpc(name=f"worker{{rank}}", rank=rank, world_size=2,
                 master_endpoint=sys.argv[2])
    infos = rpc.get_all_worker_infos()
    assert [w.name for w in infos] == ["worker0", "worker1"], infos
    if rank == 0:
        assert rpc.rpc_sync("worker1", add, args=(2, 3)) == 5
        assert rpc.rpc_async("worker1", add, args=(10, 30)).wait() == 40
        assert rpc.rpc_sync("worker1", whoami) == "worker1"
        assert rpc.rpc_sync("worker0", whoami) == "worker0"
        try:
            rpc.rpc_sync("worker1", boom)
            raise SystemExit("expected remote ValueError")
        except ValueError as e:
            assert "rpc boom" in str(e)
        print("RPC_OK", flush=True)
    rpc.shutdown()
""")


def test_rpc_two_process_cluster_port(tmp_path):
    """The reference's two-process agent script, run on the port's rpc
    (which imports no jax: the workers never load it)."""
    script = tmp_path / "w.py"
    script.write_text(WORKER.format(pkg="paddle_tpu_torch"))
    ep = _endpoint()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), ep],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    assert "RPC_OK" in outs[0]


def test_rpc_requires_init():
    from paddle_tpu_torch.distributed import rpc

    with pytest.raises(RuntimeError, match="init_rpc"):
        rpc.rpc_sync("nobody", print)


@pytest.mark.parametrize("master,advertised", [
    ("127.0.0.1:29500", "127.0.0.1"), ("localhost:29500", "127.0.0.1"),
    ("[::1]:29500", "127.0.0.1"), ("10.0.0.7:29500", None),
    ("trainer-0:29500", None)])
def test_rpc_unresolvable_host_name_uses_loopback_only_for_a_loopback_master(
        monkeypatch, master, advertised):
    """A host whose own name does not resolve advertises 127.0.0.1 when
    the master is on loopback; otherwise ``init_rpc`` raises before it
    binds a port, since peers on other hosts could not reach it."""
    from paddle_tpu_torch.distributed.rpc import rpc as rpc_mod

    def unresolvable(name):
        raise socket.gaierror(-2, "Name or service not known")

    monkeypatch.setattr(rpc_mod.socket, "gethostbyname", unresolvable)
    if advertised is not None:
        assert rpc_mod._advertised_ip(master) == advertised
        return
    monkeypatch.setattr(rpc_mod, "KVServer", None)   # must not be reached
    with pytest.raises(OSError, match="does not resolve"):
        rpc_mod.init_rpc("w", rank=0, world_size=1, master_endpoint=master)
    assert rpc_mod._state.get("kv_server") is None


# ------------------------------------------------ the two-process world
CHILD = textwrap.dedent("""
    import sys
    import torch
    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.distributed.resilience import FaultPlan
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.serving import InferenceServer, remote

    rpc.init_rpc("child", rank=1, world_size=2, master_endpoint=sys.argv[2])
    blob = torch.load(sys.argv[1], weights_only=False)
    model = GPTForCausalLM(blob["cfg"], device="cpu")
    model.load_state_dict(blob["state"])
    model.eval()
    # a slow decode step, so that a kill lands mid-stream
    FaultPlan([{"site": "serve.step", "kind": "delay", "delay": 0.05,
                "times": None}], seed=0).install(env=False)
    srv = InferenceServer(model, slots=2, device="cpu", max_length=64,
                          prefill_buckets=(32,))
    remote.host_server(srv, "default")
    print("CHILD_READY", flush=True)
    remote.wait_for_stop()
    srv.shutdown(drain=False, timeout=30)
    rpc.shutdown(timeout=10.0)
""")


@pytest.fixture(scope="module")
def pair():
    import paddle_tpu as pt
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from paddle_tpu_torch.convert import gpt_from_jax
    from paddle_tpu_torch.models.gpt import gpt_tiny

    pt.seed(7)
    kw = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    jm = JaxGPT(jax_gpt_tiny(use_flash_attention=False, **kw))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, gpt_from_jax(state, gpt_tiny(**kw), device="cpu")


@pytest.fixture(scope="module")
def world(pair, tmp_path_factory):
    """The port's rpc world of two: this process ("parent") and a child
    process hosting a gpt_tiny replica of the port ("child")."""
    from paddle_tpu_torch.distributed import rpc

    _, tm = pair
    tmp = tmp_path_factory.mktemp("fleet_child")
    weights = tmp / "weights.pt"
    torch.save({"cfg": tm.cfg, "state": tm.state_dict()}, weights)
    script = tmp / "child.py"
    script.write_text(CHILD)
    ep = _endpoint()
    proc = subprocess.Popen(
        [sys.executable, str(script), str(weights), ep],
        env=dict(os.environ, PYTHONPATH=REPO,
                 PT_FLIGHT_DIR=str(tmp / "child_flight")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    rpc.init_rpc("parent", rank=0, world_size=2, master_endpoint=ep)
    yield types.SimpleNamespace(rpc=rpc, child=proc, name="parent")
    if proc.poll() is None:
        from paddle_tpu_torch.serving import remote

        try:
            rpc.rpc_sync("child", remote._host_request_stop, timeout=10)
        except Exception:
            pass
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    rpc.shutdown(timeout=4.0)
    proc.stdout.close()


@pytest.fixture(scope="module")
def jax_world():
    from paddle_tpu.distributed import rpc

    rpc.init_rpc(name="solo", rank=0, world_size=1,
                 master_endpoint=_endpoint())
    yield types.SimpleNamespace(rpc=rpc, name="solo")
    rpc.shutdown(timeout=10.0)


def _pkg(name):
    from importlib import import_module

    root = "paddle_tpu_torch" if name == "torch" else "paddle_tpu"
    return types.SimpleNamespace(
        serving=import_module(root + ".serving"),
        remote=import_module(root + ".serving.remote"),
        server=import_module(root + ".serving.server"),
        resilience=import_module(root + ".distributed.resilience"),
        flight=import_module(root + ".observability.flight"),
        rpc=import_module(root + ".distributed.rpc"))


@pytest.fixture(params=["jax", "torch"])
def rw(request):
    """One package's rpc world and modules: the worker name to address
    this process by, its serving, remote, resilience and flight."""
    w = request.getfixturevalue("world" if request.param == "torch"
                                else "jax_world")
    ns = _pkg(request.param)
    ns.me = w.name
    return ns


class _Engine:
    pool = None
    store = None

    def __init__(self):
        self.active_count = 0
        self.slots = 2


class _Sched:
    def __init__(self):
        self.depth = 0
        self.max_queue_depth = 8


class _FakeServer:
    """Duck-typed server on the package's real RequestHandles."""

    def __init__(self, ns, tokens=(1, 2, 3), delay=0.005,
                 submit_error=None):
        self.ns = ns
        self.engine = _Engine()
        self.scheduler = _Sched()
        self.tokens = list(tokens)
        self.delay = delay
        self.submit_error = submit_error
        self.submitted = []

    def start(self):
        return self

    def submit(self, **kw):
        if self.submit_error is not None:
            raise self.submit_error
        self.submitted.append(kw)
        req = self.ns.serving.Request(prompt=kw["prompt"],
                                      corr_id=kw.get("correlation_id"))
        h = self.ns.server.RequestHandle(req)
        req.handle = h

        def run():
            for t in self.tokens:
                time.sleep(self.delay)
                h._push(t)
            h.ttft_s = self.delay
            h._finish()

        threading.Thread(target=run, daemon=True).start()
        return h

    def probe(self):
        return {"active": self.engine.active_count,
                "slots": self.engine.slots,
                "queue_depth": self.scheduler.depth,
                "max_queue_depth": self.scheduler.max_queue_depth,
                "time": time.time()}

    def snapshot(self):
        return {"requests_completed": len(self.submitted)}

    def statusz(self):
        return {"server": "fake"}

    def shutdown(self, drain=True, timeout=None):
        pass


_hosted = iter(range(10 ** 6))


def _host(rw, srv):
    name = f"fake{next(_hosted)}"
    rw.remote.host_server(srv, name)
    return name


def _remote(rw, hosted, **kw):
    kw.setdefault("rpc_timeout", 5.0)
    kw.setdefault("connect_deadline", 0.4)
    kw.setdefault("poll_interval", 0.01)
    return rw.serving.RemoteReplica(rw.me, hosted_name=hosted, **kw)


def test_rpc_transport_error_names_peer(rw):
    plan = rw.resilience.FaultPlan(
        [{"site": f"rpc.connect.{rw.me}", "kind": "partition",
          "times": None}], seed=0)
    with plan:
        with pytest.raises(rw.rpc.RpcTransportError) as ei:
            rw.rpc.rpc_sync(rw.me, int, args=(1,), connect_deadline=0.2)
    assert ei.value.peer == rw.me and isinstance(ei.value, ConnectionError)
    assert rw.rpc.rpc_sync(rw.me, int, args=(1,)) == 1


def test_remote_replica_round_trip_and_probe_view(rw):
    srv = _FakeServer(rw, tokens=(11, 12, 13))
    srv.engine.active_count = 1
    srv.scheduler.depth = 3
    rep = _remote(rw, _host(rw, srv))
    router = rw.serving.ReplicaRouter()
    router.add_replica(rep, "remote")
    h = router.submit(np.arange(4), max_new_tokens=3)
    assert list(h.result(timeout=30)) == [11, 12, 13]
    assert rep.engine.active_count == 1 and rep.scheduler.depth == 3
    assert rep.snapshot()["requests_completed"] == 1
    assert srv.submitted[0]["correlation_id"] == h.correlation_id
    assert rep.statusz()["remote_client"]["peer"] == rw.me
    assert rep.clock_offset_s is not None


def test_remote_queuefull_crosses_wire_and_fails_over(rw):
    full = _host(rw, _FakeServer(
        rw, submit_error=rw.serving.QueueFull("depth")))
    router = rw.serving.ReplicaRouter()
    router.add_replica(_remote(rw, full), "remote")
    router.add_replica(_FakeServer(rw, tokens=(5,)), "local")
    h = router.submit(np.arange(4), max_new_tokens=1, prefer="remote")
    assert h.replica == "local"
    assert router.replicas()["remote"] == "active"


def test_remote_partition_death_abandons_and_reroutes(rw, tmp_path):
    rw.flight.configure(dump_dir=str(tmp_path))
    rep = _remote(rw, _host(rw, _FakeServer(rw, tokens=(1, 2, 3),
                                            delay=0.3)), rpc_timeout=1.5)
    router = rw.serving.ReplicaRouter(suspect_misses=1, dead_misses=2)
    router.add_replica(rep, "remote")
    router.add_replica(_FakeServer(rw, tokens=(1, 2, 3)), "local")
    h = router.submit(np.arange(4), max_new_tokens=3, prefer="remote")
    plan = rw.resilience.FaultPlan(
        [{"site": f"rpc.connect.{rw.me}", "kind": "partition",
          "times": None}], seed=0)
    with plan:
        router.check_health()
        assert router.replicas()["remote"] == "suspect"
        router.check_health()
        assert router.replicas()["remote"] == "dead"
        out = h.result(timeout=30)
    assert list(out) == [1, 2, 3]
    assert h.replica == "local" and h.reroutes >= 1
    path = rw.flight.flight_recorder().last_dump_path
    assert path is not None and "replica_dead" in path
    with open(path) as f:
        assert h.correlation_id in json.load(f)["extra"]["inflight"]


def test_remote_submit_to_unreachable_raises_not_fatal(rw):
    hosted = _host(rw, _FakeServer(rw, tokens=(6,)))
    router = rw.serving.ReplicaRouter()
    router.add_replica(_remote(rw, hosted), "good")
    dead = rw.serving.RemoteReplica(rw.me, hosted_name=hosted,
                                    rpc_timeout=1.0, connect_deadline=0.2,
                                    poll_interval=0.01)
    with rw.resilience.FaultPlan(
            [{"site": f"rpc.connect.{rw.me}", "kind": "partition",
              "times": None}], seed=0):
        with pytest.raises(rw.serving.ReplicaUnreachable):
            dead.submit(prompt=np.arange(4), max_new_tokens=1)
    assert list(router.submit(np.arange(4), max_new_tokens=1).result(
        timeout=30)) == [6]


def test_remote_metrics_and_trace_export(rw):
    from paddle_tpu_torch.observability import fleet as _fleet

    rep = _remote(rw, _host(rw, _FakeServer(rw)))
    snap = rep.metrics_snapshot()
    assert {"counters", "gauges", "histograms", "host", "pid", "time",
            "serving_snapshot"} <= set(snap)
    assert snap["pid"] == os.getpid()
    out = rep.trace_export(tail=5)
    assert len(out["spans"]) <= 5 and "offset_s" in out
    assert _fleet.estimate_clock_offset(0.0, 0.02, 0.01) == 0.0


def test_remote_replica_clock_ewma_without_rpc(rw):
    rep = rw.serving.RemoteReplica("peer-x")
    assert rep.clock_offset_s is None
    rep._note_clock(10.0, 10.02, 10.07)
    assert rep.clock_offset_s == pytest.approx(0.06)
    rep._note_clock(20.0, 20.02, 20.11)
    assert rep.clock_offset_s == pytest.approx(0.8 * 0.06 + 0.2 * 0.10)
    assert rep.clock_stats()["clock_samples"] == 2
    rep._note_clock(30.0, 30.02, None)
    assert rep.clock_stats()["clock_samples"] == 2


def test_host_surface_is_module_level_and_retires_handles(rw):
    """The _host_* functions pickle by reference (module-level), and a
    finished request stays pollable for the grace TTL."""
    import pickle

    for fn in (rw.remote._host_submit, rw.remote._host_poll,
               rw.remote._host_probe, rw.remote._host_metrics,
               rw.remote._host_trace_export, rw.remote._host_shutdown):
        assert pickle.loads(pickle.dumps(fn)) is fn
    hosted = _host(rw, _FakeServer(rw, tokens=(4, 5)))
    rid = rw.remote._host_submit(hosted, {"prompt": np.arange(3),
                                          "max_new_tokens": 2})
    deadline = time.monotonic() + 10
    while True:
        out = rw.remote._host_poll(rid, 0)
        if out["done"] or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    assert out["tokens"] == [4, 5] and out["error"] is None
    assert rw.remote._host_poll(rid, 2)["tokens"] == []
    with pytest.raises(KeyError):
        rw.remote._host_poll("nope-0", 0)


# ------------------------------------------- the port across processes
def _jax_router_streams(jm, prompts, n):
    import paddle_tpu.serving as jax_serving

    router = jax_serving.ReplicaRouter()
    for name in "ab":
        srv = jax_serving.InferenceServer(jm, slots=2, **GEO)
        srv.engine.warmup()
        router.add_replica(srv, name)
    try:
        hs = [router.submit(p, max_new_tokens=n) for p in prompts]
        return [h.result(timeout=300) for h in hs]
    finally:
        router.shutdown(drain=False, timeout=60)


def test_remote_gpt_replica_serves_jax_router_streams(pair, world):
    """Greedy streams through the port's router over a local replica and
    the child's remote one equal the JAX router's, and the fleet scrape
    and trace carry both processes."""
    from paddle_tpu_torch.serving import (InferenceServer, RemoteReplica,
                                          ReplicaRouter)

    jm, tm = pair
    prompts = [np.random.default_rng(s).integers(0, 1024, 6 + 3 * s)
               .astype(np.int32) for s in range(4)]
    want = _jax_router_streams(jm, prompts, 6)
    rem = RemoteReplica("child", rpc_timeout=30.0, poll_interval=0.01)
    assert rem.wait_ready(timeout=120)
    local = InferenceServer(tm, slots=2, device="cpu", **GEO)
    router = ReplicaRouter()
    router.add_replica(local, "local")
    router.add_replica(rem, "child")
    try:
        hs = [router.submit(p, max_new_tokens=6,
                            prefer=("local", "child")[i % 2])
              for i, p in enumerate(prompts)]
        outs = [h.result(timeout=300) for h in hs]
        assert {h.replica for h in hs} == {"local", "child"}
        for a, b in zip(want, outs):
            np.testing.assert_array_equal(b, a)
        text = router.fleet_metrics_text()
        assert 'replica="child"' in text and 'replica="_local"' in text
        remote_h = next(h for h in hs if h.replica == "child")
        spans, reports = router.collect_fleet_trace(
            corr=remote_h.correlation_id)
        names = {(s.get("src"), s["name"]) for s in spans}
        assert {(None, "router:submit"), ("child", "submit"),
                ("child", "queue_wait"), ("child", "prefill"),
                ("child", "decode"), ("child", "stream_end")} <= names
        assert [s["t0"] for s in spans] == sorted(s["t0"] for s in spans)
        assert any(r["replica"] == "child" and not r["clamped"]
                   for r in reports)
        assert router.fleet_statusz()["scrape"]["replicas"]["child"][
            "stale"] is False
    finally:
        # not router.shutdown(): that would stop the child's hosted
        # server, which the next test serves through
        local.shutdown(drain=False, timeout=60)


def test_killed_remote_replica_reroutes_token_identical(pair, world,
                                                        tmp_path):
    """LAST (kills the child): SIGKILL the child mid-stream; the
    detector declares it dead, its in-flight streams reroute to the local
    replica and equal the JAX router's greedy streams, and a replica_dead
    flight dump names them."""
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.serving import (InferenceServer, RemoteReplica,
                                          ReplicaRouter)

    jm, tm = pair
    flight.configure(dump_dir=str(tmp_path))
    prompts = [np.random.default_rng(100 + s).integers(0, 1024, 9 + 2 * s)
               .astype(np.int32) for s in range(4)]
    want = _jax_router_streams(jm, prompts, 16)
    rem = RemoteReplica("child", rpc_timeout=5.0, connect_deadline=0.5,
                        poll_interval=0.01)
    assert rem.wait_ready(timeout=120)
    router = ReplicaRouter(health_check_interval=0.1)
    router.add_replica(InferenceServer(tm, slots=2, device="cpu", **GEO),
                       "local")
    router.add_replica(rem, "child")
    try:
        hs = [router.submit(p, max_new_tokens=16,
                            prefer=("child", "local")[i % 2])
              for i, p in enumerate(prompts)]
        on_child = [h for h in hs if h.replica == "child"]
        assert on_child
        deadline = time.monotonic() + 60
        while (not all(len(h.tokens()) >= 2 for h in on_child)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        world.child.send_signal(signal.SIGKILL)
        outs = [h.result(timeout=300) for h in hs]
        for a, b in zip(want, outs):
            np.testing.assert_array_equal(b, a)
        assert router.replicas()["child"] == "dead"
        assert all(h.reroutes >= 1 and h.replica == "local"
                   for h in on_child)
        dumps = [f for f in os.listdir(tmp_path) if "replica_dead" in f]
        assert dumps
        with open(tmp_path / dumps[-1]) as f:
            inflight = set(json.load(f)["extra"]["inflight"])
        assert {h.correlation_id for h in on_child} <= inflight
        assert router.snapshot()["replicas_failed"] == 1
    finally:
        router.shutdown(drain=False, timeout=60)
        world.child.wait(timeout=60)

"""The port's serving fleet (``paddle_tpu_torch.serving.router``) against
the JAX package's.

The router is a framework-free copy, so its placement, backpressure,
membership, failure detector and hedging run on device-free stub replicas
through BOTH packages (``sv`` is parametrized over them) and must behave
alike. Model-backed: greedy streams through the port's two-replica router
over ``gpt_tiny`` (and ``llama_tiny``) equal those through the JAX
router over the same converted weights; a prefix hit equals a cold solo
``generate()``; a replica killed mid-stream reroutes token-identical.
"""
import threading
import time
import types

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.serving as jax_serving
import paddle_tpu_torch.serving as torch_serving
from paddle_tpu.distributed.resilience import FaultPlan as JaxFaultPlan
from paddle_tpu.observability import flight as jax_flight
from paddle_tpu_torch.convert import gpt_from_jax, llama_from_jax
from paddle_tpu_torch.distributed.resilience import FaultPlan, RetryPolicy
from paddle_tpu_torch.observability import flight as torch_flight

GEO = dict(max_length=64, prefill_buckets=(32,))
POOL = dict(block_tokens=8, max_bytes=1 << 20)


def _ns(serving, flight, fault_plan):
    from importlib import import_module

    return types.SimpleNamespace(
        serving=serving, flight=flight, FaultPlan=fault_plan,
        Request=serving.Request,
        RequestHandle=import_module(serving.__name__ + ".server")
        .RequestHandle)


NS = {"jax": lambda: _ns(jax_serving, jax_flight, JaxFaultPlan),
      "torch": lambda: _ns(torch_serving, torch_flight, FaultPlan)}


@pytest.fixture(params=sorted(NS))
def sv(request):
    return NS[request.param]()


@pytest.fixture(autouse=True)
def _restore_flight_dirs(tmp_path):
    saved = [(f, f.flight_recorder().dump_dir)
             for f in (jax_flight, torch_flight)]
    for f, _ in saved:
        f.configure(dump_dir=str(tmp_path / "flight"))
    yield
    for f, d in saved:
        f.configure(dump_dir=d)


# ------------------------------------------------------- stub replicas
class _StubPool:
    block_tokens = 4

    def __init__(self, matched=0):
        self.matched = matched

    def match(self, prompt):
        return min(self.matched, len(prompt))

    def match_digests(self, digests):
        return min(self.matched, len(digests) * self.block_tokens)


class _StubEngine:
    def __init__(self, active, slots, pool):
        self.active_count = active
        self.slots = slots
        self.pool = pool
        self.store = None


class _StubScheduler:
    def __init__(self, depth, cap):
        self.depth = depth
        self.max_queue_depth = cap


class _StubHandle:
    def __init__(self, outcome):
        self.outcome = outcome
        self.cache_hit_tokens = 0
        self.ttft_s = 0.001

    def result(self, timeout=None):
        if isinstance(self.outcome, BaseException):
            raise self.outcome
        return self.outcome

    def stream(self):
        for t in self.result():
            yield int(t)


class _StubServer:
    """Live load fields + submit()/start()/shutdown() (the router's duck
    type)."""

    def __init__(self, active=0, depth=0, slots=4, cap=8, matched=0,
                 submit_error=None, outcomes=None):
        self.engine = _StubEngine(active, slots, _StubPool(matched))
        self.scheduler = _StubScheduler(depth, cap)
        self.submit_error = submit_error
        self.outcomes = list(outcomes or [])
        self.submitted = []
        self.shutdowns = []

    def start(self):
        return self

    def submit(self, **kw):
        if self.submit_error is not None:
            raise self.submit_error
        self.submitted.append(kw)
        out = (self.outcomes.pop(0) if self.outcomes
               else np.zeros(1, np.int32))
        return _StubHandle(out)

    def shutdown(self, drain=True, timeout=None):
        self.shutdowns.append(drain)

    def snapshot(self):
        return {"requests_completed": len(self.submitted),
                "tokens_emitted": 0, "prefix_hit_tokens": 0,
                "prefix_miss_tokens": 0}


class _FakeServer:
    """Duck-typed server on the package's REAL RequestHandles: a thread
    pushes ``tokens`` (stalling after ``stall_after``, pausing ``pause``
    s mid-stream, or failing with ``fail_with``)."""

    def __init__(self, sv, tokens=(1, 2, 3), delay=0.005, stall_after=None,
                 pause=None, submit_error=None, fail_with=None,
                 probe_exc=None, probe_sleep=0.0):
        self.sv = sv
        self.engine = _StubEngine(0, 2, None)
        self.engine.pool = None
        self.scheduler = _StubScheduler(0, 8)
        self.tokens = list(tokens)
        self.delay = delay
        self.stall_after = stall_after
        self.pause = pause
        self.submit_error = submit_error
        self.fail_with = fail_with
        self.probe_exc = probe_exc
        self.probe_sleep = probe_sleep
        self.submitted = []

    def start(self):
        return self

    def submit(self, **kw):
        if self.submit_error is not None:
            raise self.submit_error
        self.submitted.append(kw)
        req = self.sv.Request(prompt=kw["prompt"],
                              corr_id=kw.get("correlation_id"))
        h = self.sv.RequestHandle(req)
        req.handle = h

        def run():
            if self.fail_with is not None:
                time.sleep(self.delay)
                h._fail(self.fail_with)
                return
            for i, t in enumerate(self.tokens):
                if self.stall_after is not None and i >= self.stall_after:
                    return
                if self.pause is not None and i == 1:
                    time.sleep(self.pause)
                time.sleep(self.delay)
                h._push(t)
            h.ttft_s = self.delay
            h._finish()

        threading.Thread(target=run, daemon=True).start()
        return h

    def probe(self):
        if self.probe_exc is not None:
            raise self.probe_exc
        if self.probe_sleep:
            time.sleep(self.probe_sleep)
        return {"active": self.engine.active_count,
                "slots": self.engine.slots,
                "queue_depth": self.scheduler.depth,
                "max_queue_depth": self.scheduler.max_queue_depth}

    def snapshot(self):
        return {"requests_completed": len(self.submitted)}

    def shutdown(self, drain=True, timeout=None):
        pass


# -------------------------------------------------------- placement
def test_router_places_on_least_loaded(sv):
    busy = _StubServer(active=4, slots=4, depth=6)
    idle = _StubServer(active=0, slots=4, depth=0)
    r = sv.serving.ReplicaRouter()
    r.add_replica(busy, "busy")
    r.add_replica(idle, "idle")
    h = r.submit(np.arange(4), max_new_tokens=2)
    assert h.replica == "idle" and len(idle.submitted) == 1


def test_router_affinity_outweighs_mild_load_skew(sv):
    warm = _StubServer(active=1, slots=4, matched=8)
    cold = _StubServer(active=0, slots=4, matched=0)
    r = sv.serving.ReplicaRouter(affinity_weight=0.75)
    r.add_replica(warm, "warm")
    r.add_replica(cold, "cold")
    assert r.submit(np.arange(8), max_new_tokens=2).replica == "warm"
    warm.engine.active_count = 4
    warm.scheduler.depth = 8
    assert r.submit(np.arange(8), max_new_tokens=2).replica == "cold"


def test_router_queuefull_fails_over_then_propagates(sv):
    full_a = _StubServer(submit_error=sv.serving.QueueFull("a full"))
    ok_b = _StubServer()
    r = sv.serving.ReplicaRouter()
    r.add_replica(full_a, "a")
    r.add_replica(ok_b, "b")
    assert r.submit(np.arange(4), max_new_tokens=2).replica == "b"
    ok_b.submit_error = sv.serving.QueueFull("b full")
    with pytest.raises(sv.serving.QueueFull):
        r.submit(np.arange(4), max_new_tokens=2)
    calls = {"n": 0}

    def submit_retry():
        calls["n"] += 1
        if calls["n"] == 2:
            ok_b.submit_error = None
        return r.submit(np.arange(4), max_new_tokens=2)

    h = RetryPolicy(max_attempts=4, base_delay=0.01).call(submit_retry)
    assert h.replica == "b" and calls["n"] >= 2


def test_router_drain_reroutes_new_traffic(sv):
    a, b = _StubServer(), _StubServer()
    r = sv.serving.ReplicaRouter()
    r.add_replica(a, "a")
    r.add_replica(b, "b")
    assert r.submit(np.arange(4), max_new_tokens=2).replica == "a"
    r.drain("a", timeout=10)
    assert a.shutdowns == [True]
    assert r.replicas()["a"] == "dead"
    for _ in range(3):
        assert r.submit(np.arange(4), max_new_tokens=2).replica == "b"
    r.drain("b", timeout=10)
    with pytest.raises(sv.serving.NoReplicasAvailable):
        r.submit(np.arange(4), max_new_tokens=2)


def test_router_dead_replica_resubmits_to_survivor(sv):
    closed = sv.serving.SchedulerClosed
    tokens = np.asarray([5, 6, 7], np.int32)
    r = sv.serving.ReplicaRouter()
    r.add_replica(_StubServer(outcomes=[closed("crashed")]), "dying")
    healthy = _StubServer(outcomes=[tokens])
    r.add_replica(healthy, "healthy")
    h = r.submit(np.arange(4), max_new_tokens=3, prefer="dying")
    np.testing.assert_array_equal(h.result(timeout=5), tokens)
    assert h.reroutes == 1 and h.replica == "healthy"
    assert r.replicas()["dying"] == "dead"
    r2 = sv.serving.ReplicaRouter(max_reroutes=1)
    r2.add_replica(_StubServer(outcomes=[closed("x"), closed("x")]), "only")
    with pytest.raises(closed):
        r2.submit(np.arange(4), max_new_tokens=3).result(timeout=5)


def test_router_reroute_is_single_flight_across_consumers(sv):
    closed = sv.serving.SchedulerClosed
    tokens = np.asarray([3, 4], np.int32)
    healthy = _StubServer(outcomes=[tokens, tokens])
    r = sv.serving.ReplicaRouter()
    r.add_replica(_StubServer(outcomes=[closed("crashed")]), "dying")
    r.add_replica(healthy, "healthy")
    h = r.submit(np.arange(4), max_new_tokens=2, prefer="dying")
    got, errs = [], []

    def consume():
        try:
            got.append(h.result(timeout=10))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=consume) for _ in range(2)]
    [t.start() for t in ts]
    [t.join(timeout=30) for t in ts]
    assert not errs and len(got) == 2
    assert len(healthy.submitted) == 1 and h.reroutes == 1


def test_router_all_replicas_closed_raises_retryable(sv):
    closed = sv.serving.SchedulerClosed
    r = sv.serving.ReplicaRouter()
    r.add_replica(_StubServer(submit_error=closed("gone")), "x")
    r.add_replica(_StubServer(submit_error=closed("gone")), "y")
    with pytest.raises(sv.serving.NoReplicasAvailable):
        r.submit(np.arange(4), max_new_tokens=2)
    assert set(r.replicas().values()) == {"dead"}


def test_router_assigns_seed_to_unseeded_sampled(sv):
    a = _StubServer()
    r = sv.serving.ReplicaRouter()
    r.add_replica(a, "a")
    r.submit(np.arange(4), max_new_tokens=2, do_sample=True)
    seed = a.submitted[0]["seed"]
    assert isinstance(seed, int) and 0 <= seed < 2 ** 56
    r.submit(np.arange(4), max_new_tokens=2)
    assert a.submitted[1]["seed"] is None
    # the kwargs each package's router hands a replica are the same
    ref = _StubServer()
    rr = jax_serving.ReplicaRouter()
    rr.add_replica(ref, "a")
    rr.submit(np.arange(4), max_new_tokens=2)
    assert sorted(a.submitted[1]) == sorted(ref.submitted[0])


# ------------------------------------------------- adapter affinity
class _StubStore:
    def __init__(self, resident, known=None):
        self._resident = set(resident)
        self._known = set(known) if known is not None else set(resident)

    def resident(self, name):
        return name in self._resident

    def known(self, name):
        return name in (None, "base") or name in self._known

    def salt(self, name):
        return (b"" if name in (None, "base")
                else b"lora:%s@1" % str(name).encode())


def test_router_skips_replicas_without_the_adapter(sv):
    knows = _StubServer(active=3, slots=4)
    ignorant = _StubServer(active=0, slots=4)
    knows.engine.store = _StubStore({"tenant-a"})
    ignorant.engine.store = _StubStore(())
    r = sv.serving.ReplicaRouter()
    r.add_replica(knows, "knows")
    r.add_replica(ignorant, "ignorant")
    r.submit(np.arange(8, dtype=np.int32), max_new_tokens=2,
             adapter_id="tenant-a").result(timeout=30)
    assert knows.submitted and not ignorant.submitted
    with pytest.raises(ValueError, match="knows adapter"):
        r.submit(np.arange(8, dtype=np.int32), adapter_id="tenant-b")


def test_router_adapter_affinity_prefers_warm_replica(sv):
    warm = _StubServer(active=1, slots=4)
    cold = _StubServer(active=0, slots=4)
    warm.engine.store = _StubStore({"tenant-a"})
    cold.engine.store = _StubStore((), known={"tenant-a"})
    r = sv.serving.ReplicaRouter(adapter_affinity_weight=0.5)
    r.add_replica(warm, "warm")
    r.add_replica(cold, "cold")
    r.submit(np.arange(8, dtype=np.int32), max_new_tokens=2,
             adapter_id="tenant-a").result(timeout=30)
    assert warm.submitted and not cold.submitted
    r.submit(np.arange(8, dtype=np.int32), max_new_tokens=2).result(
        timeout=30)
    assert cold.submitted
    warm.engine.active_count = 4
    warm.scheduler.depth = 6
    r.submit(np.arange(8, dtype=np.int32), max_new_tokens=2,
             adapter_id="tenant-a").result(timeout=30)
    assert len(cold.submitted) == 2


def test_register_adapter_broadcasts_to_live_replicas(sv):
    class _SwapStore(_StubStore):
        def __init__(self):
            super().__init__(())
            self.registered = []

        def register(self, name, state):
            self.registered.append(name)

    a, b, bare = _StubServer(), _StubServer(), _StubServer()
    a.engine.store, b.engine.store = _SwapStore(), _SwapStore()
    r = sv.serving.ReplicaRouter()
    for name, s in (("a", a), ("b", b), ("bare", bare)):
        r.add_replica(s, name)
    assert r.register_adapter("t0", {}) == {"a": True, "b": True,
                                            "bare": False}
    assert a.engine.store.registered == b.engine.store.registered == ["t0"]


# -------------------------------------------------- failure detector
def test_detector_miss_suspects_then_kills_and_dumps(sv):
    bad = _FakeServer(sv, stall_after=0)
    ok = _FakeServer(sv, tokens=(1, 2, 3))
    router = sv.serving.ReplicaRouter(suspect_misses=1, dead_misses=3)
    router.add_replica(bad, "bad")
    router.add_replica(ok, "ok")
    h = router.submit(np.arange(4), max_new_tokens=3, prefer="bad")
    corr = h.correlation_id
    before = sv.flight.flight_recorder().stats()["dumps_written"]
    bad.probe_exc = ConnectionError("probe refused")
    router.check_health()
    assert router.replicas()["bad"] == "suspect"
    router.check_health()
    assert router.replicas()["bad"] == "suspect"
    router.check_health()
    assert router.replicas()["bad"] == "dead"
    snap = router.snapshot()
    assert snap["replicas_suspected"] == 1 and snap["replicas_failed"] == 1
    rec = sv.flight.flight_recorder()
    assert rec.stats()["dumps_written"] == before + 1
    import json

    with open(rec.last_dump_path) as f:
        dump = json.load(f)
    assert "replica_dead" in rec.last_dump_path
    assert dump["extra"]["replica"] == "bad"
    assert corr in dump["extra"]["inflight"]
    h._current()._fail(sv.serving.SchedulerClosed("server gone"))
    assert list(h.result(timeout=10)) == [1, 2, 3]
    assert h.replica == "ok"


def test_detector_latency_ewma_suspects_gray_then_revives(sv):
    gray = _FakeServer(sv)
    router = sv.serving.ReplicaRouter(suspect_latency_factor=3.0,
                                      min_suspect_latency=0.01)
    router.add_replica(gray, "gray")
    for _ in range(5):
        router.check_health()
    assert router.replicas()["gray"] == "active"
    gray.probe_sleep = 0.08
    router.check_health()
    assert router.replicas()["gray"] == "suspect"
    gray.probe_sleep = 0.0
    for _ in range(3):
        router.check_health()
    assert router.replicas()["gray"] == "active"
    snap = router.snapshot()
    assert snap["replicas_revived"] >= 1 and snap["replicas_failed"] == 0


def test_suspect_excluded_from_placement_until_no_active_left(sv):
    a = _FakeServer(sv, tokens=(1,))
    b = _FakeServer(sv, tokens=(2,))
    router = sv.serving.ReplicaRouter()
    router.add_replica(a, "a")
    router.add_replica(b, "b")
    a.probe_exc = ConnectionError("gray")
    router.check_health()
    for _ in range(3):
        assert router.submit(np.arange(4), max_new_tokens=1).replica == "b"
    a.probe_exc = ConnectionError("down")
    b.probe_exc = ConnectionError("down")
    router.check_health()
    assert set(router.replicas().values()) == {"suspect"}
    assert router.submit(np.arange(4), max_new_tokens=1).replica in ("a",
                                                                      "b")


def test_router_registry_collector_counts_transitions():
    from paddle_tpu_torch.observability import default_registry

    a = _FakeServer(NS["torch"](), tokens=(1,))
    router = torch_serving.ReplicaRouter()
    router.add_replica(a, "a")
    a.probe_exc = ConnectionError("gray")
    router.check_health()
    snap = default_registry().snapshot()
    key = f'router.replicas_suspected{{router="{router._obs_label}"}}'
    assert snap["counters"][key] == 1


# ------------------------------------------------------------ hedging
def _hedge_router(sv, **kw):
    kw.setdefault("hedge_multiplier", 2.0)
    kw.setdefault("hedge_min_s", 0.05)
    kw.setdefault("hedge_warmup_tokens", 4)
    kw.setdefault("hedge_poll_interval", 0.01)
    router = sv.serving.ReplicaRouter(**kw)
    return router


def _warm(router):
    for _ in range(router.hedge_warmup_tokens):
        router._note_inter_token(0.01)


def test_hedge_fires_on_stall_and_winner_is_adopted(sv):
    router = _hedge_router(sv)
    router.add_replica(_FakeServer(sv, tokens=(7, 8, 9), stall_after=1),
                       "slow")
    router.add_replica(_FakeServer(sv, tokens=(7, 8, 9)), "fast")
    _warm(router)
    before = sv.flight.flight_recorder().stats()["dumps_written"]
    h = router.submit(np.arange(4), max_new_tokens=3, prefer="slow")
    assert list(h.result(timeout=30)) == [7, 8, 9]
    assert h.replica == "fast"
    assert router.requests_hedged == 1 and router.hedge_wins == 1
    assert router.replicas()["slow"] == "active"
    rec = sv.flight.flight_recorder()
    assert rec.stats()["dumps_written"] == before + 1
    assert "hedge_fire" in rec.last_dump_path


def test_hedge_stream_switches_and_reemits(sv):
    router = _hedge_router(sv)
    router.add_replica(_FakeServer(sv, tokens=(4, 5, 6), stall_after=1),
                       "slow")
    router.add_replica(_FakeServer(sv, tokens=(4, 5, 6)), "fast")
    _warm(router)
    h = router.submit(np.arange(4), max_new_tokens=3, prefer="slow")
    assert list(h.stream())[-3:] == [4, 5, 6]
    assert router.hedge_wins == 1


def test_hedge_without_second_replica_and_off_by_default(sv):
    router = _hedge_router(sv)
    router.add_replica(_FakeServer(sv, tokens=(1, 2, 3), pause=0.3), "only")
    _warm(router)
    h = router.submit(np.arange(4), max_new_tokens=3)
    assert list(h.result(timeout=30)) == [1, 2, 3]
    assert router.requests_hedged == 0
    plain = sv.serving.ReplicaRouter()
    plain.add_replica(_FakeServer(sv), "a")
    assert plain._hedge_threshold() is None
    cold = _hedge_router(sv)
    cold.add_replica(_FakeServer(sv), "a")
    assert cold._hedge_threshold() is None


def test_overloaded_from_handle_is_not_a_death(sv):
    router = sv.serving.ReplicaRouter()
    router.add_replica(_FakeServer(sv, fail_with=sv.serving.Overloaded(
        "shed from queue")), "only")
    h = router.submit(np.arange(4), max_new_tokens=2)
    with pytest.raises(sv.serving.Overloaded):
        h.result(timeout=10)
    assert h.reroutes == 0 and router.replicas()["only"] == "active"


def test_router_fails_over_on_submit_overload(sv):
    ov = sv.serving.Overloaded
    router = sv.serving.ReplicaRouter()
    router.add_replica(_FakeServer(sv, submit_error=ov("full")), "shedding")
    healthy = _FakeServer(sv, tokens=(9,))
    router.add_replica(healthy, "healthy")
    h = router.submit(np.arange(4), max_new_tokens=1, prefer="shedding")
    assert h.replica == "healthy"
    healthy.submit_error = ov("also full")
    with pytest.raises(sv.serving.QueueFull):
        router.submit(np.arange(4), max_new_tokens=1)


# ------------------------------------------- model-backed: the fleet
@pytest.fixture(scope="module")
def pair():
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
    from paddle_tpu_torch.models.gpt import gpt_tiny

    pt.seed(7)
    kw = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    jm = JaxGPT(jax_gpt_tiny(use_flash_attention=False, **kw))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, gpt_from_jax(state, gpt_tiny(**kw), device="cpu")


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 1024, (n,)).astype(
        np.int32)


def _two_replicas(model, cls, **kw):
    extra = {} if cls is jax_serving.InferenceServer else {"device": "cpu"}
    router = (jax_serving if cls is jax_serving.InferenceServer
              else torch_serving).ReplicaRouter()
    servers = [cls(model, slots=2, **extra, **kw, **GEO) for _ in range(2)]
    for name, srv in zip("ab", servers):
        if not extra:
            # the JAX replicas share one Layer: trace their programs one
            # at a time, before two serving threads could trace at once
            srv.engine.warmup()
        router.add_replica(srv, name)
    return router, servers


@pytest.mark.parametrize("pooled", [False, True])
def test_greedy_router_streams_equal_the_jax_router(pair, pooled):
    jm, tm = pair
    kw = {"prefix_cache": dict(POOL)} if pooled else {}
    shared = _prompt(16, 40)
    prompts = [(np.concatenate([shared, _prompt(3 + i, 50 + i)])
                if i % 2 else _prompt(5 + 3 * i, 60 + i), 6 + i % 3)
               for i in range(6)]
    routers = [_two_replicas(jm, jax_serving.InferenceServer, **kw),
               _two_replicas(tm, torch_serving.InferenceServer, **kw)]
    try:
        outs = []
        for router, _ in routers:
            hs = [router.submit(p, max_new_tokens=n) for p, n in prompts]
            outs.append([h.result(timeout=300) for h in hs])
            assert len({h.replica for h in hs}) == 2   # both replicas serve
        for (p, n), a, b in zip(prompts, *outs):
            assert b.shape == (n,)
            np.testing.assert_array_equal(b, a)
    finally:
        for router, _ in routers:
            router.shutdown(drain=False, timeout=60)


def test_prefix_hit_stream_matches_cold_solo(pair):
    """A cold admit fills a replica's pool; two follow-ups sharing its
    16-token prefix admit as hits and equal their cold solo generate() —
    greedy and seeded-sampled — and affinity then places a sharer on the
    warm replica."""
    _, tm = pair
    router, (a, b) = _two_replicas(tm, torch_serving.InferenceServer,
                                   prefix_cache=dict(POOL))
    try:
        prefix = _prompt(16, 100)
        p1 = np.concatenate([prefix, _prompt(5, 101)])
        p2 = np.concatenate([prefix, _prompt(6, 102)])
        p3 = np.concatenate([prefix, _prompt(4, 103)])
        solo1 = tm.generate(p1[None], max_new_tokens=6, **GEO)[0]
        solo2 = tm.generate(p2[None], max_new_tokens=5, **GEO)[0]
        solo3 = tm.generate(p3[None], max_new_tokens=6, do_sample=True,
                            temperature=0.8, seed=9, **GEO)[0]
        h1 = router.submit(p1, max_new_tokens=6, prefer="a")
        np.testing.assert_array_equal(h1.result(timeout=300), solo1)
        assert h1.cache_hit_tokens == 0
        h2 = router.submit(p2, max_new_tokens=5, prefer="a")
        h3 = router.submit(p3, max_new_tokens=6, do_sample=True,
                           temperature=0.8, seed=9, prefer="a")
        np.testing.assert_array_equal(h2.result(timeout=300), solo2)
        np.testing.assert_array_equal(h3.result(timeout=300), solo3)
        assert h2.cache_hit_tokens == h3.cache_hit_tokens == 16
        p4 = np.concatenate([prefix, _prompt(5, 104)])
        assert a.engine.pool.match(p4) == 16 and b.engine.pool.match(p4) == 0
        h4 = router.submit(p4, max_new_tokens=2)
        h4.result(timeout=300)
        assert h4.replica == "a" and h4.cache_hit_tokens == 16
        snap = router.snapshot()
        assert snap["prefix_hit_tokens"] >= 48 and snap["prefix_hit_rate"] > 0
    finally:
        router.shutdown(drain=False, timeout=60)


def test_fleet_crash_reroutes_and_tokens_identical(pair):
    """A seeded sampled request whose replica is shut down hard mid-stream
    reroutes to the survivor and replays the exact solo tokens."""
    _, tm = pair
    router, (a, b) = _two_replicas(tm, torch_serving.InferenceServer)
    try:
        p = _prompt(12, 110)
        solo = tm.generate(p[None], max_new_tokens=20, do_sample=True,
                           temperature=0.9, seed=77, **GEO)[0]
        h = router.submit(p, max_new_tokens=20, do_sample=True,
                          temperature=0.9, seed=77, prefer="b")
        b.shutdown(drain=False, timeout=60)
        np.testing.assert_array_equal(h.result(timeout=300), solo)
        assert h.reroutes >= 1 and h.replica == "a"
        assert router.replicas()["b"] == "dead"
        assert router.snapshot()["requests_rerouted"] >= 1
        assert router.submit(p, max_new_tokens=3).result(
            timeout=300).shape[0] == 3
    finally:
        router.shutdown(drain=False, timeout=60)


def test_engine_fault_requeues_under_the_router(pair):
    """A FaultPlan drop at serve.admit resets one replica's engine; the
    request retries there (the server's own recovery) and the router sees
    no death."""
    _, tm = pair
    router, _ = _two_replicas(tm, torch_serving.InferenceServer)
    try:
        p = _prompt(9, 120)
        solo = tm.generate(p[None], max_new_tokens=4, **GEO)[0]
        with FaultPlan([{"site": "serve.admit", "kind": "drop",
                         "times": 1}], seed=0):
            with pytest.warns(RuntimeWarning, match="serve loop fault"):
                out = router.submit(p, max_new_tokens=4).result(timeout=300)
        np.testing.assert_array_equal(out, solo)
        assert set(router.replicas().values()) == {"active"}
        snap = router.snapshot()
        assert sum(r.get("requests_requeued", 0)
                   for r in snap["replicas"].values()) == 1
    finally:
        router.shutdown(drain=False, timeout=60)


def test_llama_router_streams_equal_the_jax_router():
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
    from paddle_tpu_torch.models.llama import llama_tiny

    pt.seed(11)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = llama_from_jax(state, llama_tiny(), device="cpu")
    prompts = [_prompt(7 + 4 * i, 70 + i) for i in range(4)]
    outs = []
    for model, cls in ((jm, jax_serving.InferenceServer),
                       (tm, torch_serving.InferenceServer)):
        router, _ = _two_replicas(model, cls)
        try:
            hs = [router.submit(p, max_new_tokens=5) for p in prompts]
            outs.append([h.result(timeout=300) for h in hs])
        finally:
            router.shutdown(drain=False, timeout=60)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


def test_server_shed_and_probe_fault_site(pair):
    _, tm = pair
    srv = torch_serving.InferenceServer(tm, slots=1, shed_on_overload=True,
                                        device="cpu", **GEO)
    srv.engine.free_slots = lambda: []
    with srv.scheduler._lock:
        srv.scheduler._svc_ewma = 5.0
    h1 = srv.submit(np.arange(4), max_new_tokens=2)
    with pytest.raises(torch_serving.Overloaded):
        srv.submit(np.arange(4), max_new_tokens=2, deadline=1.0)
    h2 = srv.submit(np.arange(4), max_new_tokens=2, deadline=60.0)
    with srv.scheduler._lock:
        srv.scheduler._svc_ewma = 1000.0
    with pytest.raises(torch_serving.Overloaded):
        h2.result(timeout=30)
    assert (srv.metrics.requests_shed, srv.metrics.requests_expired,
            srv.metrics.requests_failed) == (2, 0, 0)
    assert not h1.done
    p = srv.probe()
    assert p["slots"] == 1 and p["max_queue_depth"] == 64
    with FaultPlan([{"site": "serve.probe", "kind": "drop"}], seed=0):
        with pytest.raises(ConnectionError):
            srv.probe()
    srv.shutdown(drain=False, timeout=30)

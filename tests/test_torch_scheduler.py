"""The port's admission control (paddle_tpu_torch/serving/scheduler.py
and the server's accounting of it) against the JAX package's.

Twins of ``tests/test_slo_control_loop.py``'s token-bucket, rate-limit
and deficit-round-robin tests and of ``tests/test_fleet_resilience.py``'s
shedding tests, on injected clocks and without a model. Parity: under
the same injected clock and the same submit sequence, the port's
scheduler accepts, rejects and admits exactly the requests the JAX
scheduler does, in the same order.
"""
import threading
import time

import numpy as np
import pytest

from paddle_tpu.serving import FifoScheduler as JaxScheduler
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import RateLimited as JaxRateLimited
from paddle_tpu.serving import QueueFull as JaxQueueFull
from paddle_tpu_torch.serving import (BASE_TENANT, Backpressure, Deadline,
                                      FifoScheduler, InferenceServer,
                                      Overloaded, QueueFull, RateLimited,
                                      Request, ServingMetrics, TokenBucket)
from paddle_tpu_torch.serving.server import RequestHandle


def _req(tenant=None, deadline=None, n=4):
    return Request(prompt=np.zeros(n, np.int32), max_new_tokens=4,
                   adapter_id=tenant, deadline=deadline)


# ------------------------------------------------------------ TokenBucket
def test_token_bucket_burst_then_rate():
    b = TokenBucket(rate=2.0, burst=3.0)
    now = 100.0
    assert all(b.try_take(now) for _ in range(3))   # burst capacity
    assert not b.try_take(now)
    assert b.retry_after() == pytest.approx(0.5)    # 1 token at 2/s
    assert b.try_take(now + 0.5)
    assert not b.try_take(now + 0.5)
    assert b.level(now + 1000.0) == pytest.approx(3.0)   # capped at burst


def test_rate_limited_is_retryable_backpressure():
    e = RateLimited("over", tenant="t1", retry_after=0.25)
    assert isinstance(e, Backpressure) and isinstance(e, ConnectionError)
    assert e.tenant == "t1" and e.retry_after == pytest.approx(0.25)
    assert isinstance(Overloaded("x"), ConnectionError)


# ----------------------------------------------- scheduler rate limiting
def test_scheduler_defaults_off_no_buckets():
    s = FifoScheduler(max_queue_depth=4)
    for _ in range(4):
        s.submit(_req(tenant="loud"))
    assert s.bucket_levels() == {}
    with pytest.raises(QueueFull):
        s.submit(_req(tenant="loud"))


def test_scheduler_per_tenant_bucket_rejects_and_refills():
    clock = [0.0]
    s = FifoScheduler(max_queue_depth=64, tenant_rate=1.0,
                      tenant_burst=2.0, clock=lambda: clock[0])
    s.submit(_req(tenant="t"))
    s.submit(_req(tenant="t"))
    with pytest.raises(RateLimited) as ei:
        s.submit(_req(tenant="t"))
    assert ei.value.tenant == "t"
    assert ei.value.retry_after == pytest.approx(1.0)
    s.submit(_req(tenant="other"))
    clock[0] = 1.0
    s.submit(_req(tenant="t"))
    levels = s.bucket_levels()
    assert levels["t"]["rate"] == 1.0 and levels["t"]["burst"] == 2.0
    assert levels["t"]["tokens"] == pytest.approx(0.0)


def test_scheduler_tenant_limits_override_and_base_tenant():
    clock = [0.0]
    s = FifoScheduler(max_queue_depth=64,
                      tenant_limits={"abuser": (1.0, 1.0)},
                      clock=lambda: clock[0])
    s.submit(_req(tenant="abuser"))
    with pytest.raises(RateLimited):
        s.submit(_req(tenant="abuser"))
    for _ in range(8):
        s.submit(_req())
    assert BASE_TENANT not in s.bucket_levels()


def test_tenant_field_names_the_tenant():
    """The port's server names tenants with ``submit(tenant=...)``; the
    field wins over an adapter id, and neither means the base tenant."""
    assert FifoScheduler.tenant_of(Request(prompt=[1], tenant="a",
                                           adapter_id="b")) == "a"
    assert FifoScheduler.tenant_of(Request(prompt=[1], adapter_id="b")) == "b"
    assert FifoScheduler.tenant_of(Request(prompt=[1])) == BASE_TENANT


def test_requeue_bypasses_the_bucket():
    clock = [0.0]
    s = FifoScheduler(max_queue_depth=64, tenant_limits={"t": (1.0, 1.0)},
                      clock=lambda: clock[0])
    r = _req(tenant="t")
    s.submit(r)
    assert s.take(1)[0] == [r]
    s.requeue(r)                        # no RateLimited despite empty
    assert s.take(1)[0] == [r]


# --------------------------------------------------- DRR fair queueing
def test_fair_take_round_robins_under_10x_tenant():
    s = FifoScheduler(max_queue_depth=64, max_prefills_per_step=8,
                      fair_queueing=True)
    flood = [_req(tenant="abuser") for _ in range(20)]
    quiet = [_req(tenant="alice"), _req(tenant="bob")]
    for r in flood[:10] + quiet + flood[10:]:
        s.submit(r)
    got, _ = s.take(4)
    assert any(r is quiet[0] for r in got)
    assert any(r is quiet[1] for r in got)
    assert [r for r in got if r.adapter_id == "abuser"] == flood[:2]


def test_fair_take_fifo_within_tenant_and_drains():
    s = FifoScheduler(max_queue_depth=64, max_prefills_per_step=4,
                      fair_queueing=True)
    a = [_req(tenant="a") for _ in range(3)]
    b = [_req(tenant="b")]
    for r in a[:2] + b + a[2:]:
        s.submit(r)
    assert s.take(4)[0] == [a[0], b[0], a[1], a[2]]
    assert s.depth == 0


def test_fair_weights_bias_the_quantum():
    s = FifoScheduler(max_queue_depth=64, max_prefills_per_step=6,
                      fair_queueing=True,
                      fair_weights={"gold": 2.0, "bronze": 1.0})
    gold = [_req(tenant="gold") for _ in range(4)]
    bronze = [_req(tenant="bronze") for _ in range(4)]
    for g, b in zip(gold, bronze):
        s.submit(g)
        s.submit(b)
    got, _ = s.take(6)
    assert len([r for r in got if r.adapter_id == "gold"]) == 4
    assert len([r for r in got if r.adapter_id == "bronze"]) == 2


def test_fair_take_skips_expired_without_spending_deficit():
    s = FifoScheduler(max_queue_depth=64, max_prefills_per_step=4,
                      fair_queueing=True)
    dead = _req(tenant="a", deadline=Deadline(0.0))
    live = _req(tenant="a")
    other = _req(tenant="b")
    for r in (dead, live, other):
        s.submit(r)
    got, exp = s.take(3)
    assert all(r is not dead for r in got)
    assert any(r is live for r in got) and any(r is other for r in got)
    assert len(exp) == 1 and exp[0] is dead


def test_fair_off_is_strict_fifo():
    s = FifoScheduler(max_queue_depth=64, max_prefills_per_step=8)
    reqs = [_req(tenant=t) for t in ("a", "a", "a", "b", "a", None, "a", "b")]
    for r in reqs:
        s.submit(r)
    assert s.take(8)[0] == reqs


# ------------------------------------------------- parity with the JAX one
def _drive(sched_cls, req_cls, errors, tenants, budgets, clock_steps,
           **kw):
    """Submit ``tenants`` in order (advancing the injected clock by
    ``clock_steps[i]`` before submit i), then take() with each budget;
    returns (outcome per submit, admitted submit indices per take)."""
    clock = [0.0]
    s = sched_cls(clock=lambda: clock[0], **kw)
    outcome, index = [], {}
    for i, (t, dt) in enumerate(zip(tenants, clock_steps)):
        clock[0] += dt
        r = req_cls(prompt=np.zeros(2, np.int32), adapter_id=t)
        try:
            s.submit(r)
            outcome.append("ok")
            index[id(r)] = i
        except errors as e:
            outcome.append(type(e).__name__)
    takes = [[index[id(r)] for r in s.take(b)[0]] for b in budgets]
    return outcome, takes


@pytest.mark.parametrize("case", range(6))
def test_admission_order_equals_jax_scheduler(case):
    """Random tenant mixes (one tenant sending about 10x the others),
    random token buckets, weights and take budgets: the same accepts,
    rejects and admission order as the JAX scheduler."""
    rng = np.random.default_rng(case)
    names = ["loud", "quiet", "mid"][:2 + case % 2]
    p = np.array([10.0] + [1.0] * (len(names) - 1))
    tenants = [names[i] if rng.random() > 0.1 else None
               for i in rng.choice(len(names), 60, p=p / p.sum())]
    steps = rng.exponential(0.05, 60).tolist()
    budgets = rng.integers(1, 5, 20).tolist()
    kw = dict(max_queue_depth=40, max_prefills_per_step=3,
              fair_queueing=case != 5,
              fair_weights={"quiet": 2.0} if case % 3 == 1 else None,
              tenant_rate=None if case == 0 else 4.0,
              tenant_burst=None if case == 0 else 6.0,
              tenant_limits={"loud": (8.0, 3.0)} if case % 2 else None)
    want = _drive(JaxScheduler, JaxRequest, (JaxRateLimited, JaxQueueFull),
                  tenants, budgets, steps, **kw)
    got = _drive(FifoScheduler, Request, (RateLimited, QueueFull),
                 tenants, budgets, steps, **kw)
    assert got[0] == [o.replace("Jax", "") for o in want[0]]
    assert got[1] == want[1]
    assert "RateLimited" in got[0] or case == 0
    assert sum(map(len, got[1])) > 10


# ------------------------------------------------------------- shedding
def _mkreq(deadline=None):
    req = Request(prompt=np.arange(2),
                  deadline=Deadline(deadline) if deadline is not None
                  else None)
    req.handle = RequestHandle(req)
    return req


def test_scheduler_sheds_predicted_miss_at_submit():
    s = FifoScheduler(shed_on_overload=True)
    assert s.predicted_wait(5) is None       # zero evidence: no shedding
    with s._lock:
        s._svc_ewma = 1.0
    s.submit(_mkreq())
    s.submit(_mkreq(deadline=10.0))          # predicted 1.0s < 10s
    with pytest.raises(Overloaded):
        s.submit(_mkreq(deadline=0.5))       # predicted 2.0s > 0.5s
    assert s.depth == 2
    s.submit(_mkreq())                       # no deadline: never shed
    assert s.depth == 3


def test_scheduler_shed_default_off_is_inert():
    s = FifoScheduler()
    with s._lock:
        s._svc_ewma = 100.0
    s.submit(_mkreq())
    s.submit(_mkreq(deadline=0.01))
    assert s.depth == 2
    assert s.pop_predicted_misses() == []


def test_scheduler_queue_shed_spares_head():
    s = FifoScheduler(shed_on_overload=True)
    head, mid, tail = _mkreq(deadline=0.2), _mkreq(deadline=0.3), _mkreq()
    for r in (head, mid, tail):
        s.submit(r)
    with s._lock:
        s._svc_ewma = 1.0
    assert s.pop_predicted_misses() == [mid]
    assert s.depth == 2
    assert s.take(4)[0][0] is head


def test_scheduler_cadence_ewma_ignores_idle_gaps():
    s = FifoScheduler(shed_on_overload=True)
    s.submit(_mkreq())
    s.take(1)
    s.submit(_mkreq())
    time.sleep(0.05)
    s.take(1)                                # a genuine ~50 ms sample
    w = s.predicted_wait(2)
    assert w is not None and 0.02 <= w <= 1.0
    s.take(1)                                # empty queue: clock reset
    time.sleep(0.25)
    s.submit(_mkreq())
    s.take(1)
    assert s.predicted_wait(1) < 0.15        # the lull never counted


# ------------------------------------------------- server-side accounting
class _StubEngine:
    active_count = 0
    slots = 4
    pool = None
    store = None
    allow_top_p = True

    def validate(self, n, m):
        pass

    def free_slots(self):
        return []                            # nothing ever admits

    def cache_stats(self):
        return {}


def _stub_server(**sched_kw):
    """A real InferenceServer driving a real FifoScheduler through the
    real ``submit()``, with the engine stubbed and no worker thread."""
    srv = object.__new__(InferenceServer)
    srv.engine = _StubEngine()
    srv.scheduler = FifoScheduler(**sched_kw)
    srv.metrics = ServingMetrics(slots=4)
    srv._cv = threading.Condition()
    srv.start = lambda: srv
    return srv


def test_server_rate_limited_and_shed_counted_not_failed():
    clock = [0.0]
    srv = _stub_server(max_queue_depth=8, shed_on_overload=True,
                       tenant_limits={"abuser": (1.0, 1.0)},
                       clock=lambda: clock[0])
    h1 = srv.submit(np.zeros(4, np.int32), max_new_tokens=4,
                    tenant="abuser")
    with pytest.raises(RateLimited):
        srv.submit(np.zeros(4, np.int32), max_new_tokens=4, tenant="abuser")
    with srv.scheduler._lock:
        srv.scheduler._svc_ewma = 5.0
    with pytest.raises(Overloaded):          # a door shed (position 1)
        srv.submit(np.arange(4), max_new_tokens=2, deadline=1.0)
    h2 = srv.submit(np.arange(4), max_new_tokens=2, deadline=60.0)
    with srv.scheduler._lock:                # service collapses
        srv.scheduler._svc_ewma = 1000.0
    srv._tick()                              # the queue sweep sheds h2
    with pytest.raises(Overloaded):
        h2.result(timeout=1)
    snap = srv.metrics.snapshot()
    assert snap["requests_rate_limited"] == 1
    assert snap["requests_shed"] == 2
    assert snap["requests_failed"] == 0 and snap["requests_expired"] == 0
    assert snap["requests_submitted"] == 2
    assert not h1.done                       # the head is never shed

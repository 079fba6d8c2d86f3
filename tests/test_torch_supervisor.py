"""The port's self-healing fit loop (``paddle_tpu_torch.framework.
supervisor`` under ``Model.fit(recovery=...)``), twins of
``tests/test_self_healing.py`` on the port alone, on the CPU.

The equivalence tests hold parameters bit for bit: a SIGTERM-resumed fit,
and a fit rolled back after poisoned batches, must end exactly where an
uninterrupted fit of the same batches ends. That holds because the step is
deterministic run to run on the CPU and the checkpoint carries the step
count and base seed, from which the dropout streams are folded. The real
SIGTERM handler runs: the tests signal their own process.
"""
import dataclasses
import os
import signal
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.resilience import FaultPlan as JFaultPlan
from paddle_tpu.framework import supervisor as jsup
from paddle_tpu.hapi import Callback as JCallback
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.convert import gpt_from_jax, layer_from_jax
from paddle_tpu_torch.distributed.checkpoint import save_state
from paddle_tpu_torch.distributed.resilience import (EXIT_HANG,
                                                     EXIT_PREEMPTED,
                                                     FaultPlan)
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.framework.supervisor import (HangWatchdog,
                                                   NumericsWatchdog,
                                                   PreemptionHandler,
                                                   RecoveryPolicy,
                                                   TrainingPreempted,
                                                   TrainingSupervisor)
from paddle_tpu_torch.hapi import Callback, Model
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn.layers.common import Dropout, Linear
from paddle_tpu_torch.optimizer import AdamW
from torch_threads import few_torch_threads  # noqa: F401


class _Lin(torch.nn.Module):
    # dropout ON: resume equivalence must reproduce the per-step random
    # streams (restored base seed + count), not just the weights
    def __init__(self):
        super().__init__()
        self.fc = Linear(4, 8, device="cpu")
        self.drop = Dropout(0.2)
        self.out = Linear(8, 1, device="cpu")

    def forward(self, x):
        return self.out(self.drop(self.fc(x)))


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _lin_data(n=24):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    w = np.array([[1.0], [2.0], [3.0], [4.0]], np.float32)
    return TensorDataset([x, (x @ w).astype(np.float32)])


def _lin_model():
    m = Model(_Lin().train())
    m.prepare(AdamW(learning_rate=1e-2), loss=_mse)
    return m


def _gpt_model():
    cfg = gpt_tiny(num_layers=1, hidden_size=32, num_heads=2,
                   vocab_size=64, max_position_embeddings=32,
                   hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    m = Model(GPTForCausalLM(cfg, device="cpu").train(), labels=[])
    m.prepare(AdamW(learning_rate=1e-3, weight_decay=0.01))
    return m


def _gpt_data(n=32):
    ids = np.random.default_rng(3).integers(0, 64, (n, 16)).astype(np.int32)
    return TensorDataset([ids, ids])


def _policy(d, **kw):
    base = dict(checkpoint_dir=d, save_interval_steps=4, check_interval=2,
                max_consecutive=2, async_save=False, grace_seconds=10.0)
    base.update(kw)
    return RecoveryPolicy(**base)


def _params(m):
    return {k: v.detach().clone() for k, v in m._train_step.params.items()}


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.is_floating_point() else t


def _assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(_bits(a[k]), _bits(b[k])), k


def test_recovery_policy_equals_the_reference():
    got = [(f.name, f.default) for f in dataclasses.fields(RecoveryPolicy)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(jsup.RecoveryPolicy)]
    assert got == want
    assert (EXIT_PREEMPTED, EXIT_HANG) == (jsup.EXIT_PREEMPTED,
                                           jsup.EXIT_HANG)
    with pytest.raises(NotImplementedError, match="A8"):
        TrainingSupervisor(object(), RecoveryPolicy(
            checkpoint_dir="unused", integrity_check_interval=4))


# ------------------------------------------------------- numerics watchdog
def test_watchdog_counts_anomalies_and_scaler_skips_apart():
    wd = NumericsWatchdog(check_interval=3, max_consecutive=2)
    t, f = torch.tensor(True), torch.tensor(False)
    wd.observe(0, 0, torch.tensor(1.0), t, f)
    wd.observe(0, 1, torch.tensor(2.0), f, t)        # a scaler overflow
    wd.observe(0, 2, torch.tensor(float("nan")), f, f)
    assert wd.due
    assert wd.flush() == [(0, 2, pytest.approx(float("nan"), nan_ok=True))]
    assert (wd.anomalies, wd.scaler_skips, wd.consecutive) == (1, 1, 1)
    wd.observe(0, 3, torch.tensor(float("inf")), f, f)
    wd.observe(0, 4, torch.tensor(1.0), None, None)  # accumulate-only
    wd.flush()
    assert wd.should_rollback and wd.first_bad == (0, 2)


def test_single_nan_batch_skipped_not_rolled_back(tmp_path):
    trandom.seed(7)
    m = _lin_model()
    anomalies, rollbacks = [], []

    class Rec(Callback):
        def on_train_anomaly(self, logs=None):
            anomalies.append(logs)

        def on_rollback(self, logs=None):
            rollbacks.append(logs)

    plan = FaultPlan([{"site": "train.data", "kind": "drop", "times": 1,
                       "after": 3}], seed=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with plan:
            hist = m.fit(_lin_data(), batch_size=4, epochs=1, shuffle=False,
                         verbose=0, callbacks=[Rec()],
                         recovery=_policy(str(tmp_path), max_consecutive=3))
    assert plan.fired[0] == 1
    assert len(anomalies) == 1 and anomalies[0]["batch_index"] == 3
    assert rollbacks == []
    assert np.isfinite(hist["loss"][-1])
    assert all(torch.isfinite(v).all() for v in m._train_step.params.values())


def _fit(d, plan=None, callbacks=None, make=_lin_model, data=None,
         epochs=2, **policy):
    trandom.seed(11)
    m = make()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if plan is not None:
            plan.install()
        try:
            m.fit(data if data is not None else _lin_data(16), batch_size=4,
                  epochs=epochs, shuffle=False, verbose=0,
                  callbacks=callbacks, recovery=_policy(d, **policy))
        finally:
            if plan is not None:
                plan.uninstall()
    return m


def test_rollback_after_consecutive_anomalies_replays_bit_identically(
        tmp_path):
    """Two poisoned batches in a row escalate to a rollback onto the last
    snapshot; the plan is spent, so the replay is clean and the fit ends
    exactly where the uninterrupted one does."""
    clean = _params(_fit(str(tmp_path / "clean"), check_interval=4))
    events = []

    class Rec(Callback):
        def on_rollback(self, logs=None):
            events.append(logs)

    plan = FaultPlan([{"site": "train.data", "kind": "drop", "times": 2,
                       "after": 5}], seed=0)
    m = _fit(str(tmp_path / "rb"), plan=plan, callbacks=[Rec()],
             check_interval=4)
    assert plan.fired[0] == 2 and len(events) == 1
    # back to step_4, cut after epoch 0's last batch (4 batches an epoch)
    c = events[0]["cursor"]
    assert (c.epoch, c.batch_index, c.global_step) == (0, 4, 4)
    _assert_bit_equal(clean, _params(m))


def test_skip_window_and_max_rollbacks(tmp_path):
    events = []

    class Rec(Callback):
        def on_rollback(self, logs=None):
            events.append(logs)

    plan = FaultPlan([{"site": "train.data", "kind": "drop", "times": 2,
                       "after": 1}], seed=0)
    m = _fit(str(tmp_path / "skip"), plan=plan, callbacks=[Rec()],
             epochs=1, skip_window=2, check_interval=1)
    assert len(events) == 1 and events[0]["skip"] == [(0, 1), (0, 2)]
    assert all(torch.isfinite(v).all() for v in m._train_step.params.values())
    # every batch poisoned: the rollbacks never heal
    plan = FaultPlan([{"site": "train.data", "kind": "drop",
                       "times": None}], seed=0)
    with pytest.raises(FloatingPointError, match="max_rollbacks"):
        _fit(str(tmp_path / "hopeless"), plan=plan, epochs=1,
             check_interval=1, max_rollbacks=1)


# ----------------------------------------------------------- preemption
class _KillAt(Callback):
    """Deliver a real SIGTERM to ourselves after the N-th batch."""

    def __init__(self, at):
        super().__init__()
        self.at, self.seen, self.fired = at, 0, False
        self.preempted = []

    def on_train_batch_end(self, step, logs=None):
        self.seen += 1
        if not self.fired and self.seen == self.at:
            self.fired = True
            os.kill(os.getpid(), signal.SIGTERM)

    def on_preemption(self, logs=None):
        self.preempted.append(logs)


@pytest.mark.parametrize("make,data", [(_lin_model, _lin_data(16)),
                                       (_gpt_model, _gpt_data())],
                         ids=["mlp_dropout", "gpt_tiny_dropout"])
def test_sigterm_mid_fit_resumes_bit_identical(tmp_path, make, data):
    ref = _params(_fit(str(tmp_path / "ref"), make=make, data=data,
                       save_interval_steps=3))
    before = signal.getsignal(signal.SIGTERM)
    kill = _KillAt(5)
    with pytest.raises(TrainingPreempted) as info:
        _fit(str(tmp_path / "kill"), make=make, data=data, callbacks=[kill],
             save_interval_steps=3)
    # the signal lands after batch 5's bookkeeping: batch 6 honors it
    assert info.value.saved and info.value.global_step == 6
    assert kill.preempted and kill.preempted[0]["saved"]
    # the handler is uninstalled with the supervisor
    assert signal.getsignal(signal.SIGTERM) == before
    resumed = _fit(str(tmp_path / "kill"), make=make, data=data,
                   save_interval_steps=3)
    _assert_bit_equal(ref, _params(resumed))


def test_preemption_handler_restores_the_previous_handler():
    seen = []

    def prev(signum, frame):
        seen.append(signum)

    old = signal.signal(signal.SIGTERM, prev)
    try:
        h = PreemptionHandler(grace_seconds=5.0).install()
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.requested and h.deadline.remaining() > 0 and seen == []
        h.uninstall()
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, old)


def test_old_checkpoint_without_cursor_still_loads(tmp_path):
    trandom.seed(5)
    m = _lin_model()
    step = m._ensure_train_step()
    step((np.ones((4, 4), np.float32), np.ones((4, 1), np.float32)))
    old_style = dict(step.state_dict())
    old_style.pop("base_seed")
    save_state(old_style, str(tmp_path / "step_7"))
    trandom.seed(5)
    m2 = _lin_model()
    sup = TrainingSupervisor(m2._ensure_train_step(), _policy(str(tmp_path)))
    assert sup.restore() is None
    assert m2._train_step._count == step._count
    _assert_bit_equal(_params(m), _params(m2))


# ----------------------------------------------------------- hang watchdog
def test_hang_watchdog_detects_stall_and_rearms():
    seen = []
    wd = HangWatchdog(step_timeout=0.15, action="warn",
                      on_hang=seen.append).start()
    try:
        wd.beat()
        deadline = time.monotonic() + 5.0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            while not seen and time.monotonic() < deadline:
                time.sleep(0.05)
        assert seen and seen[0] >= 0.15 and wd.hangs_detected == 1
        time.sleep(0.3)
        assert wd.hangs_detected == 1    # once per incident
        wd.beat()
        wd.pause()
        time.sleep(0.3)
        assert wd.hangs_detected == 1
    finally:
        wd.stop()
    with pytest.raises(ValueError):
        HangWatchdog(1.0, action="ignore")


def test_fit_warns_on_injected_stall(tmp_path):
    trandom.seed(7)
    m = _lin_model()
    plan = FaultPlan([{"site": "train.step", "kind": "delay", "delay": 0.6,
                       "times": 1, "after": 3}], seed=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        with plan:
            m.fit(_lin_data(16), batch_size=4, epochs=1, shuffle=False,
                  verbose=0,
                  recovery=_policy(str(tmp_path), step_timeout=0.2))
    assert plan.fired[0] == 1
    assert any("step_timeout" in str(w.message) for w in caught)
    assert not [t for t in threading.enumerate() if t.name == "hang-watchdog"]



# ------------------------------------------------------ against the reference
# The same supervised fits through the reference's ``Model.fit(recovery=...)``
# and the port's, from the same weights (carried across by ``layer_from_jax``
# / ``gpt_from_jax``) and the same numpy batches, with dropout off. What the
# supervisor decides must be equal: the anomaly batches, each rollback's
# cursor and skip set, where a SIGTERM lands and whether it saved, and the
# step directories kept. The numbers are held at the float32 tolerances of
# the port's other parity tests (two frameworks, same math, different
# summation orders): losses 1e-5 relative, as ``tests/test_torch_hapi.py``
# holds a History; parameters 1e-4 absolute, as ``tests/test_torch_train.py``
# holds an AdamW trajectory (Adam's m/sqrt(v) magnifies rounding where a
# gradient is near zero). A rollback or resume one step off moves the
# parameters by about the learning rate, 1e-3 or more.
RTOL, PARAM_ATOL = 1e-5, 1e-4


class _JLin(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(4, 8)
        self.drop = jnn.Dropout(0.0)
        self.out = jnn.Linear(8, 1)

    def forward(self, x):
        return self.out(self.drop(self.fc(x)))


class _TLin(_Lin):
    def __init__(self):
        super().__init__()
        self.drop = Dropout(0.0)


_GPT_CFG = dict(num_layers=1, hidden_size=32, num_heads=2, vocab_size=64,
                max_position_embeddings=32, hidden_dropout_prob=0.0,
                attention_dropout_prob=0.0, use_flash_attention=False)
# the learning rates of the reference's own supervisor tests
_LR = dict(mlp=1e-2, gpt=1e-3)


def _jax_net(model):
    pt.seed(0)
    return _JLin() if model == "mlp" else JGPT(jgpt_tiny(**_GPT_CFG))


def _side(port: bool, model: str):
    """One package's pieces for a supervised fit of ``model`` ("mlp" or
    "gpt"): a model maker (each build starts from the reference's seed-0
    weights), the batches, and the package's Callback, FaultPlan,
    RecoveryPolicy and TrainingPreempted."""
    state = {k: np.asarray(v) for k, v in _jax_net(model).state_dict()
             .items()}
    labels = {} if model == "mlp" else {"labels": []}
    arrays = (_lin_data(16).tensors if model == "mlp"
              else _gpt_data(16).tensors)
    if not port:
        def make():
            net = _jax_net(model)
            net.set_state_dict(state)
            m = JModel(net, **labels)
            m.prepare(JAdamW(learning_rate=_LR[model]),
                      loss=_mse if model == "mlp" else None)
            return m
        return dict(make=make, data=JTensorDataset(list(arrays)),
                    Callback=JCallback, FaultPlan=JFaultPlan,
                    Policy=jsup.RecoveryPolicy,
                    Preempted=jsup.TrainingPreempted)

    def make():
        trandom.seed(0)
        net = (layer_from_jax(_TLin(), state) if model == "mlp"
               else gpt_from_jax(state, gpt_tiny(**_GPT_CFG), device="cpu"))
        m = Model(net.train(), **labels)
        m.prepare(AdamW(learning_rate=_LR[model]),
                  loss=_mse if model == "mlp" else None)
        return m
    return dict(make=make, data=TensorDataset(list(arrays)),
                Callback=Callback, FaultPlan=FaultPlan,
                Policy=RecoveryPolicy, Preempted=TrainingPreempted)


def _supervised_fit(side, d, epochs, plan=None, kill_at=None, **policy):
    """One supervised fit; returns what the supervisor decided, the
    History, the per-batch losses, the final parameters as numpy and the
    step directories left in ``d``."""
    seen = dict(anomalies=[], rollbacks=[], preemptions=[], losses=[])

    class Rec(side["Callback"]):
        def on_train_batch_end(self, step, logs=None):
            seen["losses"].append(float(logs["loss"]))
            if kill_at is not None and len(seen["losses"]) == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)

        def on_train_anomaly(self, logs=None):
            seen["anomalies"].append((logs["epoch"], logs["batch_index"]))

        def on_rollback(self, logs=None):
            c = logs["cursor"]
            seen["rollbacks"].append((logs["rollbacks"],
                                      None if c is None else c.as_state(),
                                      [tuple(s) for s in logs["skip"]]))

        def on_preemption(self, logs=None):
            seen["preemptions"].append((logs["global_step"], logs["saved"]))

    m = side["make"]()
    plan = None if plan is None else side["FaultPlan"](plan, seed=0)
    hist = preempted = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if plan is not None:
            plan.install()
        try:
            hist = m.fit(side["data"], batch_size=4, epochs=epochs,
                         shuffle=False, verbose=0, callbacks=[Rec()],
                         recovery=side["Policy"](**dict(
                             dict(checkpoint_dir=d, save_interval_steps=4,
                                  check_interval=2, max_consecutive=2,
                                  async_save=False, grace_seconds=10.0),
                             **policy)))
        except side["Preempted"] as e:
            preempted = (e.global_step, e.saved)
        finally:
            if plan is not None:
                plan.uninstall()
    params = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                            else v, np.float32)
              for k, v in m._train_step.params.items()}
    return dict(seen=seen, history=hist, preempted=preempted, params=params,
                dirs=sorted(os.listdir(d)) if os.path.isdir(d) else [],
                fired=None if plan is None else list(plan.fired))


def _assert_same_run(j, t):
    assert t["seen"]["anomalies"] == j["seen"]["anomalies"]
    assert t["seen"]["rollbacks"] == j["seen"]["rollbacks"]
    assert t["seen"]["preemptions"] == j["seen"]["preemptions"]
    assert t["preempted"] == j["preempted"]
    assert t["dirs"] == j["dirs"]
    assert t["fired"] == j["fired"]
    assert len(t["seen"]["losses"]) == len(j["seen"]["losses"])
    np.testing.assert_allclose(t["seen"]["losses"], j["seen"]["losses"],
                               rtol=RTOL)
    if j["history"] is None:
        assert t["history"] is None
    else:
        assert set(t["history"]) == set(j["history"])
        for k in j["history"]:
            np.testing.assert_allclose(
                np.asarray(t["history"][k], np.float64),
                np.asarray(j["history"][k], np.float64), rtol=RTOL,
                err_msg=k)
    assert t["params"].keys() == j["params"].keys()
    for k in j["params"]:
        np.testing.assert_allclose(t["params"][k], j["params"][k],
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


# (epochs, fault plan, SIGTERM after this many batches, policy)
_SCENARIOS = {
    # two poisoned batches in a row: both skipped, then a rollback to the
    # step_4 snapshot and a clean replay
    "rollback": (2, [{"site": "train.data", "kind": "drop", "times": 2,
                      "after": 5}], None, dict(check_interval=4)),
    # the same, jumping a skip window of two batches after the rollback
    "skip_window": (2, [{"site": "train.data", "kind": "drop", "times": 2,
                         "after": 1}], None,
                    dict(check_interval=1, skip_window=2)),
    # a real SIGTERM after the fifth batch, then a resume in a fresh model
    "sigterm": (2, None, 5, dict(save_interval_steps=3)),
}


@pytest.mark.parametrize("scenario", list(_SCENARIOS))
@pytest.mark.parametrize("model", ["mlp", "gpt_tiny"])
def test_supervised_fit_matches_the_reference(tmp_path, model, scenario):
    epochs, plan, kill_at, policy = _SCENARIOS[scenario]
    runs = {}
    for name, port in (("ref", False), ("port", True)):
        side = _side(port, "mlp" if model == "mlp" else "gpt")
        d = str(tmp_path / name)
        first = _supervised_fit(side, d, epochs, plan=plan, kill_at=kill_at,
                                **policy)
        resumed = (_supervised_fit(side, d, epochs, **policy)
                   if kill_at is not None else None)
        runs[name] = (first, resumed)
    (j, j_resumed), (t, t_resumed) = runs["ref"], runs["port"]
    _assert_same_run(j, t)
    if plan is not None:
        # the scenario did what it is named for
        assert len(j["seen"]["anomalies"]) == 2
        assert len(j["seen"]["rollbacks"]) == 1
    if kill_at is not None:
        assert j["preempted"] is not None and j["preempted"][1]
        _assert_same_run(j_resumed, t_resumed)

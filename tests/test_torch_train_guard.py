"""The port's guarded training step (TrainStep with a GradScaler,
FLAGS_check_nan_inf, inject_anomaly, watchdog_call, grad_transform)
against the JAX package's, on the CPU at ``gpt_tiny``.

The float16 O2 recipe of the chip run (AdamW under warm-up into cosine
decay, a global-norm clip and dynamic loss scaling) runs on both sides
from the same converted weights and token ids. The scaler's decisions
are discrete, so both sides must skip and grow at the same steps, with
the same scale and step count, exactly. Losses: within two float16 ulps
(the two frameworks round float16 sums in different orders). Parameters:
AdamW moves every element by about lr a step whatever its gradient's
size, so an element whose gradient is as small as its rounding error can
step the other way on one side; after n updates two trajectories can
part by 2 n lr plus a float16 ulp, and at most 1 % of the elements may
part by more than lr.

A skipped step must leave the state bit-equal: every parameter, master,
moment and the step count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu.framework import jit as jjit
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.convert import gpt_from_jax
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.framework import jit as tjit
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.optimizer import lr as tlr

NO_DROP = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
LR = 1e-3


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 1024, (2, 24)).astype(
        np.int32)


def _models():
    pt.seed(11)
    jm = JaxGPT(jax_gpt_tiny(**NO_DROP))
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm.train(), gpt_from_jax(state, gpt_tiny(**NO_DROP),
                                    device="cpu").train()


def _recipe(opt_mod, lr_mod, clip_mod):
    return opt_mod.AdamW(
        learning_rate=lr_mod.LinearWarmup(
            lr_mod.CosineAnnealingDecay(LR, T_max=8), 2, 0.0, LR),
        weight_decay=0.01, grad_clip=clip_mod.ClipGradByGlobalNorm(1.0))


# init 2^16 overflows float16 at the first step; growth every 2 good steps
# and a back-off at every overflow make the scale move both ways
SCALER = dict(init_loss_scaling=2.0 ** 16, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)


def _f16_steps(scaler_kw=SCALER):
    jm, tm = _models()
    jm, jopt = jamp.decorate(jm, _recipe(pt.optimizer, jlr, jclip),
                             level="O2", dtype="float16")
    tm, topt = amp.decorate(tm, _recipe(toptim, tlr, tclip), level="O2",
                            dtype="float16")
    js = jjit.TrainStep(jm, jopt, loss_fn=None,
                        scaler=jamp.GradScaler(**scaler_kw))
    ts = tjit.TrainStep(tm, topt, loss_fn=None,
                        scaler=amp.GradScaler(**scaler_kw))
    return js, ts


def _f16_ulp(x):
    e = np.frexp(np.abs(np.asarray(x, np.float64)))[1]
    return np.exp2(np.maximum(e - 11.0, -24.0))


def test_float16_scaled_recipe_matches_jax():
    js, ts = _f16_steps()
    for s in range(8):
        ids = _ids(s)
        lj, lt = float(js((ids, ids))), float(ts((ids, ids)))
        assert abs(lt - lj) <= 2 * _f16_ulp(lj), (s, lt, lj)
        assert float(ts.scaler_state["scale"]) == \
            float(js.scaler_state["scale"]), s
        assert int(ts.opt_state["step"]) == int(js.opt_state["step"]), s
    skipped = ts.scaler.skipped_step_count
    assert skipped == js.scaler.skipped_step_count
    assert ts.scaler.last_overflow_step == js.scaler.last_overflow_step
    assert 0 < skipped < 8  # the run skipped and updated
    updates = int(ts.opt_state["step"])
    parted = total = 0
    for k, p in ts.params.items():
        assert p.dtype == torch.float16
        want = np.asarray(js.params[k], np.float32)
        diff = np.abs(p.detach().float().numpy() - want)
        assert diff.max() <= 2 * updates * LR + _f16_ulp(want).max(), k
        parted += int((diff > LR).sum())
        total += diff.size
        np.testing.assert_allclose(
            ts.opt_state["master_weights"][k].numpy(),
            np.asarray(js.opt_state["master_weights"][k]), rtol=0,
            atol=2 * updates * LR + 1e-6, err_msg=k)
    assert parted <= 1e-2 * total


# ----------------------------------------------------- the classification
def _classify(loss, found, scale, params_finite):
    """The port's scaler_guard and the reference's on the same flags."""
    mine = tjit.scaler_guard(
        torch.tensor(loss, dtype=torch.float32), torch.tensor(found),
        amp.grad_scaler.init_scale_state(scale),
        torch.tensor(params_finite))
    old = (jnp.zeros(2),)
    new = (jnp.array([1.0, 1.0 if params_finite else np.inf]),)
    (sel,), jstate, jok, jfound = jjit.scaler_guard(
        jnp.asarray(loss, jnp.float32), jnp.asarray(found),
        jamp.grad_scaler.init_scale_state(scale), new, old)
    skip, tstate, ok, found_inf = mine
    assert bool(skip) == bool(jnp.all(sel == old[0]))
    assert bool(ok) == bool(jok) and bool(found_inf) == bool(jfound)
    for key in ("scale", "good_steps", "bad_steps"):
        assert float(tstate[key]) == float(jstate[key]), key
    return bool(skip), bool(ok), bool(found_inf)


@pytest.mark.parametrize("case,args,want", [
    ("benign overflow", (2.0, True, 1024.0, False), (True, True, True)),
    ("overflow at scale 1", (2.0, True, 1.0, False), (True, False, False)),
    ("overflow below scale 1", (2.0, True, 0.5, True), (True, False, False)),
    ("non-finite loss", (float("nan"), False, 1024.0, True),
     (True, False, False)),
    ("non-finite loss and grads", (float("inf"), True, 1024.0, False),
     (True, False, False)),
    ("non-finite params, finite grads", (2.0, False, 1024.0, False),
     (True, False, False)),
    ("clean step", (2.0, False, 1024.0, True), (False, True, False)),
])
def test_scaler_guard_classifies_as_jax(case, args, want):
    assert _classify(*args) == want, case


def test_finite_guard_matches_jax():
    g = {"a": torch.ones(2), "b": torch.tensor([1.0, float("nan")])}
    assert not bool(tjit.finite_guard(g, torch.tensor(True)))
    g["b"] = torch.ones(2)
    for pf, extra in ((True, None), (False, None), (True, False)):
        ok = tjit.finite_guard(g, torch.tensor(pf),
                               None if extra is None else torch.tensor(extra))
        jok, _ = jjit.finite_guard(
            {k: jnp.asarray(v.numpy()) for k, v in g.items()},
            ((jnp.ones(2) if pf else jnp.array([np.nan, 1.0])),),
            ((jnp.zeros(2),)), None if extra is None else jnp.asarray(extra))
        assert bool(ok) == bool(jok)
    with pytest.raises(FloatingPointError):
        tjit.raise_if_bad_step(torch.tensor(False), torch.tensor(1.0))
    tjit.raise_if_bad_step(torch.tensor(True), torch.tensor(1.0))


# ---------------------------------------------- anomaly and NaN checks
def _snapshot(step):
    def snap(tree):
        if isinstance(tree, dict):
            return {k: snap(v) for k, v in tree.items()}
        return tree.detach().clone() if isinstance(tree, torch.Tensor) \
            else tree
    return snap({"params": step.params, "opt": step.opt_state})


def _bit_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bit_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_injected_anomaly_keeps_the_state_and_the_scale():
    """After two steps, a poisoned batch (inject_anomaly) through
    watchdog_call: ok is False, the state bit-equal, the scale not backed
    off (an anomaly is not an overflow). The next step updates."""
    _, ts = _f16_steps(dict(init_loss_scaling=256.0))
    for s in range(2):
        ts((_ids(s), _ids(s)))
    before = _snapshot(ts)
    scale = ts.scaler_state["scale"].clone()
    bad_steps = int(ts.scaler_state["bad_steps"])
    ts.inject_anomaly()
    loss, ok, found = ts.watchdog_call((_ids(2), _ids(2)))
    assert not np.isfinite(float(loss))
    assert not bool(ok) and not bool(found)
    assert _bit_equal(_snapshot(ts), before)
    assert torch.equal(ts.scaler_state["scale"], scale)
    assert int(ts.scaler_state["bad_steps"]) == bad_steps
    assert ts.scaler.skipped_step_count == 0
    loss, ok, found = ts.watchdog_call((_ids(3), _ids(3)))
    assert bool(ok) and np.isfinite(float(loss))
    assert int(ts.opt_state["step"]) == int(before["opt"]["step"]) + 1
    assert not torch.equal(ts.params["gpt.ln_f.weight"],
                           before["params"]["gpt.ln_f.weight"])


@pytest.mark.parametrize("scaled", [False, True])
def test_check_nan_inf_raises_and_keeps_the_state(scaled):
    """FLAGS_check_nan_inf: a poisoned step raises FloatingPointError
    with the state bit-equal; a clean step then trains, and without a
    scaler its update is the unguarded one bit for bit."""
    _, tm = _models()
    kw = dict(scaler=amp.GradScaler(init_loss_scaling=256.0)) \
        if scaled else {}
    step = tjit.TrainStep(tm, AdamW(learning_rate=LR), loss_fn=None, **kw)
    _, tm2 = _models()
    plain = tjit.TrainStep(tm2, AdamW(learning_rate=LR), loss_fn=None)
    flags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        assert flags.get_flags("FLAGS_check_nan_inf") == {
            "FLAGS_check_nan_inf": True}
        step((_ids(0), _ids(0)))
        before = _snapshot(step)
        step.inject_anomaly()
        with pytest.raises(FloatingPointError):
            step((_ids(1), _ids(1)))
        assert _bit_equal(_snapshot(step), before)
        step((_ids(2), _ids(2)))
    finally:
        flags.set_flags({"FLAGS_check_nan_inf": False})
    assert int(step.opt_state["step"]) == 2
    if not scaled:
        plain((_ids(0), _ids(0)))
        plain((_ids(2), _ids(2)))
        assert _bit_equal(_snapshot(step), _snapshot(plain))
    with pytest.raises(ValueError):
        flags.set_flags({"FLAGS_no_such_flag": 1})


def test_grad_transform_matches_jax():
    """A gradient transform (here a scale by 1/2) before an SGD update:
    the float32 trajectory at the training tests' tolerances."""
    jm, tm = _models()

    def half(g):
        return {k: v * 0.5 for k, v in g.items()}

    js = jjit.TrainStep(jm, JaxSGD(learning_rate=0.1), loss_fn=None,
                        grad_transform=half)
    ts = tjit.TrainStep(tm, SGD(learning_rate=0.1), loss_fn=None,
                        grad_transform=half)
    for s in range(3):
        lj, lt = float(js((_ids(s), _ids(s)))), float(ts((_ids(s), _ids(s))))
        assert lt == pytest.approx(lj, rel=1e-5)
    for k in js.params:
        np.testing.assert_allclose(ts.params[k].detach().numpy(),
                                   np.asarray(js.params[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_state_dict_round_trip_carries_the_scaler_state():
    _, a = _f16_steps()
    for s in range(3):
        a((_ids(s), _ids(s)))
    sd = a.state_dict()
    assert set(sd["scaler_state"]) >= {"scale", "good_steps", "bad_steps"}
    want = float(a((_ids(3), _ids(3))))
    want_scale = float(a.scaler_state["scale"])
    _, b = _f16_steps(dict(init_loss_scaling=4.0))
    b.set_state_dict(sd)
    assert float(b.scaler_state["scale"]) == float(sd["scaler_state"]["scale"])
    assert b.scaler.get_loss_scaling() == float(sd["scaler_state"]["scale"])
    assert float(b((_ids(3), _ids(3)))) == want
    assert float(b.scaler_state["scale"]) == want_scale


def test_scaler_refuses_gradient_merge():
    _, tm = _models()
    with pytest.raises(ValueError, match="grad_accum"):
        tjit.TrainStep(tm, AdamW(), loss_fn=None, grad_accum_steps=2,
                       scaler=amp.GradScaler())

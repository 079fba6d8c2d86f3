"""The port's optimizers, gradient clips and scheduled learning rates
(paddle_tpu_torch.optimizer, paddle_tpu_torch.nn.clip) against the JAX
package's, on the same seeded numpy parameters and gradients.

Each optimizer takes three steps through the pure ``init``/``update``
pair on both sides. float32: parameters and every slot within rtol 1e-5,
atol 1e-6 (the same float32 formulas; the two sides round sums and
fused multiply-adds in different orders, a few ulps a step). bf16
parameters with float32 master weights (O2): the masters at the float32
tolerance, and each bf16 parameter equal to its master rounded, so within
one bf16 ulp of the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework.debugging import tree_all_finite
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"w1": (8, 12), "b1": (12,), "ln.weight": (12,), "w2": (12, 5)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step, scale=1.0):
    rng = np.random.default_rng(100 + step)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _no_bias(name):
    return not name.startswith("b")


# (class name, keyword arguments) -- each optimizer of the reference, with
# its options switched on where it has some
CASES = {
    "SGD": dict(learning_rate=0.1, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.1, momentum=0.8, weight_decay=0.02),
    "Momentum_nesterov": dict(learning_rate=0.1, momentum=0.9,
                              use_nesterov=True),
    "Adam": dict(learning_rate=0.01, weight_decay=0.01),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.05,
                  apply_decay_param_fun=_no_bias),
    "Adagrad": dict(learning_rate=0.1, initial_accumulator_value=0.1,
                    weight_decay=0.01),
    "RMSProp": dict(learning_rate=0.01, momentum=0.5),
    "RMSProp_centered": dict(learning_rate=0.01, momentum=0.5,
                             centered=True),
    "Adadelta": dict(learning_rate=1.0, rho=0.9),
    "Adamax": dict(learning_rate=0.01, weight_decay=0.01),
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.02,
                 exclude_from_weight_decay_fn=lambda n: "ln" in n),
    "LarsMomentum": dict(learning_rate=0.1, lars_coeff=0.01,
                         exclude_from_weight_decay=["ln"]),
    "DGCMomentum": dict(learning_rate=0.1, rampup_begin_step=1,
                        rampup_step=2, sparsity=(0.5, 0.75)),
}


def _pair(name, master=False):
    kw = CASES[name]
    cls = name.split("_")[0]
    mine, ref = getattr(topt, cls)(**kw), getattr(jopt, cls)(**kw)
    if master:
        mine.multi_precision = ref.multi_precision = True
    return mine, ref


def _run(name, master=False, steps=3):
    """Three updates on both sides: ``(mine_params, mine_state,
    ref_params, ref_state)``."""
    mine, ref = _pair(name, master)
    dtype = torch.bfloat16 if master else torch.float32
    jdtype = jnp.bfloat16 if master else jnp.float32
    p_np = _params()
    tp = {k: torch.tensor(v).to(dtype) for k, v in p_np.items()}
    jp = {k: jnp.asarray(v).astype(jdtype) for k, v in p_np.items()}
    ts, js = mine.init(tp), ref.init(jp)
    for i in range(steps):
        g = _grads(i)
        tp, ts = mine.update({k: torch.tensor(v).to(dtype)
                              for k, v in g.items()}, ts, tp)
        jp, js = ref.update({k: jnp.asarray(v).astype(jdtype)
                             for k, v in g.items()}, js, jp)
    return tp, ts, jp, js


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_every_optimizer_is_covered():
    names = {"SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
             "Adadelta", "Adamax", "Lamb", "LarsMomentum", "DGCMomentum"}
    assert {c.split("_")[0] for c in CASES} == names
    assert names | {"Optimizer"} <= set(topt.__all__)


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_steps_match_jax_in_float32(name):
    tp, ts, jp, js = _run(name)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in SHAPES:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL,
                                   err_msg=k)
    slots = [s for s in js if s not in ("step",)]
    assert sorted(slots) == sorted(s for s in ts if s != "step")
    for s in slots:
        for k in SHAPES:
            np.testing.assert_allclose(_np(ts[s][k]), _np(js[s][k]), **TOL,
                                       err_msg=f"{s}/{k}")


def _bf16_ulp(x):
    e = np.frexp(np.abs(x))[1]
    return np.where(x == 0, 0.0, np.exp2(e - 8.0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_steps_match_jax_with_bf16_master_weights(name):
    tp, ts, jp, js = _run(name, master=True)
    for k in SHAPES:
        assert tp[k].dtype == torch.bfloat16
        master = ts["master_weights"][k]
        assert master.dtype == torch.float32
        np.testing.assert_allclose(_np(master),
                                   _np(js["master_weights"][k]), **TOL,
                                   err_msg=k)
        # the bf16 parameter is its master, rounded
        assert torch.equal(tp[k], master.to(torch.bfloat16))
        want = _np(jp[k])
        assert np.all(np.abs(_np(tp[k]) - want) <= _bf16_ulp(want)), k


# ------------------------------------------------------------ clips
def _clip_grads():
    g = _grads(0, scale=3.0)
    t = {k: torch.tensor(v) for k, v in g.items()}
    j = {k: jnp.asarray(v) for k, v in g.items()}
    t["w2"], j["w2"] = t["w2"].to(torch.bfloat16), j["w2"].astype(
        jnp.bfloat16)
    return t, j


@pytest.mark.parametrize("make", [
    lambda m: m.ClipGradByValue(0.5),
    lambda m: m.ClipGradByValue(0.7, min=-0.2),
    lambda m: m.ClipGradByNorm(1.5),
    lambda m: m.ClipGradByGlobalNorm(2.0),
    lambda m: m.ClipGradByGlobalNorm(1e4)])
def test_clip_classes_match_jax(make):
    """Each clip on float32 and bf16 gradients: the result in each
    gradient's dtype, float32 norms, the reference's values."""
    t, j = _clip_grads()
    got, want = make(tclip)(t), make(jclip)(j)
    for k in SHAPES:
        assert got[k].dtype == t[k].dtype
        tol = TOL if t[k].dtype == torch.float32 else dict(rtol=8e-3, atol=0)
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **tol,
                                   err_msg=k)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    t, j = _clip_grads()
    got, total = tclip.clip_grad_norm_(t, 1.0, norm_type)
    want, jtotal = jclip.clip_grad_norm_(j, 1.0, norm_type)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k in SHAPES:
        assert got[k].dtype == t[k].dtype
        tol = TOL if t[k].dtype == torch.float32 else dict(rtol=8e-3, atol=0)
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **tol,
                                   err_msg=k)


def test_global_norm_clip_keeps_none():
    g = {"a": torch.ones(3), "b": None}
    out = tclip.ClipGradByGlobalNorm(1.0)(g)
    assert out["b"] is None
    torch.testing.assert_close(out["a"], torch.full((3,), 3 ** -0.5))


# ------------------------------------------------- schedules and clip
def _recipe(mod, lr_mod, clip_mod):
    return mod.AdamW(learning_rate=lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(1e-2, T_max=4), 2, 0.0, 1e-2),
        weight_decay=0.01, grad_clip=clip_mod.ClipGradByGlobalNorm(1.0))


def test_scheduled_clipped_adamw_matches_jax():
    """The pretraining recipe, warm-up into cosine decay with a global
    norm clip, over 8 steps: the learning rate is read at the optimizer's
    own step count on both sides."""
    mine, ref = _recipe(topt, tlr, tclip), _recipe(jopt, jlr, jclip)
    p = _params()
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ts, js = mine.init(tp), ref.init(jp)
    for i in range(8):
        g = _grads(i, scale=5.0)
        tp, ts = mine.update({k: torch.tensor(v) for k, v in g.items()},
                             ts, tp)
        jp, js = ref.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        for k in SHAPES:
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **TOL,
                                       err_msg=f"step {i} {k}")


def test_lr_window_refreshes_and_follows_a_loaded_state():
    """The scheduled rate is looked up on the device from a table of
    LR_WINDOW steps: a window of 2 forces refreshes, and a step count
    loaded into the state (in place) is followed, not the cached one."""
    mine = _recipe(topt, tlr, tclip)
    mine.LR_WINDOW = 2
    sched = mine._learning_rate
    tp = {k: torch.tensor(v) for k, v in _params().items()}
    ts = mine.init(tp)
    for i in range(5):
        count = int(ts["step"])
        assert float(mine._lr_at(ts["step"])) == \
            float(sched.value_at(count + 1))
        mine._lr_window["used"] -= 1  # the probe above is not an update
        mine.update({k: torch.tensor(v) for k, v in
                     _grads(i).items()}, ts, tp)
    assert int(ts["step"]) == 5
    ts["step"].copy_(torch.tensor(1))
    assert float(mine._lr_at(ts["step"])) == float(sched.value_at(2))


def test_state_dict_carries_the_scheduler():
    mine, ref = _recipe(topt, tlr, tclip), _recipe(jopt, jlr, jclip)
    for opt, lib in ((mine, torch), (ref, jnp)):
        opt.bind({k: lib.asarray(v) if lib is jnp else torch.tensor(v)
                  for k, v in _params().items()})
    for _ in range(3):
        mine._learning_rate.step()
        ref._learning_rate.step()
    sd, jsd = mine.state_dict(), ref.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == \
        jsd["LR_Scheduler"]["last_epoch"] == 3
    assert sd["LR_Scheduler"]["last_lr"] == pytest.approx(
        jsd["LR_Scheduler"]["last_lr"], rel=1e-6)
    fresh = _recipe(topt, tlr, tclip)
    fresh.set_state_dict(sd)
    assert fresh._learning_rate.last_epoch == 3
    assert fresh.get_lr() == mine.get_lr()
    assert fresh._state is sd["state"]


def test_stateful_step_matches_the_pure_update():
    """``bind``/``step``/``clear_grad`` over the pure pair."""
    a, b = topt.Momentum(0.1), topt.Momentum(0.1)
    pa = {k: torch.tensor(v) for k, v in _params().items()}
    pb = {k: v.clone() for k, v in pa.items()}
    a.bind(pa)
    sb = b.init(pb)
    for i in range(2):
        g = {k: torch.tensor(v) for k, v in _grads(i).items()}
        a.step(grads=g)
        a.clear_grad()
        b.update(g, sb, pb)
    for k in SHAPES:
        assert torch.equal(pa[k], pb[k])


# ------------------------------------------------------- guarded update
@pytest.mark.parametrize("name", ["AdamW", "Lamb", "DGCMomentum"])
@pytest.mark.parametrize("chunk", [1 << 27, 50])
def test_guarded_update_commits_or_keeps_every_bit(name, chunk):
    """``update(guard=...)``: a guard that skips leaves every parameter,
    master, slot and the step count bit-equal; one that commits gives the
    unguarded update bit for bit; the guard sees whether the candidate
    parameters are finite. A chunk of 50 elements splits the parameters
    into groups."""
    def fresh():
        opt, _ = _pair(name, master=True)
        opt.GUARD_CHUNK_NUMEL = chunk
        p = {k: torch.tensor(v).to(torch.bfloat16)
             for k, v in _params().items()}
        return opt, p, opt.init(p)

    def snap(tree):
        return {k: snap(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}

    g = {k: torch.tensor(v).to(torch.bfloat16)
         for k, v in _grads(0).items()}
    opt, p, s = fresh()
    opt.update(g, s, p)  # one committed step first: non-zero slots
    before_p, before_s = snap(p), snap(s)
    seen = []
    opt.update(g, s, p, guard=lambda ok: seen.append(ok) or torch.tensor(True))
    assert len(seen) == 1 and bool(seen[0])
    for k in SHAPES:
        assert torch.equal(p[k], before_p[k])
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(s), _leaves(before_s)))
    # commit: equal to the unguarded update of an identical run
    opt.update(g, s, p, guard=lambda ok: torch.tensor(False))
    opt2, p2, s2 = fresh()
    opt2.update(g, s2, p2)
    opt2.update(g, s2, p2)
    for k in SHAPES:
        assert torch.equal(p[k], p2[k])
    assert all(torch.equal(a, b) for a, b in zip(_leaves(s), _leaves(s2)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_guard_sees_non_finite_candidates_in_the_cast_parameters():
    """The candidate check reads the parameters as cast to their dtype: a
    float16 parameter whose float32 master steps past 65504 is
    non-finite there, although the master is finite."""
    opt = topt.SGD(learning_rate=1.0)
    opt.multi_precision = True
    p = {"w": torch.tensor([60000.0, 1.0], dtype=torch.float16)}
    s = opt.init(p)
    seen = []
    opt.update({"w": torch.tensor([-10000.0, 0.0], dtype=torch.float16)}, s,
               p, guard=lambda ok: seen.append(ok) or ~ok)
    assert not bool(seen[0])
    assert bool(tree_all_finite(s["master_weights"]))
    assert p["w"].tolist() == [60000.0, 1.0] and int(s["step"]) == 0

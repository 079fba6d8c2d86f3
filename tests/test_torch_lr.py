"""The port's learning-rate schedulers (paddle_tpu_torch.optimizer.lr)
against the JAX package's, on the same arguments.

Every scheduler's pure ``value_at(step)`` and its stateful ``step()`` over
steps 0..50. Tolerance rtol 1e-6: both sides compute in float32 (the
reference through ``jnp.asarray(step, jnp.float32)``, the port with numpy
float32 scalars), so the values agree up to the last bits of float32
transcendental functions (pow, exp, cos), a few ulps.
"""
import numpy as np
import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = range(51)


def _decay(s):
    return 0.95 ** s


def _mult(s):
    return 0.9 if s % 3 else 1.0


CASES = {
    "ConstantLR": ((), dict(learning_rate=0.05)),
    "NoamDecay": ((), dict(d_model=512, warmup_steps=10, learning_rate=2.0)),
    "ExponentialDecay": ((), dict(learning_rate=0.1, gamma=0.93)),
    "NaturalExpDecay": ((), dict(learning_rate=0.1, gamma=0.07)),
    "InverseTimeDecay": ((), dict(learning_rate=0.1, gamma=0.3)),
    "PolynomialDecay": ((), dict(learning_rate=0.1, decay_steps=20,
                                 end_lr=1e-3, power=2.0)),
    "PolynomialDecay_cycle": ((), dict(learning_rate=0.1, decay_steps=7,
                                       end_lr=1e-3, power=1.5, cycle=True)),
    "LinearWarmup": ((), dict(learning_rate=0.1, warmup_steps=9,
                              start_lr=0.0, end_lr=0.1)),
    "PiecewiseDecay": ((), dict(boundaries=[5, 17, 30],
                                values=[0.1, 0.05, 0.01, 0.001])),
    "CosineAnnealingDecay": ((), dict(learning_rate=0.1, T_max=37,
                                      eta_min=1e-4)),
    "StepDecay": ((), dict(learning_rate=0.1, step_size=6, gamma=0.7)),
    "MultiStepDecay": ((), dict(learning_rate=0.1, milestones=[4, 11, 40],
                                gamma=0.3)),
    "LambdaDecay": ((), dict(learning_rate=0.1, lr_lambda=_decay)),
    "MultiplicativeDecay": ((), dict(learning_rate=0.1, lr_lambda=_mult)),
    "OneCycleLR": ((), dict(max_learning_rate=0.1, total_steps=40)),
    "CyclicLR": ((), dict(base_learning_rate=0.01, max_learning_rate=0.1,
                          step_size_up=6, step_size_down=4)),
    "CyclicLR_triangular2": ((), dict(base_learning_rate=0.01,
                                      max_learning_rate=0.1, step_size_up=5,
                                      mode="triangular2")),
    "CyclicLR_exp_range": ((), dict(base_learning_rate=0.01,
                                    max_learning_rate=0.1, step_size_up=5,
                                    mode="exp_range", gamma=0.97)),
}


def _pair(name):
    args, kw = CASES[name]
    cls = name.split("_")[0]
    return getattr(tlr, cls)(*args, **kw), getattr(jlr, cls)(*args, **kw)


def test_every_scheduler_is_covered():
    """All 16 schedulers of the reference (and the base) exist in the
    port; each but ReduceOnPlateau has a case here (it has its own)."""
    names = {n for n in dir(jlr) if isinstance(getattr(jlr, n), type)
             and issubclass(getattr(jlr, n), jlr.LRScheduler)}
    assert len(names) == 17
    assert names == {n for n in tlr.__all__}
    assert {c.split("_")[0] for c in CASES} == names - {"LRScheduler",
                                                        "ReduceOnPlateau"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_value_at_matches_jax(name):
    mine, ref = _pair(name)
    got = [mine.value_at(s) for s in STEPS]
    assert all(isinstance(v, np.float32) for v in got)
    want = [np.float32(ref.value_at(s)) for s in STEPS]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stateful_step_matches_jax(name):
    mine, ref = _pair(name)
    assert mine.get_lr() == pytest.approx(ref.get_lr(), rel=1e-6)
    got, want = [], []
    for _ in STEPS:
        got.append(mine.step())
        want.append(ref.step())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert mine.last_epoch == ref.last_epoch == 51
    # an explicit epoch, and the state dict's round trip
    assert mine.step(epoch=7) == pytest.approx(ref.step(epoch=7), rel=1e-6)
    sd = mine.state_dict()
    assert sd == {"last_epoch": 7, "last_lr": mine.get_lr()}
    other, _ = _pair(name)
    other.set_state_dict(sd)
    assert other.last_epoch == 7 and other.get_lr() == mine.get_lr()


def test_linear_warmup_over_a_scheduler_matches_jax():
    """Warm-up into cosine decay, the pretraining recipe: value_at reads
    the inner scheduler at the step after the warm-up."""
    mine = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-4, T_max=8), 2, 0.0,
                            1e-4)
    ref = jlr.LinearWarmup(jlr.CosineAnnealingDecay(1e-4, T_max=8), 2, 0.0,
                           1e-4)
    np.testing.assert_allclose([mine.value_at(s) for s in STEPS],
                               [np.float32(ref.value_at(s)) for s in STEPS],
                               rtol=1e-6, atol=0)
    assert mine.value_at(0) == 0.0 and mine.value_at(2) == np.float32(1e-4)


@pytest.mark.parametrize("kw", [
    dict(mode="min", factor=0.5, patience=2),
    dict(mode="max", factor=0.3, patience=1, cooldown=2, min_lr=1e-3),
    dict(mode="min", factor=0.1, patience=0, threshold=0.5,
         threshold_mode="abs")])
def test_reduce_on_plateau_matches_jax(kw):
    """A fixed metric sequence that improves, stalls, and improves again:
    the same reductions, cooldowns and floors on both sides, the same
    ``value_at`` at any step."""
    metrics = [5.0, 4.0, 4.0, 4.1, 3.99, 3.99, 3.99, 3.0, 3.5, 3.5, 3.5,
               3.5, 2.0, 2.2, 2.1, 2.3, 2.4, 2.5, 1.0, 1.0]
    mine = tlr.ReduceOnPlateau(0.1, **kw)
    ref = jlr.ReduceOnPlateau(0.1, **kw)
    assert mine.step() == ref.step() == 0.1  # no metric: no change
    got = [mine.step(m) for m in metrics]
    want = [ref.step(m) for m in metrics]
    assert got == want
    assert len(set(got)) > 1  # the sequence did reduce the rate
    assert mine.value_at(123) == np.float32(ref.value_at(123))
    assert (mine.num_bad_epochs, mine.cooldown_counter, mine.best) == \
        (ref.num_bad_epochs, ref.cooldown_counter, ref.best)

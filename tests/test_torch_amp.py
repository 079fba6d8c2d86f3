"""The port's mixed precision (paddle_tpu_torch.amp) against the JAX
package's: the loss-scale schedule, unscaling, O1 autocast and
``decorate``'s signature.

The scale schedule is exact arithmetic on both sides (a float32 scale
multiplied by powers of two, integer counters), so it is held equal bit
for bit. Unscaled gradients are float32 on both sides and equal exactly:
one float32 product of a float16 value and ``1 / scale``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu.amp import grad_scaler as jgs
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import amp
from paddle_tpu_torch.amp import grad_scaler as tgs
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW


def _flags(seed, n, p):
    return [bool(x) for x in np.random.default_rng(seed).random(n) < p]


@pytest.mark.parametrize("kw,flags", [
    # grow: 3 good steps in a row double the scale
    (dict(init_loss_scaling=8.0, incr_every_n_steps=3),
     [False] * 10),
    # back off: every second overflow in a row halves it, floored at 1
    (dict(init_loss_scaling=8.0, decr_every_n_nan_or_inf=2),
     [True] * 12),
    (dict(init_loss_scaling=3.0, decr_ratio=0.25,
          decr_every_n_nan_or_inf=1), [True] * 5),
    # a mixed sequence
    (dict(init_loss_scaling=2.0 ** 15, incr_every_n_steps=4,
          decr_every_n_nan_or_inf=2), _flags(3, 60, 0.3)),
])
def test_update_scale_equals_jax_exactly(kw, flags):
    mine, ref = tgs.init_scale_state(**kw), jgs.init_scale_state(**kw)
    scales = [float(mine["scale"])]
    for found in flags:
        mine = tgs.update_scale(mine, torch.tensor(found))
        ref = jgs.update_scale(ref, jnp.asarray(found))
        for key in ("scale", "good_steps", "bad_steps"):
            assert float(mine[key]) == float(ref[key]), key
        assert mine["scale"].dtype == torch.float32
        scales.append(float(mine["scale"]))
    assert min(scales) >= 1.0
    assert len(set(scales)) > 1  # the schedule moved


def test_update_scale_takes_host_flags():
    """The schedule replays on the host from a run's printed flags."""
    s = tgs.init_scale_state(init_loss_scaling=4.0,
                             decr_every_n_nan_or_inf=1)
    s = tgs.update_scale(s, True)
    assert float(s["scale"]) == 2.0 and int(s["bad_steps"]) == 0


def test_unscale_and_check_gives_float32_like_jax():
    """float16 gradients unscaled to float32: a value below float16's
    range after unscaling keeps its float32 value (in float16 it would
    flush to zero), and an inf in any gradient flags the step."""
    rng = np.random.default_rng(0)
    g = {"a": (rng.standard_normal((4, 6)) * 1e-3).astype(np.float16),
         "b": np.array([3e-4, -2e-4, 1.0], np.float16),
         "c": rng.standard_normal(5).astype(np.float32)}
    state = dict(scale=2.0 ** 15)
    mine, found = tgs.unscale_and_check(
        {k: torch.tensor(v) for k, v in g.items()},
        tgs.init_scale_state(state["scale"]))
    ref, jfound = jgs.unscale_and_check(
        {k: jnp.asarray(v) for k, v in g.items()},
        jgs.init_scale_state(state["scale"]))
    assert not bool(found) and not bool(jfound)
    for k in g:
        assert mine[k].dtype == torch.float32
        assert np.asarray(ref[k]).dtype == np.float32
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]))
    # 3e-4 / 2^15 is about 9e-9: float16's smallest subnormal is 6e-8
    assert 0 < abs(float(mine["b"][0])) < 6e-8
    g["a"][1, 2] = np.inf
    _, found = tgs.unscale_and_check(
        {k: torch.tensor(v) for k, v in g.items()}, tgs.init_scale_state())
    assert bool(found)


def test_grad_scaler_step_skips_on_overflow_and_counts_lazily():
    scaler = amp.GradScaler(init_loss_scaling=4.0, decr_every_n_nan_or_inf=1)
    opt = AdamW(learning_rate=0.1)
    p = {"w": torch.ones(3)}
    opt.bind(p)
    assert float(scaler.scale(torch.tensor(2.0))) == 8.0
    scaler.step(opt, p, {"w": torch.tensor([4.0, 4.0, 4.0])})
    moved = p["w"].clone()
    assert not torch.equal(moved, torch.ones(3))
    scaler.step(opt, p, {"w": torch.tensor([float("inf"), 1.0, 1.0])})
    assert torch.equal(p["w"], moved)  # parameters kept on overflow
    assert len(scaler._pending) == 2  # not read back yet
    assert scaler.skipped_step_count == 1 and scaler.last_overflow_step == 2
    assert scaler._pending == [] and scaler.get_loss_scaling() == 2.0
    sd = scaler.state_dict()
    other = amp.AmpScaler()
    other.set_state_dict(sd)
    assert other.get_loss_scaling() == 2.0
    off = amp.GradScaler(enable=False)
    assert not off.is_enable()
    loss = torch.tensor(3.0)
    assert off.scale(loss) is loss


# ------------------------------------------------------------ O1
def test_auto_cast_casts_linear_as_jax_does():
    """Under auto_cast, F.linear runs in the autocast dtype (white list),
    on both sides; outside it, in the inputs' dtype."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    tx, tw, tb = (torch.tensor(a) for a in (x, w, b))
    for dtype, tdt in (("bfloat16", torch.bfloat16),
                       ("float16", torch.float16)):
        assert not amp.is_autocast_enabled()
        with amp.auto_cast(dtype=dtype):
            assert amp.is_autocast_enabled()
            assert amp.get_autocast_dtype() == tdt
            got = F.linear(tx, tw, tb)
        with jamp.auto_cast(dtype=dtype):
            want = JF.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        assert got.dtype == tdt and str(want.dtype) == dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2e-2, atol=2e-2)
    assert F.linear(tx, tw, tb).dtype == torch.float32
    with amp.amp_guard(enable=False):
        assert F.linear(tx, tw).dtype == torch.float32


def test_autocast_call_lists_match_jax():
    # the modules (the packages export functions of the same name)
    jac = importlib.import_module("paddle_tpu.amp.auto_cast")
    tac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

    assert tac.WHITE_OPS == jac.WHITE_OPS and tac.BLACK_OPS == jac.BLACK_OPS
    h = torch.ones(2, dtype=torch.bfloat16)
    i = torch.ones(2, dtype=torch.int64)
    with amp.auto_cast(dtype="float16"):
        a, n, k = tac.autocast_call("softmax", h, None, i)
        assert a.dtype == torch.float32 and n is None and k is i
        (same,) = tac.autocast_call("gelu", h)
        assert same is h
        (c,) = tac.autocast_call("matmul", h)
        assert c.dtype == torch.float16


# ------------------------------------------------------------ decorate
@pytest.mark.parametrize("kw", [
    dict(level="O2", dtype="bfloat16"),
    dict(level="O1", dtype="float16"),
    dict(level="O2", dtype="float16", save_dtype="float32"),
    dict(level="O1", dtype="bfloat16", save_dtype="float32",
         master_weight=False),
])
def test_decorate_takes_the_calls_jax_takes(kw):
    """The same arguments on both packages: every floating parameter cast
    to ``dtype`` whatever ``level`` (the reference never reads it),
    ``save_dtype`` accepted and ignored, master weights unless
    ``master_weight=False``."""
    jm = JaxGPT(jax_gpt_tiny())
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    jm, jo = jamp.decorate(jm, JaxAdamW(1e-3), **kw)
    tm, to = amp.decorate(tm, AdamW(1e-3), **kw)
    want = {str(v.dtype) for v in jm.state_dict().values()}
    got = {str(p.dtype).replace("torch.", "") for p in tm.parameters()}
    assert got == want == {kw["dtype"]}
    assert to.multi_precision == jo.multi_precision == (
        kw.get("master_weight") is not False)
    assert amp.decorate(tm, level="O1") is tm

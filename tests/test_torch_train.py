"""The port's training path (GPT loss, recompute, AdamW, O2, TrainStep)
against the JAX package's, on the CPU at ``gpt_tiny``.

A seeded JAX model is converted by name with ``gpt_from_jax``; the same
numpy token ids go through both. Dropout is 0 where the two sides are
compared (jax.random and the port's streams draw different masks); the
port's own dropout invariants (recompute replay, resume replay) are tested
on the port alone.

Tolerances, float32: the loss 1e-5 relative and the logits 1e-4 absolute
(two frameworks, same math, different summation orders); gradients 2e-4
relative to each tensor's largest magnitude; AdamW trajectories 1e-5
relative on the losses and 1e-4 absolute on the parameters after 5 steps:
Adam divides each gradient element by its own running RMS, so an element
whose gradient is as small as its float32 rounding error takes a
different step on the two sides; 1e-4 is a tenth of one step's size
(lr 1e-3), and the losses hold the trajectory as a whole.
bfloat16 (O2): losses within 2e-2 relative. bf16 sums round differently
on the two sides, which can flip a small gradient's sign, and Adam then
steps that element by lr the other way: after 3 steps two trajectories
can part by 2 * 3 * lr plus a bf16 ulp, so every parameter is held within
7e-3 and at most 1 % of the model's elements may part by more than
one lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu.framework.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_flops_per_token as jax_flops
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import functional_call, param_state
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import gpt_from_jax
from paddle_tpu_torch.distributed.parallel.recompute import recompute_wrap
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.framework.jit import EvalStep, TrainStep
from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_flops_per_token,
                                         gpt_loss_fn, gpt_tiny)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import rng_context
from paddle_tpu_torch.optimizer import AdamW

NO_DROP = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _jax_model(**kw):
    pt.seed(11)
    return JaxGPT(jax_gpt_tiny(**{**NO_DROP, **kw}))


def _pair(**kw):
    jm = _jax_model(**kw)
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = gpt_from_jax(state, gpt_tiny(**{**NO_DROP, **kw}), device="cpu")
    return jm.train(), tm.train()


def _ids(shape=(2, 24), seed=0):
    return np.random.default_rng(seed).integers(0, 1024, shape).astype(np.int32)


def _jax_loss_and_grads(jm, ids):
    def loss(p):
        out, _ = functional_call(jm, p, None, jnp.asarray(ids),
                                 jnp.asarray(ids))
        return out

    value, grads = jax.value_and_grad(loss)(param_state(jm))
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


def _torch_loss_and_grads(tm, ids):
    tm.zero_grad(set_to_none=True)
    t = torch.as_tensor(ids, dtype=torch.long)
    loss = tm(t, t)
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy()
                                  for k, p in tm.named_parameters()}


def test_train_mode_logits_match_jax():
    jm, tm = _pair()
    ids = _ids()
    lj = np.asarray(jm(jnp.asarray(ids)))
    with torch.no_grad():
        lt = tm(torch.as_tensor(ids, dtype=torch.long)).numpy()
    np.testing.assert_allclose(lt, lj, atol=1e-4, rtol=0)


@pytest.mark.parametrize("loss_chunk", [0, 8, 7])
def test_loss_and_every_grad_match_jax(loss_chunk):
    """The plain loss and the chunked loss (8 divides L-1 = 23 unevenly,
    as does 7), and the gradient of every parameter."""
    jm, tm = _pair(loss_chunk=loss_chunk)
    ids = _ids()
    lj, gj = _jax_loss_and_grads(jm, ids)
    lt, gt = _torch_loss_and_grads(tm, ids)
    assert lt == pytest.approx(lj, rel=1e-5)
    assert set(gt) == set(gj) and len(gt) == 28
    for k in gj:
        scale = np.abs(gj[k]).max()
        np.testing.assert_allclose(gt[k], gj[k], rtol=0, atol=2e-4 * scale,
                                   err_msg=k)


def test_loss_and_every_grad_match_jax_at_head_dim_256():
    """Two heads of 256 (hidden 512, 2 layers): the head dim of the float32
    D = 256 backward kernels, whose plain path this is on the CPU; the loss
    and every gradient at the tolerance of the test above."""
    jm, tm = _pair(hidden_size=512, num_heads=2)
    assert tm.cfg.hidden_size // tm.cfg.num_heads == 256
    ids = _ids()
    lj, gj = _jax_loss_and_grads(jm, ids)
    lt, gt = _torch_loss_and_grads(tm, ids)
    assert lt == pytest.approx(lj, rel=1e-5)
    assert set(gt) == set(gj) and len(gt) == 28
    for k in gj:
        scale = np.abs(gj[k]).max()
        np.testing.assert_allclose(gt[k], gj[k], rtol=0, atol=2e-4 * scale,
                                   err_msg=k)


def test_chunked_loss_equals_plain_loss():
    _, tm = _pair()
    ids = torch.as_tensor(_ids(), dtype=torch.long)
    with torch.no_grad():
        plain = tm(ids, ids)
        h = tm.gpt(ids)
        for chunk in (1, 5, 23, 64):
            assert float(tm.chunked_lm_loss(h, ids, chunk=chunk)) == \
                pytest.approx(float(plain), rel=1e-6)


def _no_bias_or_norm(name):
    return not (name.endswith("bias") or "ln_" in name)


def _run_jax(jm, opt, batches, **kw):
    step = JaxTrainStep(jm, opt, loss_fn=None, **kw)
    losses = [float(step((b, b))) for b in batches]
    return losses, {k: np.asarray(v, np.float32) for k, v in step.params.items()}


def _run_torch(tm, opt, batches, **kw):
    step = TrainStep(tm, opt, loss_fn=None, **kw)
    losses = [float(step((b, b))) for b in batches]
    return losses, {k: p.detach().float().numpy()
                    for k, p in step.params.items()}


@pytest.mark.parametrize("decay_fun", [None, _no_bias_or_norm])
def test_adamw_trajectory_matches_jax(decay_fun):
    jm, tm = _pair()
    batches = [_ids(seed=s) for s in range(5)]
    lj, pj = _run_jax(jm, JaxAdamW(learning_rate=1e-3, weight_decay=0.01,
                                   apply_decay_param_fun=decay_fun), batches)
    lt, ptt = _run_torch(tm, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                   apply_decay_param_fun=decay_fun), batches)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for k in pj:
        np.testing.assert_allclose(ptt[k], pj[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_grad_accum_matches_jax():
    jm, tm = _pair()
    batches = [_ids(seed=s) for s in range(4)]
    kw = dict(grad_accum_steps=2)
    lj, pj = _run_jax(jm, JaxAdamW(learning_rate=1e-3), batches, **kw)
    lt, ptt = _run_torch(tm, AdamW(learning_rate=1e-3), batches, **kw)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for k in pj:
        np.testing.assert_allclose(ptt[k], pj[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_o2_decorate_trajectory_matches_jax():
    jm, tm = _pair()
    jm, jopt = jamp.decorate(jm, JaxAdamW(learning_rate=1e-3), level="O2",
                             dtype="bfloat16")
    tm, topt = amp.decorate(tm, AdamW(learning_rate=1e-3), level="O2",
                            dtype="bfloat16")
    assert topt.multi_precision
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    batches = [_ids(seed=s) for s in range(3)]
    step = TrainStep(tm, topt, loss_fn=None)
    masters = step.opt_state["master_weights"]
    assert all(m.dtype == torch.float32 for m in masters.values())
    lt = [float(step((b, b))) for b in batches]
    lj, pj = _run_jax(jm, jopt, batches)
    np.testing.assert_allclose(lt, lj, rtol=2e-2)
    parted = total = 0
    for k, p in step.params.items():
        assert p.dtype == torch.bfloat16
        # the bf16 parameter is its float32 master, rounded
        assert torch.equal(p, masters[k].to(torch.bfloat16))
        diff = np.abs(p.detach().float().numpy() - pj[k])
        assert diff.max() <= 7e-3, k
        parted += int((diff > 1e-3).sum())
        total += diff.size
    assert parted <= 1e-2 * total


def _grads_with(cfg_kw, ids, seed=5):
    trandom.seed(0)
    tm = GPTForCausalLM(gpt_tiny(**cfg_kw), device="cpu").train()
    t = torch.as_tensor(ids, dtype=torch.long)
    with rng_context({"dropout": seed}):
        loss = tm(t, t)
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in tm.named_parameters()}


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("mode", ["use_recompute", "recompute_attn_only"])
def test_recompute_equals_no_recompute(dropout, mode):
    """Recompute replays the forward's random streams, so a dropout
    inside a recomputed block draws the same masks twice: loss and grads
    equal the run without recompute."""
    ids = _ids()
    kw = dict(hidden_dropout_prob=dropout, attention_dropout_prob=dropout)
    l0, g0 = _grads_with(kw, ids)
    l1, g1 = _grads_with({**kw, mode: True}, ids)
    assert l1 == l0
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)


def test_state_dict_resume_replays_the_next_loss():
    kw = dict(hidden_dropout_prob=0.1, attention_dropout_prob=0.1,
              use_recompute=True)
    batches = [_ids(seed=s) for s in range(3)]
    trandom.seed(3)
    a = TrainStep(GPTForCausalLM(gpt_tiny(**kw), device="cpu"),
                  AdamW(learning_rate=1e-3), loss_fn=None)
    a((batches[0], batches[0]))
    a((batches[1], batches[1]))
    saved = a.state_dict()
    want = float(a((batches[2], batches[2])))
    trandom.seed(4)  # another init and another base seed
    b = TrainStep(GPTForCausalLM(gpt_tiny(**kw), device="cpu",
                                 generator=torch.Generator().manual_seed(9)),
                  AdamW(learning_rate=1e-3), loss_fn=None)
    b.set_state_dict(saved)
    assert float(b((batches[2], batches[2]))) == want


def test_dropout_replays_from_the_same_seed():
    kw = dict(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    ids = _ids()

    def losses(global_seed):
        trandom.seed(global_seed)
        step = TrainStep(GPTForCausalLM(gpt_tiny(**kw), device="cpu"),
                         AdamW(learning_rate=1e-3), loss_fn=None)
        return [float(step((ids, ids))) for _ in range(2)]

    assert losses(1) == losses(1)
    assert losses(1) != losses(2)


def test_gpt_loss_fn_step_equals_loss_in_forward():
    _, tm = _pair()
    ids = _ids()
    trandom.seed(0)
    a = TrainStep(tm, AdamW(learning_rate=1e-3), loss_fn=gpt_loss_fn(tm))
    la = float(a((ids, ids)))
    _, tm2 = _pair()
    b = TrainStep(tm2, AdamW(learning_rate=1e-3), loss_fn=None)
    assert float(b((ids, ids))) == pytest.approx(la, rel=1e-6)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5))
    labels[0, 1] = labels[2, 4] = -100
    want = np.asarray(JF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                       reduction=reduction))
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          reduction=reduction)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cross_entropy_unported_options_raise():
    x = torch.zeros(2, 4)
    with pytest.raises(NotImplementedError):
        F.cross_entropy(x, torch.zeros(2, 4), soft_label=True)
    with pytest.raises(NotImplementedError):
        F.cross_entropy(x, torch.zeros(2, dtype=torch.long),
                        label_smoothing=0.1)


def test_dropout_function():
    x = torch.ones(64, 64)
    assert F.dropout(x, 0.5, training=False) is x
    assert F.dropout(x, 0.0) is x
    with rng_context({"dropout": 1}):
        y = F.dropout(x, 0.25)
    assert set(torch.unique(y).tolist()) <= {0.0, float(torch.tensor(1.0)
                                                        / 0.75)}
    assert abs(float((y > 0).float().mean()) - 0.75) < 0.05
    with rng_context({"dropout": 1}):
        assert torch.equal(F.dropout(x, 0.25), y)
    with rng_context({"dropout": 1}):
        cols = F.dropout(x, 0.5, axis=1)
    assert torch.equal(cols, cols[:1].expand_as(cols))


def test_gpt_flops_per_token_matches_jax():
    kw = dict(vocab_size=50304, hidden_size=2048, num_layers=24, num_heads=16,
              max_position_embeddings=1024)
    from paddle_tpu.models.gpt import GPTConfig as JaxConfig
    from paddle_tpu_torch.models.gpt import GPTConfig

    assert gpt_flops_per_token(GPTConfig(**kw), 1024) == \
        jax_flops(JaxConfig(**kw), 1024)


def test_gpt_from_jax_loads_bf16_state():
    jm = _jax_model()
    jm, _ = jamp.decorate(jm, JaxAdamW(), level="O2", dtype="bfloat16")
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    assert all(v.dtype.name == "bfloat16" for v in state.values())
    tm = gpt_from_jax(state, gpt_tiny(**NO_DROP, use_recompute=True,
                                      loss_chunk=8), device="cpu")
    for k, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      state[k].astype(np.float32))


def test_named_recompute_policy_raises():
    with pytest.raises(NotImplementedError):
        recompute_wrap(lambda x: x, policy="save_dots")


def test_eval_step_equals_model_forward():
    _, tm = _pair()
    ids = _ids()
    with torch.no_grad():
        want = tm(torch.as_tensor(ids, dtype=torch.long))
    assert torch.equal(EvalStep(tm)(ids), want)

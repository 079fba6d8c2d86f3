"""The port's Transformer layers (paddle_tpu_torch.nn.layers.transformer)
and ``cross_entropy``'s options against the JAX package's, on the CPU.

Weights cross by name (``convert.layer_from_jax``), inputs are numpy
arrays from seeds, dropout is 0 where the two sides are compared.
Attention runs the plain branch of SDPA on both sides (CPU tensors; the
kernel branch is held in tests/test_torch_sdpa.py). Tolerances, float32:
outputs 1e-5 (absolute and relative; a Transformer stacks LayerNorms, so
outputs are of order 1), parameter gradients 2e-4 relative / 2e-5
absolute, the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework.jit import TrainStep as JaxTrainStep
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layer import functional_call, param_state
from paddle_tpu.nn.layers import transformer as JT
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.framework.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import transformer as T
from paddle_tpu_torch.optimizer import AdamW
from torch_threads import few_torch_threads  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
BWD = dict(rtol=2e-4, atol=2e-5)
E, NH, FF = 32, 4, 64


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _state(jm):
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _pair(jax_cls, torch_cls, *args, seed=1, **kw):
    pt.seed(seed)
    jm = jax_cls(*args, **kw)
    tm = layer_from_jax(torch_cls(*args, device="cpu", **kw), _state(jm))
    return jm, tm


def _grads(jm, tm, args_np, kwargs_np=None, cotangent=None):
    """Outputs of both, and the gradient of sum(out * cotangent) for every
    parameter of both."""
    kwargs_np = kwargs_np or {}
    jargs = [jnp.asarray(a) for a in args_np]
    jkw = {k: jnp.asarray(v) for k, v in kwargs_np.items()}

    def loss(p):
        out, _ = functional_call(jm, p, None, *jargs, **jkw)
        return jnp.sum(out * cotangent), out

    (_, o_j), g_j = jax.value_and_grad(loss, has_aux=True)(param_state(jm))
    tm.zero_grad(set_to_none=True)
    o_t = tm(*[torch.from_numpy(a) for a in args_np],
             **{k: torch.from_numpy(v) for k, v in kwargs_np.items()})
    (o_t * torch.from_numpy(cotangent)).sum().backward()
    g_t = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    return np.asarray(o_j), {k: np.asarray(v) for k, v in g_j.items()}, \
        o_t.detach().numpy(), g_t


def _check(res):
    o_j, g_j, o_t, g_t = res
    np.testing.assert_allclose(o_t, o_j, **FWD)
    assert set(g_t) == set(g_j)
    for k in g_j:
        np.testing.assert_allclose(g_t[k], g_j[k], err_msg=k, **BWD)


def _key_padding(B, Lq, Lk):
    keep = np.arange(Lk)[None, :] < (Lk - 3 * np.arange(B))[:, None]
    return np.ascontiguousarray(np.broadcast_to(keep[:, None, None, :],
                                                (B, 1, Lq, Lk)))


@pytest.mark.parametrize("cross", [False, True])
def test_multi_head_attention_matches_jax(cross):
    kw = dict(kdim=24, vdim=16) if cross else {}
    jm, tm = _pair(JT.MultiHeadAttention, T.MultiHeadAttention, E, NH, **kw)
    jm.eval()
    q = _rand((2, 6, E), 0)
    if cross:
        args = [q, _rand((2, 9, 24), 1), _rand((2, 9, 16), 2)]
        mask = _key_padding(2, 6, 9)
    else:
        args, mask = [q], _key_padding(2, 6, 6)
    _check(_grads(jm, tm, args, {"attn_mask": mask},
                  cotangent=_rand((2, 6, E), 3)))


def test_multi_head_attention_cache_matches_jax():
    """With a cache the new keys and values are appended to it and
    returned with the output (``gen_cache`` builds the first one)."""
    jm, tm = _pair(JT.MultiHeadAttention, T.MultiHeadAttention, E, NH)
    k0, v0 = _rand((2, 5, NH, E // NH), 4), _rand((2, 5, NH, E // NH), 5)
    x = _rand((2, 3, E), 6)
    o_j, (k_j, v_j) = jm(jnp.asarray(x), cache=JT.MultiHeadAttention.gen_cache(
        jnp.asarray(k0), jnp.asarray(v0)))
    o_t, (k_t, v_t) = tm(torch.from_numpy(x), cache=T.MultiHeadAttention
                         .gen_cache(torch.from_numpy(k0),
                                    torch.from_numpy(v0)))
    assert tuple(k_t.shape) == (2, 8, NH, E // NH)
    for a, b in ((o_t, o_j), (k_t, k_j), (v_t, v_j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_layer_matches_jax(normalize_before, activation):
    jm, tm = _pair(JT.TransformerEncoderLayer, T.TransformerEncoderLayer,
                   E, NH, FF, dropout=0.0, activation=activation,
                   normalize_before=normalize_before)
    _check(_grads(jm, tm, [_rand((2, 7, E), 0)],
                  {"src_mask": _key_padding(2, 7, 7)},
                  cotangent=_rand((2, 7, E), 1)))


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_decoder_layer_matches_jax(normalize_before, activation):
    jm, tm = _pair(JT.TransformerDecoderLayer, T.TransformerDecoderLayer,
                   E, NH, FF, dropout=0.0, activation=activation,
                   normalize_before=normalize_before)
    causal = np.asarray(JT.Transformer.generate_square_subsequent_mask(5))
    _check(_grads(jm, tm, [_rand((2, 5, E), 0), _rand((2, 8, E), 1)],
                  {"tgt_mask": causal, "memory_mask": _key_padding(2, 5, 8)},
                  cotangent=_rand((2, 5, E), 2)))


def _transformer_pair(seed=1, **kw):
    args = dict(d_model=E, nhead=NH, num_encoder_layers=2,
                num_decoder_layers=2, dim_feedforward=FF, dropout=0.0)
    args.update(kw)
    return _pair(JT.Transformer, T.Transformer, seed=seed, **args)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_matches_jax(normalize_before):
    jm, tm = _transformer_pair(normalize_before=normalize_before)
    tgt_mask = np.broadcast_to(
        np.asarray(JT.Transformer.generate_square_subsequent_mask(6)),
        (2, 1, 6, 6)).copy()
    tgt_mask[1, :, :, 4:] = -np.inf  # a padded target row
    _check(_grads(jm, tm, [_rand((2, 9, E), 0), _rand((2, 6, E), 1)],
                  {"src_mask": _key_padding(2, 9, 9), "tgt_mask": tgt_mask,
                   "memory_mask": _key_padding(2, 6, 9)},
                  cotangent=_rand((2, 6, E), 2)))


def test_square_subsequent_mask_matches_jax():
    want = np.asarray(JT.Transformer.generate_square_subsequent_mask(5))
    got = T.Transformer.generate_square_subsequent_mask(5, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_stacked_layers_start_identical_as_in_the_reference():
    """TransformerEncoder/Decoder deep-copy their first layer, so every
    layer of a stack starts with the same weights (on both sides), and
    the copies are distinct parameters."""
    jm, tm = _transformer_pair()
    tstate = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    for stack in ("encoder", "decoder"):
        names = [k for k in tstate if k.startswith(f"{stack}.layers.0.")]
        assert names
        for k in names:
            other = k.replace(".layers.0.", ".layers.1.")
            np.testing.assert_array_equal(tstate[k], tstate[other])
            np.testing.assert_array_equal(np.asarray(jm.state_dict()[k]),
                                          np.asarray(jm.state_dict()[other]))
    fresh = T.Transformer(d_model=E, nhead=NH, num_encoder_layers=2,
                          num_decoder_layers=2, dim_feedforward=FF,
                          device="cpu")
    a = fresh.encoder.layers[0].linear1.weight
    b = fresh.encoder.layers[1].linear1.weight
    assert torch.equal(a, b) and a is not b


def test_layer_from_jax_rejects_mismatched_state():
    jm, _ = _transformer_pair()
    state = _state(jm)

    def fresh():
        return T.Transformer(d_model=E, nhead=NH, num_encoder_layers=2,
                             num_decoder_layers=2, dim_feedforward=FF,
                             device="cpu")

    missing = dict(state)
    missing.pop("decoder.norm.weight")
    with pytest.raises(KeyError, match="decoder.norm.weight"):
        layer_from_jax(fresh(), missing)
    wrong = dict(state)
    wrong["encoder.layers.0.linear1.weight"] = np.zeros((FF, E), np.float32)
    with pytest.raises(ValueError, match="linear1"):
        layer_from_jax(fresh(), wrong)


def test_transformer_train_step_matches_jax():
    """Three AdamW steps of a Transformer trained on a regression target
    through both TrainSteps (dropout 0): the losses agree."""
    jm, tm = _transformer_pair(seed=3)
    src, tgt, want = _rand((2, 9, E), 0), _rand((2, 6, E), 1), \
        _rand((2, 6, E), 2)
    mask = _key_padding(2, 9, 9)

    def jloss(out, batch):
        return jnp.mean((out - batch[3]) ** 2)

    jstep = JaxTrainStep(jm.train(), JaxAdamW(learning_rate=1e-3),
                         loss_fn=jloss, inputs_fn=lambda b: b[:3])
    tstep = TrainStep(tm.train(), AdamW(learning_rate=1e-3),
                      loss_fn=lambda out, b: ((out - b[3]) ** 2).mean(),
                      inputs_fn=lambda b: b[:3])
    jb = tuple(jnp.asarray(x) for x in (src, tgt, mask, want))
    tb = (src, tgt, mask, want)
    lj = [float(jstep(jb)) for _ in range(3)]
    lt = [float(tstep(tb)) for _ in range(3)]
    np.testing.assert_allclose(lt, lj, rtol=1e-5)


# ------------------------------------------------------- cross entropy
def _ce_pair(logits, label, **kw):
    want = np.asarray(JF.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(label), **kw))
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                          **kw)
    return got.numpy(), want


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("option", [
    dict(soft_label=True), dict(soft_label=True, label_smoothing=0.2),
    dict(shape_soft=True), dict(label_smoothing=0.1),
    dict(label_smoothing=0.1, ignore_index=2), dict(weight=True),
    dict(weight=True, ignore_index=2), dict(use_softmax=False),
    dict(use_softmax=False, label_smoothing=0.1),
    dict(soft_label=True, axis=1)])
def test_cross_entropy_options_match_jax(option, reduction):
    rng = np.random.default_rng(7)
    option = dict(option)
    kw = dict(reduction=reduction)
    logits = rng.standard_normal((3, 5, 6)).astype(np.float32)
    label = rng.integers(0, 6, (3, 5))
    label[0, 1] = 2
    if option.pop("shape_soft", False) or option.get("soft_label"):
        label = rng.dirichlet(np.ones(6), (3, 5)).astype(np.float32)
    if option.pop("axis", None):  # classes on axis 1, soft labels too
        logits = np.ascontiguousarray(logits.transpose(0, 2, 1))
        label = np.ascontiguousarray(label.transpose(0, 2, 1))
        kw["axis"] = 1
    if option.pop("weight", False):
        kw["weight"] = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    if option.get("use_softmax") is False:
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    kw.update(option)
    got, want = _ce_pair(logits, label, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cross_entropy_hard_labels_along_another_axis():
    """Hard labels with ``axis=1`` pick along that axis: the loss of the
    logits moved to the last axis. The reference's hard-label gather
    (``take_along_axis`` of a ``[..., 1]`` index) broadcasts over the
    class axis instead when it is not the last, and picks class 0's
    position; the port does not copy that."""
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((3, 6, 5)).astype(np.float32)
    label = rng.integers(0, 6, (3, 5))
    label[1, 2] = -100
    for reduction in ("mean", "none"):
        got = F.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(label), axis=1,
                              reduction=reduction, label_smoothing=0.1)
        want = F.cross_entropy(torch.from_numpy(logits).transpose(1, 2),
                               torch.from_numpy(label), reduction=reduction,
                               label_smoothing=0.1)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

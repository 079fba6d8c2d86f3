"""The port's BERT and ERNIE (paddle_tpu_torch.models.bert / ernie)
against the JAX package's, on the CPU at ``bert_tiny`` / ``ernie_tiny``.

A seeded JAX model is converted by name (``convert.bert_from_jax`` /
``ernie_from_jax``); the same numpy token ids go through both, dropout 0.
Tolerances, float32: outputs and losses 1e-5 (absolute and relative),
parameter gradients 2e-4 relative / 2e-5 absolute (the reference's);
TrainStep losses 1e-5 relative over four AdamW steps. bf16 O2: the
reference's scores become float32 (a float64 NumPy divisor), so both
sides' outputs are float32, held within 2e-2 of each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu.framework.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import bert as JB
from paddle_tpu.models import ernie as JE
from paddle_tpu.nn.layer import functional_call, param_state
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import bert_from_jax, ernie_from_jax
from paddle_tpu_torch.framework.jit import TrainStep
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import ernie as TE
from paddle_tpu_torch.optimizer import AdamW
from torch_threads import few_torch_threads  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
BWD = dict(rtol=2e-4, atol=2e-5)
NO_DROP = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
B, L = 3, 16

# (JAX class, port class, JAX config, port config, converter)
FAMILIES = {
    "bert": (JB, TB, JB.bert_tiny, TB.bert_tiny, bert_from_jax, "Bert"),
    "ernie": (JE, TE, JE.ernie_tiny, TE.ernie_tiny, ernie_from_jax, "Ernie"),
}


def _pair(family, head, seed=2, **kw):
    jmod, tmod, jcfg, tcfg, conv, prefix = FAMILIES[family]
    pt.seed(seed)
    extra = {"num_classes": 3} if head == "ForSequenceClassification" else {}
    jm = getattr(jmod, prefix + head)(jcfg(**NO_DROP, **kw), **extra)
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = conv(state, tcfg(**NO_DROP, **kw), device="cpu",
              model_cls=getattr(tmod, prefix + head), **extra)
    return jm.train(), tm.train()


def _ids(seed=0, lengths=(16, 11, 6), vocab=1024):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, L))
    for b, n in enumerate(lengths):
        ids[b, n:] = 0  # pad_token_id
    return ids


def _pretrain_args(seed=1):
    rng = np.random.default_rng(seed)
    positions = np.stack([np.sort(rng.choice(6, 4, replace=False))
                          for _ in range(B)])
    positions[2, 3] = -1  # padding, ignored
    labels = rng.integers(0, 1024, (B, 4))
    labels[0, 0] = -1
    return positions, labels, rng.integers(0, 2, B)


def _run_both(jm, tm, args, kwargs=None, reduce_out=None):
    """The output of both and the gradient of ``reduce_out(out)`` for
    every parameter."""
    kwargs = kwargs or {}
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}

    def loss(p):
        out, _ = functional_call(jm, p, None, *jargs, **jkw)
        return reduce_out(out, jnp), out

    (_, o_j), g_j = jax.value_and_grad(loss, has_aux=True)(param_state(jm))
    tm.zero_grad(set_to_none=True)
    o_t = tm(*[None if a is None else torch.as_tensor(a) for a in args],
             **{k: torch.as_tensor(v) for k, v in kwargs.items()})
    reduce_out(o_t, torch).backward()
    g_t = {k: p.grad for k, p in tm.named_parameters()}
    return o_j, {k: np.asarray(v) for k, v in g_j.items()}, o_t, g_t


def _check_grads(g_j, g_t):
    assert set(g_t) == set(g_j)
    for k, g in g_j.items():
        got = np.zeros_like(g) if g_t[k] is None else g_t[k].numpy()
        np.testing.assert_allclose(got, g, err_msg=k, **BWD)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("family", ["bert", "ernie"])
def test_model_outputs_and_grads_match_jax(family):
    jm, tm = _pair(family, "Model")
    w = np.random.default_rng(3).standard_normal((B, L, 64)).astype(
        np.float32)

    def reduce_out(out, lib):
        seq, pooled = out
        return lib.sum(seq * lib.asarray(w)) + lib.sum(pooled) \
            if lib is jnp else (seq * torch.from_numpy(w)).sum() + pooled.sum()

    kwargs = {"task_type_ids": np.ones((B, L), np.int64)} \
        if family == "ernie" else {}
    tt = np.random.default_rng(4).integers(0, 2, (B, L))
    o_j, g_j, o_t, g_t = _run_both(jm, tm, [_ids(), tt], kwargs, reduce_out)
    for a, b in zip(o_t, o_j):
        np.testing.assert_allclose(_np(a), _np(b), **FWD)
    _check_grads(g_j, g_t)


@pytest.mark.parametrize("family", ["bert", "ernie"])
@pytest.mark.parametrize("with_labels", [False, True])
def test_sequence_classification_matches_jax(family, with_labels):
    jm, tm = _pair(family, "ForSequenceClassification")
    labels = np.array([0, 2, 1])
    args = [_ids(), None, None]
    kwargs = {"labels": labels} if with_labels else {}

    def reduce_out(out, lib):
        return out if with_labels else (out * 1.5).sum()

    o_j, g_j, o_t, g_t = _run_both(jm, tm, args, kwargs, reduce_out)
    np.testing.assert_allclose(_np(o_t), _np(o_j), **FWD)
    _check_grads(g_j, g_t)


@pytest.mark.parametrize("family", ["bert", "ernie"])
@pytest.mark.parametrize("with_nsp", [False, True])
def test_pretraining_loss_matches_jax(family, with_nsp):
    """The masked-LM loss gathers the masked positions (-1 padding and -1
    labels ignored) before the tied vocab projection; with NSP labels the
    next-sentence loss is added."""
    jm, tm = _pair(family, "ForPretraining")
    positions, labels, nsp = _pretrain_args()
    args = [_ids(), positions, labels, nsp if with_nsp else None]
    o_j, g_j, o_t, g_t = _run_both(jm, tm, args,
                                   reduce_out=lambda out, lib: out)
    np.testing.assert_allclose(_np(o_t), _np(o_j), **FWD)
    _check_grads(g_j, g_t)


def test_padding_does_not_change_real_tokens():
    """More pad tokens after a row change nothing of its real positions or
    its pooled output (the -1e9 padding bias), on both sides."""
    jm, tm = _pair("bert", "Model")
    ids = _ids()
    longer = np.concatenate([ids, np.zeros((B, 8), ids.dtype)], axis=1)
    with torch.no_grad():
        s1, p1 = tm(torch.as_tensor(ids))
        s2, p2 = tm(torch.as_tensor(longer))
    js1, jp1 = jm(jnp.asarray(ids))
    js2, jp2 = jm(jnp.asarray(longer))
    for b, n in enumerate((16, 11, 6)):
        np.testing.assert_allclose(s2[b, :n].numpy(), s1[b, :n].numpy(),
                                   **FWD)
        np.testing.assert_allclose(np.asarray(js2)[b, :n],
                                   np.asarray(js1)[b, :n], **FWD)
    np.testing.assert_allclose(p2.numpy(), p1.numpy(), **FWD)
    np.testing.assert_allclose(p2.numpy(), np.asarray(jp2), **FWD)


@pytest.mark.parametrize("family", ["bert", "ernie"])
def test_train_step_losses_match_jax(family):
    jm, tm = _pair(family, "ForSequenceClassification", seed=5)
    ids, labels = _ids(6), np.array([2, 0, 1])
    jstep = JaxTrainStep(jm, JaxAdamW(learning_rate=1e-3), loss_fn=None)
    tstep = TrainStep(tm, AdamW(learning_rate=1e-3), loss_fn=None)
    # ERNIE's forward takes task_type_ids before labels
    gap = (None,) * (3 if family == "ernie" else 2)
    lj = [float(jstep((jnp.asarray(ids), *gap, jnp.asarray(labels))))
          for _ in range(4)]
    lt = [float(tstep((ids, *gap, labels))) for _ in range(4)]
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert lt[-1] < lt[0]


def test_o2_bf16_computes_attention_in_float32_as_the_reference():
    """Under bf16 O2 the reference's attention scores become float32 (its
    divisor is a float64 NumPy scalar), and the rest of the encoder
    follows in float32 against the bf16 weights: the port keeps that."""
    jm, tm = _pair("bert", "Model")
    jm = jamp.decorate(jm, level="O2", dtype="bfloat16")
    tm = amp.decorate(tm, level="O2", dtype="bfloat16")
    ids = _ids()
    js, jp = jm(jnp.asarray(ids))
    with torch.no_grad():
        ts, tp = tm(torch.as_tensor(ids))
    assert ts.dtype == torch.float32 and str(js.dtype) == "float32"
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-2,
                               atol=2e-2)


def test_configs_match_jax():
    for jc, tc in ((JB.bert_tiny, TB.bert_tiny), (JB.bert_base, TB.bert_base),
                   (JE.ernie_tiny, TE.ernie_tiny),
                   (JE.ernie_3_base, TE.ernie_3_base)):
        j, t = jc(), tc()
        assert vars(j) == vars(t)
        assert j.ffn_size == t.ffn_size


def test_conversion_rejects_mismatched_state():
    jm, _ = _pair("ernie", "ForSequenceClassification")
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    cfg = TB.bert_tiny(**NO_DROP)
    # ERNIE's task-type table is not a BERT parameter
    with pytest.raises(KeyError, match="task_type_embeddings"):
        bert_from_jax(state, cfg, device="cpu", num_classes=3)
    missing = dict(state)
    missing.pop("classifier.bias")
    with pytest.raises(KeyError, match="classifier.bias"):
        ernie_from_jax(missing, TE.ernie_tiny(**NO_DROP), device="cpu",
                       num_classes=3)
    with pytest.raises(ValueError, match="classifier"):
        ernie_from_jax(state, TE.ernie_tiny(**NO_DROP), device="cpu",
                       num_classes=2)


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (TB.BertModel, TB.BertForSequenceClassification,
                TB.BertForPretraining, TE.ErnieModel):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(TB.bert_tiny() if cls.__module__.endswith("bert")
                else TE.ernie_tiny())

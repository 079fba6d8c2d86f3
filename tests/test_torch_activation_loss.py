"""The port's activation and loss layers (``paddle_tpu_torch.nn.layers.
{activation,loss}``) against the JAX package's, on the CPU: every class,
its forward and the gradient of its input, from the same seeded numpy
inputs. ``RReLU`` draws its slopes from another generator than the
reference's: its eval forward is compared, and its training slopes are
checked against their bounds.

Tolerances, float32: outputs rtol 1e-4 / atol 1e-5, gradients rtol 2e-4
/ atol 2e-5 (the reference's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn.layers import activation as JA
from paddle_tpu.nn.layers import loss as JL
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.nn.layers import activation as TA
from paddle_tpu_torch.nn.layers import loss as TL

FWD = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=2e-4, atol=2e-5)


def _rand(shape, seed, scale=2.0):
    return np.asarray(np.random.default_rng(seed).standard_normal(shape)
                      * scale, dtype=np.float32)


def _compare(jm, tm, inputs, grad_of=(0,), seed=5):
    """Forward of both layers on ``inputs`` (numpy) and the gradients of
    sum(out * cotangent) for the inputs listed in ``grad_of``."""
    def jfn(*diff):
        args = [jnp.asarray(a) for a in inputs]
        for i, d in zip(grad_of, diff):
            args[i] = d
        return jm(*args)

    out_j, vjp = jax.vjp(jfn, *[jnp.asarray(inputs[i]) for i in grad_of])
    targs = [torch.from_numpy(a) for a in inputs]
    for i in grad_of:
        targs[i] = targs[i].clone().requires_grad_(True)
    out_t = tm(*targs)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **FWD)
    cot = _rand(np.shape(out_j), seed, 1.0)
    g_j = vjp(jnp.asarray(cot))
    (out_t * torch.from_numpy(cot)).sum().backward()
    for i, gj in zip(grad_of, g_j):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(gj),
                                   err_msg=f"grad {i}", **BWD)


# (class, constructor args, input shape)
ACTIVATIONS = [
    ("ReLU", (), (3, 4, 5)), ("ReLU6", (), (3, 4, 5)),
    ("GELU", (), (3, 4, 5)), ("GELU", (True,), (3, 4, 5)),
    ("Sigmoid", (), (3, 4, 5)), ("Tanh", (), (3, 4, 5)),
    ("LeakyReLU", (0.2,), (3, 4, 5)), ("PReLU", (4, 0.3), (3, 4, 5)),
    ("PReLU", (1, 0.1), (3, 4, 5)), ("Softmax", (1,), (3, 4, 5)),
    ("LogSoftmax", (), (3, 4, 5)), ("Softplus", (2.0, 3.0), (3, 4, 5)),
    ("Silu", (), (3, 4, 5)), ("Swish", (), (3, 4, 5)),
    ("Mish", (), (3, 4, 5)), ("Hardswish", (), (3, 4, 5)),
    ("Hardsigmoid", (), (3, 4, 5)), ("Hardtanh", (-0.5, 1.5), (3, 4, 5)),
    ("Hardshrink", (0.7,), (3, 4, 5)), ("Softshrink", (0.6,), (3, 4, 5)),
    ("Tanhshrink", (), (3, 4, 5)), ("ThresholdedReLU", (0.8,), (3, 4, 5)),
    ("ELU", (0.7,), (3, 4, 5)), ("SELU", (), (3, 4, 5)),
    ("CELU", (1.3,), (3, 4, 5)), ("Softsign", (), (3, 4, 5)),
    ("Maxout", (2,), (3, 4, 5)), ("Maxout", (3, -1), (2, 4, 6)),
    ("LogSigmoid", (), (3, 4, 5)), ("Softmax2D", (), (2, 3, 4, 5)),
]


@pytest.mark.parametrize("case", ACTIVATIONS,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(ACTIVATIONS)])
def test_activation_layer(case):
    cls, args, shape = case
    pt.seed(7)
    jm = getattr(JA, cls)(*args)
    tm = getattr(TA, cls)(*args)
    if list(tm.parameters()):
        tm = layer_from_jax(tm, {k: np.asarray(v) for k, v in
                                 jm.state_dict().items()})
    _compare(jm, tm, [_rand(shape, 8)])


def test_rrelu():
    """Eval: the mean slope, as the reference; training: each negative
    element's slope in [lower, upper], positives unchanged, and the draw
    replayed by the same "rrelu" stream seed."""
    from paddle_tpu_torch.nn.layer import rng_context

    x = _rand((4, 50), 9)
    jm, tm = JA.RReLU(0.1, 0.3), TA.RReLU(0.1, 0.3)
    jm.eval()
    tm.eval()
    _compare(jm, tm, [x])
    tm.train()
    xt = torch.from_numpy(x)
    with rng_context({"rrelu": 11}):
        a = tm(xt)
    with rng_context({"rrelu": 11}):
        b = tm(xt)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    neg = x < 0
    slope = a.numpy()[neg] / x[neg]
    assert slope.min() >= 0.1 - 1e-6 and slope.max() <= 0.3 + 1e-6
    assert slope.std() > 0.02
    np.testing.assert_array_equal(a.numpy()[~neg], x[~neg])


def _labels(shape, classes, seed):
    return np.random.default_rng(seed).integers(0, classes, shape)


def _probs(shape, seed):
    z = _rand(shape, seed)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _sign_labels(shape, seed):
    return np.where(np.random.default_rng(seed).random(shape) < 0.5, -1.0,
                    1.0).astype(np.float32)


def _loss_cases():
    logits = _rand((6, 5), 20)
    hard = _labels((6,), 5, 21)
    hard[2] = -100
    soft = _probs((6, 5), 22)
    a, b = _rand((6, 4), 23), _rand((6, 4), 24)
    prob = 1.0 / (1.0 + np.exp(-_rand((6, 4), 25)))
    binary = (np.random.default_rng(26).random((6, 4)) < 0.5).astype(
        np.float32)
    w = np.abs(_rand((5,), 27)) + 0.5
    return [
        # (class, kwargs, inputs, differentiated inputs)
        ("CrossEntropyLoss", {}, [logits, hard], (0,)),
        ("CrossEntropyLoss", dict(weight=w, reduction="sum"),
         [logits, hard], (0,)),
        ("CrossEntropyLoss", dict(soft_label=True, label_smoothing=0.1),
         [logits, soft], (0,)),
        ("CrossEntropyLoss", dict(reduction="none", label_smoothing=0.2),
         [logits, hard], (0,)),
        ("MSELoss", {}, [a, b], (0, 1)),
        ("MSELoss", dict(reduction="none"), [a, b], (0,)),
        ("L1Loss", dict(reduction="sum"), [a, b], (0,)),
        ("SmoothL1Loss", dict(delta=0.7), [a, b], (0, 1)),
        ("NLLLoss", {}, [np.log(soft), hard], (0,)),
        ("NLLLoss", dict(weight=w), [np.log(soft), hard], (0,)),
        ("NLLLoss", dict(reduction="sum"), [np.log(soft), hard], (0,)),
        ("BCELoss", {}, [prob, binary], (0,)),
        ("BCELoss", dict(weight=np.abs(b), reduction="sum"),
         [prob, binary], (0,)),
        ("BCEWithLogitsLoss", {}, [a, binary], (0,)),
        ("BCEWithLogitsLoss", dict(pos_weight=np.abs(_rand((4,), 28)),
                                   weight=np.abs(b)), [a, binary], (0,)),
        ("KLDivLoss", {}, [np.log(_probs((6, 5), 29)), soft], (0,)),
        ("KLDivLoss", dict(reduction="batchmean"),
         [np.log(_probs((6, 5), 29)), soft], (0,)),
        ("MarginRankingLoss", dict(margin=0.3), [a[:, 0], b[:, 0],
                                                 _sign_labels((6,), 30)],
         (0, 1)),
        ("HingeEmbeddingLoss", dict(margin=1.5), [a, _sign_labels((6, 4), 31)],
         (0,)),
        ("CosineEmbeddingLoss", dict(margin=0.2), [a, b,
                                                   _sign_labels((6,), 32)],
         (0, 1)),
        ("TripletMarginLoss", dict(margin=2.0, p=2.0),
         [a, b, _rand((6, 4), 33)], (0, 1, 2)),
        ("TripletMarginLoss", dict(p=1.0, swap=True, reduction="sum"),
         [a, b, _rand((6, 4), 33)], (0, 1, 2)),
        ("SoftMarginLoss", {}, [a, _sign_labels((6, 4), 34)], (0,)),
        ("MultiLabelSoftMarginLoss", dict(weight=np.abs(_rand((4,), 35))),
         [a, binary], (0,)),
        ("MultiMarginLoss", dict(p=2, margin=0.8, weight=w),
         [logits, _labels((6,), 5, 36)], (0,)),
        ("MultiMarginLoss", {}, [logits, _labels((6,), 5, 36)], (0,)),
        ("TripletMarginWithDistanceLoss", dict(margin=1.2, swap=True),
         [a, b, _rand((6, 4), 37)], (0, 1, 2)),
    ]


LOSSES = _loss_cases()


@pytest.mark.parametrize("case", LOSSES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LOSSES)])
def test_loss_layer(case):
    cls, kwargs, inputs, grad_of = case
    _compare(getattr(JL, cls)(**kwargs), getattr(TL, cls)(**kwargs),
             inputs, grad_of)


def test_every_class_is_ported():
    """Every activation class and every loss class but ``HSigmoidLoss``
    (it waits for ``nn/decode.py``'s slice) has a port of the same
    name."""
    def classes(mod):
        return {n for n, v in vars(mod).items()
                if isinstance(v, type) and v.__module__ == mod.__name__
                and not n.startswith("_")}

    assert classes(JA) <= set(TA.__all__)
    assert classes(JL) - {"HSigmoidLoss"} <= set(TL.__all__)

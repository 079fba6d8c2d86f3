"""The port's PP-YOLOE (``paddle_tpu_torch.models.ppyoloe``) against the
JAX package's, on the CPU: the nearest 2x upsampling, the class-bias
prior, the forward in eval and training mode, the DFL decode, the TAL
assigner alone on shared inputs, the loss with its gradients, one
Momentum step with L2 decay through ``TrainStep`` (running statistics
included), RepConv fusion, ``predict``, and the state dict crossing both
ways before and after ``fuse_rep()``.

``ppyoloe_tiny`` (width 8, depths 1/1/1, reg_max 8, 4 classes) at 64 x
64 on a batch of 2, weights from the port's seeded draws copied into the
reference by name. The reference's loss and gradients run under one
``jax.jit`` each, shared through a module-scoped fixture (eager, its
first call compiles every primitive: 43 s against 6 s).

Tolerances (float32): eval-mode outputs rtol 1e-4 / atol 1e-5; the
assignment bit-equal (``fg``, labels, boxes) and the aligned scores rtol
2e-6 (``iou ** 6.0``: XLA's CPU ``pow`` is not correctly rounded, 57 of
1e5 values of ``x ** 2.0`` differ from ``x * x`` by an ulp); the loss
rtol 1e-5; gradients, the update and running statistics atol 1e-4 of
each tensor's largest value (training-mode BatchNorm over 8 values a
channel at the stride-32 level amplifies float32 rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import ppyoloe as JP
from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.layer import buffer_state, functional_call, param_state
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu.vision.ops import matrix_nms as J_matrix_nms
from paddle_tpu_torch.convert import ppyoloe_from_jax
from paddle_tpu_torch.framework.jit import LossAdapter, TrainStep
from paddle_tpu_torch.models import ppyoloe as TP
from paddle_tpu_torch.optimizer import Momentum

EVAL = dict(rtol=1e-4, atol=1e-5)
LR, MOMENTUM, DECAY = 0.01, 0.9, 5e-4


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _copy_state(tm):
    # copies: on the CPU jnp.asarray may alias a torch tensor's numpy view
    return {k: jnp.asarray(v.detach().numpy().copy())
            for k, v in tm.state_dict().items()}


def _twin(tm, ctor, **kw):
    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        jm = ctor(**kw)
    finally:
        JI.set_global_initializer(None, None)
    missing, unexpected = jm.set_state_dict(_copy_state(tm))
    assert not missing and not unexpected
    return jm


def _random_statistics(tm, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, b in tm.named_buffers():
            b.copy_(torch.from_numpy(
                rng.normal(0, 0.2, b.shape) if name.endswith("_mean")
                else rng.uniform(0.5, 1.5, b.shape)))


class _Shim:
    """The reference model's ``loss`` behind the call ``functional_call``
    drives (``tests/test_vision.py``'s ``_LossShim``)."""

    def __init__(self, model):
        self._m = model

    def __call__(self, *a):
        return self._m.loss(*a)

    def __getattr__(self, name):
        return getattr(self._m, name)


def _batch(seed, n=2, size=64, g=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, size, size)).astype(np.float32)
    boxes = np.full((n, g, 4), -1.0, np.float32)
    labels = np.full((n, g), -1, np.int64)
    for b in range(n):
        k = 1 + b
        xy = rng.uniform(0, size * 0.6, (k, 2))
        wh = rng.uniform(size * 0.2, size * 0.4, (k, 2))
        boxes[b, :k] = np.concatenate([xy, np.minimum(xy + wh, size - 1)], 1)
        labels[b, :k] = rng.integers(0, 4, k)
    return x, boxes, labels


@pytest.fixture(scope="module")
def pair():
    """A seeded port ``ppyoloe_tiny`` with random statistics, its
    reference twin, a batch, and the reference's training-mode loss,
    gradients and new statistics."""
    tm = TP.ppyoloe_tiny(num_classes=4, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    _random_statistics(tm, 1)
    jm = _twin(tm, JP.ppyoloe_tiny, num_classes=4)
    x, boxes, labels = _batch(2)
    jm.train()
    params, buffers = param_state(jm), buffer_state(jm)

    def loss_fn(p):
        return functional_call(_Shim(jm), p, buffers, jnp.asarray(x),
                               jnp.asarray(boxes), jnp.asarray(labels))

    (loss, new_buf), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    opt = JMomentum(LR, MOMENTUM, weight_decay=DECAY)
    new_params, _ = jax.jit(opt.update)(grads, opt.init(params), params)
    ref = dict(loss=float(loss),
               grads={k: _np(v) for k, v in grads.items()},
               buffers={k: _np(v) for k, v in new_buf.items()},
               params={k: _np(v) for k, v in new_params.items()})
    return tm, jm, (x, boxes, labels), ref


def _jax_forward(jm, x):
    """The reference's forward, compiled once."""
    return jax.jit(lambda p, b, a: functional_call(jm, p, b, a)[0])(
        param_state(jm), buffer_state(jm), jnp.asarray(x))


def _close_rel(got, want, what, rel=1e-4):
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(_np(got[k]), w, rtol=0, atol=rel * scale,
                                   err_msg=f"{what} {k}")


def test_nearest_upsampling_is_a_twofold_repeat():
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 7)).astype(
        np.float32)
    np.testing.assert_array_equal(
        _np(TP.CSPPAN._up(torch.from_numpy(x))),
        _np(JP.CSPPAN._up(jnp.asarray(x))))


def test_class_bias_prior_and_names(pair):
    tm, jm, _, _ = pair
    for h in tm.head.cls_heads:
        np.testing.assert_allclose(_np(h.bias), -np.log(99.0), rtol=1e-7)
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    assert TP.__all__ == JP.__all__


def test_forward_and_decode_in_eval_mode(pair):
    tm, jm, (x, _, _), _ = pair
    tm.eval()
    jm.eval()
    try:
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
            dec_t = tm._decode(*got[1:])
        want = _jax_forward(jm, x)
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), **EVAL)
        np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
        np.testing.assert_array_equal(_np(got[3]), _np(want[3]))
        np.testing.assert_allclose(
            _np(dec_t), _np(jax.jit(jm._decode)(*want[1:])), rtol=1e-4,
            atol=1e-3)
    finally:
        tm.train()
        jm.train()


def test_tal_assigner_on_shared_inputs():
    """The assigner alone, fed the same scores, boxes, anchors and gts
    (ties among candidates included): ``fg``, labels and boxes
    bit-equal."""
    rng = np.random.default_rng(4)
    tm = TP.ppyoloe_tiny(num_classes=5, device="cpu")
    jm = _twin(tm, JP.ppyoloe_tiny, num_classes=5)
    pts, _ = tm._anchors((64, 64), "cpu")
    A = pts.shape[0]
    scores = rng.uniform(0, 1, (3, A, 5)).astype(np.float32)
    scores[:, ::9] = scores[:, :1]                 # ties in the metric
    ctr = _np(pts)[None] + rng.normal(0, 3, (3, A, 2))
    half = rng.uniform(4, 20, (3, A, 2))
    pred = np.concatenate([ctr - half, ctr + half], -1).astype(np.float32)
    pred[:, ::9] = pred[:, :1]
    gt = np.full((3, 5, 4), -1.0, np.float32)
    lbl = np.full((3, 5), -1, np.int64)
    for b in range(3):
        k = 2 + b
        xy = rng.uniform(0, 30, (k, 2))
        gt[b, :k] = np.concatenate([xy, xy + rng.uniform(20, 34, (k, 2))], 1)
        lbl[b, :k] = rng.integers(0, 5, k)
    gt[2, 3] = gt[2, 2]                            # a duplicated gt
    got = tm._assign(*(torch.from_numpy(a) for a in (scores, pred)), pts,
                     torch.from_numpy(gt), torch.from_numpy(lbl))
    want = jax.jit(jm._assign)(jnp.asarray(scores), jnp.asarray(pred),
                               jnp.asarray(_np(pts)), jnp.asarray(gt),
                               jnp.asarray(lbl))
    assert _np(got[0]).sum() > 20
    for i in range(3):
        np.testing.assert_array_equal(_np(got[i]), _np(want[i]))
    np.testing.assert_allclose(_np(got[3]), _np(want[3]), rtol=2e-6,
                               atol=1e-7)


def test_loss_and_gradients(pair):
    tm, _, (x, boxes, labels), ref = pair
    tm.zero_grad(set_to_none=True)
    saved = {k: b.clone() for k, b in tm.named_buffers()}
    loss = tm.loss(torch.from_numpy(x), torch.from_numpy(boxes),
                   torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    _close_rel({k: p.grad for k, p in tm.named_parameters()}, ref["grads"],
               "grad")
    _close_rel(dict(tm.named_buffers()), ref["buffers"], "statistic")
    with torch.no_grad():
        for k, b in tm.named_buffers():
            b.copy_(saved[k])
    tm.zero_grad(set_to_none=True)


def test_one_momentum_step_through_train_step(pair):
    """The detector's training entry point: ``TrainStep`` over
    ``LossAdapter`` (the model's ``loss``), Momentum with L2 decay, on
    ``(images, gt_boxes, gt_labels)``."""
    tm, _, (x, boxes, labels), ref = pair
    import copy

    model = copy.deepcopy(tm).train()
    step = TrainStep(LossAdapter(model),
                     Momentum(LR, MOMENTUM, weight_decay=DECAY))
    loss = step((x, boxes, labels))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    _close_rel(dict(model.named_parameters()), ref["params"], "param")
    _close_rel(dict(model.named_buffers()), ref["buffers"], "statistic")
    assert sorted(step.params) == sorted(
        "model." + k for k in ref["params"])


def test_repconv_fusion_and_predict(pair):
    tm, jm, (x, _, _), _ = pair
    import copy

    fused = copy.deepcopy(tm).eval()
    with torch.no_grad():
        before = fused(torch.from_numpy(x))
        fused.fuse_rep()
        after = fused(torch.from_numpy(x))
    for a, b in zip(before[:2], after[:2]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4)
    jf = _twin(tm, JP.ppyoloe_tiny, num_classes=4)
    jf.eval()
    jf.fuse_rep()
    assert sorted(fused.state_dict()) == sorted(jf.state_dict())
    assert any("._fused.weight" in k for k in fused.state_dict())
    want = _jax_forward(jf, x)
    for a, b in zip(after, want):
        np.testing.assert_allclose(_np(a), _np(b), **EVAL)
    # predict: the same detections (labels and order exact, scores and
    # boxes to float32 rounding)
    dets_t, num_t = fused.predict(torch.from_numpy(x), conf_thresh=0.3,
                                  keep_top_k=20)
    # the reference's predict, its forward and decode compiled (eager,
    # they compile every primitive first)
    cls_j, reg_j, pts_j, strs_j = want
    dets_j, num_j = J_matrix_nms(
        np.asarray(jax.jit(jf._decode)(reg_j, pts_j, strs_j)),
        np.moveaxis(np.asarray(jax.nn.sigmoid(cls_j)), 2, 1), 0.3, 0.01,
        400, 20, background_label=-1)
    np.testing.assert_array_equal(_np(num_t), _np(num_j))
    np.testing.assert_array_equal(_np(dets_t)[:, 0], _np(dets_j)[:, 0])
    np.testing.assert_allclose(_np(dets_t)[:, 1:], _np(dets_j)[:, 1:],
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_state_dict_crosses_both_ways(pair, fused):
    tm, _, _, _ = pair
    import copy

    port = copy.deepcopy(tm).eval()
    ref = _twin(port, JP.ppyoloe_tiny, num_classes=4)
    if fused:
        port.fuse_rep()
        ref.eval()
        ref.fuse_rep()
    # port -> reference
    missing, unexpected = ref.set_state_dict(_copy_state(port))
    assert not missing and not unexpected
    # reference -> port
    state = {k: np.asarray(v) for k, v in ref.state_dict().items()}
    back = ppyoloe_from_jax(state, "ppyoloe_tiny", device="cpu",
                            fused=fused, num_classes=4)
    assert not back.training
    assert sorted(back.state_dict()) == sorted(state)
    for k, v in back.state_dict().items():
        np.testing.assert_array_equal(_np(v), state[k], err_msg=k)
    with pytest.raises(KeyError):
        ppyoloe_from_jax(state, "ppyoloe_tiny", device="cpu",
                         fused=not fused, num_classes=4)
    bad = dict(state)
    bad["head.cls_heads.0.bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError):
        ppyoloe_from_jax(bad, TP.ppyoloe_tiny, device="cpu", fused=fused,
                         num_classes=4)


def test_ppyoloe_s_builds_at_the_references_widths():
    tm = TP.ppyoloe_s(device="cpu")
    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        jm = JP.ppyoloe_s()
    finally:
        JI.set_global_initializer(None, None)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    with pytest.raises(RuntimeError):
        torch.cuda.is_available() or TP.ppyoloe_tiny()

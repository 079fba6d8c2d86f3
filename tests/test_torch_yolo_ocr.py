"""The port's YOLOv3 (``paddle_tpu_torch.models.yolo``) and CRNN
(``paddle_tpu_torch.models.ocr``) against the JAX package's, on the CPU:
forward in eval mode, the training-mode loss and its gradients (the
summed per-scale ``yolo_loss`` means; CTC over the bidirectional LSTM),
one optimizer step through ``TrainStep`` (Momentum with L2 decay for the
detector, Adam for the recognizer, running statistics included),
``predict`` and greedy ``decode``, the conversions, and the model zoo's
exports.

``YOLOv3(num_classes=4, width=8)`` at 64 x 64 and ``crnn_tiny(11)`` at 32
x 64 (16 frames), batch 2, weights from the port's seeded draws copied
into the reference by name; the reference's gradients and updates run
under one ``jax.jit`` each, shared through module-scoped fixtures.

Tolerances (float32): eval-mode outputs rtol 1e-4 / atol 1e-5; losses
rtol 1e-5; gradients, updates and running statistics atol 1e-4 of each
tensor's largest value (training-mode BatchNorm over few values), the
Adam update 2 % of its learning rate (see the test).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.models as JM
from paddle_tpu.models import ocr as JO
from paddle_tpu.models import yolo as JY
from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.layer import buffer_state, functional_call, param_state
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import Momentum as JMomentum
import paddle_tpu_torch.models as TM
from paddle_tpu_torch.convert import crnn_from_jax, yolov3_from_jax
from paddle_tpu_torch.framework.jit import LossAdapter, TrainStep
from paddle_tpu_torch.models import ocr as TO
from paddle_tpu_torch.models import yolo as TY
from paddle_tpu_torch.optimizer import Adam, Momentum

EVAL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _twin(tm, ctor, *args, **kw):
    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        jm = ctor(*args, **kw)
    finally:
        JI.set_global_initializer(None, None)
    state = {k: jnp.asarray(v.detach().numpy().copy())
             for k, v in tm.state_dict().items()}
    missing, unexpected = jm.set_state_dict(state)
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
    def __init__(self, model):
        self._m = model

    def __call__(self, *a):
        return self._m.loss(*a)

    def __getattr__(self, name):
        return getattr(self._m, name)


def _jax_forward(jm, x):
    return jax.jit(lambda p, b, a: functional_call(jm, p, b, a)[0])(
        param_state(jm), buffer_state(jm), jnp.asarray(x))


def _reference_step(jm, opt, batch):
    """The reference's training-mode loss, gradients, new statistics and
    updated parameters (one jitted call each)."""
    jm.train()
    params, buffers = param_state(jm), buffer_state(jm)
    args = tuple(jnp.asarray(a) for a in batch)

    def loss_fn(p):
        return functional_call(_Shim(jm), p, buffers, *args)

    (loss, new_buf), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    new_params, _ = jax.jit(opt.update)(grads, opt.init(params), params)
    return dict(loss=float(loss), grads={k: _np(v) for k, v in grads.items()},
                buffers={k: _np(v) for k, v in new_buf.items()},
                params={k: _np(v) for k, v in new_params.items()})


def _close_rel(got, want, what, rel=1e-4):
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(_np(got[k]), w, rtol=0, atol=rel * scale,
                                   err_msg=f"{what} {k}")


def _check_training(tm, ref, batch, opt, update_atol=None):
    """The port's loss and gradients (a fresh copy, training mode) and
    one TrainStep over LossAdapter, against the reference's; the updated
    parameters within ``update_atol`` when given (else 1e-4 of each
    tensor's largest value)."""
    model = copy.deepcopy(tm).train()
    loss = model.loss(*(torch.as_tensor(a) for a in batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    _close_rel({k: p.grad for k, p in model.named_parameters()},
               ref["grads"], "grad")
    _close_rel(dict(model.named_buffers()), ref["buffers"], "statistic")
    model = copy.deepcopy(tm).train()
    step = TrainStep(LossAdapter(model), opt)
    np.testing.assert_allclose(float(step(batch)), ref["loss"], rtol=1e-5)
    if update_atol is None:
        _close_rel(dict(model.named_parameters()), ref["params"], "param")
    else:
        for k, p in model.named_parameters():
            np.testing.assert_allclose(_np(p), ref["params"][k], rtol=0,
                                       atol=update_atol, err_msg=k)
    _close_rel(dict(model.named_buffers()), ref["buffers"], "statistic")


# ------------------------------------------------------------------ YOLOv3
def _yolo_batch(seed, n=2, nb=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, 64, 64)).astype(np.float32)
    gt = np.zeros((n, nb, 4), np.float32)
    gt[:, :3, :2] = rng.uniform(0.1, 0.9, (n, 3, 2))
    gt[:, :3, 2:] = rng.uniform(0.05, 0.9, (n, 3, 2))
    lbl = np.full((n, nb), -1, np.int64)
    lbl[:, :3] = rng.integers(0, 4, (n, 3))
    return x, gt, lbl


@pytest.fixture(scope="module")
def yolo():
    tm = TY.YOLOv3(num_classes=4, width=8, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    _random_statistics(tm, 1)
    jm = _twin(tm, JY.YOLOv3, num_classes=4, width=8)
    batch = _yolo_batch(2)
    ref = _reference_step(copy.deepcopy(jm), JMomentum(0.01, 0.9,
                                                       weight_decay=5e-4),
                          batch)
    return tm, jm, batch, ref


def test_yolo_names_anchors_and_eval_forward(yolo):
    tm, jm, (x, _, _), _ = yolo
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    assert TY.DEFAULT_ANCHORS == JY.DEFAULT_ANCHORS
    assert TY.DEFAULT_ANCHOR_MASKS == JY.DEFAULT_ANCHOR_MASKS
    tm.eval()
    jm.eval()
    try:
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        want = _jax_forward(jm, x)
        assert [tuple(g.shape) for g in got] == [(2, 27, 2, 2),
                                                 (2, 27, 4, 4),
                                                 (2, 27, 8, 8)]
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), **EVAL)
    finally:
        tm.train()
        jm.train()


def test_yolo_loss_gradients_and_momentum_step(yolo):
    tm, _, batch, ref = yolo
    _check_training(tm, ref, batch, Momentum(0.01, 0.9, weight_decay=5e-4))


def test_yolo_predict(yolo):
    tm, jm, (x, _, _), _ = yolo
    tm.eval()
    jm.eval()
    try:
        img = np.asarray([[64, 64], [48, 64]], np.int32)
        dets_t, num_t = tm.predict(torch.from_numpy(x), torch.from_numpy(img),
                                   conf_thresh=0.2, keep_top_k=30)
        dets_j, num_j = jm.predict(jnp.asarray(x), img, conf_thresh=0.2,
                                   keep_top_k=30)
        assert int(_np(num_t).sum()) > 5
        np.testing.assert_array_equal(_np(num_t), _np(num_j))
        np.testing.assert_array_equal(_np(dets_t)[:, 0], _np(dets_j)[:, 0])
        np.testing.assert_allclose(_np(dets_t)[:, 1:], _np(dets_j)[:, 1:],
                                   rtol=1e-4, atol=1e-3)
    finally:
        tm.train()
        jm.train()


def test_yolov3_from_jax(yolo):
    _, jm, _, _ = yolo
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    back = yolov3_from_jax(state, device="cpu", num_classes=4, width=8)
    assert not back.training
    for k, v in back.state_dict().items():
        np.testing.assert_array_equal(_np(v), state[k], err_msg=k)
    with pytest.raises(KeyError):
        yolov3_from_jax({k: v for k, v in state.items()
                         if not k.endswith("_variance")}, device="cpu",
                        num_classes=4, width=8)
    with pytest.raises(ValueError):
        yolov3_from_jax({**state, "heads.0.bias": np.zeros(3, np.float32)},
                        device="cpu", num_classes=4, width=8)


def test_full_width_detector_builds_like_the_reference():
    tm = TY.YOLOv3(device="cpu")
    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        jm = JY.YOLOv3()
    finally:
        JI.set_global_initializer(None, None)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jm.state_dict().items()}


# -------------------------------------------------------------------- CRNN
def _ocr_batch(seed, n=2, width=64, s=5, classes=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, 32, width)).astype(np.float32)
    lab = rng.integers(1, classes, (n, s)).astype(np.int64)
    lab_len = np.asarray([s, 3][:n], np.int64)
    lab[1, 3:] = 0
    return x, lab, lab_len


@pytest.fixture(scope="module")
def crnn():
    tm = TO.crnn_tiny(11, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    _random_statistics(tm, 4)
    jm = _twin(tm, JO.crnn_tiny, 11)
    batch = _ocr_batch(5)
    ref = _reference_step(copy.deepcopy(jm), JAdam(learning_rate=5e-3),
                          batch)
    return tm, jm, batch, ref


def test_crnn_names_and_eval_forward(crnn):
    tm, jm, (x, _, _), _ = crnn
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    assert "rnn.rnns.0.rnn_bw.cell.weight_hh" in tm.state_dict()
    tm.eval()
    jm.eval()
    try:
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        assert tuple(got.shape) == (16, 2, 11)
        np.testing.assert_allclose(_np(got), _np(_jax_forward(jm, x)),
                                   **EVAL)
    finally:
        tm.train()
        jm.train()


def test_crnn_loss_gradients_and_adam_step(crnn):
    tm, _, batch, ref = crnn
    # Adam's first step moves each parameter by lr * g / (|g| + eps): a
    # float32 rounding difference in a gradient near eps shows in its
    # update (0.9 % of lr at worst here), so the update is held to 2 % of
    # lr, the gradients themselves to the usual bound
    _check_training(tm, ref, batch, Adam(learning_rate=5e-3),
                    update_atol=2e-2 * 5e-3)


def test_crnn_greedy_decode(crnn):
    tm, jm, (x, _, _), _ = crnn
    tm.eval()
    jm.eval()
    try:
        got = tm.decode(torch.from_numpy(x))
        assert got == jm.decode(jnp.asarray(x))
        ids = np.asarray([[0, 0], [3, 2], [3, 0], [0, 2], [3, 5]])
        assert TO.CRNN.greedy_collapse(ids) == [[3, 3], [2, 2, 5]]
    finally:
        tm.train()
        jm.train()


def test_crnn_from_jax_and_full_size(crnn):
    _, jm, _, _ = crnn
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    back = crnn_from_jax(state, 11, device="cpu", width=8, hidden=32)
    for k, v in back.state_dict().items():
        np.testing.assert_array_equal(_np(v), state[k], err_msg=k)
    with pytest.raises(ValueError):
        crnn_from_jax(state, 11, device="cpu", width=8, hidden=16)
    with pytest.raises(KeyError):
        crnn_from_jax({k: v for k, v in state.items() if "rnn_bw" not in k},
                      11, device="cpu", width=8, hidden=32)
    full = TO.CRNN(6625, device="cpu")
    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        jfull = JO.CRNN(6625)
    finally:
        JI.set_global_initializer(None, None)
    assert {k: tuple(v.shape) for k, v in full.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jfull.state_dict().items()}
    with torch.no_grad():
        assert tuple(full.eval()(torch.zeros(2, 3, 32, 320)).shape) == \
            (80, 2, 6625)


def test_model_zoo_exports_the_references_names():
    """``paddle_tpu_torch.models`` exports what ``paddle_tpu.models``
    exports (``per_row_keys`` is the port's ``per_row_generators``)."""
    want = {n for n in dir(JM) if not n.startswith("_")} - {"per_row_keys"}
    got = {n for n in dir(TM) if not n.startswith("_")}
    assert want - got == set()
    assert TM.PPYOLOE is TM.ppyoloe.PPYOLOE and TM.YOLOv3 is TY.YOLOv3

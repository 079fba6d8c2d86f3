"""ResNet training through the port's ``TrainStep`` and ``hapi.Model``
against the JAX package's, on the CPU: three ``Momentum`` steps
(parameters, velocities, masters, running statistics) in float32 and
under bf16 O2 (float32 logits on float32 images, bf16 on bf16 images, as
the reference computes); gradient merge keeping the micro-steps'
statistics; a skipped guarded step leaving ``_mean`` / ``_variance``
bit-equal; ``Model.fit`` / ``evaluate`` / ``save`` / ``load`` across the
packages. (Forwards, ``EvalStep``, ``flops``, ``summary`` and the
conversions are ``tests/test_torch_resnet.py``'s, and so are the shared
helpers.)

The runs train ``ResNet(BasicBlock, [1, 1, 1, 1])`` on one repeated
batch of 64 x 64 images: 32 values a channel in layer4's statistics. At
32 x 32 with fresh batches, training-mode BatchNorm over few values
amplifies float32 rounding until two float32 runs end a third of a
parameter's range apart (both from a float64 run), and nothing can be
compared. Each test states its measured errors beside its bounds; an
error is the largest |port - reference| of a tensor over its largest
|reference| value, worst tensor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu import hapi as jhapi
from paddle_tpu.framework.jit import TrainStep as JTrainStep
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu_torch import amp, hapi
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework.jit import TrainStep
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from test_torch_resnet import (BF16, CLASSES, EVAL, STATS, _batches, _bits,
                               _jax_forward, _jnp, _np, _port, _same_bits,
                               _twin, few_torch_threads)  # noqa: F401

MODEL = "basic_1111"


def _steps(o2=False, bf16_images=False, accum=1, seed=3, lr=0.01,
           name=MODEL):
    """Three (or, with ``accum``, 3 x accum) Momentum(lr, 0.9) steps of
    ``name`` on both sides: the losses and both steps."""
    tm = _port(name, seed, num_classes=CLASSES).train()
    jm = _twin(tm, name, num_classes=CLASSES)
    jm.train()
    # at the bench's 0.1 this small random network's loss climbs from the
    # first step on, and a chaotic trajectory leaves nothing to compare
    topt, jopt = Momentum(lr, 0.9), JMomentum(lr, 0.9)
    if o2:
        tm, topt = amp.decorate(tm, topt, level="O2", dtype="bfloat16")
        jm, jopt = jamp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    tstep = TrainStep(tm, topt, loss_fn=lambda o, b: F.cross_entropy(o, b[1]),
                      grad_accum_steps=accum)
    tstep.initial = {k: _np(p).copy() for k, p in tm.named_parameters()}
    jstep = JTrainStep(jm, jopt,
                       loss_fn=lambda o, b: JF.cross_entropy(o, b[1]),
                       grad_accum_steps=accum)
    losses = []
    for x, y in _batches(1, seed + 1, size=64) * (3 * accum):
        if bf16_images:
            tx = torch.from_numpy(x).to(torch.bfloat16)
            jx = jnp.asarray(x).astype(jnp.bfloat16)
        else:
            tx, jx = x, x
        losses.append((float(tstep((tx, y))), float(jstep((jx, y)))))
    return np.asarray(losses), tstep, jstep


def _worst(got, want, what):
    """The largest |got - want| of each tensor over its largest |want|,
    worst tensor: ``(value, name)``."""
    worst = (0.0, None)
    for k, t in got.items():
        ref = _jnp(want[k])
        err = float(np.abs(_np(t) - ref).max() / max(np.abs(ref).max(),
                                                         1e-30))
        worst = max(worst, (err, f"{what} {k}"))
    return worst


def _update_error(tstep, jstep):
    """||port update - reference update|| / ||reference update|| over the
    whole model (float32 masters under O2)."""
    t = tstep.opt_state.get("master_weights", tstep.params)
    j = jstep.opt_state.get("master_weights", jstep.params)
    num = den = 0.0
    for k, v in t.items():
        dj = _jnp(j[k]) - tstep.initial[k]
        num += float(((_np(v) - tstep.initial[k] - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    return (num / den) ** 0.5


def _assert_buffers(tstep, jstep, limit):
    bufs = dict(tstep.model.named_buffers())
    assert set(bufs) == set(jstep.buffers)
    assert all(b.dtype == torch.float32 for b in bufs.values())
    err, name = _worst(bufs, jstep.buffers, "buffer")
    assert err <= limit, (err, name)


def test_three_float32_steps_match_the_reference():
    """Measured: losses 1.2e-6 apart, parameters 2.5e-6 and velocities
    3.4e-6 of their largest value, statistics 7.1e-7; bounds 1e-5, 1e-4,
    1e-4 and 1e-5."""
    losses, tstep, jstep = _steps()
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=1e-5)
    assert losses[-1, 0] < losses[0, 0]
    err, name = _worst(tstep.params, jstep.params, "parameter")
    assert err <= 1e-4, (err, name)
    err, name = _worst(tstep.opt_state["velocity"],
                       jstep.opt_state["velocity"], "velocity")
    assert err <= 1e-4, (err, name)
    _assert_buffers(tstep, jstep, 1e-5)


@pytest.mark.parametrize("bf16_images", [False, True])
def test_three_o2_steps_match_the_reference(bf16_images):
    """bf16 O2: float32 images give float32 logits (the bench's quirk:
    the conv casts its bf16 weight to the image's dtype and the bf16
    BatchNorm weights promote to float32), bf16 images bf16 logits; the
    running statistics stay float32.

    Float32 images, measured: losses 2.8e-5 apart, each bf16 parameter
    6.6e-3 of its largest value (two bf16 ulps), velocities 2.6e-3,
    statistics 4.9e-5, the model's update error 1.8e-4; bounds 2e-2 (the
    reference's bf16 bound), 1.6e-2, 2e-2, 1e-3 and 2e-3. bf16 images
    (lr 0.001; at 0.01 the bf16 loss reaches 0 within three steps): the
    whole network computes in bf16 and each BatchNorm's bias gradient
    cancels over batch x H x W bf16 terms, so the updates part 11 %
    (measured 0.113 of the reference's update over the model); held at
    losses 2e-2 (measured 4.6e-3), statistics 2e-2 (3.6e-3), update
    error 0.25."""
    lr = 0.001 if bf16_images else 0.01
    losses, tstep, jstep = _steps(o2=True, bf16_images=bf16_images, lr=lr)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], **BF16)
    x, _ = _batches(1, 9, size=64)[0]
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if bf16_images:
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    with torch.no_grad():
        out_t = tstep.model.eval()(tx)
    jstep.sync_to_model()
    jstep.model.eval()
    out_j = _jax_forward(jstep.model, jx)[0]
    want = "bfloat16" if bf16_images else "float32"
    assert str(out_j.dtype) == want
    assert out_t.dtype == getattr(torch, want)
    assert all(p.dtype == torch.bfloat16 for p in tstep.params.values())
    if bf16_images:
        _assert_buffers(tstep, jstep, 2e-2)
        assert _update_error(tstep, jstep) <= 0.25
        return
    np.testing.assert_allclose(_np(out_t), _jnp(out_j), **BF16)
    err, name = _worst(tstep.params, jstep.params, "parameter")
    assert err <= 1.6e-2, (err, name)
    err, name = _worst(tstep.opt_state["velocity"],
                       jstep.opt_state["velocity"], "velocity")
    assert err <= 2e-2, (err, name)
    _assert_buffers(tstep, jstep, 1e-3)
    assert _update_error(tstep, jstep) <= 2e-3


def test_gradient_merge_keeps_micro_step_statistics():
    """With ``grad_accum_steps=2`` the micro-steps' running statistics are
    kept (the reference carries its forward's new buffers out of an
    accumulate-only call), and the merged updates match (the float32
    test's bounds)."""
    losses, tstep, jstep = _steps(accum=2)
    np.testing.assert_allclose(losses[:, 0], losses[:, 1], rtol=1e-5)
    err, name = _worst(tstep.params, jstep.params, "parameter")
    assert err <= 1e-4, (err, name)
    _assert_buffers(tstep, jstep, 1e-5)
    # an accumulate-only call moves the statistics and no parameter
    tm = _port(MODEL, 3, num_classes=CLASSES).train()
    step = TrainStep(tm, Momentum(0.1, 0.9),
                     loss_fn=lambda o, b: F.cross_entropy(o, b[1]),
                     grad_accum_steps=2)
    before = _bits(tm)
    params = {k: p.detach().clone() for k, p in tm.named_parameters()}
    step(_batches(1, 4)[0])
    assert not _same_bits(tm, before)
    assert all(torch.equal(p, params[k]) for k, p in tm.named_parameters())


@pytest.mark.parametrize("guard", ["anomaly", "check_nan_inf", "scaler"])
def test_skipped_step_restores_the_statistics(guard):
    """A guarded step that skips leaves every parameter, velocity and
    running statistic bit-equal to its value before the step, as the
    reference's selects its old buffers back; a committed guarded step
    moves them."""
    tm = _port(MODEL, 5, num_classes=CLASSES).train()
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 4) \
        if guard == "scaler" else None
    step = TrainStep(tm, Momentum(0.1, 0.9),
                     loss_fn=lambda o, b: F.cross_entropy(o, b[1]),
                     scaler=scaler)
    (x, y), (x2, y2) = _batches(2, 6)
    step((x, y))
    bufs, params = _bits(tm), {k: p.detach().clone()
                               for k, p in tm.named_parameters()}
    vel = {k: v.clone() for k, v in step.opt_state["velocity"].items()}
    if guard == "anomaly":
        step.inject_anomaly()
        _, ok, _ = step.watchdog_call((x2, y2))
        assert not bool(ok)
    elif guard == "check_nan_inf":
        tflags.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError):
                step((np.full_like(x2, np.nan), y2))
        finally:
            tflags.set_flags({"FLAGS_check_nan_inf": False})
    else:
        step.inject_anomaly()
        step((x2, y2))
    assert _same_bits(tm, bufs)
    assert all(torch.equal(p, params[k]) for k, p in tm.named_parameters())
    assert all(torch.equal(v, vel[k])
               for k, v in step.opt_state["velocity"].items())
    # the same guarded path commits a sound step, statistics included
    step.watchdog_call((x2, y2))
    assert not _same_bits(tm, bufs)


def test_skipped_step_matches_the_reference_buffers():
    """After a sound step and a poisoned one, both packages' running
    statistics are those of the sound step."""
    tm = _port(MODEL, 7, num_classes=CLASSES).train()
    jm = _twin(tm, MODEL, num_classes=CLASSES)
    jm.train()
    tstep = TrainStep(tm, Momentum(0.1, 0.9),
                      loss_fn=lambda o, b: F.cross_entropy(o, b[1]))
    jstep = JTrainStep(jm, JMomentum(0.1, 0.9),
                       loss_fn=lambda o, b: JF.cross_entropy(o, b[1]))
    (x, y), (x2, y2) = _batches(2, 8)
    for s in (tstep, jstep):
        s.watchdog_call((x, y))
    for s in (tstep, jstep):
        s.inject_anomaly()
        _, ok, _ = s.watchdog_call((x2, y2))
        assert not bool(ok)
    for k, b in tm.named_buffers():
        np.testing.assert_allclose(_np(b), _jnp(jstep.buffers[k]),
                                   err_msg=k, **STATS)


def _ce_port(out, label):
    return F.cross_entropy(out, label)


def _ce_ref(out, label):
    return JF.cross_entropy(out, label)


def test_model_fit_evaluate_save_load_across_packages(tmp_path):
    """``Model.fit`` moves the statistics as the reference's does (the
    network is not switched to eval); ``evaluate`` leaves them; ``save``
    writes ``_mean`` / ``_variance`` under the reference's names, and each
    package's checkpoint loads into the other."""
    tnet = _port(MODEL, 12, num_classes=CLASSES).train()
    jnet = _twin(tnet, MODEL, num_classes=CLASSES)
    jnet.train()
    data = _batches(1, 13, batch=16)[0]
    xs, ys = data[0], data[1].astype(np.int64)
    tm, jm = hapi.Model(tnet), jhapi.Model(jnet)
    tm.prepare(Momentum(0.01, 0.9), loss=_ce_port)
    jm.prepare(JMomentum(0.01, 0.9), loss=_ce_ref)
    th = tm.fit(TensorDataset([xs, ys]), batch_size=8, epochs=1, verbose=0,
                shuffle=False)
    jh = jm.fit(JTensorDataset([xs, ys]), batch_size=8, epochs=1, verbose=0,
                shuffle=False)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert tnet.training
    saved = _bits(tnet)
    tr = tm.evaluate(TensorDataset([xs, ys]), batch_size=8, verbose=0)
    jr = jm.evaluate(JTensorDataset([xs, ys]), batch_size=8, verbose=0)
    assert _same_bits(tnet, saved)
    np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-3)
    for k, b in tnet.named_buffers():
        np.testing.assert_allclose(_np(b), _jnp(jnet._get_by_path(k)),
                                   err_msg=k, **STATS)
    tpath, jpath = str(tmp_path / "port" / "m"), str(tmp_path / "ref" / "m")
    tm.save(tpath)
    jm.save(jpath)
    # the port's checkpoint in the reference, the reference's in the port
    j2 = jhapi.Model(_twin(_port(MODEL, 99,
                                 num_classes=CLASSES), MODEL,
                           num_classes=CLASSES))
    j2.load(tpath)
    t2 = hapi.Model(_port(MODEL, 98, num_classes=CLASSES))
    t2.load(jpath)
    for k, b in tnet.named_buffers():
        assert t2.network.state_dict()[k].dtype == torch.float32
        np.testing.assert_array_equal(_np(b), _jnp(j2.network._get_by_path(k)))
        np.testing.assert_array_equal(_np(t2.network.state_dict()[k]),
                                      _jnp(jnet._get_by_path(k)))
    t2.prepare()
    t2.network.eval()
    jnet.eval()
    np.testing.assert_allclose(t2.predict_batch([xs[:4]]),
                               np.asarray(jnet(jnp.asarray(xs[:4]))),
                               **EVAL)



"""The port's high-level API (``paddle_tpu_torch.hapi``: ``Model`` with
``fit``/``evaluate``/``predict``/``save``/``load``, the callbacks, and
``paddle_tpu_torch.metric``) against the JAX package's, on the CPU.

Reference weights cross by name (``convert.gpt_from_jax`` and
``layer_from_jax``); the same numpy data goes through both fit loops with
``shuffle=False``. Tolerances, float32: per-batch and epoch losses 1e-5
relative (two frameworks, same math, different summation orders; Adam
keeps the trajectories together over these few steps, as in
``tests/test_torch_train.py``), predictions 1e-5 absolute. Metrics
(accuracy, precision, recall, AUC) are counts and must be equal, ties in
``Accuracy`` included.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import hapi as jhapi
from paddle_tpu import metric as jmetric
import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch import hapi, metric
from paddle_tpu_torch.convert import gpt_from_jax, layer_from_jax
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.io import DataLoader, TensorDataset
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers.common import Embedding, Linear
from paddle_tpu_torch.optimizer import Adam, AdamW
from torch_threads import few_torch_threads  # noqa: F401

RTOL = 1e-5
NO_DROP = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


class JMLP(jnn.Layer):
    def __init__(self, in_dim=8, n_classes=4):
        super().__init__()
        self.fc1 = jnn.Linear(in_dim, 16)
        self.fc2 = jnn.Linear(16, n_classes)

    def forward(self, x):
        return self.fc2(JF.relu(self.fc1(x)))


class MLP(torch.nn.Module):
    def __init__(self, in_dim=8, n_classes=4):
        super().__init__()
        self.fc1 = Linear(in_dim, 16, device="cpu")
        self.fc2 = Linear(16, n_classes, device="cpu")

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class JTiny(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.embed = jnn.Embedding(64, 16)
        self.head = jnn.Linear(16, 4)

    def forward(self, ids):
        return self.head(self.embed(ids).mean(axis=1))


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.embed = Embedding(64, 16, device="cpu")
        self.head = Linear(16, 4, device="cpu")

    def forward(self, ids):
        return self.head(self.embed(ids).mean(dim=1))


def _jax_gpt():
    pt.seed(11)
    return JaxGPT(jax_gpt_tiny(**NO_DROP))


def _pair(jcls, tcls, seed=0):
    pt.seed(seed)
    jnet = jcls()
    state = {k: np.asarray(v) for k, v in jnet.state_dict().items()}
    return jnet, layer_from_jax(tcls(), state).train()


def _data(n=64, in_dim=8, n_classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, in_dim)).astype(np.float32)
    y = rng.integers(0, n_classes, size=(n, 1)).astype(np.int64)
    return x, y


class _Ragged:
    """(ids[L], label): lengths 12, 20 and 28 in blocks of 8 samples, 22
    samples (a ragged tail batch at batch size 4)."""

    def __len__(self):
        return 22

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        L = (12, 20, 28)[min(i // 8, 2)]
        return (np.asarray(rng.integers(1, 64, L), np.int64),
                np.int64(i % 4))


class JRagged(_Ragged, jio.Dataset):
    pass


class Ragged(_Ragged, tio.Dataset):
    pass


def _recorder(base):
    """A callback of package ``base`` that logs every hook it sees and
    each train batch's loss."""
    class Rec(base):
        def __init__(self):
            super().__init__()
            self.events, self.losses = [], []

        def __getattribute__(self, name):
            if name.startswith("on_"):
                events = object.__getattribute__(self, "events")
                losses = object.__getattribute__(self, "losses")

                def hook(*args, logs=None, **kw):
                    if args and isinstance(args[-1], dict):
                        logs = args[-1]
                    events.append(name)
                    if name == "on_train_batch_end":
                        losses.append(float(logs["loss"]))
                return hook
            return object.__getattribute__(self, name)
    return Rec()


def _ce(logits, label):
    return F.cross_entropy(logits, label)


def _jce(logits, label):
    return JF.cross_entropy(logits, label)


def _fit_both(jnet, tnet, train, val=None, metrics=False, **kw):
    jm = jhapi.Model(jnet)
    jm.prepare(JAdam(learning_rate=0.01), loss=_jce,
               metrics=jmetric.Accuracy(topk=(1, 2)) if metrics else None)
    tm = hapi.Model(tnet)
    tm.prepare(Adam(learning_rate=0.01), loss=_ce,
               metrics=metric.Accuracy(topk=(1, 2)) if metrics else None)
    jrec, trec = _recorder(jhapi.Callback), _recorder(hapi.Callback)
    jh = jm.fit(JTensorDataset(train) if isinstance(train, list) else train,
                None if val is None else JTensorDataset(val),
                shuffle=False, verbose=0, callbacks=[jrec], **kw)
    th = tm.fit(TensorDataset(train) if isinstance(train, list) else train,
                None if val is None else TensorDataset(val),
                shuffle=False, verbose=0, callbacks=[trec], **kw)
    return jm, tm, jh, th, jrec, trec


def _assert_history_close(jh, th):
    assert set(jh) == set(th)
    for k in jh:
        a, b = np.asarray(jh[k], np.float64), np.asarray(th[k], np.float64)
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------- fit
def test_fit_evaluate_predict_match_the_reference(tmp_path):
    jnet, tnet = _pair(JMLP, MLP)
    train, val = list(_data(64)), list(_data(32, seed=1))
    jm, tm, jh, th, jrec, trec = _fit_both(jnet, tnet, train, val,
                                           metrics=True, batch_size=16,
                                           epochs=2)
    assert "loss" in th and len(th["loss"]) == 2
    assert {"acc_top1", "eval_loss", "eval_acc_top1"} <= set(th)
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=RTOL)
    _assert_history_close(jh, th)
    # callback order, hook for hook
    assert trec.events == jrec.events
    jr = jm.evaluate(JTensorDataset(val), batch_size=16, verbose=0)
    tr = tm.evaluate(TensorDataset(val), batch_size=16, verbose=0)
    # (as in the reference, a top-(1, 2) Accuracy logs both under one key)
    assert jr["acc_top1"] == tr["acc_top1"]
    np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=RTOL)
    test_x = np.random.default_rng(2).normal(size=(8, 8)).astype(np.float32)
    jp = jm.predict(JTensorDataset([test_x]), batch_size=4,
                    stack_outputs=True)
    tp = tm.predict(TensorDataset([test_x]), batch_size=4,
                    stack_outputs=True)
    assert tp.shape == (8, 4) and isinstance(tp, np.ndarray)
    np.testing.assert_allclose(tp, np.asarray(jp), atol=1e-5)


def test_fit_decreases_loss_and_gpt_history_matches():
    jnet = _jax_gpt()
    state = {k: np.asarray(v) for k, v in jnet.state_dict().items()}
    tnet = gpt_from_jax(state, gpt_tiny(**NO_DROP), device="cpu").train()
    ids = np.random.default_rng(0).integers(0, 1024, (16, 24)).astype(
        np.int32)
    jm = jhapi.Model(jnet, labels=[])
    jm.prepare(JAdamW(learning_rate=1e-3, weight_decay=0.01))
    tm = hapi.Model(tnet, labels=[])
    tm.prepare(AdamW(learning_rate=1e-3, weight_decay=0.01))
    jrec, trec = _recorder(jhapi.Callback), _recorder(hapi.Callback)
    jh = jm.fit(JTensorDataset([ids, ids]), batch_size=4, epochs=2,
                shuffle=False, verbose=0, callbacks=[jrec])
    th = tm.fit(TensorDataset([ids, ids]), batch_size=4, epochs=2,
                shuffle=False, verbose=0, callbacks=[trec], num_workers=2,
                prefetch_depth=2)
    assert len(trec.losses) == 8 and trec.losses[-1] < trec.losses[0]
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=RTOL)
    _assert_history_close(jh, th)
    # the step's reference-shaped counters: the port compiles nothing
    stats = tm._train_step.cache_stats()
    assert stats["compiles"] == 0 and stats["calls"] == 8


def test_padded_bucketed_fit_with_metrics_matches_the_reference():
    jnet, tnet = _pair(JTiny, Tiny)
    kw = dict(batch_size=4, epochs=1, pad_batches=True,
              length_buckets=(16, 32))
    specs = dict(inputs=[(None, None)], labels=[(None,)])
    jm = jhapi.Model(jnet, **{k: [jhapi.InputSpec(s) for s in v]
                              for k, v in specs.items()})
    jm.prepare(JAdam(learning_rate=0.05), loss=_jce,
               metrics=jmetric.Accuracy())
    tm = hapi.Model(tnet, **{k: [hapi.InputSpec(s) for s in v]
                             for k, v in specs.items()})
    tm.prepare(Adam(learning_rate=0.05), loss=_ce, metrics=metric.Accuracy())
    jrec, trec = _recorder(jhapi.Callback), _recorder(hapi.Callback)
    jh = jm.fit(JRagged(), JRagged(), shuffle=False, verbose=0,
                callbacks=[jrec], **kw)
    th = tm.fit(Ragged(), Ragged(), shuffle=False, verbose=0,
                callbacks=[trec], prefetch_depth=2, **kw)
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=RTOL)
    _assert_history_close(jh, th)
    # the padded tail's filler rows are left out of eval and predict
    out = tm.predict(DataLoader(Ragged(), batch_size=4, pad_batches=True,
                                length_buckets=(16, 32)), stack_outputs=True)
    assert out.shape == (22, 4)


# ------------------------------------------------------------- metrics
def test_accuracy_ties_follow_the_reference():
    rng = np.random.default_rng(0)
    # scores on a coarse grid: many ties inside each row
    pred = rng.integers(0, 3, (64, 6)).astype(np.float32)
    label = rng.integers(0, 6, (64, 1))
    for topk in ((1,), (1, 3)):
        jm, tm = jmetric.Accuracy(topk=topk), metric.Accuracy(topk=topk)
        jc = np.asarray(jm.compute(pred, label))
        tc = tm.compute(torch.from_numpy(pred), torch.from_numpy(label))
        np.testing.assert_array_equal(tc.numpy(), jc)
        assert tm.update(tc) == jm.update(jc)
        assert tm.accumulate() == jm.accumulate()
        assert tm.name() == jm.name()
    for k in (1, 2, 4):
        assert float(metric.accuracy(torch.from_numpy(pred),
                                     torch.from_numpy(label), k=k)) \
            == float(jmetric.accuracy(pred, label, k=k))
    m = metric.Accuracy(topk=(1, 2))
    pred2 = np.array([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1]], np.float32)
    m.update(m.compute(pred2, np.array([[1], [2]])))
    assert m.accumulate() == [0.5, 1.0]
    m.reset()
    assert m.accumulate() == [0.0, 0.0]


def test_precision_recall_auc_equal_the_reference():
    rng = np.random.default_rng(1)
    preds, labels = rng.uniform(0, 1, 500), rng.integers(0, 2, 500)
    for cls in ("Precision", "Recall"):
        a, b = getattr(metric, cls)(), getattr(jmetric, cls)()
        a.update(preds, labels)
        b.update(preds, labels)
        assert a.accumulate() == b.accumulate() and a.name() == b.name()
    a, b = metric.Auc(num_thresholds=255), jmetric.Auc(num_thresholds=255)
    two = np.stack([1 - preds, preds], 1)
    a.update(two, labels)
    b.update(two, labels)
    np.testing.assert_array_equal(a.stat_pos, b.stat_pos)
    assert a.accumulate() == b.accumulate()
    a.reset()
    pos, neg = rng.uniform(0.8, 1.0, 100), rng.uniform(0.0, 0.2, 100)
    a.update(np.concatenate([pos, neg]),
             np.concatenate([np.ones(100), np.zeros(100)]))
    assert a.accumulate() > 0.99


# ----------------------------------------------------------- save / load
def test_save_load_roundtrip_and_cross_package(tmp_path):
    jnet, tnet = _pair(JMLP, MLP)
    train = list(_data(32))
    jm, tm, *_ = _fit_both(jnet, tnet, train, batch_size=16, epochs=1)
    path = str(tmp_path / "ckpt" / "m")
    tm.save(path)
    assert os.path.exists(path + ".pdparams") and \
        os.path.exists(path + ".pdopt")
    x = np.ones((2, 8), np.float32)
    saved = tm.predict_batch(x)
    m2 = hapi.Model(MLP())
    m2.prepare(Adam(learning_rate=0.01), loss=_ce)
    m2.load(path)
    np.testing.assert_array_equal(m2.predict_batch(x), tm.predict_batch(x))
    # the optimizer state rides along: one more step agrees bit for bit
    m2._ensure_train_step()
    m2.load(path)
    batch = (train[0][:16], train[1][:16])
    assert m2.train_batch(*batch) == tm.train_batch(*batch)
    # a reference-written checkpoint loads in the port, and back
    jpath = str(tmp_path / "ref" / "m")
    jm.save(jpath)
    m3 = hapi.Model(MLP())
    m3.prepare(Adam(learning_rate=0.01), loss=_ce)
    m3.load(jpath)
    np.testing.assert_allclose(m3.predict_batch(x),
                               np.asarray(jm.predict_batch(x)), atol=1e-5)
    j2 = jhapi.Model(JMLP())
    j2.prepare(JAdam(learning_rate=0.01), loss=_jce)
    j2.load(path)
    np.testing.assert_allclose(np.asarray(j2.predict_batch(x)), saved,
                               atol=1e-5)


def test_model_checkpoint_files_equal_the_reference(tmp_path):
    jnet, tnet = _pair(JMLP, MLP)
    train = list(_data(32))
    _fit_both(jnet, tnet, train, batch_size=16, epochs=2, save_freq=1,
              save_dir=None)
    for pkg, net, data, opt, d in (
            (jhapi, jnet, JTensorDataset(train), JAdam, tmp_path / "ref"),
            (hapi, tnet, TensorDataset(train), Adam, tmp_path / "port")):
        m = pkg.Model(net)
        m.prepare(opt(learning_rate=0.01), loss=_jce if pkg is jhapi else _ce)
        m.fit(data, batch_size=16, epochs=2, shuffle=False, verbose=0,
              save_dir=str(d))
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref")) == [
            "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams",
            "final.pdopt", "final.pdparams"]


def test_early_stopping_lr_scheduler_and_scalar_logger(tmp_path):
    trandom.seed(0)
    model = hapi.Model(MLP())
    model.prepare(optimizer=Adam(learning_rate=0.0), loss=_ce,
                  metrics=metric.Accuracy())
    data = TensorDataset(list(_data(32)))
    es = hapi.EarlyStopping(monitor="loss", patience=0, verbose=0,
                            save_best_model=False)
    logger = hapi.ScalarLogger(log_dir=str(tmp_path / "runs"), log_freq=1)
    model.fit(data, data, batch_size=16, epochs=5, verbose=0,
              callbacks=[es, logger, hapi.LRScheduler()])
    assert model.stop_training
    lines = (tmp_path / "runs" / "scalars.jsonl").read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    assert {r["tag"] for r in recs} == {"train", "eval"}
    # summary() is ported: it needs a shape (or the Model's inputs), as
    # the reference's does
    with pytest.raises(ValueError, match="input_size"):
        model.summary()
    assert model.summary((2, 8)) == {
        "total_params": 8 * 16 + 16 + 16 * 4 + 4,
        "trainable_params": 8 * 16 + 16 + 16 * 4 + 4}
    # fit(lora=dict) takes LoraConfig's keyword names, as the reference's
    with pytest.raises(TypeError, match="'r'"):
        model.fit(data, lora={"r": 4})


def test_progbar_logger_prints(capsys):
    trandom.seed(0)
    model = hapi.Model(MLP())
    model.prepare(optimizer=Adam(learning_rate=0.01), loss=_ce)
    model.fit(TensorDataset(list(_data(32))), batch_size=16, epochs=1,
              verbose=2, log_freq=1, shuffle=False)
    out = capsys.readouterr().out
    assert "Epoch 1/1" in out and "step 2/2" in out and "loss:" in out


def test_generate_and_serve_through_the_model():
    trandom.seed(3)
    net = gpt_from_jax({k: np.asarray(v) for k, v in _jax_gpt().state_dict()
                        .items()}, gpt_tiny(**NO_DROP), device="cpu").eval()
    m = hapi.Model(net, labels=[])
    ids = np.random.default_rng(4).integers(0, 1024, (1, 12))
    want = np.asarray(net.generate(ids, 6))
    np.testing.assert_array_equal(np.asarray(m.generate(ids, 6)), want)
    srv = m.serve(slots=2, max_length=64, prefill_buckets=(32,),
                  device="cpu")
    try:
        got = srv.submit(ids[0], max_new_tokens=6).result(timeout=120)
    finally:
        srv.shutdown()
    np.testing.assert_array_equal(np.asarray(got).reshape(-1),
                                  want.reshape(-1)[-6:])
    with pytest.raises(TypeError, match="generate"):
        hapi.Model(MLP()).generate(ids)

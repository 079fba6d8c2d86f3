"""The port's slot-record datasets (``paddle_tpu_torch.io.slot_dataset``:
InMemoryDataset, QueueDataset, BoxPSDataset) against the JAX package's, on
the CPU: the twins of ``tests/test_slot_dataset.py`` and of
``test_int64_signs_through_slot_feed`` in ``tests/test_ps.py``.

Both packages parse, shuffle and batch in the same C++ feed, so every
batch (int64 signs, counts, labels) is held bit-equal. The CTR train loop
over the feed (StagedPull, a logistic loss) is held to the reference's
jitted step at float32 tolerance: rtol 1e-5 / atol 1e-6 on every step's
loss and on the table's rows at the end.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.io import slot_dataset as JS
from paddle_tpu_torch.io import slot_dataset as S


def write_ctr_file(path, n=100, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        label = int(rng.integers(2))
        s1 = ",".join(str(int(x)) for x in rng.integers(0, 1000, 3))
        s2 = ",".join(str(int(x)) for x in rng.integers(1000, 2000,
                                                        rng.integers(1, 5)))
        lines.append(f"{label}\t101:{s1}\t102:{s2}")
    path.write_text("\n".join(lines) + "\n")
    return lines


def _datasets(cls_name, files, **kw):
    """The same dataset in both packages, loaded: ``(port, reference)``."""
    out = []
    for mod in (S, JS):
        ds = getattr(mod, cls_name)(**kw)
        ds.load_into_memory([str(f) for f in files])
        out.append(ds)
    return out


def _same_batches(a, b):
    ba, bb = list(a), list(b)
    assert len(ba) == len(bb)
    for (sa, ca, la), (sb, cb, lb) in zip(ba, bb):
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k].dtype == np.int64
            np.testing.assert_array_equal(sa[k], sb[k])
            np.testing.assert_array_equal(ca[k], cb[k])
        np.testing.assert_array_equal(la, lb)
    return ba


def test_load_and_batch(tmp_path):
    f = tmp_path / "part-0"
    write_ctr_file(f, n=100)
    ds, jds = _datasets("InMemoryDataset", [f], slots=[101, 102],
                        batch_size=32, max_per_slot=4)
    assert len(ds) == len(jds) == 100
    batches = _same_batches(ds, jds)
    assert len(batches) == 3
    signs, counts, labels = batches[0]
    assert signs[101].shape == (32, 4) and signs[102].shape == (32, 4)
    assert labels.shape == (32,) and set(np.unique(labels)) <= {0.0, 1.0}
    assert (counts[101] == 3).all() and (signs[101][:, 3] == -1).all()
    assert counts[102].min() >= 1 and counts[102].max() <= 4


def test_first_record_content(tmp_path):
    f = tmp_path / "part-0"
    f.write_text("1\t101:5,7\t102:42\n0\t101:9\n")
    ds, jds = _datasets("InMemoryDataset", [f], slots=[101, 102],
                        batch_size=2, max_per_slot=3, drop_last=False)
    signs, counts, labels = _same_batches(ds, jds)[0]
    np.testing.assert_array_equal(labels, [1.0, 0.0])
    np.testing.assert_array_equal(signs[101], [[5, 7, -1], [9, -1, -1]])
    np.testing.assert_array_equal(signs[102], [[42, -1, -1], [-1, -1, -1]])
    np.testing.assert_array_equal(counts[102], [1, 0])


def test_unknown_slots_ignored_and_errors(tmp_path):
    f = tmp_path / "part-0"
    f.write_text("1\t999:1,2\t101:3\n")
    bad = tmp_path / "bad"
    bad.write_text("not_a_label\t101:1\n")
    for mod in (S, JS):
        ds = mod.InMemoryDataset(slots=[101], batch_size=1, drop_last=False)
        ds.load_into_memory([str(f)])
        signs, _, _ = next(iter(ds))
        np.testing.assert_array_equal(signs[101][0][:1], [3])
        with pytest.raises(IOError):
            ds.load_into_memory([str(tmp_path / "missing")])
        with pytest.raises(ValueError, match="malformed"):
            ds.load_into_memory([str(bad)])


def test_shuffle_is_permutation(tmp_path):
    f = tmp_path / "part-0"
    write_ctr_file(f, n=64)
    ds, jds = _datasets("InMemoryDataset", [f], slots=[101], batch_size=64,
                        max_per_slot=3)
    before = next(iter(ds))[0][101].copy()
    for d in (ds, jds):
        d.local_shuffle(seed=7)
    after = _same_batches(ds, jds)[0][0][101]
    assert not np.array_equal(before, after)
    assert sorted(map(tuple, before.tolist())) == \
        sorted(map(tuple, after.tolist()))
    ds.global_shuffle(seed=9)
    jds.global_shuffle(seed=9)
    _same_batches(ds, jds)
    ds.release_memory()
    assert len(ds) == 0


def test_truncated_line_rejected_not_merged(tmp_path):
    bad = tmp_path / "bad"
    bad.write_text("1\t101:\n0\t101:7\n")
    ok = tmp_path / "ok"
    ok.write_text("1\t101:3\n\n0\t101:7\n")
    for mod in (S, JS):
        ds = mod.InMemoryDataset(slots=[101], batch_size=1, drop_last=False)
        with pytest.raises(ValueError, match="malformed"):
            ds.load_into_memory([str(bad)])
        ds2 = mod.InMemoryDataset(slots=[101], batch_size=2,
                                  drop_last=False)
        assert ds2.load_into_memory([str(ok)]) == 2


def test_int64_signs_through_slot_feed(tmp_path):
    big = 2 ** 40 + 7
    f = tmp_path / "part"
    f.write_text(f"1\t101:{big},{big + 2 ** 32}\n")
    ds, jds = _datasets("InMemoryDataset", [f], slots=[101], batch_size=1,
                        max_per_slot=2, drop_last=False)
    signs = _same_batches(ds, jds)[0][0]
    assert signs[101].dtype == np.int64
    np.testing.assert_array_equal(signs[101][0], [big, big + 2 ** 32])


def test_queue_and_boxps_datasets_stream_in_order(tmp_path):
    f = tmp_path / "part-0"
    write_ctr_file(f, n=40)
    for name in ("QueueDataset", "BoxPSDataset"):
        ds, jds = _datasets(name, [f], slots=[101, 102], batch_size=8,
                            max_per_slot=4)
        assert isinstance(ds, S.InMemoryDataset)
        _same_batches(ds, jds)
        for fn in (ds.local_shuffle, ds.global_shuffle):
            with pytest.raises(NotImplementedError):
                fn(seed=1)


def test_ctr_train_e2e(tmp_path):
    """The train_from_dataset slice: slot file -> InMemoryDataset ->
    StagedPull over a PS table -> logistic loss -> AUC. The port's torch
    step against the reference's jitted step on the same batches: every
    loss and the final rows at float32 tolerance; the loss halves and the
    training-set AUC passes 0.9 as in the reference."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.distributed.ps import (MemorySparseTable as JTable,
                                           SparseAccessorConfig as JCfg,
                                           StagedPull as JStaged)
    from paddle_tpu_torch.distributed.ps import (MemorySparseTable,
                                                 SparseAccessorConfig,
                                                 StagedPull)
    from paddle_tpu_torch.metric import Auc

    rng = np.random.default_rng(5)
    lines = []
    for _ in range(512):
        label = int(rng.integers(2))
        base = 0 if label else 500
        lines.append(f"{label}\t101:" + ",".join(
            map(str, rng.integers(base, base + 200, 3))))
    f = tmp_path / "train"
    f.write_text("\n".join(lines))
    ds, jds = _datasets("InMemoryDataset", [f], slots=[101], batch_size=128,
                        max_per_slot=3)
    table = MemorySparseTable(SparseAccessorConfig(
        embed_dim=8, optimizer="adagrad", learning_rate=0.2, seed=0))
    jtable = JTable(JCfg(embed_dim=8, optimizer="adagrad",
                         learning_rate=0.2, seed=0))
    staged, jstaged = StagedPull(table, device="cpu"), JStaged(jtable)

    @jax.jit
    def jstep(rows, inv, mask, labels):
        def loss_fn(rows):
            emb = JStaged.lookup(rows, inv) * mask[:, :, None]
            logit = emb.sum((1, 2))
            return -jnp.mean(labels * jax.nn.log_sigmoid(logit)
                             + (1 - labels) * jax.nn.log_sigmoid(-logit))
        return jax.value_and_grad(loss_fn)(rows)

    def step(rows, inv, mask, labels):
        rows = rows.requires_grad_(True)
        logit = (StagedPull.lookup(rows, inv) * mask[:, :, None]).sum((1, 2))
        F = torch.nn.functional
        loss = -torch.mean(labels * F.logsigmoid(logit)
                           + (1 - labels) * F.logsigmoid(-logit))
        (g,) = torch.autograd.grad(loss, rows)
        return loss, g

    losses, jlosses = [], []
    for epoch in range(6):
        ds.local_shuffle(seed=epoch)
        jds.local_shuffle(seed=epoch)
        for (signs, _, labels), (jsigns, _, jlabels) in zip(ds, jds):
            np.testing.assert_array_equal(signs[101], jsigns[101])
            ids = signs[101].clip(min=0)
            mask = (signs[101] >= 0).astype(np.float32)
            rows, inv, uniq = staged.pull(ids)
            loss, g = step(rows, inv, torch.as_tensor(mask),
                           torch.as_tensor(labels))
            staged.push(uniq, g)
            jrows, jinv, juniq = jstaged.pull(ids)
            jloss, jg = jstep(jrows, jinv, jnp.asarray(mask),
                              jnp.asarray(labels))
            jstaged.push(juniq, jg)
            losses.append(float(loss))
            jlosses.append(float(jloss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    keys = np.arange(0, 700)
    np.testing.assert_allclose(table.pull(keys), jtable.pull(keys),
                               rtol=1e-5, atol=1e-6)

    auc = Auc()
    for signs, _, labels in ds:
        ids = signs[101].clip(min=0)
        mask = (signs[101] >= 0).astype(np.float32)
        rows, inv, _ = staged.pull(ids)
        logit = (StagedPull.lookup(rows, inv).numpy()
                 * mask[:, :, None]).sum((1, 2))
        prob = 1 / (1 + np.exp(-logit))
        auc.update(np.stack([1 - prob, prob], axis=1), labels[:, None])
    assert auc.accumulate() > 0.9

"""The port's parameter-server tables, SparseEmbedding, StagedPull, the
pass builder and the FL coordinator (``paddle_tpu_torch.distributed.ps``)
against the JAX package's, on the CPU: the twins of ``tests/test_ps.py``.

Both packages compile the same C++ sources (each into its own library), so
rows, saved files and optimizer updates are held bit-equal: every twin runs
the same numpy inputs through both packages' tables and compares with
``assert_array_equal``. Where a step computes in float32 on either side
(the SparseEmbedding train step, the CTR step with a dense tower, StagedPull
through a loss), the tolerance is rtol 1e-5 / atol 1e-7 on losses, rows
and dense weights (float32 sums of a few dozen terms in another order).

Also here: table files crossing between the packages byte for byte, the
pulls of one ``TrainStep`` call counted (exactly one a lookup), the
``grad_anchor`` ``RuntimeError``, duplicate ids pushed once per occurrence
through the lookup path, and int64 ids above 2^31 (the port keeps them,
the reference's lookup path narrows them to int32).
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import ps as J
from paddle_tpu_torch import native
from paddle_tpu_torch.distributed import ps as P
from paddle_tpu_torch.distributed.ps.table import (read_table_file,
                                                   read_table_rows,
                                                   write_table_subset)

TOL = dict(rtol=1e-5, atol=1e-7)


def _cfg(mod, optimizer="sgd", dim=4, lr=0.1, **kw):
    return mod.SparseAccessorConfig(
        embed_dim=dim, optimizer=optimizer, learning_rate=lr,
        initial_range=0.01, seed=7, **kw)


def make_tables(optimizer="sgd", dim=4, lr=0.1, **kw):
    """The same table in both packages: ``(port, reference)``."""
    return (P.MemorySparseTable(_cfg(P, optimizer, dim, lr, **kw)),
            J.MemorySparseTable(_cfg(J, optimizer, dim, lr, **kw)))


def _both(tables, fn):
    """``fn(table)`` on each table; the two results must be bit-equal."""
    got = [fn(t) for t in tables]
    np.testing.assert_array_equal(got[0], got[1])
    return got[0]


# ------------------------------------------------------------ tables
def test_pull_deterministic_init():
    tabs = make_tables()
    a = _both(tabs, lambda t: t.pull([3, 5, 3]))
    assert a.shape == (3, 4)
    np.testing.assert_array_equal(a[0], a[2])
    assert np.abs(a).max() <= 0.01
    b = _both(make_tables(), lambda t: t.pull([3]))
    np.testing.assert_array_equal(a[0], b[0])
    assert len(tabs[0]) == len(tabs[1]) == 2


def test_sgd_rule():
    tabs = make_tables("sgd", lr=0.5)
    w0 = _both(tabs, lambda t: t.pull([11]))
    g = np.full((1, 4), 2.0, np.float32)
    for t in tabs:
        t.push([11], g)
    w = _both(tabs, lambda t: t.pull([11]))
    np.testing.assert_allclose(w, w0 - 0.5 * g, rtol=1e-6)


def test_adagrad_rule():
    tabs = make_tables("adagrad", lr=0.1)
    w0 = _both(tabs, lambda t: t.pull([1])).astype(np.float64)
    g1 = np.array([[1.0, -2.0, 0.5, 3.0]], np.float32)
    g2 = np.array([[0.5, 1.0, -1.0, 2.0]], np.float32)
    for t in tabs:
        t.push([1], g1)
        t.push([1], g2)
    g2sum = g1.astype(np.float64) ** 2
    w = w0 - 0.1 * g1 / (np.sqrt(g2sum) + 1e-8)
    g2sum += g2.astype(np.float64) ** 2
    w = w - 0.1 * g2 / (np.sqrt(g2sum) + 1e-8)
    np.testing.assert_allclose(_both(tabs, lambda t: t.pull([1])), w,
                               rtol=1e-5)


def test_adam_rule():
    tabs = make_tables("adam", lr=0.01)
    w = _both(tabs, lambda t: t.pull([42])).astype(np.float64)
    m, v = np.zeros(4), np.zeros(4)
    b1, b2, eps = 0.9, 0.999, 1e-8
    rng = np.random.default_rng(0)
    for step in range(1, 4):
        g = rng.normal(size=(1, 4)).astype(np.float32)
        for t in tabs:
            t.push([42], g)
        g64 = g.astype(np.float64)[0]
        m = b1 * m + (1 - b1) * g64
        v = b2 * v + (1 - b2) * g64 ** 2
        w = w - 0.01 * (m / (1 - b1 ** step)) / (
            np.sqrt(v / (1 - b2 ** step)) + eps)
    np.testing.assert_allclose(_both(tabs, lambda t: t.pull([42])), w,
                               rtol=1e-4)


def test_duplicate_keys_in_batch_apply_serially():
    tabs = make_tables("sgd", lr=1.0)
    w0 = _both(tabs, lambda t: t.pull([9]))
    for t in tabs:
        t.push([9, 9, 9], np.ones((3, 4), np.float32))
    np.testing.assert_allclose(_both(tabs, lambda t: t.pull([9])), w0 - 3.0,
                               rtol=1e-6)


def test_large_push_applies_duplicates_in_batch_order():
    """A push larger than one C++ worker chunk: the C++ table applies
    duplicates in order only within a chunk (across its worker threads the
    order is a race, and adagrad's result depends on it). The port's push
    applies every key's occurrences in batch order, so it repeats bit for
    bit and equals the reference's table fed one row at a time."""
    rng = np.random.default_rng(3)
    keys = (rng.random(4096) ** 3 * 500).astype(np.int64)   # skewed: repeats
    g = rng.standard_normal((4096, 4)).astype(np.float32)
    got = []
    for _ in range(2):
        t = P.MemorySparseTable(_cfg(P, "adagrad"))
        t.push(keys, g)
        got.append(t.pull(np.arange(500)))
    serial = J.MemorySparseTable(_cfg(J, "adagrad"))
    for k, row in zip(keys, g):
        serial.push([k], row[None])
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], serial.pull(np.arange(500)))


class _CountedLib:
    """The native library seen through one table: counts its push calls."""

    def __init__(self, lib):
        self.lib, self.pushes = lib, 0

    def __getattr__(self, name):
        if name.startswith("pt_table_push"):
            self.pushes += 1
        return getattr(self.lib, name)


@pytest.mark.parametrize("op", ["push", "push_raw"])
def test_hot_key_push_is_one_call_in_batch_order(op):
    """A CTR slot's hot value: one key in half of a batch of 65536 (large
    enough that the reference's chunks, racing over its threads, apply the
    hot key in another order on most runs on an 8-core host). The port's
    push is one call into the C++ table, which applies each shard's keys on
    one thread in batch order: it repeats bit for bit and equals the
    reference's table fed one row at a time (adagrad's rule, and the
    additive delta merge of ``push_raw``, depend on that order)."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2 ** 40, 65536)
    keys[rng.random(65536) < 0.5] = 12345
    g = rng.standard_normal((65536, 4)).astype(np.float32)
    uniq = np.unique(keys)
    got = []
    for _ in range(3):
        t = P.MemorySparseTable(_cfg(P, "adagrad"))
        t._lib = lib = _CountedLib(t._lib)
        getattr(t, op)(keys, g)
        assert lib.pushes == 1
        got.append(t.pull(uniq))
    serial = J.MemorySparseTable(_cfg(J, "adagrad"))
    for k, row in zip(keys, g):
        getattr(serial, op)([k], row[None])
    for other in got[1:]:
        np.testing.assert_array_equal(got[0], other)
    np.testing.assert_array_equal(got[0], serial.pull(uniq))


def test_table_file_helpers(tmp_path):
    """``read_table_file``, ``read_table_rows`` and ``write_table_subset``
    read the file both packages save (counting no show, as a pull would),
    and a subset loads in either package as exactly the rows it names."""
    tabs = make_tables("adagrad")
    keys = np.arange(50, dtype=np.int64) * 3
    g = np.random.default_rng(2).normal(size=(50, 4)).astype(np.float32)
    for t in tabs:
        t.push(keys, g)
    path = str(tmp_path / "ref.bin")
    tabs[1].save(path)
    rec = read_table_file(path)
    assert rec["key"].tolist() == keys.tolist()
    assert rec["v"].shape == (50, 2 * 4 + 2)
    ask = np.asarray([147, 0, 9], np.int64)
    rows = read_table_rows(path, ask)
    np.testing.assert_array_equal(rows, read_table_rows(path, ask))
    np.testing.assert_array_equal(rows[:, :4], tabs[0].pull(ask))
    assert (rows[:, 8] == 0).all()              # pushes count no show
    with pytest.raises(KeyError):
        read_table_rows(path, [1])
    sub = str(tmp_path / "sub.bin")
    write_table_subset(path, ask, sub)
    for mod in (P, J):
        t = mod.MemorySparseTable(_cfg(mod, "adagrad"))
        t.load(sub)
        assert len(t) == 3
        np.testing.assert_array_equal(t.pull(ask), rows[:, :4])
    again = str(tmp_path / "again.bin")
    tabs[0].save(again)                         # after the pull above
    np.testing.assert_array_equal(read_table_rows(again, ask)[:, 8], 1)
    with pytest.raises(IOError):
        read_table_file(str(tmp_path / "sub.bin.missing"))


def test_native_build_names_the_command_without_a_compiler(monkeypatch,
                                                           tmp_path):
    """No compiler: the build raises and names the command it would run,
    and publishes nothing."""
    monkeypatch.setattr(native, "CXX", "no-such-cxx")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="no-such-cxx -O3 -std=c"):
        native.build()
    assert not list(tmp_path.glob("*.so"))


def test_save_load_roundtrip(tmp_path):
    tabs = make_tables("adagrad")
    g = np.random.default_rng(1).normal(size=(100, 4)).astype(np.float32)
    for t in tabs:
        t.push(np.arange(100), g)
    want = _both(tabs, lambda t: t.pull(np.arange(100)))
    paths = [str(tmp_path / f"t{i}.bin") for i in range(2)]
    for t, p in zip(tabs, paths):
        t.save(p)
    # both packages write the same table file, byte for byte
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    fresh = make_tables("adagrad")
    fresh[0].load(paths[1])      # the reference's file in the port
    fresh[1].load(paths[0])      # the port's file in the reference
    _both(fresh, lambda t: t.pull(np.arange(100)))
    np.testing.assert_array_equal(fresh[0].pull(np.arange(100)), want)
    assert len(fresh[0]) == len(fresh[1]) == 100


def test_shrink_evicts_cold_keys():
    tabs = make_tables()
    for t in tabs:
        t.pull([1, 2, 3])
        t.pull([1])
    assert [t.shrink(2.0) for t in tabs] == [2, 2]
    assert [set(t.keys().tolist()) for t in tabs] == [{1}, {1}]


def test_ssd_pass_lifecycle(tmp_path):
    out = []
    for mod in (P, J):
        t = mod.SSDSparseTable(str(tmp_path / mod.__name__), mod.
                               SparseAccessorConfig(
            embed_dim=4, optimizer="sgd", learning_rate=1.0, seed=3))
        t.begin_pass()
        w0 = t.pull([5])
        t.push([5], np.ones((1, 4), np.float32))
        trained = t.pull([5])
        t.pull([6, 7])
        t.end_pass()
        t.shrink(3.0)
        assert len(t) == 0
        t.begin_pass()
        np.testing.assert_allclose(t.pull([5]), trained, rtol=1e-6)
        assert not np.allclose(t.pull([5]), w0)
        out.append(t.pull([5, 6, 7]))
    np.testing.assert_array_equal(out[0], out[1])


def test_load_merge_keeps_live_rows(tmp_path):
    res = []
    for mod in (P, J):
        t = mod.MemorySparseTable(_cfg(mod))
        t.push([1, 2], np.ones((2, 4), np.float32))
        path = str(tmp_path / f"{mod.__name__}.bin")
        t.save(path)
        t.push([1], np.ones((1, 4), np.float32))
        live = t.pull([1])
        t2 = mod.MemorySparseTable(_cfg(mod))
        t2.push([1], np.ones((1, 4), np.float32) * 5)
        mine = t2.pull([1])
        t2.load(path, merge=True)
        np.testing.assert_array_equal(t2.pull([1]), mine)
        assert 2 in set(t2.keys().tolist())
        t.load(path)
        assert not np.allclose(t.pull([1]), live)
        res.append(np.concatenate([t.pull([1, 2]), t2.pull([1, 2])]))
    np.testing.assert_array_equal(res[0], res[1])


def test_begin_pass_no_rollback(tmp_path):
    res = []
    for mod in (P, J):
        t = mod.SSDSparseTable(str(tmp_path / mod.__name__), mod.
                               SparseAccessorConfig(
            embed_dim=4, optimizer="sgd", learning_rate=1.0, seed=3))
        t.pull([5])
        t.end_pass()
        t.push([5], np.ones((1, 4), np.float32))
        trained = t.pull([5])
        t.begin_pass()
        np.testing.assert_array_equal(t.pull([5]), trained)
        res.append(trained)
    np.testing.assert_array_equal(res[0], res[1])


def test_ssd_beyond_ram_working_set(tmp_path):
    got = []
    for mod in (P, J):
        t = mod.SSDSparseTable(str(tmp_path / mod.__name__), mod.
                               SparseAccessorConfig(
            embed_dim=8, optimizer="sgd", learning_rate=1.0, seed=5),
            cache_threshold=1e9)
        n, chunk = 5000, 1000
        expected = {}
        for p in range(5):
            t.begin_pass()
            keys = np.arange(p * chunk, (p + 1) * chunk, dtype=np.int64)
            t.pull(keys)
            t.push(keys, np.full((chunk, 8), float(p + 1), np.float32))
            vals = t.pull(keys)
            t.end_pass()
            assert len(t) == 0
            expected.update({int(k): vals[i] for i, k in enumerate(keys)})
        t.begin_pass()
        all_keys = np.arange(n, dtype=np.int64)
        rows = t.pull(all_keys)
        np.testing.assert_array_equal(
            rows, np.stack([expected[int(k)] for k in all_keys]))
        assert len(t) == n
        got.append(rows)
    np.testing.assert_array_equal(got[0], got[1])


def test_ps_context_persistables(tmp_path):
    ctx = P.PSContext()
    t1 = ctx.create_table("emb_a", embed_dim=4, optimizer="sgd", seed=1)
    ctx.create_table("emb_b", embed_dim=4, optimizer="sgd", seed=2)
    with pytest.raises(ValueError):
        ctx.create_table("emb_a", embed_dim=4)
    t1.push([1, 2], np.ones((2, 4), np.float32))
    want = t1.pull([1, 2])
    ctx.init_server()
    ctx.save_persistables(str(tmp_path / "ps"))
    # the port's persistables load in the reference's context and back
    for mod in (P, J):
        ctx2 = mod.PSContext()
        ctx2.create_table("emb_a", embed_dim=4, optimizer="sgd", seed=1)
        ctx2.load_persistables(str(tmp_path / "ps"))
        np.testing.assert_array_equal(ctx2.get_table("emb_a").pull([1, 2]),
                                      want)
    jctx = J.PSContext()
    jt = jctx.create_table("emb_a", embed_dim=4, optimizer="sgd", seed=1)
    jt.push([1, 2], np.ones((2, 4), np.float32))
    jt.pull([1, 2])      # the same show counts as the port's table
    jctx.save_persistables(str(tmp_path / "jps"))
    assert (open(tmp_path / "ps" / "emb_a.table", "rb").read()
            == open(tmp_path / "jps" / "emb_a.table", "rb").read())


# ------------------------------------------------------------ SparseEmbedding
def test_sparse_embedding_jit_train_step():
    """The port's SparseEmbedding trained by its TrainStep against the
    reference's jitted functional step: the same ids (one repeated), the
    same target; losses and table rows at float32 tolerance, the anchor's
    gradient zero, one pull and one push a step."""
    from paddle_tpu.nn.layer import buffer_state, functional_call, param_state
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD

    target = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    ids = np.asarray([100, 2000, 100, 31337], np.int64)

    jemb = J.SparseEmbedding(8, optimizer="adagrad", learning_rate=0.5,
                             seed=0)
    params, buffers = param_state(jemb), buffer_state(jemb)
    jids = jnp.asarray(ids, jnp.int32)

    @jax.jit
    def train_step(params):
        def loss_fn(p):
            e, _ = functional_call(jemb, p, buffers, jids)
            return jnp.mean((e - jnp.asarray(target)) ** 2)
        return jax.value_and_grad(loss_fn)(params)

    emb = P.SparseEmbedding(8, optimizer="adagrad", learning_rate=0.5,
                            seed=0, device="cpu")
    calls = {"pull": 0, "push": 0}
    pull, push = emb.table.pull, emb.table.push

    def counted(name, fn):
        def call(*a):
            calls[name] += 1
            return fn(*a)
        return call

    emb.table.pull = counted("pull", pull)
    emb.table.push = counted("push", push)
    step = TrainStep(emb, SGD(learning_rate=1.0),
                     loss_fn=lambda e, b: torch.mean((e - b[1]) ** 2))
    jl, tl = [], []
    for i in range(20):
        val, g = train_step(params)
        jl.append(float(val))
        tl.append(float(step((ids, target))))
        assert calls == {"pull": i + 1, "push": i + 1}
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0] * 0.2, tl
    np.testing.assert_allclose(pull(ids), jemb.table.pull(ids), **TOL)
    assert len(emb.table) == len(jemb.table) == 3
    (anchor_g,) = jax.tree_util.tree_leaves(g)
    assert float(jnp.abs(anchor_g).max()) == 0.0
    assert float(emb.grad_anchor) == 0.0   # its SGD update is zero


def test_sparse_embedding_only_anchor_param():
    from paddle_tpu.nn.layer import param_state

    emb = P.SparseEmbedding(4, optimizer="sgd", seed=1, device="cpu")
    named = dict(emb.named_parameters())
    jnamed = param_state(J.SparseEmbedding(4, optimizer="sgd", seed=1))
    assert list(named) == list(jnamed) == ["grad_anchor"]
    assert named["grad_anchor"].shape == () == jnamed["grad_anchor"].shape
    assert float(named["grad_anchor"]) == 0.0


def test_sparse_embedding_push_dce_guard():
    """Training with grad enabled but an anchor that needs no gradient
    raises the reference's RuntimeError naming grad_anchor; eval works;
    and the supported path pushes."""
    emb = P.SparseEmbedding(4, optimizer="sgd", seed=3, device="cpu")
    ids = torch.tensor([1, 2])
    emb.grad_anchor.requires_grad_(False)
    with pytest.raises(RuntimeError, match="grad_anchor"):
        emb(ids)
    # the reference raises the same error for the same composition
    jemb = J.SparseEmbedding(4, optimizer="sgd", seed=3)
    with pytest.raises(RuntimeError, match="grad_anchor"):
        jax.grad(jax.jit(lambda w: jnp.sum(w * jnp.sum(jemb(
            jnp.asarray([1, 2]))))))(jnp.ones(4, jnp.float32))
    emb.eval()
    assert torch.isfinite(emb(ids).sum())
    emb.train()
    emb.grad_anchor.requires_grad_(True)
    before = emb.table.pull(np.asarray([1, 2])).copy()
    torch.sum(emb(ids) ** 2).backward()
    after = emb.table.pull(np.asarray([1, 2]))
    assert not np.allclose(before, after), "the backward pushed nothing"
    assert float(emb.grad_anchor.grad) == 0.0


def test_sparse_embedding_eval_no_callback_backend(monkeypatch):
    """Eval composition: a plain pull and no push. The reference bakes the
    rows at trace time where its backend lacks host callbacks; the port
    has no traced program (callbacks_supported() is True)."""
    from paddle_tpu.distributed.ps import embedding as jemb_mod

    assert P.callbacks_supported() is True
    emb = P.SparseEmbedding(4, optimizer="sgd", seed=5, device="cpu")
    jemb = J.SparseEmbedding(4, optimizer="sgd", seed=5)
    ids = np.asarray([3, 9], np.int64)
    want = emb.table.pull(ids)
    emb.eval()
    jemb.eval()
    monkeypatch.setattr(jemb_mod, "_callbacks_supported", False)
    jout = np.asarray(jax.jit(lambda: jemb(jnp.asarray(ids)))())
    out = emb(torch.as_tensor(ids))
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_array_equal(out.numpy(), want)
    emb.train()
    with torch.no_grad():
        emb(torch.as_tensor(ids))            # no_grad: no Function, no push
    np.testing.assert_array_equal(emb.table.pull(ids), want)


def test_sparse_embedding_duplicate_ids_push_every_occurrence():
    """The lookup path pushes every flat id, duplicates included, so the
    table applies adagrad once per occurrence (not a merged gradient):
    held bit-equal to pushing the same rows through the reference table."""
    emb = P.SparseEmbedding(4, optimizer="adagrad", learning_rate=0.3,
                            seed=2, device="cpu")
    ref = J.MemorySparseTable(J.SparseAccessorConfig(
        embed_dim=4, optimizer="adagrad", learning_rate=0.3, seed=2))
    ids = torch.tensor([[5, 5], [7, 5]])
    w = torch.tensor(np.random.default_rng(0).normal(size=(2, 2, 4)),
                     dtype=torch.float32)
    (emb(ids) * w).sum().backward()
    ref.pull(ids.numpy().reshape(-1))
    ref.push(ids.numpy().reshape(-1), w.numpy().reshape(-1, 4))
    np.testing.assert_array_equal(emb.table.pull([5, 7]), ref.pull([5, 7]))
    merged = J.MemorySparseTable(J.SparseAccessorConfig(
        embed_dim=4, optimizer="adagrad", learning_rate=0.3, seed=2))
    merged.pull([5, 7])
    g = w.numpy().reshape(-1, 4)
    merged.push([5, 7], np.stack([g[0] + g[1] + g[3], g[2]]))
    assert not np.allclose(emb.table.pull([5]), merged.pull([5]), rtol=1e-6)


# ------------------------------------------------------------ the CTR step
def _jax_ctr():
    import paddle_tpu as pt
    import paddle_tpu.nn as jnn

    class CTRModel(jnn.Layer):   # examples/ps_ctr_train.py:28-40
        def __init__(self, dim=16):
            super().__init__()
            self.emb = J.SparseEmbedding(dim, optimizer="adagrad",
                                         learning_rate=0.1, seed=0)
            self.fc1 = jnn.Linear(2 * dim, 32)
            self.fc2 = jnn.Linear(32, 1)

        def forward(self, user_ids, item_ids):
            u = self.emb(user_ids)
            v = self.emb(item_ids)
            h = jax.nn.relu(self.fc1(jnp.concatenate([u, v], -1)))
            return self.fc2(h)[:, 0]

    pt.seed(0)
    return CTRModel()


def _torch_ctr(state, device="cpu"):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.nn.layers.common import Linear

    class CTRModel(torch.nn.Module):
        def __init__(self, dim=16):
            super().__init__()
            self.emb = P.SparseEmbedding(dim, optimizer="adagrad",
                                         learning_rate=0.1, seed=0,
                                         device=device)
            self.fc1 = Linear(2 * dim, 32, device=device)
            self.fc2 = Linear(32, 1, device=device)

        def forward(self, user_ids, item_ids):
            u = self.emb(user_ids)
            v = self.emb(item_ids)
            h = torch.relu(self.fc1(torch.cat([u, v], -1)))
            return self.fc2(h)[:, 0]

    return convert.layer_from_jax(CTRModel(), state).train()


def _bce(logits, labels):
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def test_ctr_step_parity_with_reference():
    """examples/ps_ctr_train.py's CTR step: the reference's jitted
    functional step against the port's TrainStep, with the dense tower
    crossing through layer_from_jax. User and item ids overlap and repeat
    within a batch; losses, dense weights and the touched rows agree at
    float32 tolerance after 8 steps; exactly one pull and one push per
    lookup a step (two of each)."""
    from paddle_tpu.nn.layer import buffer_state, functional_call, param_state
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD

    jm = _jax_ctr()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = _torch_ctr(state)
    params, buffers = param_state(jm), buffer_state(jm)

    @jax.jit
    def train_step(params, u, i, y):
        def loss_fn(p):
            logits, _ = functional_call(jm, p, buffers, u, i)
            return jnp.mean(jnp.maximum(logits, 0) - logits * y
                            + jnp.log1p(jnp.exp(-jnp.abs(logits))))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        return loss, jax.tree.map(lambda p, g: p - 0.05 * g, params, grads)

    calls = {"pull": 0, "push": 0}
    table = tm.emb.table
    pull, push = table.pull, table.push
    table.pull = lambda k: (calls.__setitem__("pull", calls["pull"] + 1),
                            pull(k))[1]
    table.push = lambda k, g: (calls.__setitem__("push", calls["push"] + 1),
                               push(k, g))[1]
    step = TrainStep(tm, SGD(learning_rate=0.05),
                     loss_fn=lambda out, b: _bce(out, b[2]),
                     inputs_fn=lambda b: (b[0], b[1]))
    rng = np.random.default_rng(0)
    jl, tl = [], []
    touched = set()
    for s in range(8):
        users = rng.integers(0, 60, 64).astype(np.int64)
        items = rng.integers(0, 60, 64).astype(np.int64)
        labels = ((users % 3 == 0) & (items % 2 == 0)).astype(np.float32)
        touched |= set(users.tolist()) | set(items.tolist())
        loss, params = train_step(params, jnp.asarray(users, jnp.int32),
                                  jnp.asarray(items, jnp.int32), labels)
        jl.append(float(loss))
        tl.append(float(step((users, items, labels))))
        assert calls == {"pull": 2 * (s + 1), "push": 2 * (s + 1)}
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[name]), **TOL,
                                   err_msg=name)
    keys = np.asarray(sorted(touched), np.int64)
    np.testing.assert_allclose(pull(keys), jm.emb.table.pull(keys), **TOL)


def test_int64_ids_beyond_int32_contract():
    """int64 feature signs above 2^31: the host paths of both packages
    keep them (the table, StagedPull's dedup). The port's lookup path keeps
    them too, where the reference's narrows them to int32 (jnp.asarray
    with x64 off maps 2^40 + 3 to 3): an accepted divergence."""
    big_a, big_b = 2 ** 40 + 3, 2 ** 40 + (2 ** 32) + 3  # equal mod 2^32
    tabs = make_tables("sgd")
    ra = _both(tabs, lambda t: t.pull(np.asarray([big_a])))
    rb = _both(tabs, lambda t: t.pull(np.asarray([big_b])))
    assert not np.allclose(ra, rb)
    t = tabs[0]
    staged = P.StagedPull(t, device="cpu")
    ids = np.asarray([[big_a, big_b], [big_b, big_a]], np.int64)
    rows, inv, uniq = staged.pull(ids)
    assert uniq.dtype == np.int64 and set(uniq) == {big_a, big_b}
    emb = P.StagedPull.lookup(rows, inv).numpy()
    np.testing.assert_array_equal(emb[0, 0], emb[1, 1])
    np.testing.assert_array_equal(emb[0, 1], emb[1, 0])
    assert not np.array_equal(emb[0, 0], emb[0, 1])
    g = np.zeros((2, 4), np.float32)
    g[list(uniq).index(big_a)] = 1.0
    before_b = t.pull(np.asarray([big_b]))
    staged.push(uniq, g)
    np.testing.assert_allclose(t.pull(np.asarray([big_a]))[0],
                               ra[0] - t.accessor.learning_rate, rtol=1e-5)
    np.testing.assert_array_equal(t.pull(np.asarray([big_b])), before_b)

    # the lookup path: the port's rows are the table's rows of the int64
    # ids; the reference's are those of the ids' low 32 bits
    emb = P.SparseEmbedding(4, optimizer="sgd", seed=9, device="cpu")
    jemb = J.SparseEmbedding(4, optimizer="sgd", seed=9)
    ids = np.asarray([big_a, 3], np.int64)
    out = emb(torch.as_tensor(ids))
    np.testing.assert_array_equal(out.detach().numpy(), emb.table.pull(ids))
    assert not np.array_equal(out[0].detach().numpy(), out[1].detach().numpy())
    jout = np.asarray(jax.jit(lambda a: jemb._lookup(jnp.asarray(ids), a))(
        jemb.grad_anchor))
    np.testing.assert_array_equal(jout[0], jout[1])   # narrowed to key 3
    np.testing.assert_array_equal(jout[1], out[1].detach().numpy())


def test_staged_pull_train_dedup():
    tabs = make_tables("sgd", lr=1.0)
    staged = P.StagedPull(tabs[0], device="cpu")
    jstaged = J.StagedPull(tabs[1])
    ids = np.asarray([7, 9, 7, 7])
    rows, inv, uniq = staged.pull(ids)
    jrows, jinv, juniq = jstaged.pull(ids)
    assert rows.shape == (2, 4) and uniq.tolist() == [7, 9] == juniq.tolist()
    np.testing.assert_array_equal(inv.numpy(), [0, 1, 0, 0])
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    w7 = rows[0].numpy().copy()
    rows.requires_grad_(True)
    P.StagedPull.lookup(rows, inv).sum().backward()
    _, jg = jax.value_and_grad(
        lambda r: jnp.sum(J.StagedPull.lookup(r, jinv)))(jrows)
    np.testing.assert_allclose(rows.grad.numpy(), [[3.0] * 4, [1.0] * 4])
    np.testing.assert_array_equal(rows.grad.numpy(), np.asarray(jg))
    staged.push(uniq, rows.grad)
    jstaged.push(juniq, jg)
    np.testing.assert_allclose(tabs[0].pull([7])[0], w7 - 3.0, rtol=1e-6)
    _both(tabs, lambda t: t.pull([7, 9]))


# ------------------------------------------------------------ pass builder
def test_pipelined_pass_builder_overlap_and_parity():
    t, jt = make_tables("sgd")
    rng = np.random.default_rng(0)
    passes = [rng.integers(0, 500, (16, 3)) for _ in range(3)]
    builder = P.PipelinedPassBuilder(t, device="cpu")
    jbuilder = J.PipelinedPassBuilder(jt)
    builder.prefetch(0, passes[0])
    jbuilder.prefetch(0, passes[0])
    for p in range(3):
        if p + 1 < 3:
            builder.prefetch(p + 1, passes[p + 1])
            jbuilder.prefetch(p + 1, passes[p + 1])
            builder._threads[p + 1].join()
            jbuilder._threads[p + 1].join()
        rows, inv, uniq = builder.get(p)
        jrows, jinv, juniq = jbuilder.get(p)
        np.testing.assert_array_equal(uniq, juniq)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
        g = np.ones((uniq.size, 4), np.float32)
        builder.push(p, g)
        jbuilder.push(p, g)
        builder.end_pass(p)
        jbuilder.end_pass(p)
    _both((t, jt), lambda x: x.pull(np.arange(500)))

    class SlowTable(P.MemorySparseTable):
        def pull(self, keys):
            time.sleep(0.3)
            return super().pull(keys)

    slow = SlowTable(P.SparseAccessorConfig(embed_dim=4, optimizer="sgd"))
    b2 = P.PipelinedPassBuilder(slow, device="cpu")
    t0 = time.perf_counter()
    b2.prefetch(0, np.arange(8))
    assert time.perf_counter() - t0 < 0.1
    rows, _, _ = b2.get(0)
    assert rows.shape == (8, 4)


def test_pass_builder_errors():
    for mod, kw in ((P, {"device": "cpu"}), (J, {})):
        b = mod.PipelinedPassBuilder(mod.MemorySparseTable(_cfg(mod)), **kw)
        with pytest.raises(KeyError, match="never prefetched"):
            b.get(9)
        with pytest.raises(KeyError, match="no pulled key set"):
            b.push(9, np.zeros((1, 4), np.float32))


def test_pass_builder_ssd_no_data_loss(tmp_path):
    got = []
    for mod, kw in ((P, {"device": "cpu"}), (J, {})):
        t = mod.SSDSparseTable(str(tmp_path / mod.__name__),
                               mod.SparseAccessorConfig(
            embed_dim=4, optimizer="sgd", learning_rate=1.0, seed=3),
            cache_threshold=1e9)
        b = mod.PipelinedPassBuilder(t, **kw)
        ids = np.arange(10, dtype=np.int64)
        b.prefetch(0, ids)
        _, _, uniq = b.get(0)
        b.prefetch(1, ids)
        b._threads[1].join()
        b.push(0, np.ones((uniq.size, 4), np.float32))
        trained = t.pull(ids)
        b.end_pass(0)
        assert len(t) == 0
        _, _, uniq1 = b.get(1)
        b.push(1, np.ones((uniq1.size, 4), np.float32))
        np.testing.assert_allclose(t.pull(ids), trained - 1.0, rtol=1e-6)
        got.append(t.pull(ids))
    np.testing.assert_array_equal(got[0], got[1])


# ------------------------------------------------------------ FL coordinator
def test_fl_coordinator_round_loop():
    """The port's coordinator drives reference clients and port clients
    alike (the same KV keys and JSON)."""
    from paddle_tpu.distributed.ps import FLClient as JFLClient

    coord = P.Coordinator(selector=P.coordinator.ClientSelector(max_rounds=2))
    try:
        clients = [P.FLClient("c0", coord.endpoint),
                   P.FLClient("c1", coord.endpoint),
                   JFLClient("c2", coord.endpoint)]
        results = {}

        def client_loop(c):
            info = (P.ClientInfoAttr if isinstance(c, P.FLClient)
                    else J.ClientInfoAttr)
            for r in range(2):
                c.push_client_info(r, info(loss=1.0 / (r + 1),
                                           num_samples=64))
                results[(c.client_id, r)] = c.pull_fl_strategy(
                    r, timeout=30).action

        ts = [threading.Thread(target=client_loop, args=(c,))
              for c in clients]
        for t in ts:
            t.start()
        rounds = coord.run(num_clients=3, timeout=30)
        for t in ts:
            t.join(timeout=30)
        assert rounds == 2
        assert all(results[(f"c{i}", 0)] == P.FLStrategy.JOIN
                   for i in range(3))
        assert all(results[(f"c{i}", 1)] == P.FLStrategy.FINISH
                   for i in range(3))
    finally:
        coord.stop()


def test_fl_coordinator_custom_selector():
    def pick_worst(round_idx, states):
        ranked = sorted(states, key=lambda c: -(states[c].loss or 0))
        join = set(ranked[:len(ranked) // 2])
        return {c: P.FLStrategy(P.FLStrategy.JOIN if c in join
                                else P.FLStrategy.WAIT) for c in states}

    coord = P.Coordinator(selector=P.coordinator.ClientSelector(
        select_fn=pick_worst))
    try:
        cs = [P.FLClient(f"c{i}", coord.endpoint) for i in range(4)]
        for i, c in enumerate(cs):
            c.push_client_info(0, P.ClientInfoAttr(loss=float(i)))
        coord.run_round(0, num_clients=4, timeout=30)
        acts = {c.client_id: c.pull_fl_strategy(0, timeout=30).action
                for c in cs}
        assert acts["c3"] == "JOIN" and acts["c2"] == "JOIN"
        assert acts["c0"] == "WAIT" and acts["c1"] == "WAIT"
    finally:
        coord.stop()

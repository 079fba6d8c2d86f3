"""The port's ``geometric`` (message passing, segment reductions, the
samplers and reindexing) against the JAX package's, on the CPU: the
twins of the ``geometric`` tests of ``tests/test_graph.py``, plus every
reduction and message op on random inputs.

The reductions run in float32 on both sides (an ``index_add`` against
XLA's scatter-add, in another order): sums and means at rtol 1e-6 /
atol 1e-6, max and min bit-equal. The index rules are the reference's
(an out-of-range segment id is dropped, a negative gather index wraps and
an out-of-range one clamps, an empty segment gives 0). The samplers and
reindexing are numpy and the C++ store on both sides: bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import geometric as JGeo
from paddle_tpu.distributed.ps import graph as JG
from paddle_tpu_torch import geometric as G
from paddle_tpu_torch.distributed.ps.graph import (DistGraphClient,
                                                   GraphServer, GraphTable)

TOL = dict(rtol=1e-6, atol=1e-6)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def test_send_u_recv_sum_mean():
    x = np.asarray([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], np.float32)
    src, dst = np.asarray([0, 1, 2, 0]), np.asarray([1, 2, 1, 0])
    out = G.send_u_recv(torch.as_tensor(x), torch.as_tensor(src),
                        torch.as_tensor(dst), "sum")
    np.testing.assert_allclose(_np(out), [[1, 2], [6, 8], [3, 4]])
    out = G.send_u_recv(x, src, dst, "mean", device="cpu")
    np.testing.assert_allclose(_np(out), [[1, 2], [3, 4], [3, 4]])
    np.testing.assert_array_equal(_np(out), _np(JGeo.send_u_recv(
        x, src, dst, "mean")))


def test_send_u_recv_max_empty_segment_zero():
    out = G.send_u_recv(torch.tensor([[1.0], [2.0]]), torch.tensor([0]),
                        torch.tensor([0]), "max", out_size=3)
    np.testing.assert_allclose(_np(out), [[1.0], [0.0], [0.0]])


def test_send_ue_recv_and_send_uv():
    x = torch.tensor([[1.0], [2.0]])
    e = torch.tensor([[10.0], [20.0]])
    out = G.send_ue_recv(x, e, torch.tensor([0, 1]), torch.tensor([0, 0]),
                         "mul", "sum")
    np.testing.assert_allclose(_np(out), [[50.0], [0.0]])
    uv = G.send_uv(x, x, torch.tensor([0, 1]), torch.tensor([1, 0]), "add")
    np.testing.assert_allclose(_np(uv), [[3.0], [3.0]])


def test_send_u_recv_differentiable():
    x = torch.ones((3, 2), requires_grad=True)
    src, dst = torch.tensor([0, 1, 2]), torch.tensor([0, 0, 1])
    G.send_u_recv(x, src, dst, "sum").sum().backward()
    np.testing.assert_allclose(_np(x.grad), np.ones((3, 2)))
    # every reduction's gradient against the reference's jax.grad
    rng = np.random.default_rng(4)
    xv = rng.normal(size=(6, 3)).astype(np.float32)
    s, d = rng.integers(0, 6, 15), rng.integers(0, 5, 15)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    for op in ("sum", "mean", "max", "min"):
        xt = torch.tensor(xv, requires_grad=True)
        (G.send_u_recv(xt, torch.as_tensor(s), torch.as_tensor(d), op,
                       out_size=5) * torch.as_tensor(w)).sum().backward()
        jg = jax.grad(lambda a: jnp.sum(JGeo.send_u_recv(
            a, jnp.asarray(s), jnp.asarray(d), op, out_size=5) * w))(
                jnp.asarray(xv))
        np.testing.assert_allclose(_np(xt.grad), np.asarray(jg), **TOL,
                                   err_msg=op)


_NUMPY_CALLS = {
    "send_u_recv": lambda x, i, **kw: G.send_u_recv(x, i, i, "max", **kw),
    "send_ue_recv": lambda x, i, **kw: G.send_ue_recv(x, x, i, i, "mul",
                                                      "mean", **kw),
    "send_uv": lambda x, i, **kw: G.send_uv(x, x, i, i, "sub", **kw),
    "segment_pool": lambda x, i, **kw: G.segment_pool(x, i, "min", **kw),
    "segment_sum": lambda x, i, **kw: G.segment_sum(x, i, **kw),
    "segment_mean": lambda x, i, **kw: G.segment_mean(x, i, **kw),
    "segment_min": lambda x, i, **kw: G.segment_min(x, i, **kw),
    "segment_max": lambda x, i, **kw: G.segment_max(x, i, **kw),
}


@pytest.mark.parametrize("fn", sorted(_NUMPY_CALLS))
def test_numpy_inputs_run_on_the_default_device(fn):
    """With no tensor among its arguments (numpy features and ids, as the
    samplers return them) a function runs on ``cuda``, and without a card
    it raises and names ``device='cpu'``; given a device it runs there; a
    tensor argument's device wins when no device is given."""
    call = _NUMPY_CALLS[fn]
    x = np.asarray([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], np.float32)
    ids = np.asarray([0, 1, 1])
    if torch.cuda.is_available():
        assert call(x, ids).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(x, ids)
    got = call(x, ids, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(
        _np(call(torch.as_tensor(x), torch.as_tensor(ids))), _np(got))


def test_sample_neighbors_csc():
    row = np.asarray([1, 2, 2], np.int64)
    colptr = np.asarray([0, 2, 3, 3], np.int64)
    out, cnt = G.sample_neighbors(row, colptr, [0, 1, 2], sample_size=5)
    assert cnt.tolist() == [2, 1, 0]
    assert set(out[:2].tolist()) == {1, 2} and out[2] == 2
    rng = np.random.default_rng(0)
    row = rng.integers(0, 40, 400)
    colptr = np.concatenate([[0], np.sort(rng.integers(0, 400, 40)), [400]])
    for replace in (False, True):
        got = G.sample_neighbors(row, colptr, np.arange(41), 6, replace, 3)
        want = JGeo.sample_neighbors(row, colptr, np.arange(41), 6,
                                     replace, 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_reindex_graph():
    src, dst, nodes = G.reindex_graph(
        x=[10, 20], neighbors=[30, 20, 10, 40], count=[2, 2])
    assert nodes.tolist() == [10, 20, 30, 40]
    assert src.tolist() == [2, 1, 0, 3]
    assert dst.tolist() == [0, 0, 1, 1]
    args = ([5, 9], [[7, 9, 2], [5, 11]], [[2, 1], [1, 1]])
    for a, b in zip(G.reindex_heter_graph(*args),
                    JGeo.reindex_heter_graph(*args)):
        np.testing.assert_array_equal(a, b)


def test_khop_sampler():
    row = np.asarray([1, 2, 3], np.int64)
    colptr = np.asarray([0, 1, 2, 3, 3], np.int64)
    src, dst, table = G.khop_sampler(row, colptr, [0], [1, 1])
    assert table.tolist() == [0, 1, 2]
    assert src.tolist() == [1, 2] and dst.tolist() == [0, 1]
    rng = np.random.default_rng(1)
    row = rng.integers(0, 50, 500)
    colptr = np.concatenate([[0], np.sort(rng.integers(0, 500, 50)), [500]])
    for a, b in zip(G.khop_sampler(row, colptr, [0, 4], [5, 3], seed=2),
                    JGeo.khop_sampler(row, colptr, [0, 4], [5, 3], seed=2)):
        np.testing.assert_array_equal(a, b)


def test_segment_pool():
    out = G.segment_pool(torch.tensor([[1.0], [2.0], [3.0]]),
                         torch.tensor([0, 0, 1]), "mean")
    np.testing.assert_allclose(_np(out), [[1.5], [3.0]])


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_reductions_match_reference(op):
    """Random rows and segment ids (some out of range, some segments
    empty), float32 and int32 features, through send_u_recv, send_ue_recv
    with each message op, segment_pool and the segment_* functions."""
    rng = np.random.default_rng(ord(op[0]))
    x = rng.normal(size=(20, 5)).astype(np.float32)
    e = rng.normal(size=(60, 5)).astype(np.float32) + 3.0
    src = rng.integers(-25, 25, 60)          # wraps once, then clamps
    dst = rng.integers(-2, 18, 60)           # out-of-range ids dropped
    exact = op in ("max", "min")

    def check(got, want, what):
        if exact:
            np.testing.assert_array_equal(_np(got), np.asarray(want), what)
        else:
            np.testing.assert_allclose(_np(got), np.asarray(want), **TOL,
                                       err_msg=what)

    check(G.send_u_recv(torch.as_tensor(x), torch.as_tensor(src),
                        torch.as_tensor(dst), op, out_size=16),
          JGeo.send_u_recv(x, src, dst, op, out_size=16), "send_u_recv")
    for mop in ("add", "sub", "mul", "div"):
        check(G.send_ue_recv(x, e, src, dst, mop, op, out_size=16,
                             device="cpu"),
              JGeo.send_ue_recv(x, e, src, dst, mop, op, out_size=16), mop)
    ids = np.sort(rng.integers(0, 7, 20))
    check(G.segment_pool(x, ids, op, device="cpu"),
          JGeo.segment_pool(x, ids, op),
          "segment_pool")
    check(getattr(G, f"segment_{op}")(x, ids, device="cpu"),
          getattr(JGeo, f"segment_{op}")(x, ids), f"segment_{op}")
    xi = rng.integers(-50, 50, (20, 3)).astype(np.int32)
    got = G.segment_pool(torch.as_tensor(xi), ids, op, num_segments=9)
    want = np.asarray(JGeo.segment_pool(xi, ids, op, num_segments=9))
    if op == "mean":
        np.testing.assert_allclose(_np(got), want, **TOL)
    else:
        np.testing.assert_array_equal(_np(got), want)
    uv = G.send_uv(x, x * 2, src, src[::-1], "mul", device="cpu")
    np.testing.assert_allclose(_np(uv), np.asarray(JGeo.send_uv(
        x, x * 2, src, src[::-1], "mul")), **TOL)


def test_khop_sampler_from_store_local_vs_sharded():
    """Multi-hop sampling over the port's single-host store, the port's
    sharded client over two in-process graph servers, and the reference's
    store: the same subgraph, features and node table, bit for bit; the
    minibatch then feeds send_u_recv as in the reference."""
    rng = np.random.default_rng(9)
    src = rng.integers(0, 80, 800).astype(np.int64)
    dst = rng.integers(0, 80, 800).astype(np.int64)
    feats = np.random.default_rng(1).normal(size=(80, 16)).astype(
        np.float32)
    stores = []
    for cls in (GraphTable, JG.GraphTable):
        g = cls()
        g.add_edges(src, dst)
        g.build(symmetric=True)
        g.set_features(np.arange(80), feats)
        stores.append(g)
    servers = [GraphServer(), GraphServer()]
    client = DistGraphClient([("127.0.0.1", s.port) for s in servers])
    try:
        client.add_edges(src, dst)
        client.build(symmetric=True)
        client.set_features(np.arange(80), feats)
        seeds = np.asarray([0, 3, 11], np.int64)
        want = JGeo.khop_sampler_from_store(stores[1], seeds, [4, 3], seed=5,
                                            with_features=True)
        for store in (stores[0], client):
            got = G.khop_sampler_from_store(store, seeds, [4, 3], seed=5,
                                            with_features=True)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        es, ed, idx, f = want
        assert idx[:3].tolist() == seeds.tolist()
        assert es.max(initial=-1) < idx.size and f.shape == (idx.size, 16)
        with pytest.raises(ValueError):
            G.khop_sampler_from_store(stores[0], seeds, [0, 3])
        h = G.send_u_recv(torch.as_tensor(f), torch.as_tensor(es),
                          torch.as_tensor(ed), "mean", out_size=idx.size)
        np.testing.assert_allclose(_np(h), np.asarray(JGeo.send_u_recv(
            f, es, ed, "mean", out_size=idx.size)), **TOL)
    finally:
        client.close()
        for s in servers:
            s.stop()

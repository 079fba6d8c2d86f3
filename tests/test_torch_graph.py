"""The port's graph engine (``paddle_tpu_torch.distributed.ps.graph``: the
C++ CSR store, graph-shard servers, the sharded client and
GraphDataGenerator) against the JAX package's, on the CPU: the twins of
the graph-engine tests of ``tests/test_graph.py`` (the ``geometric`` twins
are ``tests/test_torch_geometric.py``).

Both packages compile the same C++ sources, so samples, walks, features
and generator batches are held bit-equal. The graph servers are the
port's own subprocesses; a port client is also held against the
reference's graph servers. The DeepWalk skip-gram step (the example's and
``tools/graph_bench.py``'s) is held to the reference's jitted step at
float32 tolerance (rtol 1e-5 / atol 1e-6 on the embedding and losses).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.ps import graph as JG
from paddle_tpu_torch.distributed.ps.graph import (DistGraphClient,
                                                   GraphDataGenerator,
                                                   GraphServer, GraphTable,
                                                   launch_graph_servers)


def toy_graph(mod=None, symmetric=False):
    g = (mod or GraphTable)()
    g.add_edges([0, 0, 1, 2], [1, 2, 2, 3])
    g.build(symmetric=symmetric)
    return g


def _pair(build):
    """``build(GraphTable class)`` in both packages: ``(port, reference)``."""
    return build(GraphTable), build(JG.GraphTable)


def _same(pair, fn):
    a, b = (fn(g) for g in pair)
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)
    return a


def test_graph_build_counts():
    for cls in (GraphTable, JG.GraphTable):
        g = toy_graph(cls)
        assert (g.num_nodes, g.num_edges) == (4, 4)
        assert g.degree(0) == 2 and g.degree(3) == 0
        gs = toy_graph(cls, symmetric=True)
        assert gs.num_edges == 8 and gs.degree(3) == 1


def test_sample_neighbors_exact_sets():
    pair = _pair(toy_graph)
    nb, cnt = _same(pair, lambda g: g.sample_neighbors([0, 3, 777], 4))
    assert nb.shape == (3, 4)
    assert set(nb[0][nb[0] >= 0].tolist()) == {1, 2} and cnt[0] == 2
    assert cnt[1] == 0 and cnt[2] == 0 and (nb[1] == -1).all()


def test_sample_neighbors_without_replacement_subset():
    def build(cls):
        g = cls()
        g.add_edges(np.zeros(50, np.int64), np.arange(1, 51))
        g.build()
        return g

    pair = _pair(build)
    nb, cnt = _same(pair, lambda g: g.sample_neighbors([0], 10, seed=3))
    assert cnt[0] == 10 and len(set(nb[0].tolist())) == 10
    assert all(1 <= v <= 50 for v in nb[0])
    nb2, _ = _same(pair, lambda g: g.sample_neighbors([0], 10, seed=4))
    assert not np.array_equal(nb, nb2)


def test_random_walk_follows_edges():
    pair = _pair(toy_graph)
    edges = {(0, 1), (0, 2), (1, 2), (2, 3)}
    walks = _same(pair, lambda g: g.random_walk([0, 1], 5, seed=11))
    for start, walk in zip([0, 1], walks):
        prev = start
        for v in walk:
            if v < 0:
                break
            assert (prev, int(v)) in edges
            prev = int(v)
    assert (_same(pair, lambda g: g.random_walk([3], 4)) == -1).all()


def test_graph_data_generator_static_shapes():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 200, 2000), rng.integers(0, 200, 2000)

    def build(cls):
        g = cls()
        g.add_edges(src, dst)
        g.build(symmetric=True)
        return g

    g, jg = _pair(build)
    gen = GraphDataGenerator(g, batch_size=64, walk_len=6, window=2,
                             num_neg=3, seed=1)
    jgen = JG.GraphDataGenerator(jg, batch_size=64, walk_len=6, window=2,
                                 num_neg=3, seed=1)
    firsts = []
    for _ in range(2):   # two epochs: the reshuffle is the reference's too
        batches, jbatches = list(gen), list(jgen)
        assert len(batches) == len(jbatches) >= 10
        for b, jb in zip(batches, jbatches):
            for x, y in zip(b, jb):
                np.testing.assert_array_equal(x, y)
        for c, x, neg in batches:
            assert c.shape == (64,) and x.shape == (64,)
            assert neg.shape == (64, 3) and neg.dtype == np.int64
            assert (c >= 0).all() and (x >= 0).all()
        firsts.append(batches[0][0])
    assert not np.array_equal(firsts[0], firsts[1])


def test_node_features_roundtrip():
    pair = _pair(toy_graph)
    for g in pair:
        g.set_features([0, 2], [[1.0, 2.0], [3.0, 4.0]])
        assert g.feature_dim == 2
        with pytest.raises(ValueError):
            g.set_features([1], [[1.0, 2.0, 3.0]])
    out = _same(pair, lambda g: g.get_features([2, 0, 99]))
    np.testing.assert_allclose(out, [[3, 4], [1, 2], [0, 0]])


def test_walk_step_composes_to_random_walk():
    g = toy_graph(symmetric=True)
    jg = toy_graph(JG.GraphTable, symmetric=True)
    starts = np.asarray([0, 1, 2, 3], np.int64)
    walks = _same((g, jg), lambda t: t.random_walk(starts, 5, seed=9))
    cur = starts.copy()
    rows = np.arange(starts.size)
    for step in range(5):
        cur = _same((g, jg), lambda t: t.walk_step(cur, rows, step, seed=9))
        np.testing.assert_array_equal(cur, walks[:, step])


def test_weighted_sampling_bias():
    def build(cls):
        g = cls()
        g.add_edges([0, 0], [1, 2], weights=[9.0, 1.0])
        g.build()
        return g

    pair = _pair(build)
    nb, _ = _same(pair, lambda g: g.sample_neighbors([0], 400, replace=True,
                                                     seed=5))
    assert 0.8 < (nb[0] == 1).mean() < 0.98
    walks = _same(pair, lambda g: g.random_walk(np.zeros(500, np.int64), 1,
                                                seed=3))
    assert 0.8 < (walks[:, 0] == 1).mean() < 0.98

    def build2(cls):
        g = cls()
        g.add_edges(np.zeros(20, np.int64), np.arange(1, 21),
                    weights=[100.0] * 2 + [0.01] * 18)
        g.build()
        return g

    nb2, _ = _same(_pair(build2), lambda g: g.sample_neighbors([0], 2,
                                                              seed=7))
    assert set(nb2[0].tolist()) == {1, 2}


# ------------------------------------------------ the sharded graph engine
def random_coo(n_nodes=120, n_edges=1500, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_nodes, n_edges).astype(np.int64),
            rng.integers(0, n_nodes, n_edges).astype(np.int64))


def _local(src, dst, weights=None, cls=GraphTable):
    g = cls()
    g.add_edges(src, dst, weights=weights)
    g.build(symmetric=True)
    return g


@pytest.fixture(scope="module")
def graph_cluster():
    """Two of the port's graph-shard server subprocesses + a port client,
    built with random_coo."""
    procs, endpoints = launch_graph_servers(2)
    client = DistGraphClient(endpoints)
    client.add_edges(*random_coo())
    client.build(symmetric=True)
    yield client
    client.stop_servers()
    client.close()
    for p in procs:
        p.wait(timeout=10)


def test_dist_graph_parity_with_single_host(graph_cluster):
    local = _local(*random_coo())
    jlocal = _local(*random_coo(), cls=JG.GraphTable)
    assert graph_cluster.num_nodes == local.num_nodes == jlocal.num_nodes
    assert graph_cluster.num_edges == local.num_edges
    np.testing.assert_array_equal(graph_cluster.node_ids(),
                                  np.sort(local.node_ids()))
    for k in [0, 5, 77, 119]:
        assert graph_cluster.degree(k) == local.degree(k) == jlocal.degree(k)
    nodes = np.asarray([0, 3, 50, 111, 999], np.int64)
    want = _same((local, jlocal), lambda g: g.sample_neighbors(nodes, 8,
                                                              seed=5))
    got = graph_cluster.sample_neighbors(nodes, 8, seed=5)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    starts = np.arange(40, dtype=np.int64)
    np.testing.assert_array_equal(
        graph_cluster.random_walk(starts, 6, seed=3),
        _same((local, jlocal), lambda g: g.random_walk(starts, 6, seed=3)))


def test_dist_graph_features(graph_cluster):
    rng = np.random.default_rng(7)
    keys = np.arange(0, 120, dtype=np.int64)
    feats = rng.normal(size=(120, 16)).astype(np.float32)
    graph_cluster.set_features(keys, feats)
    assert graph_cluster.feature_dim == 16
    np.testing.assert_array_equal(graph_cluster.get_features(keys[::-1]),
                                  feats[::-1])
    got = graph_cluster.get_features([5, 100000, 6])
    np.testing.assert_array_equal(got[0], feats[5])
    np.testing.assert_array_equal(got[1], np.zeros(16, np.float32))
    np.testing.assert_array_equal(got[2], feats[6])


def test_sample_with_features_local_and_dist(graph_cluster):
    local = _local(*random_coo())
    jlocal = _local(*random_coo(), cls=JG.GraphTable)
    feats = np.random.default_rng(7).normal(size=(120, 16)).astype(
        np.float32)
    for g in (local, jlocal):
        g.set_features(np.arange(120), feats)
    graph_cluster.set_features(np.arange(120), feats)
    nodes = np.asarray([0, 7, 999], np.int64)
    nb_l, _, f_l = _same((local, jlocal), lambda g: g.sample_with_features(
        nodes, 4, seed=2))
    nb_d, _, f_d = graph_cluster.sample_with_features(nodes, 4, seed=2)
    np.testing.assert_array_equal(nb_l, nb_d)
    np.testing.assert_array_equal(f_l, f_d)
    assert f_l.shape == (3, 4, 16)
    np.testing.assert_array_equal(f_l[2], np.zeros((4, 16)))
    for i in range(2):
        for j in range(4):
            if nb_l[i, j] >= 0:
                np.testing.assert_array_equal(f_l[i, j], feats[nb_l[i, j]])


def test_dist_graph_feeds_deepwalk_generator(graph_cluster):
    if not getattr(graph_cluster, "_built", False):
        graph_cluster.add_edges(*random_coo())
        graph_cluster.build()
    batches = list(GraphDataGenerator(graph_cluster, batch_size=32,
                                      walk_len=4, window=2, num_neg=3,
                                      seed=1))
    assert len(batches) >= 5
    ids = set(graph_cluster.node_ids().tolist())
    for c, x, neg in batches[:3]:
        assert c.shape == (32,) and x.shape == (32,) and neg.shape == (32, 3)
        assert set(c.tolist()) <= ids and set(x.tolist()) <= ids


def test_inproc_graph_server_roundtrip():
    srv = GraphServer()
    client = DistGraphClient([("127.0.0.1", srv.port)])
    client.add_edges([0, 0, 1], [1, 2, 2])
    client.build()
    assert client.num_nodes == 3 and client.num_edges == 3
    nb, ct = client.sample_neighbors([0], 4)
    assert set(nb[0][nb[0] >= 0].tolist()) == {1, 2} and ct[0] == 2
    # the reference's client speaks the same wire to the port's server
    jclient = JG.DistGraphClient([("127.0.0.1", srv.port)])
    jclient._built = True
    for x, y in zip(jclient.sample_neighbors([0, 1], 4, seed=3),
                    client.sample_neighbors([0, 1], 4, seed=3)):
        np.testing.assert_array_equal(x, y)
    jclient.close()
    client.close()
    srv.stop()


def test_weighted_dist_graph_parity(graph_cluster):
    rng = np.random.default_rng(3)
    src = rng.integers(0, 60, 600).astype(np.int64)
    dst = rng.integers(0, 60, 600).astype(np.int64)
    w = rng.uniform(0.1, 5.0, 600).astype(np.float32)
    local = _local(src, dst, w)
    jlocal = _local(src, dst, w, cls=JG.GraphTable)
    graph_cluster.clear_edges()
    graph_cluster.add_edges(src, dst, weights=w)
    graph_cluster.build(symmetric=True)
    starts = np.arange(40, dtype=np.int64)
    np.testing.assert_array_equal(
        graph_cluster.random_walk(starts, 5, seed=11),
        _same((local, jlocal), lambda g: g.random_walk(starts, 5, seed=11)))
    want = _same((local, jlocal), lambda g: g.sample_neighbors(
        starts, 6, replace=True, seed=2))
    for x, y in zip(graph_cluster.sample_neighbors(starts, 6, replace=True,
                                                   seed=2), want):
        np.testing.assert_array_equal(x, y)


def test_multi_hop_walk_uses_fewer_rpc_rounds(graph_cluster):
    src, dst = random_coo(seed=3)
    graph_cluster.clear_edges()
    graph_cluster.add_edges(src, dst)
    graph_cluster.build(symmetric=True)
    starts = graph_cluster.node_ids()[:64]
    rounds = []
    orig = graph_cluster._request_multi

    def counting(reqs):
        rounds.append(len(reqs))
        return orig(reqs)

    graph_cluster._request_multi = counting
    try:
        walks = graph_cluster.random_walk(starts, walk_len=20, seed=5)
    finally:
        graph_cluster._request_multi = orig
    assert walks.shape == (64, 20)
    assert 1 <= len(rounds) <= 16, rounds
    np.testing.assert_array_equal(
        _same((_local(src, dst), _local(src, dst, cls=JG.GraphTable)),
              lambda g: g.random_walk(starts, 20, seed=5)), walks)


def test_port_client_against_reference_graph_servers():
    """The port's DistGraphClient over two of the reference's graph-shard
    server subprocesses: samples, walks and features bit-equal to the
    port's single-host store."""
    procs, endpoints = JG.launch_graph_servers(2)
    client = DistGraphClient(endpoints)
    try:
        src, dst = random_coo(seed=4)
        client.add_edges(src, dst)
        client.build(symmetric=True)
        local = _local(src, dst)
        nodes = np.arange(0, 130, 3, dtype=np.int64)
        for x, y in zip(client.sample_neighbors(nodes, 5, seed=6),
                        local.sample_neighbors(nodes, 5, seed=6)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(client.random_walk(nodes, 8, seed=2),
                                      local.random_walk(nodes, 8, seed=2))
        feats = np.random.default_rng(1).normal(size=(120, 8)).astype(
            np.float32)
        client.set_features(np.arange(120), feats)
        np.testing.assert_array_equal(client.get_features(nodes), np.concatenate(
            [feats, np.zeros((10, 8), np.float32)])[nodes])
    finally:
        client.stop_servers()
        client.close()
        for p in procs:
            p.wait(timeout=10)


# ------------------------------------------------------ the DeepWalk step
def _skipgram_loss(e, c, x, negs):
    ce, xe, ne = e[c], e[x], e[negs]
    pos = torch.sum(ce * xe, -1)
    neg = torch.einsum("bd,bkd->bk", ce, ne)
    return (torch.mean(torch.nn.functional.softplus(-pos))
            + torch.mean(torch.nn.functional.softplus(neg)))


def test_deepwalk_step_parity():
    """tools/graph_bench.py's skip-gram step (examples/graph_deepwalk.py's
    with lr 0.1) on GraphDataGenerator batches: the port's torch step
    against the reference's jitted step, 6 steps, the same batches from
    the same generator; float32 tolerance on losses and the embedding."""
    import jax
    import jax.numpy as jnp

    src, dst = random_coo(n_nodes=300, n_edges=3000, seed=2)
    g = _local(src, dst)
    n, dim = int(g.node_ids().max()) + 1, 16
    emb0 = np.random.default_rng(0).normal(size=(n, dim), scale=0.1).astype(
        np.float32)

    @jax.jit
    def jstep(emb, c, x, negs):
        def loss_fn(e):
            ce, xe, ne = e[c], e[x], e[negs]
            pos = jnp.sum(ce * xe, -1)
            neg = jnp.einsum("bd,bkd->bk", ce, ne)
            return (jnp.mean(jax.nn.softplus(-pos))
                    + jnp.mean(jax.nn.softplus(neg)))
        loss, grad = jax.value_and_grad(loss_fn)(emb)
        return emb - 0.1 * grad, loss

    gen = GraphDataGenerator(g, batch_size=128, walk_len=8, window=2,
                             num_neg=4, seed=0)
    je = jnp.asarray(emb0)
    te = torch.tensor(emb0, requires_grad=True)
    for i, (c, x, negs) in zip(range(6), gen):
        je, jloss = jstep(je, c, x, negs)
        loss = _skipgram_loss(te, *(torch.as_tensor(a) for a in (c, x,
                                                                 negs)))
        (grad,) = torch.autograd.grad(loss, te)
        with torch.no_grad():
            te = (te - 0.1 * grad).requires_grad_(True)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(te.detach().numpy(), np.asarray(je),
                               rtol=1e-5, atol=1e-6)


def _chip_smoke(monkeypatch):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_dry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "nvidia_smi_line", lambda: "no card")
    return mod


def test_graph_training_phase_dry_run(monkeypatch):
    """chip_smoke.py's graph_training phase (tools/graph_bench.py's regime
    ported) end to end on the CPU at a tiny size: positive rates on one
    host and over two graph-shard servers with equal samples and walks,
    DeepWalk sequential and overlapped held to the float64 run, message
    passing equal to itself, no flash launch."""
    c = _chip_smoke(monkeypatch)
    out = c.phase_graph_training(0, device="cpu", edges=20000, iters=3,
                                 steps=4, dw_batch=512)
    for section in ("single_host", "two_shard"):
        for metric in ("build_edges_per_s", "neighbor_samples_per_s",
                       "walk_hops_per_s"):
            assert out["graph"][section][metric] > 0
    assert out["graph"]["two_shard"]["equal_to_single_host"]
    assert out["deepwalk"]["overlapped_s"] > 0
    assert out["message_passing"]["reindex_equal_to_first_hop"]
    assert set(out["flash_launches"].values()) == {0}

"""The port's PS service (``paddle_tpu_torch.distributed.ps.service``:
server subprocesses, the sharded client, the communicator modes, the
dense plane) against the JAX package's, on the CPU: the twins of
``tests/test_ps_service.py``.

The servers are the port's own subprocesses (``python -m
paddle_tpu_torch.distributed.ps.server``); the wire is the reference's,
so a port client is also held against the reference's servers and a
reference client against the port's, with bit-equal rows. Pulls and
pushes through the service are bit-equal to a local table (the same C++
rule on the same keys); the async communicator merges a nondeterministic
number of batches, held at rtol 1e-4 / atol 1e-6 as the reference holds
it; SparseEmbedding over the network at float32 tolerance (rtol 1e-5).
"""
import socket
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import ps as J
from paddle_tpu_torch.distributed import ps as P
from paddle_tpu_torch.distributed.ps.service import (
    _splitmix64, launch_port_subprocesses)
from torch_threads import few_torch_threads  # noqa: F401

DIM = 4


def make_local(mod=P, optimizer="sgd", lr=1.0, seed=11):
    return mod.MemorySparseTable(mod.SparseAccessorConfig(
        embed_dim=DIM, optimizer=optimizer, learning_rate=lr, seed=seed))


@pytest.fixture(scope="module")
def cluster():
    """Two of the port's PS server subprocesses + a port client."""
    procs, endpoints = P.launch_servers(
        2, embed_dim=DIM, optimizer="sgd", learning_rate=1.0, seed=11)
    client = P.PsClient(endpoints, embed_dim=DIM)
    yield client
    client.stop_servers()
    client.close()
    for p in procs:
        p.wait(timeout=10)


def test_shard_of_matches_cpp_router():
    assert _splitmix64(np.array([0], np.uint64))[0] == np.uint64(
        0xE220A8397B1DCDAF)
    keys = np.random.default_rng(0).integers(-2 ** 62, 2 ** 62, 10_000)
    for n in (1, 2, 3, 16):
        np.testing.assert_array_equal(P.shard_of(keys, n),
                                      J.shard_of(keys, n))


@pytest.mark.parametrize("num_servers", [2, 4, 16])
def test_server_routing_decorrelated_from_table_shards(num_servers):
    keys = np.arange(200_000, dtype=np.int64)
    sid = P.shard_of(keys, num_servers)
    mine = keys[sid == 0]
    internal = _splitmix64(mine.view(np.uint64)) % np.uint64(16)
    counts = np.bincount(internal.astype(np.int64), minlength=16)
    assert (counts > 0).all()
    assert counts.max() < 4 * counts.mean()


def test_pull_parity_with_local_table(cluster):
    keys = np.arange(100, dtype=np.int64)
    got = cluster.pull(keys)
    np.testing.assert_array_equal(got, make_local().pull(keys))
    np.testing.assert_array_equal(got, make_local(J).pull(keys))


def test_push_parity_and_routing(cluster):
    local, jlocal = make_local(), make_local(J)
    rng = np.random.default_rng(0)
    keys = rng.integers(1000, 2000, 64).astype(np.int64)
    grads = rng.normal(size=(64, DIM)).astype(np.float32)
    for t in (cluster, local, jlocal):
        t.pull(keys)
        t.push(keys, grads)
    got = cluster.pull(keys)
    np.testing.assert_array_equal(got, local.pull(keys))
    np.testing.assert_array_equal(got, jlocal.pull(keys))
    sid = P.shard_of(np.unique(keys), 2)
    assert 0 < sid.sum() < sid.size


def test_hot_key_push_is_one_request_per_server(cluster, monkeypatch):
    """One key in half of a batch of 65536: the client's push is one
    request per server, and each server's table applies its keys in batch
    order, so the rows equal the reference's table fed one row at a
    time."""
    rng = np.random.default_rng(6)
    keys = rng.integers(2 ** 41, 2 ** 42, 65536)
    keys[rng.random(65536) < 0.5] = 2 ** 41 + 7
    g = rng.normal(size=(65536, DIM)).astype(np.float32)
    sent = []
    real = cluster._request
    monkeypatch.setattr(cluster, "_request",
                        lambda s, op, *a, **kw: (sent.append(s),
                                                 real(s, op, *a, **kw))[1])
    cluster.push(keys, g)
    monkeypatch.undo()
    assert sorted(sent) == [0, 1]
    serial = make_local(J)
    for k, row in zip(keys, g):
        serial.push([k], row[None])
    uniq = np.unique(keys)
    np.testing.assert_array_equal(cluster.pull(uniq), serial.pull(uniq))


def test_size_keys_save_load(cluster, tmp_path):
    before = len(cluster)
    cluster.pull(np.arange(5000, 5010))
    assert len(cluster) >= before + 10
    assert set(range(5000, 5010)) <= set(cluster.keys().tolist())
    path = str(tmp_path / "snap")
    cluster.save(path)
    rows = cluster.pull(np.arange(5000, 5010))
    cluster.push(np.arange(5000, 5010), np.ones((10, DIM), np.float32))
    cluster.load(path)
    np.testing.assert_array_equal(cluster.pull(np.arange(5000, 5010)), rows)
    # a shard the port's server saved loads in the reference's table
    ref = make_local(J)
    ref.load(f"{path}.shard0")
    k = np.arange(5000, 5010)[P.shard_of(np.arange(5000, 5010), 2) == 0]
    np.testing.assert_array_equal(ref.pull(k), cluster.pull(k))


def test_barrier_releases_world(cluster):
    order = []

    def worker(i):
        cluster.barrier(world=3)
        order.append(i)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    time.sleep(0.3)
    assert order == []
    cluster.barrier(world=3)
    for t in ts:
        t.join(timeout=5)
    assert sorted(order) == [0, 1]


def test_async_communicator_parity(cluster):
    local = make_local()
    rng = np.random.default_rng(3)
    keys = np.arange(9000, 9032, dtype=np.int64)
    cluster.pull(keys)
    local.pull(keys)
    comm = P.Communicator(cluster, mode="async")
    total = np.zeros((keys.size, DIM), np.float32)
    for _ in range(10):
        g = rng.normal(size=(keys.size, DIM)).astype(np.float32)
        comm.push(keys, g)
        total += g
    comm.stop()
    local.push(keys, total)
    np.testing.assert_allclose(cluster.pull(keys), local.pull(keys),
                               rtol=1e-4, atol=1e-6)


def test_geo_communicator_buffers_k_steps(cluster):
    keys = np.arange(9500, 9504, dtype=np.int64)
    base = cluster.pull(keys)
    comm = P.Communicator(cluster, mode="geo", k_steps=4)
    for _ in range(3):
        comm.push(keys, np.ones((keys.size, DIM), np.float32))
    np.testing.assert_array_equal(cluster.pull(keys), base)
    comm.push(keys, np.ones((keys.size, DIM), np.float32))
    np.testing.assert_allclose(cluster.pull(keys), base - 4.0, rtol=1e-6)
    comm.stop()


def test_sparse_embedding_over_network(cluster):
    """The port's SparseEmbedding trains through its PsClient; the losses
    equal the reference's SparseEmbedding over a local table with the
    same accessor (float32 tolerance)."""
    import jax
    import jax.numpy as jnp
    import torch

    emb = P.SparseEmbedding(DIM, table=cluster, device="cpu")
    target = np.random.default_rng(5).normal(size=(6, DIM)).astype(
        np.float32)
    ids = np.arange(7000, 7006)
    jemb = J.SparseEmbedding(DIM, table=make_local(J, lr=5.0))
    jstep = jax.jit(jax.value_and_grad(lambda a: jnp.mean(
        (jemb._lookup(jnp.asarray(ids), a) - target) ** 2)))
    cluster.set_learning_rate(5.0)
    losses, jlosses = [], []
    for _ in range(15):
        loss = torch.mean((emb(torch.as_tensor(ids)) - torch.as_tensor(
            target)) ** 2)
        loss.backward()
        losses.append(float(loss))
        jlosses.append(float(jstep(jemb.grad_anchor)[0]))
    cluster.set_learning_rate(1.0)
    assert losses[-1] < losses[0] * 0.1
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-7)


def _reserved_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _server_argv(port):
    return [sys.executable, "-m", "paddle_tpu_torch.distributed.ps.server",
            "--port", str(port), "--embed-dim", str(DIM),
            "--optimizer", "sgd", "--lr", "1.0", "--seed", "11"]


def test_client_retries_across_server_restart(tmp_path):
    argv = _server_argv(_reserved_port())
    procs, eps = launch_port_subprocesses([argv])
    client = P.PsClient(eps, embed_dim=DIM, retries=8, retry_delay=0.25)
    keys = np.arange(100, dtype=np.int64)
    client.pull(keys)
    client.push(keys, np.ones((100, DIM), np.float32))
    before = client.pull(keys)
    snap = str(tmp_path / "restart-snap")
    client.save(snap)
    procs[0].kill()
    procs[0].wait(timeout=10)
    procs2, eps2 = launch_port_subprocesses(
        [argv + ["--load", f"{snap}.shard0"]])
    assert eps2[0][1] == eps[0][1]
    np.testing.assert_array_equal(client.pull(keys), before)
    client.push(keys, np.ones((100, DIM), np.float32))
    np.testing.assert_allclose(client.pull(keys), before - 1.0)
    client.stop_servers()
    client.close()
    procs2[0].wait(timeout=10)


def test_dense_survives_server_restart(tmp_path):
    argv = _server_argv(_reserved_port())
    procs, eps = launch_port_subprocesses([argv])
    client = P.PsClient(eps, embed_dim=DIM, retries=8, retry_delay=0.25)
    client.dense_init(17, optimizer="sgd", learning_rate=1.0)
    vals = np.arange(17, dtype=np.float32)
    client.dense_set(vals)
    client.dense_push(np.ones(17, np.float32))
    snap = str(tmp_path / "dense-snap")
    client.save(snap)
    procs[0].kill()
    procs[0].wait(timeout=10)
    procs2, _ = launch_port_subprocesses(
        [argv + ["--load", f"{snap}.shard0"]])
    client.dense_init(17, optimizer="sgd", learning_rate=1.0)
    np.testing.assert_allclose(client.dense_pull(), vals - 1.0)
    client.dense_push(np.ones(17, np.float32))
    np.testing.assert_allclose(client.dense_pull(), vals - 2.0)
    client.stop_servers()
    client.close()
    procs2[0].wait(timeout=10)


def test_dense_parameter_path(cluster):
    L = 101
    local = P.MemoryDenseTable(L, optimizer="sgd", learning_rate=1.0)
    jlocal = J.MemoryDenseTable(L, optimizer="sgd", learning_rate=1.0)
    cluster.dense_init(L, optimizer="sgd", learning_rate=1.0)
    rng = np.random.default_rng(1)
    init = rng.normal(size=L).astype(np.float32)
    for t in (local, jlocal):
        t.set(init)
    cluster.dense_set(init)
    np.testing.assert_array_equal(cluster.dense_pull(), local.pull())
    for _ in range(3):
        g = rng.normal(size=L).astype(np.float32)
        local.push(g)
        jlocal.push(g)
        cluster.dense_push(g)
    np.testing.assert_array_equal(cluster.dense_pull(), local.pull())
    np.testing.assert_array_equal(local.pull(), jlocal.pull())
    cluster.dense_init(L, optimizer="sgd", learning_rate=1.0)
    np.testing.assert_array_equal(cluster.dense_pull(), local.pull())


def test_show_click_accessor_shrink():
    res = []
    for mod in (P, J):
        t = make_local(mod)
        keys = np.arange(20, dtype=np.int64)
        t.pull(keys)
        hot = keys[:5]
        t.push_show_click(hot, shows=np.full(5, 10.0),
                          clicks=np.full(5, 3.0))
        assert t.shrink(threshold=5.0) == 15
        res.append(set(t.keys().tolist()))
    assert res[0] == res[1] == set(range(5))


def test_geo_communicator_delta_train(cluster):
    keys = np.arange(9700, 9704, dtype=np.int64)
    base = cluster.pull(keys)
    comm = P.Communicator(cluster, mode="geo", k_steps=3, geo_lr=1.0)
    g = np.ones((keys.size, DIM), np.float32)
    comm.push(keys, g)
    np.testing.assert_allclose(comm.pull(keys), base - 1.0, rtol=1e-6)
    np.testing.assert_array_equal(cluster.pull(keys), base)
    comm.push(keys, g)
    comm.push(keys, g)
    np.testing.assert_allclose(cluster.pull(keys), base - 3.0, rtol=1e-6)
    comm.push(keys, 2 * g)
    comm.stop()
    np.testing.assert_allclose(cluster.pull(keys), base - 5.0, rtol=1e-6)


def test_inproc_server_roundtrip():
    srv = P.PsServer(P.SparseAccessorConfig(embed_dim=DIM, optimizer="sgd",
                                            learning_rate=1.0, seed=7))
    client = P.PsClient([("127.0.0.1", srv.port)], embed_dim=DIM)
    local = make_local(seed=7)
    keys = np.arange(10, dtype=np.int64)
    np.testing.assert_array_equal(client.pull(keys), local.pull(keys))
    client.push(keys, np.ones((10, DIM), np.float32))
    local.push(keys, np.ones((10, DIM), np.float32))
    np.testing.assert_array_equal(client.pull(keys), local.pull(keys))
    # the reference's client speaks the same wire to the port's server
    jclient = J.PsClient([("127.0.0.1", srv.port)], embed_dim=DIM)
    np.testing.assert_array_equal(jclient.pull(keys), local.pull(keys))
    jclient.close()
    client.close()
    srv.stop()


def test_strategy_a_sync_selects_communicator_mode(cluster):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.mesh import set_mesh

    ctx = P.get_ps_context()
    s = DistributedStrategy()
    assert ctx.configure_mode(s) == "sync"
    s.a_sync = True
    s.a_sync_configs = {"k_steps": 0}
    assert ctx.configure_mode(s) == "async"
    s.a_sync_configs = {"k_steps": 8}
    assert ctx.configure_mode(s) == "geo"
    comm = ctx.communicator_for(cluster)
    assert comm.mode == "geo" and comm.k_steps == 8
    assert ctx.communicator_for(cluster) is comm
    keys = np.arange(9900, 9904, dtype=np.int64)
    base = cluster.pull(keys)
    for _ in range(8):
        comm.push(keys, np.ones((keys.size, DIM), np.float32))
    np.testing.assert_allclose(cluster.pull(keys), base - 8.0, rtol=1e-6)
    ctx.stop_server()
    assert ctx.communicator_for(cluster) is not comm
    # fleet.init wires it, in the parameter-server mode too
    s2 = DistributedStrategy()
    s2.a_sync = True
    try:
        fleet.init(is_collective=False, strategy=s2, device="cpu")
        assert ctx.mode == "async"
    finally:
        ctx.configure_mode(DistributedStrategy())
        fleet._fleet_state.update(strategy=None, hcg=None,
                                  initialized=False)
        set_mesh(None)


def test_port_client_against_reference_servers():
    """The port's PsClient against two of the reference's PS server
    subprocesses: pulls and pushes bit-equal to the port's local table,
    and the dense plane too."""
    procs, endpoints = J.launch_servers(
        2, embed_dim=DIM, optimizer="adagrad", learning_rate=0.5, seed=4)
    client = P.PsClient(endpoints, embed_dim=DIM)
    try:
        local = make_local(optimizer="adagrad", lr=0.5, seed=4)
        rng = np.random.default_rng(8)
        keys = rng.integers(0, 2 ** 40, 300).astype(np.int64)
        keys[::7] = keys[0]                      # duplicates in the batch
        np.testing.assert_array_equal(client.pull(keys), local.pull(keys))
        g = rng.normal(size=(keys.size, DIM)).astype(np.float32)
        client.push(keys, g)
        local.push(keys, g)
        np.testing.assert_array_equal(client.pull(keys), local.pull(keys))
        assert len(client) == len(local)
        client.dense_init(9, optimizer="adagrad", learning_rate=0.5)
        dense = P.MemoryDenseTable(9, optimizer="adagrad", learning_rate=0.5)
        client.dense_set(np.arange(9, dtype=np.float32))
        dense.set(np.arange(9, dtype=np.float32))
        client.dense_push(np.ones(9, np.float32))
        dense.push(np.ones(9, np.float32))
        np.testing.assert_array_equal(client.dense_pull(), dense.pull())
    finally:
        client.stop_servers()
        client.close()
        for p in procs:
            p.wait(timeout=10)


def test_ps_ctr_phase_dry_run(monkeypatch):
    """chip_smoke.py's ps_ctr_training phase end to end on the CPU at a
    tiny size: the table rates, the lookup run held to the float64 run
    with both planted faults tripping the rows gate, serving leaving the
    rows as they were, StagedPull, and the two servers (sync bit-equal to
    the local run, async)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_dry", path)
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    monkeypatch.setattr(c, "nvidia_smi_line", lambda: "no card")
    out = c.phase_ps_ctr_training(0, device="cpu", keys=20000, batch=512,
                                  steps=8, bench_iters=5)
    assert out["tables"]["cold_pull_keys_per_s"] > 0
    look = out["lookup"]
    assert look["replay_bit_equal"]
    for fault in ("skip_push", "merge_duplicates"):
        assert look["readings"][fault]["rows_err"] > look["gates"]["rows"]
    assert out["serving"]["rows_and_state_unchanged"]
    assert out["network"]["sync"]["bit_equal_to_local"]
    assert set(out["flash_launches"].values()) == {0}

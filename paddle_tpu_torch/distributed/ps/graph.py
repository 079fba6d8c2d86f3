"""Graph table + walk-based batch generator over the native CSR store
(port of ``paddle_tpu/distributed/ps/graph.py``).

Reference parity:
  - ``GraphGpuWrapper``/``GpuPsGraphTable`` (``paddle/fluid/framework/fleet/
    heter_ps/graph_gpu_wrapper.h:25``, ``graph_gpu_ps_table.h:32``) — graph
    storage + ``graph_neighbor_sample_v2``;
  - ``GraphDataGenerator`` (``paddle/fluid/framework/data_feed.h:893``,
    walk kernel ``data_feed.cu:708``, ``FillWalkBuf`` ``data_feed.cu:883``) —
    random-walk window batches with negative sampling for
    deepwalk/node2vec-style GNN+CTR training;
  - CPU-side ``CommonGraphTable`` (``ps/table/common_graph_table.cc``).

Sampling runs on host C++ threads (the same sources as the JAX package's,
so samples and walks are the same for the same seeds); every batch has a
static shape.
"""
from __future__ import annotations

import struct
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ... import native


class GraphTable:
    """CSR graph with thread-parallel neighbor sampling and random walks."""

    def __init__(self):
        self._lib = native.get_lib()
        self._h = self._lib.pt_graph_create()
        self._built = False

    def add_edges(self, src, dst, weights=None) -> None:
        """Add directed edges; optional per-edge float weights bias
        neighbor sampling and walks toward heavier edges (the reference's
        weighted CSR, ``gpu_graph_node.h`` weight payloads)."""
        src = np.ascontiguousarray(np.asarray(src).reshape(-1), np.int64)
        dst = np.ascontiguousarray(np.asarray(dst).reshape(-1), np.int64)
        assert src.size == dst.size
        if weights is None:
            self._lib.pt_graph_add_edges(
                self._h, native.as_i64_ptr(src), native.as_i64_ptr(dst),
                src.size)
        else:
            w = np.ascontiguousarray(
                np.asarray(weights, np.float32).reshape(-1))
            assert w.size == src.size
            self._lib.pt_graph_add_edges_weighted(
                self._h, native.as_i64_ptr(src), native.as_i64_ptr(dst),
                native.as_f32_ptr(w), src.size)
        self._built = False

    def clear_edges(self) -> None:
        """Drop all edges (and the derived CSR); features are kept."""
        self._lib.pt_graph_clear_edges(self._h)
        self._built = False

    def build(self, symmetric: bool = False) -> None:
        """Finalize into CSR. ``symmetric=True`` adds reverse edges
        (reverse edges reuse their forward edge's weight)."""
        self._lib.pt_graph_build(self._h, 1 if symmetric else 0)
        self._built = True

    @property
    def num_nodes(self) -> int:
        return int(self._lib.pt_graph_num_nodes(self._h))

    @property
    def num_edges(self) -> int:
        return int(self._lib.pt_graph_num_edges(self._h))

    def node_ids(self) -> np.ndarray:
        n = self.num_nodes
        out = np.empty(n, np.int64)
        w = self._lib.pt_graph_node_ids(self._h, native.as_i64_ptr(out), n)
        return out[:w]

    def degree(self, key: int) -> int:
        return int(self._lib.pt_graph_degree(self._h, int(key)))

    def sample_neighbors(self, nodes, sample_size: int, replace: bool = False,
                         seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Sample up to ``sample_size`` neighbors per node.

        Returns ``(neighbors [n, k] int64 padded -1, counts [n] int32)`` —
        the padded-static-shape form of ``graph_neighbor_sample_v2``.
        """
        assert self._built, "call build() first"
        nodes = np.ascontiguousarray(np.asarray(nodes).reshape(-1), np.int64)
        out = np.empty((nodes.size, sample_size), np.int64)
        counts = np.empty(nodes.size, np.int32)
        self._lib.pt_graph_sample_neighbors(
            self._h, native.as_i64_ptr(nodes), nodes.size, sample_size,
            1 if replace else 0, seed, native.as_i64_ptr(out),
            native.as_i32_ptr(counts))
        return out, counts

    def random_walk(self, starts, walk_len: int, seed: int = 0) -> np.ndarray:
        """Fixed-length uniform random walks; [n, walk_len] int64, padded -1
        after dead ends (start node excluded). Each hop is deterministic in
        (seed, walk row, step, node) so the sharded client's hop-by-hop walk
        reproduces this exactly."""
        assert self._built, "call build() first"
        starts = np.ascontiguousarray(np.asarray(starts).reshape(-1), np.int64)
        out = np.empty((starts.size, walk_len), np.int64)
        self._lib.pt_graph_random_walk(
            self._h, native.as_i64_ptr(starts), starts.size, walk_len, seed,
            native.as_i64_ptr(out))
        return out

    def walk_step(self, nodes, idxs, step: int, seed: int = 0) -> np.ndarray:
        """One walk hop per node: ``next[i] = hop(nodes[i])`` chosen
        deterministically from ``(seed, idxs[i], step, nodes[i])``; -1 for
        sinks/unknown/negative inputs."""
        nodes = np.ascontiguousarray(np.asarray(nodes).reshape(-1), np.int64)
        idxs = np.ascontiguousarray(np.asarray(idxs).reshape(-1), np.int64)
        out = np.empty(nodes.size, np.int64)
        self._lib.pt_graph_walk_step(
            self._h, native.as_i64_ptr(nodes), native.as_i64_ptr(idxs),
            nodes.size, int(step), seed, native.as_i64_ptr(out))
        return out

    # -- node features (GpuPsCommGraphFea, gpu_graph_node.h:326) ----------
    def set_features(self, keys, feats) -> None:
        """Attach a float feature vector to each node (first call fixes the
        feature dim)."""
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1), np.int64)
        feats = np.ascontiguousarray(
            np.asarray(feats, np.float32).reshape(keys.size, -1))
        rc = self._lib.pt_graph_set_features(
            self._h, native.as_i64_ptr(keys), native.as_f32_ptr(feats),
            keys.size, feats.shape[1])
        if rc != 0:
            raise ValueError(
                f"feature dim {feats.shape[1]} != table dim {self.feature_dim}")

    @property
    def feature_dim(self) -> int:
        return int(self._lib.pt_graph_feature_dim(self._h))

    def sample_with_features(self, nodes, sample_size: int,
                             replace: bool = False, seed: int = 0):
        """Neighbor sample with features attached (graph_neighbor_sample_v3
        analogue); see :func:`_sample_with_features`."""
        return _sample_with_features(self, nodes, sample_size, replace, seed)

    def get_features(self, keys) -> np.ndarray:
        """[n, dim] float32 features; zero-filled for nodes without any."""
        dim = self.feature_dim
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1), np.int64)
        if dim == 0:
            return np.zeros((keys.size, 0), np.float32)
        out = np.empty((keys.size, dim), np.float32)
        rc = self._lib.pt_graph_get_features(
            self._h, native.as_i64_ptr(keys), keys.size, dim,
            native.as_f32_ptr(out))
        if rc != 0:
            raise ValueError("feature dim mismatch")
        return out

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and native is not None:
            try:
                self._lib.pt_graph_destroy(h)
            except Exception:
                pass


def _sample_with_features(store, nodes, sample_size: int, replace: bool,
                          seed: int):
    """Neighbor sample + feature gather in one call (the reference's
    ``graph_neighbor_sample_v3``: samples arrive with their
    ``GpuPsCommGraphFea`` payloads). Returns ``(neighbors [n,k], counts [n],
    feats [n,k,dim])`` with zero features on padding."""
    nb, cnt = store.sample_neighbors(nodes, sample_size, replace=replace,
                                     seed=seed)
    dim = store.feature_dim
    flat = nb.reshape(-1)
    feats = np.zeros((flat.size, dim), np.float32)
    valid = np.where(flat >= 0)[0]
    if valid.size and dim:
        feats[valid] = store.get_features(flat[valid])
    return nb, cnt, feats.reshape(nb.shape[0], sample_size, dim)


class GraphServer:
    """One graph shard served over TCP (in-proc flavor for tests; real
    deployments run
    ``python -m paddle_tpu_torch.distributed.ps.graph_server``).

    The multi-host half of the reference's graph engine: GraphBrpcServer
    (``ps/service/graph_brpc_server.cc``) dispatching into its
    CommonGraphTable shard. Ingest (add_edges/build/set_features) is phased
    before serving reads, matching the reference's pass-based build."""

    def __init__(self, port: int = 0, table: Optional[GraphTable] = None):
        self.table = table or GraphTable()
        self._lib = native.get_lib()
        self._h = self._lib.pt_graph_server_start(self.table._h, int(port))
        if not self._h:
            raise OSError(f"failed to bind graph server on port {port}")

    @property
    def port(self) -> int:
        return int(self._lib.pt_graph_server_port(self._h))

    def wait(self) -> None:
        self._lib.pt_graph_server_wait(self._h)

    def stop(self) -> None:
        h, self._h = self._h, None
        if h:
            self._lib.pt_graph_server_stop(h)
            self._lib.pt_graph_server_destroy(h)

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


# graph service opcodes (native/src/graph_service.cc)
_GOP_ADD_EDGES = 1
_GOP_BUILD = 2
_GOP_NUM_NODES = 3
_GOP_NUM_EDGES = 4
_GOP_NODE_IDS = 5
_GOP_DEGREE = 6
_GOP_SAMPLE = 7
_GOP_WALK_STEP = 8
_GOP_SET_FEAT = 9
_GOP_GET_FEAT = 10
_GOP_FEAT_DIM = 11
_GOP_STOP = 12
_GOP_CLEAR_EDGES = 13
_GOP_ADD_EDGES_W = 14
_GOP_WALK_MULTI = 15


class DistGraphClient:
    """Sharded graph client: the :class:`GraphTable` interface over N graph
    servers, nodes partitioned by ``shard_of`` (a node's adjacency and
    features live wholly on its owner shard).

    Parity contract with the single-host store (tested in test_graph.py):

    - ``sample_neighbors`` routes each query node to its owner; the owner
      holds that node's full CSR row in the same order the single-host
      store would, and sampling is deterministic per (seed, node) — so
      results are bit-identical.
    - ``random_walk`` steps hop-by-hop: at step t the frontier is grouped
      by owner shard, each owner picks the next neighbor deterministically
      from (seed, walk row, step, node) — the HeterComm per-hop key
      exchange (``graph_gpu_ps_table.h:128-134``) restated client-side.
      Bit-identical to the single-host walk.
    - ``set_features``/``get_features`` route by owner.

    Edges are buffered client-side and partitioned at :meth:`build` (both
    directions for ``symmetric=True``, forward before reverse, preserving
    the single-host CSR row order).
    """

    def __init__(self, endpoints: Sequence[Tuple[str, int]]):
        from .service import _Conn
        import threading

        if not endpoints:
            raise ValueError("need at least one graph endpoint")
        self.endpoints = list(endpoints)
        self._conns = [_Conn(h, p) for h, p in self.endpoints]
        self._locks = [threading.Lock() for _ in self._conns]
        self._src_buf: list = []
        self._dst_buf: list = []
        self._w_buf: list = []
        self._built = False

    def _shard_of(self, keys: np.ndarray) -> np.ndarray:
        from .service import shard_of

        return shard_of(keys, len(self._conns))

    def _request(self, s: int, op: int, body: bytes = b"") -> bytes:
        with self._locks[s]:
            return self._conns[s].request(op, body)

    def _request_multi(self, reqs):
        """Scatter-gather: write EVERY request before reading any reply,
        so the shards' server-side work overlaps instead of serializing
        one round-trip per shard (the brpc parallel-channel pattern,
        ``brpc_ps_client.cc`` DownpourBrpcClosure over N requests).
        ``reqs`` is ``[(shard, op, body), ...]``; replies come back in the
        same order (the framed protocol answers pipelined requests in
        FIFO order per connection)."""
        held = sorted({s for s, _, _ in reqs})
        for s in held:
            self._locks[s].acquire()
        try:
            for s, op, body in reqs:
                self._conns[s].send(op, body)
            # EVERY pipelined reply must be read even when one is an error
            # frame — an unread reply would desync that connection and the
            # next request would parse a stale payload as its own
            results, first_err = [], None
            for s, op, _ in reqs:
                try:
                    results.append(self._conns[s].recv(op))
                except Exception as e:  # noqa: BLE001 — re-raised below
                    results.append(None)
                    if first_err is None:
                        first_err = e
            if first_err is not None:
                raise first_err
            return results
        finally:
            for s in held:
                self._locks[s].release()

    # -- ingest ------------------------------------------------------------
    def clear_edges(self) -> None:
        """Drop the client-side edge buffer (a later build() starts from
        scratch; servers clear on every build anyway)."""
        self._src_buf, self._dst_buf, self._w_buf = [], [], []
        self._built = False

    def add_edges(self, src, dst, weights=None) -> None:
        src = np.ascontiguousarray(np.asarray(src).reshape(-1), np.int64)
        dst = np.ascontiguousarray(np.asarray(dst).reshape(-1), np.int64)
        assert src.size == dst.size
        if weights is not None:
            weights = np.ascontiguousarray(
                np.asarray(weights, np.float32).reshape(-1))
            assert weights.size == src.size
        self._src_buf.append(src)
        self._dst_buf.append(dst)
        self._w_buf.append(weights)
        self._built = False

    def build(self, symmetric: bool = False) -> None:
        src = (np.concatenate(self._src_buf) if self._src_buf
               else np.empty(0, np.int64))
        dst = (np.concatenate(self._dst_buf) if self._dst_buf
               else np.empty(0, np.int64))
        weighted = any(w is not None for w in self._w_buf)
        if weighted:
            w = np.concatenate([
                np.ones(s.size, np.float32) if wb is None else wb
                for s, wb in zip(self._src_buf, self._w_buf)])
        else:
            w = None
        if symmetric:
            # forward stream first, then the reversed stream — the order the
            # single-host Build(symmetric) appends them, so each owner's CSR
            # rows match (reverse edges keep their forward weight)
            src, dst = (np.concatenate([src, dst]), np.concatenate([dst, src]))
            if weighted:
                w = np.concatenate([w, w])
        owner = self._shard_of(src)
        # clear first: the client re-sends its FULL buffer each build.
        # Scatter incrementally — build each shard's edge body, send its
        # three pipelined requests, and FREE the body before building the
        # next shard's (the bodies together would double the edge set's
        # footprint) — then gather every reply at the end, so each shard
        # partitions/sorts while the client streams the next shard's edges.
        sent = []  # (shard, op) in send order
        for s in range(len(self._conns)):
            self._locks[s].acquire()
        try:
            for s in range(len(self._conns)):
                sel = owner == s
                ss, dd = src[sel], dst[sel]
                if weighted:
                    body = (struct.pack("<I", ss.size) + ss.tobytes()
                            + dd.tobytes() + w[sel].tobytes())
                    add_op = _GOP_ADD_EDGES_W
                else:
                    body = (struct.pack("<I", ss.size) + ss.tobytes()
                            + dd.tobytes())
                    add_op = _GOP_ADD_EDGES
                del ss, dd
                self._conns[s].send(_GOP_CLEAR_EDGES)
                self._conns[s].send(add_op, body)
                del body
                self._conns[s].send(_GOP_BUILD, struct.pack("<B", 0))
                sent += [(s, _GOP_CLEAR_EDGES), (s, add_op), (s, _GOP_BUILD)]
            first_err = None
            for s, op in sent:
                try:
                    self._conns[s].recv(op)
                except Exception as e:  # noqa: BLE001 — re-raised below
                    if first_err is None:
                        first_err = e
            if first_err is not None:
                raise first_err
        finally:
            for s in range(len(self._conns)):
                self._locks[s].release()
        self._built = True

    # -- control plane -----------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return int(self.node_ids().size)

    @property
    def num_edges(self) -> int:
        return sum(
            struct.unpack("<q", self._request(s, _GOP_NUM_EDGES))[0]
            for s in range(len(self._conns)))

    def node_ids(self) -> np.ndarray:
        parts = [np.frombuffer(self._request(s, _GOP_NODE_IDS), np.int64)
                 for s in range(len(self._conns))]
        # endpoints of cross-shard edges are interned on both sides; the
        # global node set is the union
        return np.unique(np.concatenate(parts)) if parts else \
            np.empty(0, np.int64)

    def degree(self, key: int) -> int:
        s = int(self._shard_of(np.asarray([key], np.int64))[0])
        return struct.unpack(
            "<q", self._request(s, _GOP_DEGREE, struct.pack("<q", int(key))))[0]

    # -- data plane --------------------------------------------------------
    def sample_neighbors(self, nodes, sample_size: int, replace: bool = False,
                         seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        assert self._built, "call build() first"
        nodes = np.ascontiguousarray(np.asarray(nodes).reshape(-1), np.int64)
        out = np.empty((nodes.size, sample_size), np.int64)
        counts = np.empty(nodes.size, np.int32)
        owner = self._shard_of(nodes)
        reqs, sels = [], []
        for s in range(len(self._conns)):
            sel = np.where(owner == s)[0]
            if sel.size == 0:
                continue
            part = nodes[sel]
            body = (struct.pack("<IiBQ", part.size, sample_size,
                                1 if replace else 0, seed) + part.tobytes())
            reqs.append((s, _GOP_SAMPLE, body))
            sels.append(sel)
        for sel, payload in zip(sels, self._request_multi(reqs)):
            nb = np.frombuffer(payload[:sel.size * sample_size * 8],
                               np.int64).reshape(sel.size, sample_size)
            ct = np.frombuffer(payload[sel.size * sample_size * 8:], np.int32)
            out[sel] = nb
            counts[sel] = ct
        return out, counts

    def random_walk(self, starts, walk_len: int, seed: int = 0) -> np.ndarray:
        """Distributed walk with server-side multi-hop runs: each walker
        advances ON its owner shard until it dies, finishes, or its next
        node belongs to another shard — one scatter-gather round per
        shard-crossing instead of one round-trip per hop (for 2 uniform
        shards that halves the RPC rounds; the reference's server-side
        FillWalkBuf + HeterComm handoff, ``ps_gpu_wrapper.h:198``).
        Per-hop hashing is unchanged, so output stays bit-identical to the
        single-host :meth:`GraphTable.random_walk`."""
        assert self._built, "call build() first"
        starts = np.ascontiguousarray(np.asarray(starts).reshape(-1), np.int64)
        n = starts.size
        out = np.full((n, walk_len), -1, np.int64)
        cur = starts.copy()
        step = np.zeros(n, np.int32)
        rows = np.arange(n, dtype=np.int64)
        num_shards = len(self._conns)
        active = np.where(cur >= 0)[0]
        # chunk so BOTH frames stay safely under the server's 256 MB cap:
        # worst-case reply is walk_len*8+5 bytes/walker, the request is a
        # flat 20 bytes/walker (which dominates at walk_len=1)
        max_per_req = max(1, (200 << 20) // max(walk_len * 8 + 5, 20))
        while active.size:
            owner = self._shard_of(cur[active])
            reqs, sels = [], []
            for s in range(num_shards):
                shard_sel = active[owner == s]
                for lo in range(0, shard_sel.size, max_per_req):
                    sel = shard_sel[lo:lo + max_per_req]
                    body = (struct.pack("<IiIIQ", sel.size, walk_len, s,
                                        num_shards, seed)
                            + cur[sel].tobytes() + rows[sel].tobytes()
                            + step[sel].tobytes())
                    reqs.append((s, _GOP_WALK_MULTI, body))
                    sels.append(sel)
            still = []
            for sel, payload in zip(sels, self._request_multi(reqs)):
                m = sel.size
                adv = np.frombuffer(payload[:4 * m], np.int32)
                status = np.frombuffer(payload[4 * m:5 * m], np.uint8)
                flat = np.frombuffer(payload[5 * m:], np.int64)
                adv64 = adv.astype(np.int64)
                # scatter variable-length runs into out[row, step:step+adv]
                tgt_rows = np.repeat(sel, adv64)
                run_end = np.cumsum(adv64)
                tgt_cols = (np.arange(flat.size, dtype=np.int64)
                            - np.repeat(run_end - adv64, adv64)
                            + np.repeat(step[sel].astype(np.int64), adv64))
                out[tgt_rows, tgt_cols] = flat
                step[sel] += adv
                has = adv64 > 0
                cur[sel[has]] = flat[run_end[has] - 1]
                still.append(sel[status == 2])  # handoff: still walking
            active = (np.concatenate(still) if still
                      else np.empty(0, np.int64))
        return out

    # -- features ----------------------------------------------------------
    def set_features(self, keys, feats) -> None:
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1), np.int64)
        feats = np.ascontiguousarray(
            np.asarray(feats, np.float32).reshape(keys.size, -1))
        dim = feats.shape[1]
        owner = self._shard_of(keys)
        reqs = []
        for s in range(len(self._conns)):
            sel = owner == s
            if not sel.any():
                continue
            kk, ff = keys[sel], feats[sel]
            body = (struct.pack("<Ii", kk.size, dim) + kk.tobytes()
                    + ff.tobytes())
            reqs.append((s, _GOP_SET_FEAT, body))
        self._request_multi(reqs)

    @property
    def feature_dim(self) -> int:
        dims = [struct.unpack("<i", self._request(s, _GOP_FEAT_DIM))[0]
                for s in range(len(self._conns))]
        return max(dims) if dims else 0

    def sample_with_features(self, nodes, sample_size: int,
                             replace: bool = False, seed: int = 0):
        """Neighbor sample with features attached (graph_neighbor_sample_v3
        analogue); see :func:`_sample_with_features`."""
        return _sample_with_features(self, nodes, sample_size, replace, seed)

    def get_features(self, keys) -> np.ndarray:
        dim = self.feature_dim
        keys = np.ascontiguousarray(np.asarray(keys).reshape(-1), np.int64)
        if dim == 0:
            return np.zeros((keys.size, 0), np.float32)
        out = np.zeros((keys.size, dim), np.float32)
        owner = self._shard_of(keys)
        reqs, sels = [], []
        for s in range(len(self._conns)):
            sel = np.where(owner == s)[0]
            if sel.size == 0:
                continue
            kk = keys[sel]
            body = struct.pack("<Ii", kk.size, dim) + kk.tobytes()
            reqs.append((s, _GOP_GET_FEAT, body))
            sels.append(sel)
        for sel, payload in zip(sels, self._request_multi(reqs)):
            out[sel] = np.frombuffer(payload, np.float32).reshape(sel.size,
                                                                  dim)
        return out

    # -- lifecycle ---------------------------------------------------------
    def stop_servers(self) -> None:
        for s in range(len(self._conns)):
            try:
                self._request(s, _GOP_STOP)
            except (IOError, ConnectionError):
                pass  # server exits as it acks

    def close(self) -> None:
        for conn in self._conns:
            conn.close()


def launch_graph_servers(num_servers: int, timeout: float = 30.0):
    """Spawn graph-shard server subprocesses on ephemeral ports; returns
    ``(procs, endpoints)`` via the PORT-line handshake. The native
    library is built first, so the servers load this process's build."""
    import sys

    from .service import launch_port_subprocesses

    native.build()
    argv = [sys.executable, "-m",
            "paddle_tpu_torch.distributed.ps.graph_server",
            "--port", "0"]
    return launch_port_subprocesses([argv] * num_servers, timeout=timeout)


class GraphDataGenerator:
    """Walk-window skip-gram batch stream with negative sampling.

    The ``GraphDataGenerator`` analogue (``data_feed.h:893``): walks start
    from every node (shuffled per epoch), a sliding window over each walk
    emits (center, context) positive pairs, and negatives are drawn uniformly
    from the node set — the deepwalk training feed of the reference's PGLBox
    pipeline. Batches are constant-shape ``(batch_size,)`` int64 triples
    (center, context, negatives[batch, num_neg]) so the step sees one
    shape; the final partial batch is dropped (reference drops it too).
    """

    def __init__(self, graph: GraphTable, batch_size: int = 512,
                 walk_len: int = 8, window: int = 2, num_neg: int = 4,
                 seed: int = 0, starts: Optional[np.ndarray] = None):
        self.graph = graph
        self.batch_size = batch_size
        self.walk_len = walk_len
        self.window = window
        self.num_neg = num_neg
        self.seed = seed
        self._starts = (np.asarray(starts, np.int64) if starts is not None
                        else graph.node_ids())
        self._nodes = graph.node_ids()
        self._epoch = 0

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        starts = rng.permutation(self._starts)
        walks = self.graph.random_walk(
            starts, self.walk_len, seed=int(rng.integers(2 ** 62)))
        # full sequences: start node + its walk
        seqs = np.concatenate([starts[:, None], walks], axis=1)
        centers, contexts = [], []
        L = seqs.shape[1]
        for off in range(1, self.window + 1):
            src = seqs[:, :-off].reshape(-1)
            dst = seqs[:, off:].reshape(-1)
            ok = (src >= 0) & (dst >= 0)
            centers.append(src[ok])
            contexts.append(dst[ok])
            centers.append(dst[ok])   # symmetric window
            contexts.append(src[ok])
        centers = np.concatenate(centers)
        contexts = np.concatenate(contexts)
        perm = rng.permutation(centers.size)
        centers, contexts = centers[perm], contexts[perm]
        bs = self.batch_size
        for i in range(centers.size // bs):
            c = centers[i * bs:(i + 1) * bs]
            x = contexts[i * bs:(i + 1) * bs]
            neg = rng.choice(self._nodes, size=(bs, self.num_neg))
            yield c, x, neg.astype(np.int64)

"""Graph sampling + reindex, host-side (port of
``paddle_tpu/geometric/sampling.py``).

Reference parity: ``python/paddle/geometric/sampling/neighbors.py``
(``sample_neighbors`` over CSC ``row``/``colptr`` tensors; CUDA kernel
``paddle/phi/kernels/gpu/graph_sample_neighbors_kernel.cu``),
``graph_reindex.py:28`` and ``graph_khop_sampler.py:21``. Sampling is
host work feeding padded batches to the card; the heavy store lives in
C++ (:class:`paddle_tpu_torch.distributed.ps.graph.GraphTable`), while
this module also accepts plain CSC numpy arrays for API parity.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _sample_from_csc(row: np.ndarray, colptr: np.ndarray, node: int,
                     k: int, rng: np.random.Generator,
                     replace: bool) -> np.ndarray:
    beg, end = int(colptr[node]), int(colptr[node + 1])
    neigh = row[beg:end]
    # k <= 0 is the "take all neighbors" sentinel regardless of `replace`.
    if neigh.size == 0 or k <= 0 or (not replace and neigh.size <= k):
        return neigh.copy()
    return rng.choice(neigh, size=k, replace=replace)


def sample_neighbors(row, colptr, input_nodes, sample_size: int = -1,
                     replace: bool = False, seed: Optional[int] = None,
                     return_eids: bool = False):
    """Sample neighbors of ``input_nodes`` from a CSC graph.

    Returns ``(out_neighbors, out_count)`` as int64/int32 numpy arrays —
    ``out_neighbors`` is the concatenation of each node's sampled
    neighbors (ragged, like the reference), ``out_count[i]`` its length.
    """
    row = np.asarray(row, np.int64).reshape(-1)
    colptr = np.asarray(colptr, np.int64).reshape(-1)
    nodes = np.asarray(input_nodes, np.int64).reshape(-1)
    rng = np.random.default_rng(seed)
    k = int(sample_size)
    outs, counts = [], np.empty(nodes.size, np.int32)
    for i, u in enumerate(nodes):
        s = _sample_from_csc(row, colptr, int(u), k, rng, replace)
        outs.append(s)
        counts[i] = s.size
    out = (np.concatenate(outs) if outs else np.empty(0, np.int64))
    if return_eids:
        raise NotImplementedError("eids not tracked; store edge ids as "
                                  "features if needed")
    return out.astype(np.int64), counts


def _intern_ids(x):
    """First-seen interning table seeded with ``x``: returns
    ``(local: dict id->idx, out_nodes: list, map_ids)`` where
    ``map_ids(ids) -> np.ndarray`` maps (and interns) a flat id array.
    Shared by reindex_graph / reindex_heter_graph / _khop_core — the
    single definition of the "x first, then first-seen" ordering."""
    local = {int(v): i for i, v in enumerate(x)}
    out_nodes = list(x)

    def map_ids(ids):
        out = np.empty(len(ids), np.int64)
        for i, v in enumerate(ids):
            vi = int(v)
            idx = local.get(vi)
            if idx is None:
                idx = len(out_nodes)
                local[vi] = idx
                out_nodes.append(vi)
            out[i] = idx
        return out

    return local, out_nodes, map_ids


def reindex_graph(x, neighbors, count) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """Relabel global ids to a compact local space.

    Returns ``(reindex_src, reindex_dst, out_nodes)`` where ``out_nodes``
    starts with ``x`` then first-seen new neighbor ids;
    ``reindex_src[i]`` is the local id of ``neighbors[i]`` and
    ``reindex_dst`` repeats each center's local id ``count[i]`` times —
    exactly the reference's ``graph_reindex`` contract.
    """
    x = np.asarray(x, np.int64).reshape(-1)
    neighbors = np.asarray(neighbors, np.int64).reshape(-1)
    count = np.asarray(count, np.int64).reshape(-1)
    _, out_nodes, map_ids = _intern_ids(x)
    src = map_ids(neighbors)
    dst = np.repeat(np.arange(x.size, dtype=np.int64), count)
    return src, dst, np.asarray(out_nodes, np.int64)


def _khop_core(fetch, input_nodes, sample_sizes):
    """Shared khop mechanics: hop loop + local-id interning + edge
    accumulation. ``fetch(frontier, hop, k) -> list of per-node neighbor
    id-lists`` abstracts the backing store (CSC arrays or a graph
    service)."""
    nodes = np.asarray(input_nodes, np.int64).reshape(-1)
    local = {}
    table = []

    def intern(v: int) -> int:
        idx = local.get(v)
        if idx is None:
            idx = len(table)
            local[v] = idx
            table.append(v)
        return idx

    for u in nodes:
        intern(int(u))
    all_src, all_dst = [], []
    frontier = nodes
    for hop, k in enumerate(sample_sizes):
        if frontier.size == 0:
            break
        per_node = fetch(frontier, hop, int(k))
        nxt = []
        for u, neigh in zip(frontier, per_node):
            du = intern(int(u))
            for v in neigh:
                v = int(v)
                all_src.append(intern(v))
                all_dst.append(du)
                nxt.append(v)
        frontier = np.unique(np.asarray(nxt, np.int64)) if nxt else \
            np.empty(0, np.int64)
    return (np.asarray(all_src, np.int64), np.asarray(all_dst, np.int64),
            np.asarray(table, np.int64))


def khop_sampler(row, colptr, input_nodes, sample_sizes,
                 seed: Optional[int] = None):
    """Multi-hop neighborhood sampling (reference ``graph_khop_sampler``).

    Returns ``(edge_src, edge_dst, sample_index)``: local-id edges over the
    union frontier and the global ids backing each local id.
    """

    def fetch(frontier, hop, k):
        neigh, cnt = sample_neighbors(
            row, colptr, frontier, k,
            seed=None if seed is None else seed + hop)
        out, pos = [], 0
        for c in cnt:
            out.append(neigh[pos:pos + c])
            pos += c
        return out

    return _khop_core(fetch, input_nodes, sample_sizes)


def khop_sampler_from_store(store, input_nodes, sample_sizes,
                            seed: int = 0, with_features: bool = False):
    """Multi-hop sampling over a graph STORE — single-host
    :class:`~paddle_tpu_torch.distributed.ps.graph.GraphTable` or the sharded
    :class:`~paddle_tpu_torch.distributed.ps.graph.DistGraphClient` — the GNN
    minibatch feed of the reference's GpuPs khop path
    (``graph_khop_sampler.py`` over ``GpuPsGraphTable``).

    Because per-node sampling is deterministic in (seed, node), the
    subgraph is IDENTICAL whether the store is local or sharded across
    servers. Returns ``(edge_src, edge_dst, sample_index)`` in local ids
    (edges point neighbor -> center, khop_sampler convention), plus the
    node-feature matrix for ``sample_index`` when ``with_features``.
    """
    if any(int(k) <= 0 for k in sample_sizes):
        raise ValueError(
            "store-backed khop needs sample sizes > 0: the padded "
            "static-shape store sampler has no take-all sentinel")

    def fetch(frontier, hop, k):
        nb, cnt = store.sample_neighbors(frontier, k, seed=seed + hop)
        return [[v for v in nb[i][:int(cnt[i])] if v >= 0]
                for i in range(len(frontier))]

    out = _khop_core(fetch, input_nodes, sample_sizes)
    if with_features:
        feats = store.get_features(out[2])
        return out + (feats,)
    return out


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """Multi-edge-type reindex (reference ``geometric/reindex.py:138``):
    one shared local-id table over all graphs — ``x`` first, then new ids
    in first-seen order across the graphs' neighbor lists — returning the
    concatenated ``(reindex_src, reindex_dst, out_nodes)``. The optional
    hash buffers of the reference's GPU kernel have no host-side meaning
    and are accepted for signature parity."""
    del value_buffer, index_buffer
    x = np.asarray(x, np.int64).reshape(-1)
    _, out_nodes, map_ids = _intern_ids(x)
    srcs, dsts = [], []
    for nb, ct in zip(neighbors, count):
        nb = np.asarray(nb, np.int64).reshape(-1)
        ct = np.asarray(ct, np.int64).reshape(-1)
        srcs.append(map_ids(nb))
        dsts.append(np.repeat(np.arange(x.size, dtype=np.int64), ct))
    return (np.concatenate(srcs) if srcs else np.empty(0, np.int64),
            np.concatenate(dsts) if dsts else np.empty(0, np.int64),
            np.asarray(out_nodes, np.int64))

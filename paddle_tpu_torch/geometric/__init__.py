"""paddle_tpu_torch.geometric — GNN message passing + graph sampling
(port of ``paddle_tpu/geometric``).

Reference parity: ``python/paddle/geometric/`` (``message_passing/send_recv.py``,
``sampling/neighbors.py``) and the incubate wrappers
(``python/paddle/incubate/operators/graph_send_recv.py``,
``graph_sample_neighbors.py:28``, ``graph_reindex.py:28``,
``graph_khop_sampler.py:21``). Aggregation is a scatter-reduce on the
ids' device (``cuda`` when no argument is a tensor; differentiable);
samplers run in the native C++ CSR store or over in-memory CSC arrays,
returning padded static shapes.
"""
from .message_passing import (segment_max, segment_mean, segment_min,
                              segment_pool, segment_sum, send_u_recv,
                              send_ue_recv, send_uv)
from .sampling import (reindex_heter_graph,  # noqa: F401
                       khop_sampler, khop_sampler_from_store,
                       reindex_graph, sample_neighbors)

__all__ = [
    "send_u_recv", "send_ue_recv", "send_uv", "segment_pool",
    "segment_sum", "segment_mean", "segment_min", "segment_max",
    "sample_neighbors", "reindex_graph", "reindex_heter_graph",
    "khop_sampler", "khop_sampler_from_store",
]

"""DataParallel wrapper (port of
``paddle_tpu/distributed/parallel/data_parallel.py``).

The reference's dygraph ``DataParallel`` installs the C++ ``Reducer``
(bucketed fused all-reduce overlapped with the backward). Here gradient
synchronization belongs to the step: ``DistributedTrainStep`` with
``batch_axes=("dp",)`` reduces the gradients, and with
``overlap_grad_reduce=True`` it does so bucket by bucket from gradient
hooks while the backward runs (``distributed.overlap``). This class keeps
the reference's API so ported scripts run: ``forward`` delegates,
``scale_loss`` is the identity (the step's loss is already the global
batch's mean), ``no_sync`` is a no-op context (gradient merge is the
step's ``grad_accum_steps``), and ``comm_buffer_size`` (MB, the
``Reducer``'s bucket size) is kept as ``_comm_buffer_mb``, which the step
reads as its default ``bucket_size_mb``.
"""
from __future__ import annotations

import contextlib

from torch import nn

__all__ = ["DataParallel"]


class DataParallel(nn.Module):
    def __init__(self, layers: nn.Module, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        del strategy, last_comm_buffer_size, find_unused_parameters, group
        self._layers = layers
        # bucket-size hint (MB) for the overlap schedule; see module doc
        self._comm_buffer_mb = float(comm_buffer_size)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        yield

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, state, *a, **kw):
        return self._layers.load_state_dict(state, *a, **kw)

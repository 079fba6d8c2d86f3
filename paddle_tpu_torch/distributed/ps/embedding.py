"""Sparse embedding lookup whose backward pushes into a PS table (port of
``paddle_tpu/distributed/ps/embedding.py``).

Reference parity: ``distributed_lookup_table``/``c_embedding`` +
``PSGPUWrapper::PullSparse``/``PushSparseGrad``
(``paddle/fluid/framework/fleet/ps_gpu_wrapper.h:157,170``) and the Python
``paddle.static.nn.sparse_embedding``. The pull is a host call into the
C++ table whose rows (``[batch, dim]``, never the table) are copied to the
ids' device; the push rides the backward of a ``torch.autograd.Function``,
and the optimizer update happens in the table, so the embedding never
appears among the step's parameters.

Feature ids stay int64 from end to end: the reference's traced path
narrows them to int32 (``jnp.asarray`` with x64 off), the port does not.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...nn.initializer import Constant, create_parameter
from .table import MemorySparseTable, SparseAccessorConfig

__all__ = ["SparseEmbedding", "StagedPull", "callbacks_supported",
           "make_lookup"]


def callbacks_supported() -> bool:
    """Whether the training path can reach the host table from inside a
    step: always, since the port runs no traced program (the reference
    probes its backend for host callbacks)."""
    return True


def _host_ids(ids) -> np.ndarray:
    """The ids as a flat int64 host array (a copy back from the card)."""
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().to("cpu")
        return ids.reshape(-1).to(torch.int64).numpy()
    return np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64)


class _Lookup(torch.autograd.Function):
    """``rows = table.pull(ids)`` forward, ``table.push(ids, grad)``
    backward; no gradient for the ids, zero for the anchor."""

    @staticmethod
    def forward(ctx, ids, anchor, table, device):
        flat = _host_ids(ids)
        # the pull is effectful (it initializes missing keys and bumps the
        # show counter that shrink reads): exactly once a call
        rows = torch.from_numpy(table.pull(flat))
        ctx.table, ctx.flat = table, flat
        ctx.anchor_meta = (anchor.shape, anchor.dtype, anchor.device)
        return rows.to(device).reshape(tuple(ids.shape) + (table.embed_dim,))

    @staticmethod
    def backward(ctx, grad):
        flat_g = grad.detach().reshape(-1, ctx.table.embed_dim).to(
            "cpu", torch.float32).numpy()
        # every occurrence of a duplicate id is pushed: the table applies
        # its rule once per occurrence, as the reference's push does
        ctx.table.push(ctx.flat, flat_g)
        shape, dtype, device = ctx.anchor_meta
        return None, torch.zeros(shape, dtype=dtype, device=device), None, \
            None


def make_lookup(table: MemorySparseTable):
    """A differentiable ``lookup(ids, anchor) -> float32[..., dim]`` bound
    to ``table``; its backward pushes the row gradients into the table
    (which applies its optimizer rule).

    ``anchor`` is a scalar that requires grad: integer ids carry no
    gradient, so without such an input the output would have no
    ``grad_fn`` and the backward (and the push) would never run
    (:class:`SparseEmbedding` registers one). The rows land on the ids'
    device (the anchor's for host ids)."""

    def lookup(ids, anchor):
        device = ids.device if isinstance(ids, torch.Tensor) \
            else anchor.device
        if not isinstance(ids, torch.Tensor):
            ids = torch.as_tensor(np.asarray(ids, np.int64))
        return _Lookup.apply(ids, anchor, table, device)

    return lookup


class SparseEmbedding(nn.Module):
    """Embedding layer backed by a PS table instead of a dense parameter.

    Ids are arbitrary int64 feature hashes (no vocab bound) and rows live
    on the host, the CTR regime of the reference's HeterPS. The table
    applies the update on ``push`` during the backward, so the layer's only
    parameter is ``grad_anchor`` (shape ``()``, zero): a module that is
    training with grad enabled goes through :func:`make_lookup`; in eval
    or under ``no_grad`` it does a plain pull and no push."""

    def __init__(self, embed_dim: int, table: MemorySparseTable = None,
                 device=None, **accessor_kw):
        super().__init__()
        if table is None:
            table = MemorySparseTable(
                SparseAccessorConfig(embed_dim=embed_dim, **accessor_kw))
        assert table.embed_dim == embed_dim
        self.table = table
        self.embed_dim = embed_dim
        self._lookup = make_lookup(table)
        from ... import default_device

        self.grad_anchor = create_parameter(
            (), default_initializer=Constant(0.0),
            device=default_device(device))

    def forward(self, ids):
        device = ids.device if isinstance(ids, torch.Tensor) \
            else self.grad_anchor.device
        if not (self.training and torch.is_grad_enabled()):
            rows = torch.from_numpy(self.table.pull(_host_ids(ids)))
            shape = tuple(np.shape(ids))
            return rows.to(device).reshape(shape + (self.embed_dim,))
        if not self.grad_anchor.requires_grad:
            # the push would be unreachable from any differentiated value:
            # the step would run, the loss move, and the embedding never
            # train. Fail loudly instead.
            raise RuntimeError(
                "SparseEmbedding is training with grad enabled, but its "
                "grad_anchor parameter does not require grad, so embedding "
                "gradients would be silently dropped. Train it through "
                "TrainStep (which makes grad_anchor require grad), or call "
                ".eval() on the layer for inference.")
        return self._lookup(ids, self.grad_anchor)

    def extra_repr(self):
        acc = getattr(self.table, "accessor", None)  # PsClient has none
        opt = f", optimizer={acc.optimizer}" if acc is not None else ""
        return f"embed_dim={self.embed_dim}{opt}"


class StagedPull:
    """Pull-before / push-after staging: the reference's own structure
    (``PSGPUWorker`` pulls via ``PullSparse`` before the program runs and
    pushes via ``PushSparseGrad`` after it, ``ps_gpu_wrapper.h:157,170``).
    The step takes the deduplicated ``rows`` as an ordinary differentiable
    input, so the row gradients come back merged (the communicator's
    batched merge, ``communicator.h:426``).

    Usage::

        staged = StagedPull(table, device="cuda")
        rows, inv, uniq = staged.pull(ids)          # host side
        rows.requires_grad_()
        loss = f(StagedPull.lookup(rows, inv))      # emb = rows[inv]
        loss.backward()
        staged.push(uniq, rows.grad)                # host side, C++ update
    """

    def __init__(self, table: MemorySparseTable, device=None):
        from ... import default_device

        self.table = table
        self.device = default_device(device)

    def pull(self, ids):
        ids = _host_ids(ids).reshape(np.shape(ids))
        uniq, inv = np.unique(ids.reshape(-1), return_inverse=True)
        rows = self.table.pull(uniq)
        return (torch.from_numpy(rows).to(self.device),
                torch.from_numpy(inv.reshape(ids.shape)).to(self.device),
                uniq)

    @staticmethod
    def lookup(rows, inv):
        """The gather: embedding activations for the original ids."""
        return rows[inv]

    def push(self, uniq, row_grads) -> None:
        if isinstance(row_grads, torch.Tensor):
            row_grads = row_grads.detach().to("cpu", torch.float32).numpy()
        self.table.push(uniq, np.asarray(row_grads))

"""Single-device ``Linear``, ``Embedding`` and ``Dropout`` with the
reference's weight layout and randomness
(``paddle_tpu/distributed/parallel/mp_layers.py:51-150``,
``paddle_tpu/nn/layers/common.py:56``).

``Linear.weight`` is ``[in, out]`` and ``Embedding.weight`` is
``[vocab, hidden]``, exactly as the JAX package stores them, so loading a
converted checkpoint is a copy, never a transpose. The tensor-parallel
names alias these: on one card there is nothing to shard, and
``ParallelCrossEntropy``/``parallel_matmul`` are the plain loss and
product.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F

__all__ = ["Linear", "Embedding", "Dropout", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "parallel_matmul"]


def _normal(shape, std: float, device, generator: Optional[torch.Generator]):
    w = torch.empty(shape, device=device)
    return w.normal_(0.0, std, generator=generator)


class Linear(nn.Module):
    """``y = x @ weight + bias``; weight ``[in, out]`` drawn from
    ``Normal(0, std)``, bias zeros. ``has_bias=False`` registers no bias
    parameter at all (``bias`` is None), as the reference's Llama
    projections (``mp_layers.py:87-91``)."""

    def __init__(self, in_features: int, out_features: int, *,
                 std: float = 0.02, has_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(
            _normal((in_features, out_features), std, device, generator))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if has_bias else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Row lookup into ``weight`` ``[num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 std: float = 0.02, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(
            _normal((num_embeddings, embedding_dim), std, device, generator))

    def forward(self, ids):
        return self.weight[ids]


ColumnParallelLinear = Linear
RowParallelLinear = Linear
VocabParallelEmbedding = Embedding


class Dropout(nn.Module):
    """``F.dropout`` as a layer, active in training mode only; its masks
    come from the "dropout" random stream (not torch's global RNG)."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class ParallelCrossEntropy(nn.Module):
    """Per-token softmax cross entropy (``mp_layers.py:129``); on one card
    the vocab dimension is whole, so it is ``cross_entropy`` with
    ``reduction="none"``."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, reduction="none",
                               ignore_index=self.ignore_index)


def parallel_matmul(x, weight, transpose_y: bool = False,
                    tensor_parallel_output: bool = True):
    """The logit projection with a (tied) embedding weight
    (``mp_layers.py:145``): ``x @ weight`` or ``x @ weight^T``."""
    del tensor_parallel_output  # one card: nothing is sharded
    return torch.matmul(x, weight.t() if transpose_y else weight)

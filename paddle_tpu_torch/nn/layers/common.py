"""Single-device ``Linear`` and ``Embedding`` with the reference's weight
layout (``paddle_tpu/distributed/parallel/mp_layers.py:51-126``).

``Linear.weight`` is ``[in, out]`` and ``Embedding.weight`` is
``[vocab, hidden]``, exactly as the JAX package stores them, so loading a
converted checkpoint is a copy, never a transpose. The tensor-parallel
names alias these: on one card there is nothing to shard.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F

__all__ = ["Linear", "Embedding", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding"]


def _normal(shape, std: float, device, generator: Optional[torch.Generator]):
    w = torch.empty(shape, device=device)
    return w.normal_(0.0, std, generator=generator)


class Linear(nn.Module):
    """``y = x @ weight + bias``; weight ``[in, out]`` drawn from
    ``Normal(0, std)``, bias zeros."""

    def __init__(self, in_features: int, out_features: int, *,
                 std: float = 0.02, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(
            _normal((in_features, out_features), std, device, generator))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

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

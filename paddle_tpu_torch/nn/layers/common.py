"""Single-device ``Linear``, ``Embedding`` and ``Dropout`` with the
reference's weight layout, parameter creation and randomness
(``paddle_tpu/nn/layers/common.py:13-66``).

``Linear.weight`` is ``[in, out]`` and ``Embedding.weight`` is
``[vocab, hidden]``, exactly as the JAX package stores them, so loading a
converted checkpoint is a copy, never a transpose. The tensor-parallel
layers (``paddle_tpu_torch.distributed.parallel.mp_layers``) are these
layers with their parameters split over a mesh's "mp" axis.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import functional as F
from ..initializer import Normal, create_parameter

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` ``[in, out]``
    (``paddle_tpu/nn/layers/common.py:13``). The parameters are made as
    the reference's ``create_parameter`` makes them
    (:func:`~paddle_tpu_torch.nn.initializer.create_parameter`):
    ``weight_attr``/``bias_attr`` (an initializer, or an object with an
    ``initializer``) first, then the global initializer, then
    ``XavierUniform`` for the weight and ``Constant(0)`` for the bias.
    ``bias_attr=False`` or ``has_bias=False`` registers no bias at all
    (``bias`` is None), as the reference's Llama projections
    (``mp_layers.py:87-91``). ``std`` is the tensor-parallel linears'
    weight attribute ``Normal(0, std)``, the draw the GPT and Llama
    blocks ask for."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None, *, std: Optional[float] = None,
                 has_bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del name
        self.in_features = in_features
        self.out_features = out_features
        if std is not None:
            weight_attr = Normal(0.0, std)
        self.weight = create_parameter(
            (in_features, out_features), attr=weight_attr, device=device,
            generator=generator)
        self.bias = None
        if has_bias and bias_attr is not False:
            self.bias = create_parameter((out_features,), attr=bias_attr,
                                         is_bias=True, device=device,
                                         generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(nn.Module):
    """Row lookup into ``weight`` ``[num_embeddings, embedding_dim]``
    (``common.py:36``): ``weight_attr`` first, then the global
    initializer, then ``Normal(0, 1)``; ``std`` is the attribute
    ``Normal(0, std)`` (the GPT and Llama vocab embeddings'). With
    ``padding_idx`` that row starts at zero and every lookup of it gives
    zeros, so it never takes a gradient."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, *,
                 std: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del sparse, name
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        if std is not None:
            weight_attr = Normal(0.0, std)
        self.weight = create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=Normal(0.0, 1.0), device=device,
            generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, ids):
        out = self.weight[ids]
        if self.padding_idx is not None:
            out = out.masked_fill((ids == self.padding_idx)[..., None], 0.0)
        return out

    def extra_repr(self) -> str:
        return (f"num_embeddings={self.num_embeddings}, "
                f"embedding_dim={self.embedding_dim}")


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

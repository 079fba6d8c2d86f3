"""``LayerNorm`` and ``RMSNorm`` (port of ``paddle_tpu/nn/layers/norm.py:136,
161``)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """Parameters ``weight`` (ones) and ``bias`` (zeros), as the
    reference names them."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5, *,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(self.normalized_shape, device=device))
        self.bias = nn.Parameter(
            torch.zeros(self.normalized_shape, device=device))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self.normalized_shape}, epsilon={self.epsilon}"


class RMSNorm(nn.Module):
    """The Llama family's norm: one parameter, ``weight`` (ones)."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, epsilon={self.epsilon}"

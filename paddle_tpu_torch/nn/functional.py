"""The subset of ``paddle_tpu/nn/functional.py`` that the GPT serving path
uses, in PyTorch.

Weights keep the JAX package's layout: a linear weight is ``[in, out]``
(paddle's convention), not torch's ``[out, in]``, so converted
checkpoints copy straight across.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

__all__ = ["linear", "gelu", "layer_norm"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` laid out ``[in, out]``."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def gelu(x, approximate: bool = False):
    """GELU; ``approximate=True`` is the tanh form (``jax.nn.gelu``'s
    default in the reference's GPT MLP, ``models/gpt.py:143``)."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """LayerNorm with the reference's numerics: statistics in float32 for
    half-precision inputs, cast back, then the affine weight and bias."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    half = x.dtype in (torch.bfloat16, torch.float16)
    xf = x.float() if half else x
    out = _F.layer_norm(xf, tuple(normalized_shape), eps=epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out

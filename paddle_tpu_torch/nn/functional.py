"""The subset of ``paddle_tpu/nn/functional.py`` that the GPT and Llama
serving and training paths use, in PyTorch.

Weights keep the JAX package's layout: a linear weight is ``[in, out]``
(paddle's convention), not torch's ``[out, in]``, so converted
checkpoints copy straight across.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from .layer import take_rng_key

__all__ = ["linear", "gelu", "silu", "layer_norm", "rms_norm", "dropout",
           "cross_entropy"]


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


def silu(x):
    """``x * sigmoid(x)`` (``jax.nn.silu``, ``functional.py:29``): the gate
    of Llama's SwiGLU MLP."""
    return _F.silu(x)


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


def rms_norm(x, weight=None, epsilon: float = 1e-6):
    """RMSNorm with the reference's numerics (``functional.py:207-216``):
    ``x * rsqrt(mean(x^2) + eps)`` in float32 for half-precision inputs,
    cast back to x's dtype, and only then times ``weight``. Under O2 that
    order decides the bf16 rounding."""
    half = x.dtype in (torch.bfloat16, torch.float16)
    xf = x.float() if half else x
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train"):
    """Dropout (``functional.py:318``): keep each element with probability
    ``1 - p``; ``upscale_in_train`` divides kept values by ``1 - p``. The
    mask comes from a ``torch.Generator`` seeded with a draw from the
    "dropout" stream (:func:`~paddle_tpu_torch.nn.layer.take_rng_key`), so
    it replays under recompute and on a resumed step. ``axis`` draws one
    mask value per index of those axes, broadcast over the others."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.ndim for a in axes]
        mask_shape = tuple(x.shape[i] if i in axes else 1
                           for i in range(x.ndim))
    else:
        mask_shape = tuple(x.shape)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(take_rng_key("dropout"))
    keep = torch.rand(mask_shape, generator=gen, device=x.device) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x))


def cross_entropy(input, label, weight=None, ignore_index: int = -100,  # noqa: A002
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0):
    """Softmax cross entropy with hard labels (``functional.py:732``),
    computed in the logits' dtype as the reference does (bf16 logits under
    O2 give bf16 losses). ``ignore_index`` labels contribute 0 and, for
    ``reduction="mean"``, are left out of the count. Soft labels, class
    weights, label smoothing and ``use_softmax=False`` are not ported and
    raise ``NotImplementedError``."""
    label = torch.as_tensor(label, device=input.device)
    if (soft_label or weight is not None or label_smoothing
            or not use_softmax or (label.ndim == input.ndim
                                   and label.shape == input.shape)):
        raise NotImplementedError(
            "cross_entropy: only hard labels with softmax, no class weights "
            "and no label smoothing are ported")
    axis = axis % input.ndim
    logp = torch.log_softmax(input, dim=axis)
    if label.ndim == input.ndim and label.shape[axis] == 1:
        label = label.squeeze(axis)
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        n_valid = torch.clamp(valid.sum().to(loss.dtype), min=1.0)
        return loss.sum() / n_valid
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                     f"{reduction!r}")

"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm`` and
``clip_grad_norm_``.

Each clip is a pure function of a ``{name: tensor}`` dict of gradients
(None entries pass through) that returns a new dict. The norms are
computed in float32 and each clipped gradient is returned in its own
dtype, with the reference's casts. Every scale stays a device tensor: no
clip reads a value back to the host.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]

Grads = Dict[str, Optional[torch.Tensor]]


class ClipGradBase:
    def __call__(self, grads: Grads) -> Grads:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads):
        return {k: None if g is None else g.clamp(self.min, self.max)
                for k, g in grads.items()}


class ClipGradByNorm(ClipGradBase):
    """Per-tensor norm clip: each gradient scaled by ``min(clip_norm /
    max(||g||, 1e-12), 1)``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        out = {}
        for k, g in grads.items():
            if g is None:
                out[k] = None
                continue
            g32 = g.float()
            norm = torch.sqrt(torch.sum(torch.square(g32)))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out[k] = (g32 * scale).to(g.dtype)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Global-norm clip across all gradients: each scaled by ``clip_norm /
    max(||grads||, clip_norm)``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        leaves = [g for g in grads.values() if g is not None]
        if not leaves:
            return grads
        # the sum of the per-tensor float32 sums of squares, in order
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in leaves])
        gnorm = torch.sqrt(sq.sum())
        scale = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        names = [k for k, g in grads.items() if g is not None]
        out = dict(grads)
        for k, t in zip(names, torch._foreach_mul(
                [grads[k].float() for k in names], scale)):
            out[k] = t.to(grads[k].dtype)
        return out


def clip_grad_norm_(grads: Grads, max_norm, norm_type=2.0):
    """Torch-style helper on a gradient dict: returns ``(clipped,
    total_norm)``, ``total_norm`` a 0-d device tensor."""
    leaves = [g for g in grads.values() if g is not None]
    if norm_type == float("inf"):
        total = torch.max(torch.stack([g.abs().max().float()
                                       for g in leaves]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(g.float().abs() ** norm_type) for g in leaves])) \
            ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    # g * scale promotes as the reference's does (a float32 0-d array
    # promotes a half g to float32; a torch 0-d tensor would not)
    clipped = {k: None if g is None else
               (g.to(torch.promote_types(g.dtype, scale.dtype)) * scale)
               .to(g.dtype) for k, g in grads.items()}
    return clipped, total

"""Parameter reparametrizations and flattening (port of
``paddle_tpu/nn/utils/__init__.py``): ``weight_norm``,
``remove_weight_norm``, ``spectral_norm``, ``parameters_to_vector`` and
``vector_to_parameters``.

The reparametrization runs in a forward pre-hook that sets ``layer.<name>``
to a tensor computed from the new parameters, so the layer's own
``forward`` reads it as it read the parameter. The arithmetic is the
reference's, not ``torch.nn.utils``': the norm is taken over every axis
but ``dim`` of the weight as the layer stores it (``[in, out]`` for a
``Linear``), with 1e-12 added to it, and the parameters are named
``<name>_g`` and ``<name>_v`` (``<name>_orig`` with ``<name>_u`` /
``<name>_v`` buffers for the spectral norm).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]

_WN_EPS = 1e-12


def _norm_except_dim(v, dim: Optional[int]):
    """The 2-norm over every axis but ``dim`` (kept, size 1 elsewhere), or
    over all of ``v`` when ``dim`` is None."""
    if dim is None:
        return torch.sqrt((v * v).sum())
    axes = tuple(i for i in range(v.ndim) if i != dim % v.ndim)
    return torch.sqrt((v * v).sum(dim=axes, keepdim=True))


def _weight(g, v, dim):
    return g * v / (_norm_except_dim(v, dim) + _WN_EPS)


def weight_norm(layer: nn.Module, name: str = "weight",
                dim: Optional[int] = 0):
    """``layer.<name>`` as ``g * v / (||v|| + 1e-12)``: the magnitude
    ``<name>_g`` (the norm over every axis but ``dim``) and the direction
    ``<name>_v`` train as separate parameters. Returns ``layer``."""
    if f"{name}_v" in layer._parameters:
        raise ValueError(f"weight_norm already applied to {name!r}")
    w = layer._parameters.pop(name).detach()
    layer.register_parameter(f"{name}_g",
                             nn.Parameter(_norm_except_dim(w, dim)))
    layer.register_parameter(f"{name}_v", nn.Parameter(w.clone()))

    def hook(lyr, inputs):
        setattr(lyr, name, _weight(getattr(lyr, f"{name}_g"),
                                   getattr(lyr, f"{name}_v"), dim))

    handle = layer.register_forward_pre_hook(hook)
    if not hasattr(layer, "_wn_state"):
        layer._wn_state = {}
    layer._wn_state[name] = {"dim": dim, "hook": handle}
    hook(layer, ())  # ``layer.<name>`` reads before the first forward
    return layer


def remove_weight_norm(layer: nn.Module, name: str = "weight"):
    """Fold ``<name>_g`` and ``<name>_v`` back into a plain ``<name>``
    parameter. Returns ``layer``."""
    state = getattr(layer, "_wn_state", {}).get(name)
    if state is None:
        raise ValueError(f"{name!r} has no weight norm to remove")
    v = layer._parameters.pop(f"{name}_v")
    g = layer._parameters.pop(f"{name}_g")
    with torch.no_grad():
        w = _weight(g, v, state["dim"])
    state["hook"].remove()
    del layer._wn_state[name]
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, nn.Parameter(w))
    return layer


def spectral_norm(layer: nn.Module, name: str = "weight",
                  n_power_iterations: int = 1, eps: float = 1e-12,
                  dim: int = 0):
    """``layer.<name>`` divided by its largest singular value, estimated
    by ``n_power_iterations`` of power iteration on the weight as a
    ``[shape[dim], -1]`` matrix each forward. The weight trains as
    ``<name>_orig``; the iteration's vectors are the buffers
    ``<name>_u`` and ``<name>_v``, drawn from a generator seeded 0 and
    carried across calls (no gradient through them). Returns ``layer``."""
    w = layer._parameters.pop(name).detach()
    layer.register_parameter(f"{name}_orig", nn.Parameter(w.clone()))
    rows = w.shape[dim]
    gen = torch.Generator(device=w.device).manual_seed(0)
    layer.register_buffer(f"{name}_u", torch.randn(
        rows, generator=gen, device=w.device, dtype=w.dtype))
    layer.register_buffer(f"{name}_v", torch.randn(
        w.numel() // rows, generator=gen, device=w.device, dtype=w.dtype))

    def l2(x):
        return x / (torch.linalg.vector_norm(x) + eps)

    def hook(lyr, inputs):
        w_orig = getattr(lyr, f"{name}_orig")
        m = w_orig.movedim(dim, 0).reshape(w_orig.shape[dim], -1)
        u = getattr(lyr, f"{name}_u")
        v = getattr(lyr, f"{name}_v")
        with torch.no_grad():
            for _ in range(n_power_iterations):
                v = l2(m.T @ u)
                u = l2(m @ v)
        setattr(lyr, f"{name}_u", u)
        setattr(lyr, f"{name}_v", v)
        setattr(lyr, name, w_orig / (u @ (m @ v)))

    layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer


def parameters_to_vector(parameters, name=None):
    """Every tensor of ``parameters`` flattened, in order, as one
    vector."""
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """``vec`` cut into tensors shaped like ``parameters``, in order.
    They are returned, not written into the parameters, as the reference
    returns them; assign them back to change the model."""
    out, off = [], 0
    for p in parameters:
        out.append(vec[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
    return out

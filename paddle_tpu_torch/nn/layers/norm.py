"""Normalization layers (port of ``paddle_tpu/nn/layers/norm.py``).

BatchNorm keeps its running statistics in float32 buffers named
``_mean`` and ``_variance``, as the reference names them, so a reference
``state_dict()`` loads by name. The reference returns the new statistics
from a functional call and its compiled step carries them; here a
training-mode forward copies them into the buffers in place, detached
and under ``torch.no_grad``. What the reference's step does with them
(kept on gradient-merge micro-steps, restored on a skipped step, thrown
away by ``EvalStep``) is ``framework/jit.py``'s. The buffers stay float32
whatever the module is cast to: the reference's ``Layer.to(dtype)`` casts
parameters only (``paddle_tpu/nn/layer.py:365-371``), torch's
``Module.to`` would cast floating buffers too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import functional as F
from ..initializer import Constant, Normal, create_parameter

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm"]


def _affine(module, num_features, weight_attr, bias_attr, device, generator):
    """``weight`` (ones) and ``bias`` (zeros) of ``num_features``, or None
    where the attribute is False."""
    module.weight = None if weight_attr is False else create_parameter(
        (num_features,), attr=weight_attr, default_initializer=Constant(1.0),
        device=device, generator=generator)
    module.bias = None if bias_attr is False else create_parameter(
        (num_features,), attr=bias_attr, is_bias=True, device=device,
        generator=generator)


class _BatchNormBase(nn.Module):
    """Batch norm over the channel axis of ``data_format`` ("NC..." puts
    it at 1, else last): batch statistics in training mode (unless
    ``use_global_stats``), which also move the running ones by paddle's
    momentum; the running ones in eval mode (:func:`F.batch_norm`)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        _affine(self, num_features, weight_attr, bias_attr, device, generator)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        out, new_mean, new_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats)
        if self.training and not self.use_global_stats:
            with torch.no_grad():
                self._mean.copy_(new_mean)
                self._variance.copy_(new_var)
        return out

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        for name in ("_mean", "_variance"):
            if self._buffers[name].dtype != torch.float32:
                self._buffers[name] = self._buffers[name].float()
        return self

    def extra_repr(self) -> str:
        return (f"num_features={self.num_features}, "
                f"momentum={self.momentum}, epsilon={self.epsilon}")


class BatchNorm(_BatchNormBase):
    """The legacy ``paddle.nn.BatchNorm``: ``act`` names a function of
    :mod:`~paddle_tpu_torch.nn.functional` applied to the output."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=None, *, device=None, generator=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats,
                         device=device, generator=generator)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, *, device=None,
                 generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device=device, generator=generator)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None,
                 generator=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device=device, generator=generator)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm. With ``axis_name=None`` it is BatchNorm
    (``norm.py:108-109``); statistics reduced over a mesh axis wait for
    ROADMAP A8 and raise ``NotImplementedError``."""

    def __init__(self, *args, axis_name=None, **kwargs):
        super().__init__(*args, **kwargs)
        if axis_name is not None:
            raise NotImplementedError(
                f"SyncBatchNorm(axis_name={axis_name!r}): batch statistics "
                f"reduced over a mesh axis are not ported yet (ROADMAP A8)")
        self._axis_name = axis_name

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm sublayer replaced by a
        SyncBatchNorm carrying its state (the reference's recursion)."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer.num_features, layer.momentum, layer.epsilon,
                      data_format=layer.data_format,
                      device=layer._mean.device)
            new.load_state_dict(layer.state_dict())
            return new.train(layer.training)
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


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


class GroupNorm(nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, generator=None):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        _affine(self, num_channels, weight_attr, bias_attr, device, generator)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)


class InstanceNorm1D(nn.Module):
    """``weight_attr=False`` drops both the weight and the bias, as the
    reference does; ``momentum`` is accepted and not read."""

    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device=None, generator=None):
        super().__init__()
        self.num_features = num_features
        self.epsilon = epsilon
        self.data_format = data_format
        if weight_attr is False:
            self.weight = self.bias = None
        else:
            _affine(self, num_features, weight_attr, bias_attr, device,
                    generator)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon, data_format=self.data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, generator=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, device=device,
                         generator=generator)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, *, device=None, generator=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, device=device,
                         generator=generator)


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(nn.Module):
    """``weight`` over its largest singular value, estimated by
    ``power_iters`` rounds of power iteration from the parameters
    ``weight_u`` ``[weight_shape[dim]]`` and ``weight_v`` (the rest),
    both drawn ``Normal(0, 1)``; ``u`` and ``v`` are not written back, as
    in the reference."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, *, device=None, generator=None):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        self.weight_u = create_parameter((h,), default_initializer=Normal(
            0.0, 1.0), device=device, generator=generator)
        self.weight_v = create_parameter((w,), default_initializer=Normal(
            0.0, 1.0), device=device, generator=generator)

    def forward(self, weight):
        w = weight.movedim(self.dim, 0)
        mat = w.reshape(w.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self.power_iters):
            v = mat.t() @ u
            v = v / (torch.linalg.vector_norm(v) + self.eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self.eps)
        sigma = u @ mat @ v
        return (mat / sigma).reshape(w.shape).movedim(0, self.dim)

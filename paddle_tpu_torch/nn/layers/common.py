"""The common layers (``paddle_tpu/nn/layers/common.py``): single-device
``Linear``, ``Embedding`` and ``Dropout`` with the reference's weight
layout, parameter creation and randomness (``:13-66``), and the
parameter-free wrappers over ``nn.functional`` (dropouts, flatten,
resizing, padding, shuffles, patches) with ``Bilinear`` (``:70-265``).

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
from ..initializer import Normal, XavierUniform, create_parameter

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Identity", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "CosineSimilarity", "PixelShuffle",
           "PixelUnshuffle", "Unfold", "Fold", "Bilinear",
           "PairwiseDistance", "ChannelShuffle"]


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


class Dropout2D(nn.Module):
    """``F.dropout2d``: whole channels, in training mode only."""

    def __init__(self, p: float = 0.5, data_format: str = "NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(nn.Module):
    def __init__(self, p: float = 0.5, data_format: str = "NCDHW",
                 name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(nn.Module):
    def __init__(self, p: float = 0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(nn.Module):
    """The axes ``start_axis`` to ``stop_axis`` as one."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ...ops.manipulation import flatten

        return flatten(x, self.start_axis, self.stop_axis)


class Identity(nn.Module):
    """Its input; takes and ignores any arguments."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(nn.Module):
    """``F.interpolate`` with fixed arguments (its modes are the
    reference's, not torch's)."""

    def __init__(self, size=None, scale_factor=None, mode: str = "nearest",
                 align_corners: bool = False, align_mode: int = 0,
                 data_format: str = "NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with ``align_corners=True``."""

    def __init__(self, size=None, scale_factor=None,
                 data_format: str = "NCHW", name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None,
                 data_format: str = "NCHW", name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class Pad1D(nn.Module):
    """``F.pad`` with fixed arguments; ``Pad2D`` and ``Pad3D`` differ only
    in the default ``data_format``."""

    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format: str = "NCL", name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format: str = "NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format: str = "NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(nn.Module):
    def __init__(self, padding, data_format: str = "NCHW", name=None):
        super().__init__()
        self.padding, self.data_format = padding, data_format

    def forward(self, x):
        return F.zeropad2d(x, self.padding, self.data_format)


class CosineSimilarity(nn.Module):
    def __init__(self, axis: int = 1, eps: float = 1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PixelShuffle(nn.Module):
    def __init__(self, upscale_factor: int, data_format: str = "NCHW",
                 name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(nn.Module):
    def __init__(self, downscale_factor: int, data_format: str = "NCHW",
                 name=None):
        super().__init__()
        self.factor, self.data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor, self.data_format)


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes, self.kernel_sizes = output_sizes, kernel_sizes
        self.strides, self.paddings = strides, paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)


class Bilinear(nn.Module):
    """``x1 @ weight[o] @ x2 + bias[o]`` with ``weight`` ``[out, in1,
    in2]`` (``common.py:199``), drawn ``XavierUniform`` unless
    ``weight_attr`` says otherwise; ``bias_attr=False`` leaves no bias."""

    def __init__(self, in1_features: int, in2_features: int,
                 out_features: int, weight_attr=None, bias_attr=None,
                 name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr,
            default_initializer=XavierUniform(), device=device,
            generator=generator)
        self.bias = None
        if bias_attr is not False:
            self.bias = create_parameter((out_features,), attr=bias_attr,
                                         is_bias=True, device=device,
                                         generator=generator)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PairwiseDistance(nn.Module):
    def __init__(self, p: float = 2.0, epsilon: float = 1e-6,
                 keepdim: bool = False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class ChannelShuffle(nn.Module):
    def __init__(self, groups: int, data_format: str = "NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)

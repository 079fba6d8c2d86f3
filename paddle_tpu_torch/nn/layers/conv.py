"""Conv layers (port of ``paddle_tpu/nn/layers/conv.py``).

The weight is ``[out_c, in_c / groups, *kernel]`` (``[in_c, out_c /
groups, *kernel]`` for a transposed conv), paddle's layout, so a reference
state dict loads by name. Default draws are the reference's:
``KaimingUniform(fan_in)`` for the weight and ``Uniform(±1/sqrt(fan_in))``
for the bias, with ``fan_in = in_c / groups * prod(kernel)``, through
:func:`~paddle_tpu_torch.nn.initializer.create_parameter`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import functional as F
from ..initializer import KaimingUniform, Uniform, create_parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride, padding,
                 dilation, groups, padding_mode, weight_attr, bias_attr,
                 data_format, n_spatial, transpose=False, output_padding=0, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = F._pair(kernel_size, n_spatial)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode   # accepted; zeros, as the reference
        self.data_format = data_format
        self.output_padding = output_padding
        self._n_spatial = n_spatial
        self._transpose = transpose
        if transpose:
            shape = (in_channels, out_channels // groups) + self.kernel_size
        else:
            shape = (out_channels, in_channels // groups) + self.kernel_size
        fan_in = (in_channels // groups) * math.prod(self.kernel_size)
        self.weight = create_parameter(
            shape, attr=weight_attr,
            default_initializer=(KaimingUniform(fan_in=fan_in)
                                 if weight_attr is None else None),
            device=device, generator=generator)
        self.bias = None
        if bias_attr is not False:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = create_parameter(
                (out_channels,), attr=bias_attr, is_bias=True,
                default_initializer=(Uniform(-bound, bound)
                                     if bias_attr is None else None),
                device=device, generator=generator)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 1, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 2, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, 3, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv1DTranspose(_ConvNd):
    """``forward(x, output_size=None)``: ``output_size`` is accepted and
    not read, as in the reference (``output_padding`` sets the size)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 1, transpose=True,
                         output_padding=output_padding, device=device,
                         generator=generator)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups, self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 2, transpose=True,
                         output_padding=output_padding, device=device,
                         generator=generator)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups, self.data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, 3, transpose=True,
                         output_padding=output_padding, device=device,
                         generator=generator)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups, self.data_format)

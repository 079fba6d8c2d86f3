"""Activation layers (port of ``paddle_tpu/nn/layers/activation.py``):
each forwards to its function in :mod:`~paddle_tpu_torch.nn.functional`.
``SELU`` accepts ``scale`` and ``alpha`` and, as in the reference, runs
``jax.nn.selu``'s fixed ones; ``RReLU`` draws its slopes from the "rrelu"
random stream in training mode.
"""
from __future__ import annotations

from torch import nn

from .. import functional as F
from ..initializer import Constant, create_parameter

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "LeakyReLU",
           "PReLU", "Softmax", "LogSoftmax", "Softplus", "Silu",
           "Swish", "Mish", "Hardswish", "Hardsigmoid", "Hardtanh",
           "Hardshrink", "Softshrink", "Tanhshrink",
           "ThresholdedReLU", "ELU", "SELU", "CELU", "Softsign",
           "Maxout", "RReLU", "LogSigmoid", "Softmax2D"]


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)


class GELU(nn.Module):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)


class Sigmoid(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.sigmoid(x)


class Tanh(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class PReLU(nn.Module):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 generator=None):
        super().__init__()
        self.data_format = data_format
        self.weight = create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=Constant(init), device=device,
            generator=generator)

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class Softmax(nn.Module):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class LogSoftmax(nn.Module):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)


class Softplus(nn.Module):
    def __init__(self, beta=1, threshold=20, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class Silu(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.silu(x)


class Swish(Silu):
    pass


class Mish(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.mish(x)


class Hardswish(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardswish(x)


class Hardsigmoid(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardtanh(nn.Module):
    def __init__(self, min=-1.0, max=1.0, name=None):  # noqa: A002
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Hardshrink(nn.Module):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(nn.Module):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class Tanhshrink(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanhshrink(x)


class ThresholdedReLU(nn.Module):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold)


class ELU(nn.Module):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SELU(nn.Module):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
        super().__init__()

    def forward(self, x):
        return F.selu(x)


class CELU(nn.Module):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class Softsign(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.softsign(x)


class Maxout(nn.Module):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class RReLU(nn.Module):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class LogSigmoid(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.log_sigmoid(x)


class Softmax2D(nn.Module):
    """Softmax over the channel dim of [N, C, H, W] (reference
    ``paddle.nn.Softmax2D``)."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.softmax(x, axis=-3)

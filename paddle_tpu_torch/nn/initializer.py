"""Parameter initializers (port of ``paddle_tpu/nn/initializer.py``).

Each initializer is a callable ``(shape, dtype=torch.float32, device=None,
generator=None) -> torch.Tensor``. The random ones draw from the explicit
``torch.Generator`` they are given (it must live on ``device``); without
one they draw from a new generator seeded from the port's global seed
(:func:`paddle_tpu_torch.framework.random.next_seed`), as the reference
takes a fresh key from its global generator per parameter. Random values
are drawn in float32 and cast to ``dtype``.

Fans follow paddle's layouts (:func:`_fans`): a linear weight is ``[in,
out]``, a conv kernel ``[out_c, in_c, *spatial]``. ``Bilinear`` is the
reference's, not Paddle's (ADVICE.md): every ``[kh, kw]`` position gets the
same separable pattern, whatever its channels.

The resolution order of a parameter's initializer
(:func:`_resolve_initializer`, the reference's contract): an initializer
carried by the parameter's attribute wins; then the global default set by
:func:`set_global_initializer`; then the layer's built-in default.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..framework import random as framework_random

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Orthogonal", "Dirac", "Bilinear",
           "set_global_initializer", "calculate_gain", "constant", "normal",
           "uniform", "xavier_normal", "xavier_uniform", "kaiming_normal",
           "kaiming_uniform"]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # paddle linear weights are [in, out]
        return shape[0], shape[1]
    # conv kernels [out_c, in_c, *spatial] (paddle layout)
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _generator(device, generator: Optional[torch.Generator]):
    if generator is not None:
        return generator
    g = torch.Generator(device=torch.device("cpu" if device is None
                                            else device))
    g.manual_seed(framework_random.next_seed())
    return g


class Initializer:
    """``init(shape, dtype, device, generator)`` returns a new tensor."""

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        w = torch.empty(tuple(shape), device=device)
        w.normal_(self.mean, self.std, generator=_generator(device, generator))
        return w.to(dtype)


class TruncatedNormal(Initializer):
    """``Normal(mean, std)`` truncated at two standard deviations (the
    reference's ``truncated_gaussian_random`` kernel): the inverse CDF of a
    uniform draw on ``[Phi(-2), Phi(2)]``, as ``jax.random.truncated_normal``
    draws it."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0)))
                  for b in (-2.0, 2.0))
        u = torch.empty(tuple(shape), device=device)
        u.uniform_(lo, hi, generator=_generator(device, generator))
        z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp_(-2.0, 2.0)
        return (z * self.std + self.mean).to(dtype)


def _uniform(shape, low, high, dtype, device, generator):
    w = torch.empty(tuple(shape), device=device)
    w.uniform_(low, high, generator=_generator(device, generator))
    return w.to(dtype)


def _standard_normal(shape, device, generator):
    w = torch.empty(tuple(shape), device=device)
    return w.normal_(0.0, 1.0, generator=_generator(device, generator))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return _uniform(shape, self.low, self.high, dtype, device, generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fin, fout = _fans(shape)
        fin = self.fan_in or fin
        fout = self.fan_out or fout
        std = self.gain * math.sqrt(2.0 / (fin + fout))
        return (_standard_normal(shape, device, generator) * std).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fin, fout = _fans(shape)
        fin = self.fan_in or fin
        fout = self.fan_out or fout
        limit = self.gain * math.sqrt(6.0 / (fin + fout))
        return _uniform(shape, -limit, limit, dtype, device, generator)


def _kaiming_gain(nonlinearity, negative_slope):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fin = self.fan_in or _fans(shape)[0]
        std = _kaiming_gain(self.nonlinearity, self.negative_slope) \
            / math.sqrt(fin)
        return (_standard_normal(shape, device, generator) * std).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fin = self.fan_in or _fans(shape)[0]
        limit = _kaiming_gain(self.nonlinearity, self.negative_slope) \
            * math.sqrt(3.0 / fin)
        return _uniform(shape, -limit, limit, dtype, device, generator)


class Assign(Initializer):
    """The given value (array, tensor or nested list), reshaped to
    ``shape`` when its own shape differs."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        value = self.value
        if isinstance(value, torch.Tensor):
            out = value.detach().to(device=device, dtype=dtype).clone()
        else:
            out = torch.as_tensor(np.asarray(value), device=device).to(dtype)
        if tuple(out.shape) != tuple(shape):
            out = out.reshape(tuple(shape))
        return out


class Orthogonal(Initializer):
    """``jax.nn.initializers.orthogonal(scale=gain)``: the last axis is the
    columns, the rest the rows; a standard normal ``[max, min]`` matrix's Q
    (with the signs of R's diagonal), transposed when rows < columns."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        shape = tuple(shape)
        if len(shape) < 2:
            raise ValueError("orthogonal initializer requires at least a "
                             "two-dimensional shape")
        n_rows, n_cols = math.prod(shape[:-1]), shape[-1]
        a = _standard_normal((max(n_rows, n_cols), min(n_rows, n_cols)),
                             device, generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if n_rows < n_cols:
            q = q.t()
        return (self.gain * q.reshape(shape)).to(dtype)


class Dirac(Initializer):
    """Identity-preserving conv kernel ``[out_c, in_c, *spatial]``: a 1 at
    the spatial centre of channel pair ``(g * out_c / groups + i, i)``."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        out = np.zeros(tuple(shape), dtype=np.float32)
        out_c, in_c = shape[0], shape[1]
        spatial_center = tuple(s // 2 for s in shape[2:])
        per_group = out_c // self.groups
        for g in range(self.groups):
            for i in range(min(per_group, in_c)):
                out[(g * per_group + i, i) + spatial_center] = 1.0
        return torch.from_numpy(out).to(device=device, dtype=dtype)


class Bilinear(Initializer):
    """Bilinear-upsampling kernel for transposed convs: every ``[kh, kw]``
    position of the 4-D weight gets ``(1-|x/f-c|)(1-|y/f-c|)`` with
    ``f = ceil(k/2)``, ``c = (2f-1-f%2)/(2f)``."""

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        shape = tuple(shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        if shape[2] != shape[3]:
            raise ValueError("Bilinear initializer needs square kernels")
        k = shape[3]
        f = math.ceil(k / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        filt = 1 - np.abs(np.arange(k) / f - c)
        patt = torch.from_numpy(np.outer(filt, filt).astype(np.float32))
        return patt.expand(shape).to(device=device, dtype=dtype).clone()


# global defaults installed by set_global_initializer: [weight, bias]
_GLOBAL_INIT = [None, None]


def set_global_initializer(weight_init, bias_init=None):
    """Set the framework-wide default initializers: they apply to
    parameters created without an initializer of their own (which keeps
    priority), in place of each layer's built-in default. ``None``
    cancels."""
    if weight_init is not None and not isinstance(weight_init, Initializer):
        raise TypeError("weight_init must be an Initializer or None")
    if bias_init is not None and not isinstance(bias_init, Initializer):
        raise TypeError("bias_init must be an Initializer or None")
    _GLOBAL_INIT[0] = weight_init
    _GLOBAL_INIT[1] = bias_init


def _resolve_initializer(attr, default_initializer, is_bias: bool = False):
    """An initializer carried by ``attr`` (a bare Initializer, or an
    object with an ``initializer`` attribute, as ``ParamAttr``); then the
    global default; then ``default_initializer``."""
    if attr is not None and attr is not False:
        if isinstance(attr, Initializer):
            return attr
        init = getattr(attr, "initializer", None)
        if isinstance(init, Initializer):
            return init
    ginit = _GLOBAL_INIT[1] if is_bias else _GLOBAL_INIT[0]
    if ginit is not None:
        return ginit
    return default_initializer


def create_parameter(shape, attr=None, is_bias: bool = False,
                     default_initializer=None, dtype=torch.float32,
                     device=None, generator=None) -> torch.nn.Parameter:
    """A parameter drawn as the reference's ``Layer.create_parameter``
    draws it: the initializer of :func:`_resolve_initializer`, and when
    none applies ``Constant(0)`` for a bias, ``XavierUniform`` else."""
    init = _resolve_initializer(attr, default_initializer, is_bias=is_bias)
    if init is None:
        init = Constant(0.0) if is_bias else XavierUniform()
    return torch.nn.Parameter(init(tuple(shape), dtype=dtype, device=device,
                                   generator=generator))


# paddle also exposes functional-style aliases
constant = Constant
normal = Normal
uniform = Uniform
xavier_normal = XavierNormal
xavier_uniform = XavierUniform
kaiming_normal = KaimingNormal
kaiming_uniform = KaimingUniform


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0

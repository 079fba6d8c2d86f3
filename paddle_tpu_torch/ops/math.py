"""Elementwise and reduction math ops (port of ``paddle_tpu/ops/math.py``).

Paddle's names and arguments (``axis``, ``keepdim``, None for a full
reduction) over torch ops. The ``*_`` variants return their result and
leave the input as it is, as the reference's do.
"""
from __future__ import annotations

import torch

from ..framework.dtype import convert_dtype
from ._common import axis as _axis
from ._common import float_of, pair, t

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "scale", "maximum", "minimum", "fmax", "fmin", "abs",
    "neg", "sign", "reciprocal", "square", "sqrt", "rsqrt", "exp", "expm1",
    "log", "log2", "log10", "log1p", "floor", "ceil", "round", "trunc",
    "frac", "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh",
    "cosh", "tanh", "asinh", "acosh", "atanh", "deg2rad", "rad2deg", "erf",
    "erfinv", "lgamma", "digamma", "sigmoid", "logit", "logsumexp",
    "logaddexp", "sum", "mean", "prod", "max", "min", "amax", "amin", "all",
    "any", "count_nonzero", "cumsum", "cumprod", "cummax", "cummin", "clip",
    "nansum", "nanmean", "isfinite", "isinf", "isnan", "stanh", "inner",
    "outer", "kron", "gcd", "lcm", "diff", "heaviside", "rot90", "trace",
    "addmm", "lerp", "add_n", "angle", "sgn", "frexp", "ldexp", "copysign",
    "hypot", "signbit", "sinc", "i0", "i0e", "i1", "i1e", "xlogy",
    "nan_to_num", "increment", "multiplex", "logcumsumexp", "renorm",
    "trapezoid", "cumulative_trapezoid", "floor_mod", "rank", "shape",
    "broadcast_shape", "polar", "add_", "subtract_", "multiply_", "scale_",
    "remainder_", "floor_mod_", "lerp_", "increment_", "nan_to_num_",
    "ceil_", "exp_", "floor_", "round_", "rsqrt_", "sqrt_", "tanh_",
    "reciprocal_", "clip_", "erfinv_", "abs_", "sigmoid_", "gammaln",
    "gammainc", "gammaincc", "multigammaln", "polygamma", "nextafter",
    "isposinf", "isneginf", "isreal",
]


def _binary(fn):
    def op(x, y, name=None):
        return fn(*pair(x, y))

    return op


def _unary(fn, to_float=False):
    def op(x, name=None):
        x = t(x)
        return fn(float_of(x) if to_float else x)

    return op


# ---------------------------------------------------------------- arithmetic
add = _binary(torch.add)
subtract = _binary(torch.sub)
multiply = _binary(torch.mul)
divide = _binary(torch.true_divide)
floor_divide = _binary(torch.floor_divide)
mod = _binary(torch.remainder)
remainder = mod
pow = _binary(torch.pow)  # noqa: A001 - paddle name
maximum = _binary(torch.maximum)
minimum = _binary(torch.minimum)
fmax = _binary(torch.fmax)
fmin = _binary(torch.fmin)
atan2 = _binary(torch.atan2)
logaddexp = _binary(torch.logaddexp)
gcd = _binary(torch.gcd)
lcm = _binary(torch.lcm)
kron = _binary(torch.kron)
inner = _binary(torch.inner)
heaviside = _binary(torch.heaviside)
copysign = _binary(torch.copysign)
hypot = _binary(torch.hypot)
xlogy = _binary(torch.special.xlogy)
nextafter = _binary(torch.nextafter)
floor_mod = mod


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    x = t(x)
    s = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(bias, dtype=x.dtype, device=x.device)
    out = x * s + b if bias_after_scale else (x + b) * s
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


abs = _unary(torch.abs)  # noqa: A001
neg = _unary(torch.neg)
sign = _unary(torch.sign)
reciprocal = _unary(torch.reciprocal)
square = _unary(torch.square)
sqrt = _unary(torch.sqrt, True)
rsqrt = _unary(torch.rsqrt, True)
exp = _unary(torch.exp, True)
expm1 = _unary(torch.expm1, True)
log = _unary(torch.log, True)
log2 = _unary(torch.log2, True)
log10 = _unary(torch.log10, True)
log1p = _unary(torch.log1p, True)
floor = _unary(torch.floor)
ceil = _unary(torch.ceil)
round = _unary(torch.round)  # noqa: A001 - half to even, as jnp.round
trunc = _unary(torch.trunc)
frac = _unary(lambda x: x - torch.trunc(x))

# ---------------------------------------------------------------- trig
sin = _unary(torch.sin, True)
cos = _unary(torch.cos, True)
tan = _unary(torch.tan, True)
asin = _unary(torch.asin, True)
acos = _unary(torch.acos, True)
atan = _unary(torch.atan, True)
sinh = _unary(torch.sinh, True)
cosh = _unary(torch.cosh, True)
tanh = _unary(torch.tanh, True)
asinh = _unary(torch.asinh, True)
acosh = _unary(torch.acosh, True)
atanh = _unary(torch.atanh, True)
deg2rad = _unary(torch.deg2rad, True)
rad2deg = _unary(torch.rad2deg, True)

# ---------------------------------------------------------------- special
erf = _unary(torch.special.erf, True)
erfinv = _unary(torch.special.erfinv, True)
lgamma = _unary(torch.special.gammaln, True)
digamma = _unary(torch.special.digamma, True)
sigmoid = _unary(torch.sigmoid, True)


def logit(x, eps=None, name=None):
    x = float_of(t(x))
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = float_of(t(x))
    dims = tuple(range(x.ndim)) if axis is None else _axis(axis)
    return torch.logsumexp(x, dim=dims, keepdim=keepdim)


# ---------------------------------------------------------------- reductions
def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    x = t(x)
    dims = None if axis is None else _axis(axis)
    return torch.sum(x, dim=dims, keepdim=keepdim,
                     dtype=convert_dtype(dtype))


def mean(x, axis=None, keepdim=False, name=None):
    x = float_of(t(x))
    return torch.mean(x, dim=None if axis is None else _axis(axis),
                      keepdim=keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = t(x, dtype=dtype)
    if axis is None:
        out = torch.prod(x)
        return out.reshape([1] * x.ndim) if keepdim else out
    dims = _axis(axis)
    dims = sorted((d % x.ndim for d in (dims if isinstance(dims, tuple)
                                        else (dims,))), reverse=True)
    for d in dims:
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _extreme(fn):
    """A reduction over ``axis`` (None: every dim) that torch spells
    with ``dim`` and no ``dim=None``."""
    def op(x, axis=None, keepdim=False, name=None):
        x = t(x)
        if axis is None:
            out = fn(x)
            return out.reshape([1] * x.ndim) if keepdim else out
        return fn(x, dim=_axis(axis), keepdim=keepdim)

    return op


max = _extreme(torch.amax)  # noqa: A001
min = _extreme(torch.amin)  # noqa: A001
amax = max
amin = min


all = _extreme(torch.all)  # noqa: A001
any = _extreme(torch.any)  # noqa: A001


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = t(x)
    dims = None if axis is None else _axis(axis)
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        keep = range(x.ndim) if dims is None else \
            (dims if isinstance(dims, tuple) else (dims,))
        shape = list(x.shape)
        for d in keep:
            shape[d % x.ndim] = 1
        out = out.reshape(shape)
    return out


def cumsum(x, axis=None, dtype=None, name=None):
    x = t(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=axis, dtype=convert_dtype(dtype))


def cumprod(x, dim=None, dtype=None, name=None):
    x = t(x)
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim=dim, dtype=convert_dtype(dtype))


def _cum_extreme(fn):
    def op(x, axis=None, dtype="int64", name=None):
        x = t(x)
        if axis is None:
            x, axis = x.reshape(-1), 0
        values, ind = fn(x, dim=axis)
        return values, ind.to(convert_dtype(dtype))

    return op


cummax = _cum_extreme(torch.cummax)
cummin = _cum_extreme(torch.cummin)


def clip(x, min=None, max=None, name=None):  # noqa: A002
    x = t(x)
    return torch.clamp(x, min=min, max=max)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = t(x)
    return torch.nansum(x, dim=None if axis is None else _axis(axis),
                        keepdim=keepdim, dtype=convert_dtype(dtype))


def nanmean(x, axis=None, keepdim=False, name=None):
    x = float_of(t(x))
    return torch.nanmean(x, dim=None if axis is None else _axis(axis),
                         keepdim=keepdim)


# ---------------------------------------------------------------- tests / misc
isfinite = _unary(torch.isfinite)
isinf = _unary(torch.isinf)
isnan = _unary(torch.isnan)
isposinf = _unary(torch.isposinf)
isneginf = _unary(torch.isneginf)
isreal = _unary(torch.isreal)
signbit = _unary(torch.signbit)
angle = _unary(torch.angle)
sgn = _unary(lambda x: torch.sgn(x) if x.is_complex() else torch.sign(x))
sinc = _unary(torch.sinc, True)
i0 = _unary(torch.special.i0, True)
i0e = _unary(torch.special.i0e, True)
i1 = _unary(torch.special.i1, True)
i1e = _unary(torch.special.i1e, True)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * float_of(t(x)))


def outer(x, y, name=None):
    x, y = pair(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = t(x)
    if prepend is not None:
        prepend = t(prepend, like=x)
    if append is not None:
        append = t(append, like=x)
    return torch.diff(x, n=n, dim=axis, prepend=prepend, append=append)


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(t(x), k, list(axes))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(t(x), offset, axis1, axis2).sum(-1)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return beta * t(input) + alpha * torch.matmul(t(x), t(y))


def lerp(x, y, weight, name=None):
    x, y = pair(x, y)
    w = weight if isinstance(weight, torch.Tensor) else \
        torch.as_tensor(weight, dtype=x.dtype, device=x.device)
    return x + w * (y - x)


def add_n(inputs, name=None):
    """The sum of a list of same-shape tensors."""
    if not isinstance(inputs, (list, tuple)):
        return t(inputs)
    out = t(inputs[0])
    for x in inputs[1:]:
        out = out + t(x, like=out)
    return out


def frexp(x, name=None):
    return tuple(torch.frexp(float_of(t(x))))


def ldexp(x, y, name=None):
    x, y = pair(x, y)
    return float_of(x) * torch.pow(2.0, y.to(float_of(x).dtype))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(t(x), nan=nan, posinf=posinf, neginf=neginf)


def increment(x, value=1.0, name=None):
    x = t(x)
    return x + torch.as_tensor(value, dtype=x.dtype, device=x.device)


def multiplex(inputs, index, name=None):
    """``out[i] = inputs[index[i]][i]``."""
    stacked = torch.stack([t(x) for x in inputs])
    idx = t(index, like=stacked).reshape(-1).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


def logcumsumexp(x, axis=None, dtype=None, name=None):
    x = float_of(t(x, dtype=dtype))
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, dim=axis)


def renorm(x, p, axis, max_norm, name=None):
    """Clamp the p-norm of every slice along ``axis`` to ``max_norm``."""
    x = t(x)
    dims = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = torch.sum(torch.abs(x) ** p, dim=dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = float_of(t(y))
    if x is not None:
        return torch.trapezoid(y, t(x, like=y), dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = float_of(t(y))
    n = y.shape[axis]
    lo = y.narrow(axis, 0, n - 1)
    hi = y.narrow(axis, 1, n - 1)
    if x is not None:
        x = t(x, like=y)
        if x.ndim == 1:
            shape = [1] * y.ndim
            shape[axis] = x.shape[0]
            x = x.reshape(shape)
        d = x.narrow(axis, 1, n - 1) - x.narrow(axis, 0, n - 1)
    else:
        d = 1.0 if dx is None else dx
    return torch.cumsum((lo + hi) * d / 2.0, dim=axis)


def rank(x, name=None):
    """The input's number of dims as a 0-d int32 tensor."""
    x = t(x)
    return torch.tensor(x.ndim, dtype=torch.int32, device=x.device)


def shape(x, name=None):
    """The shape as an int32 tensor."""
    x = t(x)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def polar(abs, angle, name=None):  # noqa: A002 - paddle names
    r, a = pair(abs, angle)
    return torch.polar(float_of(r), float_of(a))


def _out_of_place(fn):
    def op_(x, *args, **kwargs):
        return fn(x, *args, **kwargs)

    op_.__name__ = fn.__name__ + "_"
    op_.__doc__ = (f"``{fn.__name__}`` under the name of paddle's in-place "
                   f"variant: returns the result, the input unchanged.")
    return op_


add_ = _out_of_place(add)
subtract_ = _out_of_place(subtract)
multiply_ = _out_of_place(multiply)
scale_ = _out_of_place(scale)
remainder_ = _out_of_place(mod)
floor_mod_ = _out_of_place(mod)
lerp_ = _out_of_place(lerp)
increment_ = _out_of_place(increment)
nan_to_num_ = _out_of_place(nan_to_num)
ceil_ = _out_of_place(ceil)
exp_ = _out_of_place(exp)
floor_ = _out_of_place(floor)
round_ = _out_of_place(round)
rsqrt_ = _out_of_place(rsqrt)
sqrt_ = _out_of_place(sqrt)
tanh_ = _out_of_place(tanh)
reciprocal_ = _out_of_place(reciprocal)
clip_ = _out_of_place(clip)
erfinv_ = _out_of_place(erfinv)
abs_ = _out_of_place(abs)
sigmoid_ = _out_of_place(sigmoid)


def gammaln(x, name=None):
    return torch.special.gammaln(t(x, dtype=torch.float32))


def gammainc(x, y, name=None):
    """Regularized lower incomplete gamma ``P(x, y)``: ``x`` is the shape
    parameter."""
    return torch.special.gammainc(t(x, dtype=torch.float32),
                                  t(y, dtype=torch.float32))


def gammaincc(x, y, name=None):
    return torch.special.gammaincc(t(x, dtype=torch.float32),
                                   t(y, dtype=torch.float32))


def multigammaln(x, p, name=None):
    return torch.special.multigammaln(t(x, dtype=torch.float32), int(p))


def polygamma(x, n, name=None):
    return torch.special.polygamma(int(n), t(x, dtype=torch.float32))


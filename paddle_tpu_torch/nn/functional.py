"""``paddle_tpu/nn/functional.py`` in PyTorch: the functions that the
GPT and Llama paths, the encoder path (``nn.Transformer``, BERT, ERNIE)
and the convolutional path (the conv, pooling, norm, activation and loss
layers, ResNet) call.

Weights keep the JAX package's layout: a linear weight is ``[in, out]``
(paddle's convention), not torch's ``[out, in]``, and a conv kernel
``[out_c, in_c / groups, *k]`` (``[in_c, out_c / groups, *k]`` for a
transposed conv), so converted checkpoints copy straight across.

The reference lowers convolutions, pools and batch norm through XLA
(``lax.conv_general_dilated``, ``lax.reduce_window``, plain ``jnp``);
here they are ordinary torch ops (cuDNN on the card) with the
reference's semantics kept where torch's differ: explicit (possibly
asymmetric) padding for ``'SAME'`` with a stride and for ``ceil_mode``,
paddle's batch-norm momentum, and JAX's dtype promotion, cast by hand
where torch would raise on mixed operands (a conv casts its weight to the
input's dtype, ``functional.py:403``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as _F

from ..amp.auto_cast import autocast_call
from ..ops.math import _out_of_place
from .layer import take_rng_key

__all__ = [
    # activations
    "relu", "relu6", "sigmoid", "silu", "swish", "elu", "selu", "celu",
    "glu", "tanh", "gelu", "leaky_relu", "prelu", "rrelu", "hardtanh",
    "hardshrink", "softshrink", "tanhshrink", "thresholded_relu",
    "hardsigmoid", "hardswish", "mish", "softplus", "softsign", "maxout",
    "softmax", "log_softmax", "log_sigmoid",
    # linear, norms, dropout
    "linear", "layer_norm", "rms_norm", "batch_norm", "group_norm",
    "instance_norm", "local_response_norm", "dropout",
    # conv and pooling
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "max_pool1d", "max_pool2d", "max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
    "adaptive_avg_pool2d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "adaptive_max_pool3d", "max_unpool1d",
    "max_unpool2d", "max_unpool3d",
    # losses
    "cross_entropy", "mse_loss", "l1_loss", "smooth_l1_loss", "nll_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "kl_div",
    "margin_ranking_loss", "ctc_loss", "hinge_embedding_loss",
    "cosine_similarity",
    "cosine_embedding_loss", "triplet_margin_loss", "soft_margin_loss",
    "multi_label_soft_margin_loss", "multi_margin_loss",
    "triplet_margin_with_distance_loss",
    # attention
    "scaled_dot_product_attention"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` laid out ``[in, out]``. Under
    an O1 ``amp.auto_cast`` block the product runs in the autocast dtype
    (the white-list contract, ``functional.py:152-154``)."""
    x, weight, bias = autocast_call("linear", x, weight, bias)
    if x.dtype != weight.dtype:
        # jnp.matmul promotes mixed operands (a float32 activation meets
        # bf16 O2 weights in BERT after its attention); torch.matmul
        # would raise
        dtype = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dtype), weight.to(dtype)
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def relu(x):
    """``max(x, 0)`` (``jax.nn.relu``): ``nn.Transformer``'s default
    activation, looked up by name (``transformer.py:99``)."""
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def gelu(x, approximate: bool = False):
    """GELU; ``approximate=True`` is the tanh form (``jax.nn.gelu``'s
    default in the reference's GPT MLP, ``models/gpt.py:143``)."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    """``x * sigmoid(x)`` (``jax.nn.silu``, ``functional.py:29``): the gate
    of Llama's SwiGLU MLP."""
    return _F.silu(x)


swish = silu


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def sigmoid(x):
    return torch.sigmoid(x)


def elu(x, alpha: float = 1.0):
    return _F.elu(x, alpha)


def selu(x):
    """``jax.nn.selu`` at its fixed scale and alpha (the ``SELU`` layer
    accepts others and, as in the reference, does not read them)."""
    return _F.selu(x)


def celu(x, alpha: float = 1.0):
    return _F.celu(x, alpha)


def glu(x, axis: int = -1):
    return _F.glu(x, dim=axis)


def leaky_relu(x, negative_slope: float = 0.01, name=None):
    return _F.leaky_relu(x, negative_slope)


def prelu(x, weight, data_format: str = "NCHW", name=None):
    """``x`` where ``x >= 0``, else ``weight * x``; a weight of more than
    one element is per channel (axis 1, or the last for channels-last)."""
    if weight.numel() > 1:
        shape = [1] * x.ndim
        shape[1 if data_format.startswith("NC") else x.ndim - 1] = \
            weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x >= 0, x, weight * x)


def _seeded(x, stream: str) -> torch.Generator:
    """A generator on ``x``'s device seeded from the named stream (see
    :func:`~paddle_tpu_torch.nn.layer.take_rng_key`)."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(take_rng_key(stream))
    return gen


def rrelu(x, lower: float = 1.0 / 8.0, upper: float = 1.0 / 3.0,
          training: bool = True, name=None):
    """Randomised leaky ReLU: in training each negative element's slope is
    uniform on ``[lower, upper]``, drawn from a generator seeded from the
    "rrelu" stream (jax's draws and torch's differ; the distribution is
    the reference's); in eval the slope is their mean."""
    if training:
        a = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
            lower, upper, generator=_seeded(x, "rrelu"))
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, a * x)


def hardtanh(x, min: float = -1.0, max: float = 1.0, name=None):  # noqa: A002
    return torch.clamp(x, min, max)


def hardshrink(x, threshold: float = 0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold: float = 0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def thresholded_relu(x, threshold: float = 1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def hardsigmoid(x, slope: float = 0.1666667, offset: float = 0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _softplus(x):
    """``jax.nn.softplus``: ``log(1 + exp(x))`` without a threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


def softplus(x, beta: float = 1.0, threshold: float = 20.0, name=None):
    return torch.where(x * beta > threshold, x, _softplus(x * beta) / beta)


def softsign(x, name=None):
    return x / (1.0 + x.abs())


def maxout(x, groups: int, axis: int = 1, name=None):
    axis = axis % x.ndim
    c = x.shape[axis]
    shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return x.reshape(shape).amax(dim=axis + 1)


def softmax(x, axis: int = -1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis: int = -1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def log_sigmoid(x, name=None):
    return _F.logsigmoid(x)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float16": torch.float16,
            "bfloat16": torch.bfloat16, "float64": torch.float64}[str(dtype)]


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


def _channel_shape(x, data_format: str):
    """The channel axis of ``x`` under ``data_format`` ("NC..." puts it at
    1, anything else last) and the broadcast shape of a per-channel
    vector."""
    ch_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    shape = [1] * x.ndim
    shape[ch_axis] = x.shape[ch_axis]
    return ch_axis, shape


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-05, data_format: str = "NCHW",
               use_global_stats=None, name=None):
    """Batch norm with the reference's numerics (``functional.py:219-254``);
    returns ``(out, new_running_mean, new_running_var)`` and mutates
    nothing (``nn.BatchNorm*`` copies the new statistics into its
    buffers).

    In training (and without ``use_global_stats``) the batch mean and the
    biased variance normalise, taken in float32 for bfloat16 and float16
    inputs; the running statistics move by paddle's convention,
    ``momentum * running + (1 - momentum) * batch`` (torch's momentum is
    the other share), with the unbiased variance ``var * n / (n - 1)``,
    and keep the running buffers' dtype. They take no gradient. ``out`` is
    ``(x - mean) * rsqrt(var + eps)`` in x's dtype, then ``* weight``,
    then ``+ bias``, which promote as JAX does (a float32 x and bf16 O2
    weights give float32)."""
    ch_axis, shape = _channel_shape(x, data_format)
    reduce_axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    if training and not use_global_stats:
        half = x.dtype in (torch.bfloat16, torch.float16)
        var, mean = torch.var_mean(x.float() if half else x, dim=reduce_axes,
                                   correction=0)
        with torch.no_grad():
            n = x.numel() // x.shape[ch_axis]
            unbiased = var.detach() * n / max(n - 1, 1)
            new_mean = (momentum * running_mean + (1 - momentum)
                        * mean.detach().to(running_mean.dtype))
            new_var = (momentum * running_var + (1 - momentum)
                       * unbiased.to(running_var.dtype))
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    out = (x - mean.reshape(shape).to(x.dtype)) * torch.rsqrt(
        var.reshape(shape).float() + epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out, new_mean, new_var


def group_norm(x, num_groups: int, weight=None, bias=None,
               epsilon: float = 1e-05, data_format: str = "NCHW", name=None):
    """Group norm (``functional.py:257``): statistics per sample and group
    of ``C / num_groups`` channels, in x's dtype."""
    if data_format.startswith("NC"):
        N, C = x.shape[0], x.shape[1]
        g = x.reshape(N, num_groups, C // num_groups, *x.shape[2:])
        axes = tuple(range(2, g.ndim))
    else:
        N, C = x.shape[0], x.shape[-1]
        g = x.reshape(N, *x.shape[1:-1], num_groups, C // num_groups)
        axes = tuple(range(1, g.ndim - 2)) + (g.ndim - 1,)
    var, mean = torch.var_mean(g, dim=axes, keepdim=True, correction=0)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    _, shape = _channel_shape(x, data_format)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats: bool = True,
                  momentum: float = 0.9, eps: float = 1e-05,
                  data_format: str = "NCHW", name=None):
    """Instance norm (``functional.py:286``): statistics per sample and
    channel over the spatial axes. The running statistics are accepted and
    not read, and ``bias`` applies only with a ``weight``, as in the
    reference."""
    ch_axis, shape = _channel_shape(x, data_format)
    axes = tuple(range(2, x.ndim)) if ch_axis == 1 \
        else tuple(range(1, x.ndim - 1))
    var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
    return out


def local_response_norm(x, size: int, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0,
                        data_format: str = "NCHW", name=None):
    """``x / (k + alpha * sum of x^2 over `size` neighbouring channels) **
    beta``, the window centred with its extra channel after
    (``functional.py:303``)."""
    ch_axis, _ = _channel_shape(x, data_format)
    sq = x.square().movedim(ch_axis, -1)
    lo = (size - 1) // 2
    padded = _F.pad(sq, (lo, size - 1 - lo))
    C = sq.shape[-1]
    summed = sum(padded[..., i:i + C] for i in range(size))
    return x / torch.pow(k + alpha * summed.movedim(-1, ch_axis), beta)


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
    keep = torch.rand(mask_shape, generator=_seeded(x, "dropout"),
                      device=x.device) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x))


# ------------------------------------------------------------ conv / pool
_CONV = {1: _F.conv1d, 2: _F.conv2d, 3: _F.conv3d}
_CONV_T = {1: _F.conv_transpose1d, 2: _F.conv_transpose2d,
           3: _F.conv_transpose3d}
_MAX_POOL = {2: _F.max_pool2d, 3: _F.max_pool3d}
_AVG_POOL = {2: _F.avg_pool2d, 3: _F.avg_pool3d}


def _pair(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


def _conv_padding(padding, n_spatial, kernel, stride, dilation):
    """paddle padding: an int, one int per spatial dimension, a (lo, hi)
    pair per dimension (flat or nested), or 'SAME' / 'VALID'
    (``functional.py:377``)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n_spatial
    padding = list(padding)
    if len(padding) == n_spatial and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n_spatial:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n_spatial)]
    return [tuple(p) for p in padding]


def _padtype_pads(pad: str, sizes, windows, strides):
    """XLA's pads for 'VALID' (none) and 'SAME' (``ceil(size / stride)``
    outputs, the odd padding row at the high end)."""
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if pad != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {pad!r}")
    pads = []
    for size, w, s in zip(sizes, windows, strides):
        total = max((-(-size // s) - 1) * s + w - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_spatial(x, pads, value=0.0):
    """``x`` ``[N, C, *spatial]`` padded by ``pads`` ((lo, hi) per spatial
    dimension; negative crops)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return _F.pad(x, flat, value=value)


def _symmetric(pads, limit=None):
    """The per-dimension pad when every dimension pads both ends alike
    (within ``limit``), else None."""
    if all(lo == hi and lo >= 0 for lo, hi in pads) and (
            limit is None or all(lo <= lim for (lo, _), lim in
                                 zip(pads, limit))):
        return [lo for lo, _ in pads]
    return None


def _add_bias(out, bias, channel_axis=1):
    if bias is None:
        return out
    shape = [1] * out.ndim
    shape[channel_axis] = -1
    return out + bias.to(out.dtype).reshape(shape)


def _convnd(x, weight, bias, stride, padding, dilation, groups, n_spatial,
            channel_last):
    """``lax.conv_general_dilated`` as the reference calls it
    (``functional.py:391-410``): the weight cast to x's dtype, then the
    bias added in the output's dtype. Channels-last inputs run
    channels-first and are moved back."""
    x, weight, bias = autocast_call("conv", x, weight, bias)
    stride = _pair(stride, n_spatial)
    dilation = _pair(dilation, n_spatial)
    kernel = tuple(weight.shape[2:])
    if channel_last:
        x = x.movedim(-1, 1)
    pads = _conv_padding(padding, n_spatial, kernel, stride, dilation)
    if isinstance(pads, str):
        pads = _padtype_pads(pads, x.shape[2:], [d * (k - 1) + 1 for k, d in
                                                 zip(kernel, dilation)],
                             stride)
    sym = _symmetric(pads)
    if sym is None:
        x, sym = _pad_spatial(x, pads), 0
    out = _add_bias(_CONV[n_spatial](x, weight.to(x.dtype), None, stride, sym,
                                     dilation, groups), bias)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 1,
                   data_format == "NLC")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 2,
                   data_format == "NHWC")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 3,
                   data_format == "NDHWC")


def _convnd_transpose(x, weight, bias, stride, padding, output_padding,
                      dilation, groups, n_spatial, channel_last):
    """The reference's transposed conv (``functional.py:428-466``): the
    gradient of a conv, run as a stride-1 conv of the stride-dilated input
    padded ``(d (k - 1) - lo, d (k - 1) - hi + output_padding)``. The
    weight is ``[in_c, out_c / groups, *k]``, torch's transposed layout.
    Torch's transposed conv gives the full output (pads ``d (k - 1)`` each
    side), cropped or zero-padded to those pads. A 'SAME' / 'VALID'
    string raises, as the reference's ``lax`` call does. No autocast, as
    in the reference."""
    stride = _pair(stride, n_spatial)
    dilation = _pair(dilation, n_spatial)
    kernel = tuple(weight.shape[2:])
    if channel_last:
        x = x.movedim(-1, 1)
    pad = _conv_padding(padding, n_spatial, kernel, stride, dilation)
    if isinstance(pad, str):
        raise ValueError("String padding is not implemented for transposed "
                         "convolution: give the padding explicitly")
    full = [d * (k - 1) for k, d in zip(kernel, dilation)]
    opad = _pair(output_padding, n_spatial)
    trans = [(f - lo, f - hi + op)
             for f, (lo, hi), op in zip(full, pad, opad)]
    out = _CONV_T[n_spatial](x, weight.to(x.dtype), None, stride, 0, 0,
                             groups, dilation)
    out = _pad_spatial(out, [(lo - f, hi - f)
                             for (lo, hi), f in zip(trans, full)])
    out = _add_bias(out, bias)
    return out.movedim(1, -1) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCL", name=None):
    return _convnd_transpose(x, weight, bias, stride, padding, output_padding,
                             dilation, groups, 1, data_format == "NLC")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW", output_size=None, name=None):
    return _convnd_transpose(x, weight, bias, stride, padding, output_padding,
                             dilation, groups, 2, data_format == "NHWC")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW", output_size=None, name=None):
    return _convnd_transpose(x, weight, bias, stride, padding, output_padding,
                             dilation, groups, 3, data_format == "NDHWC")


def _pool_pads(x, kernel, stride, padding, ceil_mode):
    """The reference's ``reduce_window`` pads for ``x`` ``[N, C,
    *spatial]`` (``functional.py:487-511``): ``ceil_mode`` widens the high
    pad until the last partial window fits; a string pad ignores it."""
    n = len(kernel)
    pad = _conv_padding(padding, n, kernel, stride, (1,) * n)
    if isinstance(pad, str):
        return _padtype_pads(pad, x.shape[2:], kernel, stride)
    pads = list(pad)
    if ceil_mode:
        for i, size in enumerate(x.shape[2:]):
            lo, hi = pads[i]
            rem = (size + lo + hi - kernel[i]) % stride[i]
            if rem:
                pads[i] = (lo, hi + stride[i] - rem)
    return pads


def _pool_geometry(kernel_size, stride, n_spatial):
    kernel = _pair(kernel_size, n_spatial)
    return kernel, _pair(stride if stride is not None else kernel_size,
                         n_spatial)


def _max_pool(x, kernel_size, stride, padding, n_spatial, channel_last,
              ceil_mode):
    """Max over windows, padding with -inf (the reference's
    ``reduce_window`` init); torch's own padding where it is the same
    (symmetric, at most half the window)."""
    kernel, stride = _pool_geometry(kernel_size, stride, n_spatial)
    if channel_last:
        x = x.movedim(-1, 1)
    pads = _pool_pads(x, kernel, stride, padding, ceil_mode)
    sym = _symmetric(pads, [k // 2 for k in kernel])
    if sym is None:
        x, sym = _pad_spatial(x, pads, float("-inf")), 0
    out = _MAX_POOL[n_spatial](x, kernel, stride, sym)
    return out.movedim(1, -1) if channel_last else out


def _sum_pool(x, kernel, stride, pads):
    """Window sums of ``x`` ``[N, C, *spatial]`` zero-padded by ``pads``
    (2 or 3 spatial dimensions)."""
    if any(lo or hi for lo, hi in pads):
        x = _pad_spatial(x, pads)
    return _AVG_POOL[len(kernel)](x, kernel, stride, 0, False, True, 1)


def _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override, n_spatial, channel_last):
    """Window sums over the reference's pads, divided by
    ``divisor_override``, else (``exclusive``) by the count of real
    elements in each window, else by the window's size
    (``functional.py:545-582``)."""
    kernel, stride = _pool_geometry(kernel_size, stride, n_spatial)
    if channel_last:
        x = x.movedim(-1, 1)
    pads = _pool_pads(x, kernel, stride, padding, ceil_mode)
    summed = _sum_pool(x, kernel, stride, pads)
    if divisor_override:
        out = summed / divisor_override
    elif exclusive and any(lo or hi for lo, hi in pads):
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = summed / _sum_pool(ones, kernel, stride, pads)
    else:
        out = summed / math.prod(kernel)
    return out.movedim(1, -1) if channel_last else out


def _as_2d_pool_args(kernel_size, stride, padding):
    """A 1-d pool's arguments for the 2-d pool over ``x[..., None]`` (the
    reference's ``max_pool1d`` / ``avg_pool1d``)."""
    k = _pair(kernel_size, 1) + (1,)
    s = None if stride is None else _pair(stride, 1) + (1,)
    p = padding if isinstance(padding, str) else _pair(padding, 1) + (0,)
    return k, s, p


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, name=None):
    """``max_pool2d`` over ``x[..., None]``; ``return_mask`` is not read
    (the reference's)."""
    k, s, p = _as_2d_pool_args(kernel_size, stride, padding)
    return max_pool2d(x.unsqueeze(-1), k, s, p, ceil_mode=ceil_mode) \
        .squeeze(-1)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """Max pooling; ``return_mask`` (NCHW, no ``ceil_mode``) also returns
    each maximum's flat ``H * W`` index into the input, int32, the first
    maximum of its window in row-major order, as ``max_unpool2d`` reads
    it."""
    if return_mask:
        if data_format != "NCHW" or ceil_mode:
            raise NotImplementedError(
                "return_mask supports NCHW without ceil_mode")
        return _max_pool2d_with_mask(x, kernel_size, stride, padding)
    return _max_pool(x, kernel_size, stride, padding, 2, data_format == "NHWC",
                     ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    """Max pooling over three spatial axes; ``return_mask`` is not read
    (the reference's)."""
    return _max_pool(x, kernel_size, stride, padding, 3,
                     data_format == "NDHWC", ceil_mode)


def _max_pool2d_with_mask(x, kernel_size, stride, padding):
    kh, kw = _pair(kernel_size, 2)
    sh, sw = _pair(stride or kernel_size, 2)
    ph, pw = _pair(padding, 2)
    W = x.shape[3]
    padded = _F.pad(x, (pw, pw, ph, ph), value=float("-inf"))
    out, idx = _F.max_pool2d(padded, (kh, kw), (sh, sw), return_indices=True)
    wp = W + 2 * pw
    row, col = idx // wp - ph, idx % wp - pw
    return out, (row * W + col).to(torch.int32)


def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, name=None):
    k, s, p = _as_2d_pool_args(kernel_size, stride, padding)
    return avg_pool2d(x.unsqueeze(-1), k, s, p, ceil_mode=ceil_mode,
                      exclusive=exclusive).squeeze(-1)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, 2, data_format == "NHWC")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, 3, data_format == "NDHWC")


def _adaptive_pool_nd(x, output_size, axes, reduce: str):
    """Adaptive pooling one axis at a time (``functional.py:1169-1181``):
    output ``i`` of an axis of ``size`` covers ``[floor(i size / out),
    ceil((i + 1) size / out))``."""
    for axis, out in zip(axes, output_size):
        size = x.shape[axis]
        segs = []
        for i in range(out):
            start, end = (i * size) // out, ((i + 1) * size + out - 1) // out
            seg = x.narrow(axis, start, end - start)
            segs.append(seg.mean(dim=axis, keepdim=True) if reduce == "mean"
                        else seg.amax(dim=axis, keepdim=True))
        x = torch.cat(segs, dim=axis)
    return x


def adaptive_avg_pool1d(x, output_size, name=None):
    return adaptive_avg_pool2d(x.unsqueeze(-1), (output_size, 1)).squeeze(-1)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """An even split is ``avg_pool2d`` with the quotient as window and
    stride, as in the reference; an uneven one the adaptive windows."""
    out_h, out_w = _pair(output_size, 2)
    axes = (2, 3) if data_format == "NCHW" else (1, 2)
    H, W = x.shape[axes[0]], x.shape[axes[1]]
    out_h = H if out_h is None else out_h
    out_w = W if out_w is None else out_w
    if H % out_h == 0 and W % out_w == 0:
        kh, kw = H // out_h, W // out_w
        return avg_pool2d(x, (kh, kw), (kh, kw), 0, data_format=data_format)
    return _adaptive_pool_nd(x, (out_h, out_w), axes, "mean")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    axes = (2, 3, 4) if data_format == "NCDHW" else (1, 2, 3)
    sizes = [x.shape[a] if s is None else int(s)
             for a, s in zip(axes, _pair(output_size, 3))]
    return _adaptive_pool_nd(x, sizes, axes, "mean")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        raise NotImplementedError(
            "return_mask is not supported for adaptive max pooling")
    return adaptive_max_pool2d(x.unsqueeze(-1), (output_size, 1)).squeeze(-1)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """NCHW only; ``return_mask`` is not read (the reference's)."""
    out_h, out_w = _pair(output_size, 2)
    H, W = x.shape[2], x.shape[3]
    if H % out_h == 0 and W % out_w == 0:
        kh, kw = H // out_h, W // out_w
        return max_pool2d(x, (kh, kw), (kh, kw), 0)
    return _adaptive_pool_nd(x, (out_h, out_w), (2, 3), "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        raise NotImplementedError(
            "return_mask is not supported for adaptive max pooling")
    sizes = [x.shape[a] if s is None else int(s)
             for a, s in zip((2, 3, 4), _pair(output_size, 3))]
    return _adaptive_pool_nd(x, sizes, (2, 3, 4), "max")


def _flat_unpool(x, indices, out_len):
    """Pooled values scattered to their flat spatial indices in zeros; an
    index outside ``[0, out_len)`` is dropped, as JAX's scatter drops it
    (it lands in a spare slot cut off after)."""
    N, C = x.shape[:2]
    idx = indices.reshape(N, C, -1).long()
    idx = torch.where((idx >= 0) & (idx < out_len), idx,
                      torch.full_like(idx, out_len))
    flat = x.new_zeros((N, C, out_len + 1))
    return flat.scatter(2, idx, x.reshape(N, C, -1))[..., :out_len]


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    """Pooled values back at their argmax positions, zeros elsewhere
    (``functional.py:1248``; flat ``H * W`` indices, as ``max_pool2d``'s
    ``return_mask`` gives them)."""
    kh, kw = _pair(kernel_size, 2)
    sh, sw = _pair(stride or kernel_size, 2)
    ph, pw = _pair(padding, 2)
    N, C, Ho, Wo = x.shape
    if output_size is None:
        H = (Ho - 1) * sh - 2 * ph + kh
        W = (Wo - 1) * sw - 2 * pw + kw
    else:
        H, W = output_size[-2], output_size[-1]
    return _flat_unpool(x, indices, H * W).reshape(N, C, H, W)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    osz = None if output_size is None else (output_size[-1], 1)
    return max_unpool2d(x.unsqueeze(-1), indices.unsqueeze(-1),
                        (kernel_size, 1), (stride or kernel_size, 1),
                        (padding, 0), osz).squeeze(-1)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    kd, kh, kw = _pair(kernel_size, 3)
    sd, sh, sw = _pair(stride or kernel_size, 3)
    pd, ph, pw = _pair(padding, 3)
    N, C, Do, Ho, Wo = x.shape
    if output_size is None:
        D = (Do - 1) * sd - 2 * pd + kd
        H = (Ho - 1) * sh - 2 * ph + kh
        W = (Wo - 1) * sw - 2 * pw + kw
    else:
        D, H, W = output_size[-3:]
    return _flat_unpool(x, indices, D * H * W).reshape(N, C, D, H, W)


def _reduce_loss(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                     f"{reduction!r}")


def cross_entropy(input, label, weight=None, ignore_index: int = -100,  # noqa: A002
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0):
    """Softmax cross entropy (``functional.py:732-770``), in the logits'
    dtype as the reference computes it (bf16 logits under O2 give bf16
    losses).

    ``use_softmax=False`` takes ``input`` as probabilities (their log,
    clipped to ``[1e-15, 1]``). Soft labels (``soft_label=True``, or a
    label of the logits' shape) give ``-sum(target * logp)`` with the
    target smoothed towards ``1 / classes`` by ``label_smoothing``. Hard
    labels: ``ignore_index`` labels contribute 0 and are left out of the
    mean's count; ``label_smoothing`` mixes the picked log-probability with
    the mean over classes; class ``weight`` scales each label's loss, and
    the mean then divides by the valid labels' weights."""
    label = torch.as_tensor(label, device=input.device)
    axis = axis % input.ndim
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(torch.clamp(input, 1e-15, 1.0))
    if soft_label or (label.ndim == input.ndim
                      and label.shape == input.shape):
        target = label.to(logp.dtype)
        if label_smoothing > 0:
            k = input.shape[axis]
            target = (1 - label_smoothing) * target + label_smoothing / k
        return _reduce_loss(-(target * logp).sum(dim=axis), reduction)
    if label.ndim == input.ndim and label.shape[axis] == 1:
        label = label.squeeze(axis)
    label = label.long()
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        picked = ((1 - label_smoothing) * picked
                  + label_smoothing * logp.mean(dim=axis))
    loss = -picked
    if weight is not None:
        w = torch.as_tensor(weight, device=input.device)[safe]
        loss = loss * w
        if reduction == "mean":
            zero = torch.zeros((), dtype=w.dtype, device=w.device)
            denom = torch.where(valid, w, zero).sum()
            return (torch.where(valid, loss, torch.zeros_like(loss)).sum()
                    / torch.clamp(denom, min=1e-12))
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        n_valid = torch.clamp(valid.sum().to(loss.dtype), min=1.0)
        return loss.sum() / n_valid
    return _reduce_loss(loss, reduction)


def _t(v, like):
    """``v`` (a tensor, array or number) as a tensor on ``like``'s
    device."""
    return torch.as_tensor(v, device=like.device)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce_loss((input - _t(label, input)).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce_loss((input - _t(label, input)).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    d = input - _t(label, input)
    ad = d.abs()
    return _reduce_loss(torch.where(ad < delta, 0.5 * d * d / delta,
                                    ad - 0.5 * delta), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """Negative log-likelihood of log-probabilities ``input``, the class
    on the LAST axis (the reference's, ``functional.py:782``);
    ``ignore_index`` labels count 0 and leave the mean's denominator."""
    label = _t(label, input).long()
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    loss = -torch.gather(input, -1, safe.unsqueeze(-1)).squeeze(-1)
    if weight is not None:
        w = _t(weight, input)[safe]
        loss = loss * w
        if reduction == "mean":
            zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
            return (torch.where(valid, loss, zero).sum()
                    / torch.clamp(torch.where(valid, w, zero.to(w.dtype))
                                  .sum(), min=1e-12))
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum().to(loss.dtype), min=1.0)
    return _reduce_loss(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",  # noqa: A002
                         name=None):
    p = torch.clamp(input, 1e-12, 1.0 - 1e-7)
    label = _t(label, input)
    loss = -(label * torch.log(p) + (1 - label) * torch.log1p(-p))
    if weight is not None:
        loss = loss * _t(weight, input)
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``max(z, 0) - z y + log(1 + exp(-|z|))``; with ``pos_weight``,
    ``-(pos_weight y log sigmoid(z) + (1 - y) log sigmoid(-z))``."""
    label = _t(label, logit)
    if pos_weight is not None:
        loss = -(_t(pos_weight, logit) * label * _F.logsigmoid(logit)
                 + (1 - label) * _F.logsigmoid(-logit))
    else:
        loss = (torch.clamp(logit, min=0) - logit * label
                + torch.log1p(torch.exp(-logit.abs())))
    if weight is not None:
        loss = loss * _t(weight, logit)
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    """``label * (log(label) - input)``, ``input`` log-probabilities;
    ``'batchmean'`` divides the sum by the batch."""
    target = _t(label, input)
    loss = target * (torch.log(torch.clamp(target, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / loss.shape[0]
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    return _reduce_loss(torch.clamp(
        -_t(label, input) * (input - other) + margin, min=0.0), reduction)


class _LogAddExp(torch.autograd.Function):
    """``torch.logaddexp`` with the reference's derivative, ``g *
    exp(x - out)`` for each input (JAX's ``logaddexp`` rule, infinities
    read as 0). Where both inputs are the finite ``-1e30`` of an
    impossible CTC path, ``out`` rounds back to ``-1e30`` and each input
    takes the whole gradient, where torch's own rule would split it in
    halves; ``ctc_loss`` keeps the reference's."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        a, b, out = ctx.saved_tensors

        def finite(t):
            return torch.where(torch.isinf(t), torch.zeros_like(t), t)

        o = finite(out)
        return (grad * torch.exp(finite(a) - o),
                grad * torch.exp(finite(b) - o))


# the log-probability of an impossible path: finite, so that logaddexp's
# gradients stay finite
_CTC_NEG = -1e30


def _ctc_skip_ok(ext):
    """Where the blank-extended labels ``ext`` ``[B, L]`` allow the step
    from ``i - 2``: between two distinct labels only."""
    return torch.cat([torch.zeros((ext.shape[0], 2), dtype=torch.bool,
                                  device=ext.device),
                      ext[:, 2:] != ext[:, :-2]], dim=1)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """Connectionist Temporal Classification loss (``functional.py:840``,
    paddle's warpctc semantics): the log-alpha recursion over the
    blank-extended labels, a loop over time batched over the sequences,
    its gradient torch's autograd through that loop.

    ``log_probs``: ``[T, B, C]`` logits (time-major; the log-softmax is
    taken here, in float32, or in float64 for float64 logits);
    ``labels``: ``[B, S]`` padded ids. The skip from ``i -
    2`` is allowed only between distinct labels. Impossible paths carry
    the finite ``-1e30`` rather than ``-inf``, so ``logaddexp``'s
    gradients stay finite and a label too long for its frames gives a
    large finite loss (about 1e30) where ``torch.nn.functional.ctc_loss``
    gives ``inf``. ``norm_by_times`` divides the gradient (not the value)
    by the frame count; ``"mean"`` is ``mean(loss_i / max(label_len_i,
    1))``."""
    lp = torch.log_softmax(log_probs if log_probs.dtype == torch.float64
                           else log_probs.to(torch.float32), dim=-1)
    T, B, C = lp.shape
    dev = lp.device
    labels = torch.as_tensor(labels, device=dev).long()
    S = labels.shape[1]
    L = 2 * S + 1
    in_len = torch.as_tensor(input_lengths, device=dev).long()
    lab_len = torch.as_tensor(label_lengths, device=dev).long()
    NEG = torch.tensor(_CTC_NEG, dtype=lp.dtype, device=dev)

    # blank-extended sequence: [blank, l1, blank, l2, ..., blank]
    ext = torch.full((B, L), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    valid_pos = torch.arange(L, device=dev)[None, :] < (
        2 * lab_len[:, None] + 1)
    skip_ok = _ctc_skip_ok(ext)
    neg1 = NEG.expand(B, 1)
    neg2 = NEG.expand(B, 2)

    e0 = lp[0].gather(1, ext)
    alpha = torch.cat([e0[:, :1], torch.where(lab_len[:, None] > 0,
                                              e0[:, 1:2], NEG),
                       NEG.expand(B, L - 2)], dim=1) if L > 1 else e0[:, :1]
    alpha = torch.where(valid_pos, alpha, NEG)
    alphas = [alpha]
    for t in range(1, T):
        one = torch.cat([neg1, alpha[:, :-1]], dim=1)
        two = torch.where(skip_ok, torch.cat([neg2, alpha[:, :-2]], dim=1),
                          NEG)
        alpha = _LogAddExp.apply(_LogAddExp.apply(alpha, one), two) + \
            lp[t].gather(1, ext)
        alpha = torch.where(valid_pos, alpha, NEG)
        alphas.append(alpha)
    alphas = torch.stack(alphas)                       # [T, B, L]
    a_fin = alphas[(in_len - 1).clamp_min(0), torch.arange(B, device=dev)]
    end_blank = 2 * lab_len
    end_label = (2 * lab_len - 1).clamp_min(0)
    v1 = a_fin.gather(1, end_blank[:, None])[:, 0]
    v2 = torch.where(lab_len > 0, a_fin.gather(1, end_label[:, None])[:, 0],
                     NEG)
    loss = -_LogAddExp.apply(v1, v2)
    if norm_by_times:
        scaled = loss / in_len.to(lp.dtype).clamp_min(1.0)
        loss = (loss - scaled).detach() + scaled
    if reduction == "mean":
        return (loss / lab_len.to(lp.dtype).clamp_min(1.0)).mean()
    return _reduce_loss(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",  # noqa: A002
                         name=None):
    return _reduce_loss(torch.where(_t(label, input) == 1, input,
                                    torch.clamp(margin - input, min=0.0)),
                        reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(n1 * n2, min=eps)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = cosine_similarity(input1, input2, axis=-1)
    return _reduce_loss(torch.where(_t(label, cos) == 1, 1 - cos,
                                    torch.clamp(cos - margin, min=0.0)),
                        reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,  # noqa: A002
                        eps=1e-6, swap=False, reduction="mean", name=None):
    def dist(a, b):
        return torch.linalg.vector_norm(a - b + eps, ord=p, dim=-1)

    d_pos, d_neg = dist(input, positive), dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce_loss(torch.clamp(d_pos - d_neg + margin, min=0.0),
                        reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return _reduce_loss(_softplus(-_t(label, input).to(input.dtype) * input),
                        reduction)


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    y = _t(label, input).to(input.dtype)
    loss = -(y * _F.logsigmoid(input) + (1 - y) * _F.logsigmoid(-input))
    if weight is not None:
        loss = loss * _t(weight, input)
    return _reduce_loss(loss.mean(dim=-1), reduction)


def multi_margin_loss(input, label, p: int = 1, margin: float = 1.0,  # noqa: A002
                      weight=None, reduction="mean", name=None):
    lab = _t(label, input).long()
    target = torch.gather(input, 1, lab[:, None])
    m = torch.clamp(margin - target + input, min=0.0) ** p
    if weight is not None:
        m = m * _t(weight, input)[lab][:, None]
    m = m * (1 - _F.one_hot(lab, input.shape[1]).to(input.dtype))
    return _reduce_loss(m.sum(dim=1) / input.shape[1], reduction)


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or (
        lambda a, b: torch.linalg.vector_norm(a - b, dim=-1))
    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce_loss(torch.clamp(dp - dn + margin, min=0.0), reduction)


def _plain_attention(q, k, v, attn_mask=None, dropout_p: float = 0.0,
                     is_causal: bool = False):
    """The plain branch of :func:`scaled_dot_product_attention` on ``[B,
    L, H, D]`` (``functional.py:995-1014``): scores in q's dtype scaled by
    ``1/sqrt(D)``, the causal mask bottom-right aligned (``tril(k=Lk-Lq)``)
    and a boolean mask as ``-inf``, a float mask added, softmax in float32
    cast back to q's dtype, dropout on the probabilities. A row that masks
    every key gives NaN, as in the reference."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    if is_causal:
        Lq, Lk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(Lq, Lk, dtype=torch.bool,
                          device=scores.device).tril(Lk - Lq)
        scores = torch.where(keep, scores, neg_inf)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, neg_inf)
        else:
            scores = scores + attn_mask.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        probs = dropout(probs, p=dropout_p, training=True)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None):
    """Attention on paddle's ``[B, L, H, D]`` layout (``functional.py:
    969-1014``), ``attn_mask`` broadcast to ``[B, H, Lq, Lk]``: boolean
    (True keeps) or additive float.

    Where :func:`~paddle_tpu_torch.kernels.flash_attention.should_use_flash`
    admits the call (CUDA tensors of a routed dtype and head dim, a mask
    of four dims whose last two are ``[Lq, Lk]``), it runs the flash
    kernels: a boolean mask becomes a float32 ``-1e30`` bias that takes no
    gradient, a float mask is the bias itself (trained when it requires a
    gradient), and dropout runs inside the kernels with a seed from the
    "dropout" stream. Everything else runs :func:`_plain_attention`.

    Causal attention with ``Lq != Lk`` never takes the kernels: they mask
    top-left, the reference's plain path (the semantics) bottom-right.

    The two branches differ on a row whose mask keeps no key: the kernels'
    ``-1e30`` averages V uniformly there, the plain ``-inf`` gives NaN (the
    reference's own split)."""
    from ..kernels import flash_attention as fa

    del name
    q, k, v = query, key, value
    p_drop = dropout_p if training else 0.0
    same_length = q.shape[1] == k.shape[1]
    if (same_length or not is_causal) and fa.should_use_flash(
            q, k, attn_mask, p_drop):
        bias, bias_grad = None, True
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                # a keep-mask is not trained: no dS output, no dbias pass
                bias = torch.zeros(attn_mask.shape, dtype=torch.float32,
                                   device=attn_mask.device)
                bias.masked_fill_(~attn_mask, -1e30)
                bias_grad = False
            else:
                bias = attn_mask
        # the reference draws randint(key, (), 0, 2**31 - 1)
        seed = take_rng_key("dropout") % (2 ** 31 - 1) if p_drop > 0.0 else 0
        return fa.flash_attention_blhd(q, k, v, causal=is_causal, bias=bias,
                                       dropout_p=p_drop, seed=seed,
                                       bias_grad=bias_grad)
    return _plain_attention(q, k, v, attn_mask, p_drop, is_causal)


# ------------------------------------------------------------- the long tail
# The rest of the reference's namespace (``functional.py:136-1579``): the
# in-place aliases, embedding and label helpers, the spatial and vision
# functions, the remaining losses, beam search's backtrace and sparse
# attention. Each is plain torch with the reference's semantics; where
# the reference calls a JAX primitive whose numerics torch does not share
# (``jax.image.resize``, ``jnp.linspace``), the primitive's arithmetic is
# written out here.

relu_ = _out_of_place(relu)
tanh_ = _out_of_place(tanh)
softmax_ = _out_of_place(softmax)
elu_ = _out_of_place(elu)


def softplus_(x, name=None):
    """``jax.nn.softplus`` (no beta, no threshold), the reference's
    ``softplus_``: returns the result, the input unchanged."""
    return _softplus(x)


def _on(x, device=None):
    """``x`` as a tensor: a tensor stays where it is, anything else goes
    to ``device`` (None: the card)."""
    if isinstance(x, torch.Tensor):
        return x
    from .. import default_device

    return torch.as_tensor(x, device=default_device(device))


def gumbel_softmax(x, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g =
    -log(-log(u))``, ``u`` uniform on ``[tiny, 1)`` from the "gumbel"
    stream (``functional.py:136``). ``hard=True`` returns the one-hot of
    the argmax with the soft sample's gradient (straight-through)."""
    u = torch.rand(x.shape, generator=_seeded(x, "gumbel"), dtype=x.dtype,
                   device=x.device).clamp_min(torch.finfo(x.dtype).tiny)
    y = torch.softmax((x - torch.log(-torch.log(u))) / temperature, dim=axis)
    if hard:
        onehot = torch.zeros_like(y).scatter_(
            axis, y.argmax(dim=axis, keepdim=True), 1.0)
        y = (onehot - y).detach() + y
    return y


def embedding(x, weight, padding_idx=None, sparse: bool = False, name=None):
    """Rows of ``weight`` at the ids ``x``; rows looked up by
    ``padding_idx`` are zeros (``functional.py:161``)."""
    ids = _t(x, weight).long()
    out = weight[ids]
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


def one_hot(x, num_classes: int, name=None):
    """float32 one-hot rows (``jax.nn.one_hot``, ``functional.py:170``):
    an id outside ``[0, num_classes)``, -1 say, gives a row of zeros
    where ``torch.nn.functional.one_hot`` would raise."""
    x = _on(x)
    classes = torch.arange(num_classes, device=x.device)
    return (x[..., None] == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon: float = 0.1, name=None):
    """``(1 - eps) * label + eps / classes``, or ``+ eps * prior_dist``."""
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * _t(prior_dist, label)
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def normalize(x, p=2, axis: int = 1, epsilon: float = 1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``, the norm as
    ``sum(|x| ** p) ** (1 / p)``."""
    nrm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(nrm, min=epsilon)


def dropout2d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCHW", name=None):
    """Whole channels dropped: one mask value per (sample, channel)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p: float = 0.5, training: bool = True, name=None):
    """SELU-preserving dropout (``functional.py:348``): a dropped element
    becomes ``-alpha * scale``, then ``a * x + b`` restores the mean and
    variance. The mask comes from the "dropout" stream."""
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = torch.rand(x.shape, generator=_seeded(x, "dropout"),
                      device=x.device) < 1.0 - p
    a = 1.0 / math.sqrt((1.0 - p) * (1.0 + p * alpha_p ** 2))
    b = -a * alpha_p * p
    return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b


# ------------------------------------------------------------- resizing
def _jnp_linspace(start: float, stop: float, num: int, device):
    """``jnp.linspace(start, stop, num)`` in float32, its arithmetic:
    ``start * (1 - i / div) + stop * (i / div)`` and the end point itself
    (torch's linspace rounds otherwise)."""
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    if num == 1:
        return start_t.reshape(1)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    return torch.cat([start_t * (1 - step) + stop_t * step, stop_t[None]])


def _keys_cubic(x):
    """Keys' cubic kernel with a = -0.5 (``jax.image``'s, not torch's
    a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0)


def _resize_weights(m: int, n: int, kernel, device):
    """``jax.image``'s ``compute_weight_mat`` for an axis of ``m`` to
    ``n`` samples (scale ``n / m``, no translation, antialiased):
    ``[m, n]`` weights, each column normalised, the kernel widened by
    ``m / n`` when it shrinks the axis."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    src = torch.arange(m, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(
        torch.float32).eps), w / torch.where(total != 0, total,
                                             torch.ones_like(total)),
        torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _image_resize(x, axes, size, method: str):
    """``jax.image.resize(x, ..., method)`` over the spatial ``axes``: an
    axis whose size does not change is left alone. "nearest" takes input
    ``floor((i + 0.5) * m / n)`` (half-pixel centres); "linear" and
    "cubic" contract each axis with :func:`_resize_weights` (antialiased
    when shrinking)."""
    if method != "nearest" and not x.is_floating_point():
        x = x.to(torch.float32)
    for axis, n in zip(axes, size):
        m = x.shape[axis]
        if m == n:
            continue
        if method == "nearest":
            src = ((torch.arange(n, dtype=torch.float32, device=x.device)
                    + 0.5) * m / n).floor().long()
            x = x.index_select(axis, src)
            continue
        w = _resize_weights(m, n, _keys_cubic if method == "cubic"
                            else _triangle, x.device).to(x.dtype)
        x = torch.matmul(x.movedim(axis, -1), w).movedim(-1, axis)
    return x


def _separable_linear_resize(x, positions, axes):
    """Linear interpolation at the given source ``positions`` along each
    axis (``functional.py:657-672``): the align-corners path."""
    for axis, pos in zip(axes, positions):
        size = x.shape[axis]
        lo = pos.floor().long()
        hi = (lo + 1).clamp(0, size - 1)
        w = (pos - lo).to(x.dtype)
        lo = lo.clamp(0, size - 1)
        shape = [1] * x.ndim
        shape[axis] = -1
        w = w.reshape(shape)
        x = (x.index_select(axis, lo) * (1 - w)
             + x.index_select(axis, hi) * w)
    return x


_RESIZE_METHOD = {"nearest": "nearest", "bilinear": "linear",
                  "trilinear": "linear", "linear": "linear",
                  "bicubic": "cubic", "area": "linear"}


def interpolate(x, size=None, scale_factor=None, mode: str = "nearest",
                align_corners: bool = False, align_mode: int = 0,
                data_format: str = "NCHW", name=None):
    """Resize the spatial axes (``functional.py:622-654``), the
    reference's semantics, which are not ``torch.nn.functional.
    interpolate``'s:

    - ``size`` or ``int(side * scale_factor)`` per axis;
    - "nearest" samples half-pixel centres, whatever ``align_corners``;
    - "bilinear", "trilinear", "linear" and "area" are linear, "bicubic"
      Keys' cubic at a = -0.5, both as ``jax.image.resize`` computes them:
      antialiased when an axis shrinks;
    - with ``align_corners=True`` every mode but "nearest" is linear
      interpolation between the corner-aligned source positions;
    - ``align_mode`` is not read."""
    channel_last = not data_format.startswith("NC")
    n_spatial = x.ndim - 2
    axes = list(range(1, 1 + n_spatial)) if channel_last \
        else list(range(2, 2 + n_spatial))
    spatial = [x.shape[a] for a in axes]
    if size is None:
        size = tuple(int(s * f) for s, f in
                     zip(spatial, _pair(scale_factor, n_spatial)))
    else:
        size = tuple(int(s) for s in _pair(size, n_spatial))
    method = _RESIZE_METHOD[mode]
    if method == "nearest" or not align_corners:
        return _image_resize(x, axes, size, method)
    positions = [torch.zeros(1, dtype=torch.float32, device=x.device)
                 if n == 1 else _jnp_linspace(0.0, m - 1.0, n, x.device)
                 for m, n in zip(spatial, size)]
    return _separable_linear_resize(x, positions, axes)


def upsample(x, size=None, scale_factor=None, mode: str = "nearest",
             align_corners: bool = False, align_mode: int = 0,
             data_format: str = "NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


# ------------------------------------------------------------- rearranging
def pixel_shuffle(x, upscale_factor: int, data_format: str = "NCHW",
                  name=None):
    """``[N, C r^2, H, W]`` to ``[N, C, H r, W r]`` (channels-last:
    ``[N, H, W, r, r, C]`` order)."""
    r = upscale_factor
    if data_format == "NCHW":
        N, C, H, W = x.shape
        return x.reshape(N, C // (r * r), r, r, H, W).permute(
            0, 1, 4, 2, 5, 3).reshape(N, C // (r * r), H * r, W * r)
    N, H, W, C = x.shape
    return x.reshape(N, H, W, r, r, C // (r * r)).permute(
        0, 1, 3, 2, 4, 5).reshape(N, H * r, W * r, C // (r * r))


def pixel_unshuffle(x, downscale_factor: int, data_format: str = "NCHW",
                    name=None):
    r = downscale_factor
    if data_format == "NCHW":
        N, C, H, W = x.shape
        return x.reshape(N, C, H // r, r, W // r, r).permute(
            0, 1, 3, 5, 2, 4).reshape(N, C * r * r, H // r, W // r)
    N, H, W, C = x.shape
    return x.reshape(N, H // r, r, W // r, r, C).permute(
        0, 1, 3, 5, 2, 4).reshape(N, H // r, W // r, C * r * r)


def channel_shuffle(x, groups: int, data_format: str = "NCHW", name=None):
    """The channels as ``[groups, C / groups]`` transposed: ShuffleNetV2's
    mixing step."""
    if data_format == "NCHW":
        N, C, H, W = x.shape
        return x.reshape(N, groups, C // groups, H, W).transpose(1, 2) \
            .reshape(N, C, H, W)
    N, H, W, C = x.shape
    return x.reshape(N, H, W, groups, C // groups).transpose(3, 4) \
        .reshape(N, H, W, C)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """Sliding ``[kh, kw]`` patches of ``[N, C, H, W]`` as ``[N, C kh kw,
    L]``, channel-major (im2col); the padding is one (h, w) pair."""
    ph, pw = _pair(paddings, 2)
    return _F.unfold(x, _pair(kernel_sizes, 2), _pair(dilations, 2),
                     (ph, pw), _pair(strides, 2))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """The inverse of :func:`unfold`: patches summed back into ``[N, C,
    H, W]`` where they overlap (col2im, ``functional.py:1295``)."""
    ph, pw = _pair(paddings, 2)
    return _F.fold(x, _pair(output_sizes, 2), _pair(kernel_sizes, 2),
                   _pair(dilations, 2), (ph, pw), _pair(strides, 2))


def zeropad2d(x, padding, data_format: str = "NCHW", name=None):
    """Zeros around the spatial axes, ``padding`` (left, right, top,
    bottom) or one int for all four."""
    left, right, top, bottom = _pair(padding, 4)
    if data_format == "NCHW":
        return _F.pad(x, (left, right, top, bottom))
    return _F.pad(x, (0, 0, left, right, top, bottom))


def pad(x, pad, mode: str = "constant", value: float = 0.0,  # noqa: A002
        data_format: str = "NCHW", name=None):
    """``paddle.pad`` (:func:`paddle_tpu_torch.ops.manipulation.pad`)."""
    from ..ops.manipulation import pad as _pad

    return _pad(x, pad, mode=mode, value=value, data_format=data_format)


def temporal_shift(x, seg_num: int, shift_ratio: float = 0.25,
                   data_format: str = "NCHW", name=None):
    """TSM's shift over ``[N T, C, H, W]``: the first ``C * shift_ratio``
    channels move one segment back, the next as many one segment ahead,
    zeros where they leave; the rest stay."""
    NT, C, H, W = x.shape
    x = x.reshape(NT // seg_num, seg_num, C, H, W)
    f = int(C * shift_ratio)
    left = torch.cat([x[:, 1:, :f], torch.zeros_like(x[:, :1, :f])], dim=1)
    right = torch.cat([torch.zeros_like(x[:, :1, f:2 * f]),
                       x[:, :-1, f:2 * f]], dim=1)
    return torch.cat([left, right, x[:, :, 2 * f:]], dim=2).reshape(
        NT, C, H, W)


def diag_embed(input, offset: int = 0, dim1: int = -2, dim2: int = -1,  # noqa: A002
               name=None):
    """Each last-axis vector on a diagonal (``offset`` above the main one)
    of a new ``[n, n]`` pair of axes placed at ``dim1`` (rows) and
    ``dim2`` (columns)."""
    n = input.shape[-1] + abs(offset)
    out = input.new_zeros(tuple(input.shape[:-1]) + (n, n))
    idx = torch.arange(input.shape[-1], device=input.device)
    out[..., idx + max(-offset, 0), idx + max(offset, 0)] = input
    nd = out.ndim
    d1, d2 = dim1 % nd, dim2 % nd
    if (d1, d2) != (nd - 2, nd - 1):
        perm = [i for i in range(nd) if i not in (nd - 2, nd - 1)]
        for dst, src in sorted([(d1, nd - 2), (d2, nd - 1)]):
            perm.insert(dst, src)
        out = out.permute(perm)
    return out


def pairwise_distance(x, y, p: float = 2.0, epsilon: float = 1e-6,
                      keepdim: bool = False, name=None):
    """``||x - y + epsilon||_p`` over the last axis."""
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias)``, ``weight``
    ``[out, in1, in2]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def sequence_mask(lengths, maxlen=None, dtype="bool"):
    """``mask[..., j] = j < lengths[...]`` over ``maxlen`` columns; the
    reference needs ``maxlen`` given (it raises without one)."""
    from ..framework.dtype import convert_dtype

    if maxlen is None:
        raise ValueError("sequence_mask: pass maxlen explicitly (the "
                         "reference needs a static width)")
    lengths = _on(lengths)
    row = torch.arange(int(maxlen), device=lengths.device)
    return (row < lengths[..., None]).to(convert_dtype(dtype))


# ------------------------------------------------------------- losses
def square_error_cost(input, label):  # noqa: A002
    return (input - _t(label, input)).square()


def log_loss(input, label, epsilon: float = 1e-4, name=None):  # noqa: A002
    y = _t(label, input).to(input.dtype)
    return -(y * torch.log(input + epsilon)
             + (1 - y) * torch.log(1 - input + epsilon))


def dice_loss(input, label, epsilon: float = 1e-5, name=None):  # noqa: A002
    """``mean(1 - (2 |X∩Y| + eps) / (|X| + |Y| + eps))`` per sample:
    ``input`` ``[N, ..., C]`` probabilities, ``label`` ``[N, ..., 1]``
    class ids."""
    lab = _t(label, input)
    if lab.shape[-1] == 1:
        lab = lab[..., 0]
    onehot = one_hot(lab, input.shape[-1]).to(input.dtype)
    axes = tuple(range(1, input.ndim))
    inter = 2.0 * (input * onehot).sum(dim=axes)
    denom = input.sum(dim=axes) + onehot.sum(dim=axes)
    return (1.0 - (inter + epsilon) / (denom + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg: float = 0.002, name=None):
    """Cross entropy of the anchor-positive similarities against the
    same-label rows (each row's targets summing to 1), plus ``l2_reg / 4``
    of the two embeddings' mean squared norms."""
    lab = _t(labels, anchor).reshape(-1)
    sim = anchor @ positive.T
    tgt = (lab[:, None] == lab[None, :]).to(sim.dtype)
    tgt = tgt / tgt.sum(dim=1, keepdim=True)
    xent = (-tgt * torch.log_softmax(sim, dim=1)).sum(dim=1).mean()
    reg = l2_reg * ((anchor * anchor).sum(1).mean()
                    + (positive * positive).sum(1).mean()) * 0.25
    return xent + reg


def sigmoid_focal_loss(logit, label, normalizer=None, alpha: float = 0.25,
                       gamma: float = 2.0, reduction: str = "sum",
                       name=None):
    """``alpha_t (1 - p_t) ** gamma`` times the logits' binary cross
    entropy, divided by ``normalizer`` when given."""
    y = _t(label, logit)
    p = torch.sigmoid(logit)
    ce = (torch.clamp(logit, min=0) - logit * y
          + torch.log1p(torch.exp(-logit.abs())))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / _t(normalizer, logit)
    return _reduce_loss(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100,
                               numeric_stable_mode: bool = True,
                               return_softmax: bool = False, axis: int = -1):
    """Unreduced :func:`cross_entropy` with a trailing axis of 1 (and the
    softmax with ``return_softmax``)."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)[..., None]
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def margin_cross_entropy(logits, label, margin1: float = 1.0,
                         margin2: float = 0.5, margin3: float = 0.0,
                         scale: float = 64.0, group=None,
                         return_softmax: bool = False,
                         reduction: str = "mean", name=None):
    """ArcFace's combined margin (``functional.py:1434``): the target
    class's cosine becomes ``cos(m1 theta + m2) - m3``, every logit is
    scaled by ``scale``, then softmax cross entropy. ``group`` is not
    read (one device)."""
    cos = torch.clamp(logits, -1.0, 1.0)
    lab = _t(label, logits).reshape(-1).long()
    onehot = one_hot(lab, cos.shape[-1])
    theta = torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7))
    target = torch.cos(margin1 * theta + margin2) - margin3
    adj = torch.where(onehot > 0, target, cos) * scale
    logp = torch.log_softmax(adj, dim=-1)
    loss = _reduce_loss(-logp.gather(1, lab[:, None])[:, 0], reduction)
    if return_softmax:
        return loss, torch.softmax(adj, dim=-1)
    return loss


def hsigmoid_loss(input, label, num_classes: int, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse: bool = False,
                  name=None):
    """Hierarchical sigmoid (``functional.py:1396``), ``[N, 1]`` losses.

    The default tree is the word2vec heap: leaf ``c`` is node
    ``num_classes + c``, its ancestors ``node // 2`` down to node 1, each
    internal node's weight row ``node - 1`` and its code the child's
    parity. A custom tree gives ``path_table`` (weight rows, -1 past a
    path's end) and ``path_code``. A step with code 1 costs
    ``softplus(-logit)``, code 0 ``softplus(logit)``."""
    lab = _t(label, input).reshape(-1).long()
    if path_table is None:
        depth = int(math.ceil(math.log2(max(num_classes, 2)))) + 1
        nodes, codes, masks = [], [], []
        node = lab + num_classes
        for _ in range(depth):
            parent = node // 2
            codes.append((node % 2).to(torch.float32))
            live = parent >= 1
            masks.append(live.to(torch.float32))
            nodes.append(torch.where(live, parent, torch.ones_like(parent)))
            node = parent
        table = torch.stack(nodes, 1) - 1
        code = torch.stack(codes, 1)
        mask = torch.stack(masks, 1)
    else:
        table = _t(path_table, input).long()
        code = _t(path_code, input).to(torch.float32)
        mask = (table >= 0).to(torch.float32)
        table = table.clamp_min(0)
    logits = torch.einsum("bd,bkd->bk", input, weight[table])
    if bias is not None:
        logits = logits + bias.reshape(-1)[table]
    nll = _softplus(-(2.0 * code - 1.0) * logits) * mask
    return nll.sum(dim=1, keepdim=True)


def class_center_sample(label, num_classes: int, num_samples: int,
                        group=None):
    """Partial FC's class centres (``functional.py:1454``): every positive
    class of ``label``, then negatives drawn without replacement from a
    seeded ``numpy`` generator (its seed from the framework's stream) up
    to ``num_samples``, sorted. Returns ``(label remapped into the sampled
    classes, the sampled classes)`` as int64 tensors on the label's
    device."""
    import numpy as np

    from ..framework import random as framework_random

    lab_t = _on(label)
    lab = lab_t.detach().cpu().numpy().reshape(-1)
    pos = np.unique(lab)
    rest = np.setdiff1d(np.arange(num_classes), pos)
    n_extra = max(0, num_samples - pos.size)
    rng = np.random.default_rng(framework_random.next_seed() % (2 ** 31 - 1))
    extra = rng.choice(rest, size=min(n_extra, rest.size), replace=False)
    sampled = np.concatenate([pos, np.sort(extra)]).astype(np.int64)
    remapped = np.searchsorted(pos, lab).astype(np.int64)
    return (torch.from_numpy(remapped).to(lab_t.device),
            torch.from_numpy(sampled).to(lab_t.device))


# ------------------------------------------------------------- warps
def affine_grid(theta, out_shape, align_corners: bool = True, name=None):
    """``[N, 2, 3]`` affine parameters to an ``[N, H, W, 2]`` grid of
    normalised (x, y) sampling positions (``functional.py:1478``)."""
    H, W = int(out_shape[2]), int(out_shape[3])

    def coords(n):
        if align_corners:
            return _jnp_linspace(-1.0, 1.0, n, theta.device)
        step = 2.0 / n
        return _jnp_linspace(-1.0 + step / 2, 1.0 - step / 2, n,
                             theta.device)

    gy, gx = torch.meshgrid(coords(H), coords(W), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).to(theta.dtype)
    return torch.einsum("hwk,nik->nhwi", base, theta)


def grid_sample(x, grid, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = True,
                name=None):
    """``[N, C, H, W]`` sampled at the normalised ``[N, Ho, Wo, 2]`` grid
    (``functional.py:1496-1550``): bilinear or nearest (rounding half to
    even), padding by zeros, the border, or reflection about ``[0, s -
    1]`` (``align_corners``) or ``[-0.5, s - 0.5]`` then clipped."""
    N, C, H, W = x.shape

    def unnorm(g, size):
        if align_corners:
            return (g + 1) * (size - 1) / 2
        return ((g + 1) * size - 1) / 2

    gx = unnorm(grid[..., 0], W)
    gy = unnorm(grid[..., 1], H)

    def reflect(v, lo, hi):
        span = hi - lo
        if span <= 0:
            return torch.full_like(v, max(lo, 0.0))
        v = ((v - lo) % (2 * span)).abs()
        return torch.where(v > span, 2 * span - v, v) + lo

    if padding_mode == "reflection":
        if align_corners:
            gx, gy = reflect(gx, 0.0, W - 1.0), reflect(gy, 0.0, H - 1.0)
        else:
            gx = reflect(gx, -0.5, W - 0.5).clamp(0, W - 1)
            gy = reflect(gy, -0.5, H - 0.5).clamp(0, H - 1)
    batch = torch.arange(N, device=x.device)[:, None, None]

    def gather(ix, iy):
        vals = x[batch, :, iy.clamp(0, H - 1), ix.clamp(0, W - 1)]
        if padding_mode == "zeros":
            inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            vals = vals * inb[..., None]
        return vals

    if mode == "nearest":
        return gather(gx.round().long(), gy.round().long()).movedim(-1, 1)
    x0, y0 = gx.floor().long(), gy.floor().long()
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    out = (gather(x0, y0) * (1 - wx) * (1 - wy)
           + gather(x0 + 1, y0) * wx * (1 - wy)
           + gather(x0, y0 + 1) * (1 - wx) * wy
           + gather(x0 + 1, y0 + 1) * wx * wy)
    return out.movedim(-1, 1)


# ------------------------------------------------------------- decoding
def gather_tree(ids, parents):
    """Beam search's backtrace (``functional.py:1139``): from ``ids`` and
    ``parents`` ``[T, B, beam]``, each final beam's tokens along its chain
    of parents, ``[T, B, beam]``."""
    T, B, K = ids.shape
    rows = torch.arange(B, device=ids.device)[:, None]
    beam = torch.arange(K, device=ids.device).expand(B, K)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(ids[t][rows, beam])
        beam = parents[t][rows, beam]
    return torch.stack(toks[::-1])


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Block-sparse attention from CSR rows (``functional.py:1553``),
    ``[B, H, L, D]``: the CSR layout becomes a dense keep-mask on the
    host, masked scores are -1e30 (a row that keeps nothing averages V),
    ``attn_mask`` is added; ``key_padding_mask`` is not read, as in the
    reference. Plain torch, as the reference is plain code."""
    import numpy as np

    B, H, L, D = query.shape
    offs = np.asarray(torch.as_tensor(sparse_csr_offset).cpu())
    cols = np.asarray(torch.as_tensor(sparse_csr_columns).cpu())
    mask = np.zeros((B, H, L, L), bool)
    for b in range(B):
        for h in range(H):
            o, c = offs[b, h], cols[b, h]
            for r in range(L):
                mask[b, h, r, c[o[r]:o[r + 1]]] = True
    s = torch.einsum("bhld,bhmd->bhlm", query, key) / math.sqrt(D)
    s = torch.where(torch.from_numpy(mask).to(s.device), s,
                    torch.full_like(s, -1e30))
    if attn_mask is not None:
        s = s + _t(attn_mask, s)
    return torch.einsum("bhlm,bhmd->bhld", torch.softmax(s, dim=-1), value)


__all__ += [
    "relu_", "tanh_", "softmax_", "elu_", "softplus_", "gumbel_softmax",
    "embedding", "one_hot", "label_smooth", "normalize", "dropout2d",
    "dropout3d", "alpha_dropout", "interpolate", "upsample",
    "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "unfold", "fold",
    "zeropad2d", "pad", "temporal_shift", "diag_embed", "pairwise_distance",
    "bilinear", "sequence_mask", "square_error_cost", "log_loss",
    "dice_loss", "npair_loss", "sigmoid_focal_loss",
    "softmax_with_cross_entropy", "margin_cross_entropy", "hsigmoid_loss",
    "class_center_sample", "affine_grid", "grid_sample", "gather_tree",
    "sparse_attention"]

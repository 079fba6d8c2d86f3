"""The port's convolution and pooling functions
(``paddle_tpu_torch.nn.functional``) against the JAX package's, on the
CPU: every conv, transposed conv and pool across its padding forms
(int, per dimension, flat and nested pairs, 'SAME' with a stride,
'VALID'), groups, dilation, both data formats, ``ceil_mode``,
``exclusive``, ``return_mask`` with the unpools, and uneven adaptive
sizes; outputs and the gradients of the input and the weight.

Inputs are float32 numpy arrays from seeds, the same on both sides. The
gradients are those of ``sum(out * cotangent)`` for a seeded cotangent.
Tolerances, float32: outputs rtol 1e-4 / atol 1e-5, gradients rtol 2e-4
/ atol 2e-5 (the reference's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.layers import conv as JC
from paddle_tpu.nn.layers import pooling as JP
import paddle_tpu as pt
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import conv as TC
from paddle_tpu_torch.nn.layers import pooling as TP
from torch_threads import few_torch_threads  # noqa: F401

FWD = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=2e-4, atol=2e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check_vjp(jfn, tfn, arrays, seed=99, grads=True):
    """Outputs of ``jfn`` / ``tfn`` on ``arrays`` and, with ``grads``, the
    gradient of sum(out * cotangent) for each array."""
    jin = [jnp.asarray(a) for a in arrays]
    out_j, vjp = jax.vjp(jax.jit(jfn), *jin)
    tin = [torch.tensor(a, requires_grad=grads) for a in arrays]
    out_t = tfn(*tin)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **FWD)
    if not grads:
        return
    cot = _rand(out_j.shape, seed)
    g_j = vjp(jnp.asarray(cot))
    (out_t * torch.from_numpy(cot)).sum().backward()
    for i, (gj, t) in enumerate(zip(g_j, tin)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj),
                                   err_msg=f"grad {i}", **BWD)


def _channels_last(shape):
    return (shape[0],) + tuple(shape[2:]) + (shape[1],)


# (spatial dims, padding, stride, dilation, groups, channels-last, bias)
CONV_CASES = [
    (1, 0, 1, 1, 1, False, True),
    (1, 2, 2, 1, 1, False, False),
    (1, "SAME", 2, 1, 1, False, True),
    (1, "VALID", 1, 2, 2, True, True),
    (1, [1, 2], 1, 1, 1, False, True),
    (2, 0, 1, 1, 1, False, True),
    (2, 1, 1, 1, 1, False, False),
    (2, 1, 2, 1, 1, True, True),
    (2, [1, 2], 1, 1, 1, False, True),
    (2, [0, 1, 2, 1], 2, 1, 1, False, True),
    (2, [(1, 0), (2, 1)], 1, 1, 2, False, True),
    (2, "SAME", 2, 1, 1, False, True),
    (2, "SAME", 1, 2, 1, True, False),
    (2, "SAME", 3, 1, 4, False, True),
    (2, "VALID", 2, 1, 1, True, True),
    (2, 2, 1, 2, 2, False, True),
    (2, 1, (2, 1), (1, 2), 1, False, True),
    (3, 1, 1, 1, 1, False, True),
    (3, "SAME", 2, 1, 2, False, False),
    (3, [1, 0, 1], 1, 2, 1, True, True),
    (3, [0, 1, 1, 0, 1, 1], 2, 1, 1, False, True),
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[f"conv{c[0]}d-{i}" for i, c in
                              enumerate(CONV_CASES)])
def test_conv_matches_reference(case):
    n, padding, stride, dilation, groups, channel_last, has_bias = case
    cin, cout, k = 4, 8, 3
    x_shape = (2, cin) + (9, 8, 7)[:n]
    if channel_last:
        x_shape = _channels_last(x_shape)
    x = _rand(x_shape, 1)
    w = _rand((cout, cin // groups) + (k,) * n, 2) * 0.3
    b = _rand((cout,), 3)
    fmt = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"),
           3: ("NCDHW", "NDHWC")}[n][channel_last]
    name = f"conv{n}d"
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=fmt)
    arrays = [x, w, b] if has_bias else [x, w]

    def jfn(*a):
        return getattr(JF, name)(a[0], a[1], a[2] if has_bias else None,
                                 **kw)

    def tfn(*a):
        return getattr(F, name)(a[0], a[1], a[2] if has_bias else None,
                                **kw)

    _check_vjp(jfn, tfn, arrays)


# (spatial dims, padding, stride, output_padding, dilation, groups,
#  channels-last)
CONV_T_CASES = [
    (1, 0, 1, 0, 1, 1, False),
    (1, 1, 2, 1, 1, 1, False),
    (1, [2, 1], 2, 0, 1, 2, True),
    (2, 0, 1, 0, 1, 1, False),
    (2, 1, 2, 0, 1, 1, False),
    (2, 1, 2, 1, 1, 1, True),
    (2, [1, 2], 2, 0, 1, 2, False),
    (2, [0, 1, 2, 1], 2, 1, 1, 1, False),
    (2, [(2, 0), (0, 1)], 2, 0, 1, 1, False),
    (2, [0, 1], 2, 1, 1, 1, True),
    (2, 2, 1, 0, 2, 2, False),
    (3, 1, 2, 1, 1, 1, False),
    (3, [1, 0, 2], 1, 0, 2, 2, True),
]


@pytest.mark.parametrize("case", CONV_T_CASES,
                         ids=[f"conv{c[0]}d_transpose-{i}" for i, c in
                              enumerate(CONV_T_CASES)])
def test_conv_transpose_matches_reference(case):
    n, padding, stride, opad, dilation, groups, channel_last = case
    cin, cout, k = 4, 6, 3
    x_shape = (2, cin) + (6, 5, 4)[:n]
    if channel_last:
        x_shape = _channels_last(x_shape)
    x = _rand(x_shape, 4)
    w = _rand((cin, cout // groups) + (k,) * n, 5) * 0.3
    b = _rand((cout,), 6)
    fmt = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"),
           3: ("NCDHW", "NDHWC")}[n][channel_last]
    name = f"conv{n}d_transpose"
    kw = dict(stride=stride, padding=padding, output_padding=opad,
              dilation=dilation, groups=groups, data_format=fmt)
    _check_vjp(lambda x_, w_, b_: getattr(JF, name)(x_, w_, b_, **kw),
               lambda x_, w_, b_: getattr(F, name)(x_, w_, b_, **kw),
               [x, w, b])


def test_conv_under_o1_autocast():
    """Inside ``auto_cast`` (O1) a conv is white-listed: input, weight and
    bias run in bf16, as the reference's ``_convnd`` casts them; a
    transposed conv is not cast (the reference's does not call the
    autocast hook). bf16 outputs within the reference's 2e-2."""
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp

    x, w, b = _rand((2, 4, 9, 8), 1), _rand((8, 4, 3, 3), 2) * 0.3, \
        _rand((8,), 3)
    with jamp.auto_cast(dtype="bfloat16"):
        out_j = JF.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          padding=1)
        tj = JF.conv2d_transpose(jnp.asarray(x), jnp.asarray(
            _rand((4, 6, 3, 3), 4)), stride=2, padding=1)
    with amp.auto_cast(dtype="bfloat16"):
        out_t = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), padding=1)
        tt = F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(
            _rand((4, 6, 3, 3), 4)), stride=2, padding=1)
    assert out_t.dtype == torch.bfloat16 and str(out_j.dtype) == "bfloat16"
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    assert tt.dtype == torch.float32 and str(tj.dtype) == "float32"


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_transpose_string_padding_raises(padding):
    """The reference's lax call refuses a string pad with a stride-dilated
    input; the port refuses it too."""
    x, w = _rand((1, 4, 5, 5), 4), _rand((4, 2, 3, 3), 5)
    with pytest.raises(ValueError):
        JF.conv2d_transpose(jnp.asarray(x), jnp.asarray(w), stride=2,
                            padding=padding)
    with pytest.raises(ValueError):
        F.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                           stride=2, padding=padding)


# (kind, spatial dims, kernel, stride, padding, ceil_mode, exclusive,
#  divisor_override, channels-last)
POOL_CASES = [
    ("max", 1, 3, 2, 1, False, True, None, False),
    ("max", 1, 2, None, 0, True, True, None, False),
    ("max", 2, 3, 2, 1, False, True, None, False),
    ("max", 2, 2, None, 0, False, True, None, True),
    ("max", 2, 3, 2, 0, True, True, None, False),
    ("max", 2, 3, 2, [1, 0], True, True, None, True),
    ("max", 2, (3, 2), (2, 1), [0, 1, 2, 0], False, True, None, False),
    ("max", 2, 4, 3, 2, False, True, None, False),
    ("max", 3, 2, 2, 1, True, True, None, False),
    ("avg", 1, 3, 2, 1, False, True, None, False),
    ("avg", 1, 3, 2, 1, True, False, None, False),
    ("avg", 2, 3, 2, 1, False, True, None, False),
    ("avg", 2, 3, 2, 1, False, False, None, True),
    ("avg", 2, 3, 2, 1, True, True, None, False),
    ("avg", 2, 3, 2, 0, True, False, None, False),
    ("avg", 2, 2, None, 0, False, True, 3, False),
    ("avg", 2, (2, 3), (1, 2), [(1, 0), (0, 1)], False, True, None, False),
    ("avg", 3, 2, 2, 1, True, True, None, False),
    ("avg", 3, 3, 2, 1, False, False, None, False),
]


@pytest.mark.parametrize("case", POOL_CASES,
                         ids=[f"{c[0]}_pool{c[1]}d-{i}" for i, c in
                              enumerate(POOL_CASES)])
def test_pool_matches_reference(case):
    kind, n, k, s, p, ceil, excl, div, channel_last = case
    x_shape = (2, 3) + (9, 8, 7)[:n]
    if channel_last:
        x_shape = _channels_last(x_shape)
    x = _rand(x_shape, 7)
    fmt = {2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}.get(n, ("", ""))[
        channel_last]
    name = f"{kind}_pool{n}d"
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil)
    if kind == "avg":
        kw["exclusive"] = excl
        if n > 1:
            kw["divisor_override"] = div
    if n > 1:
        kw["data_format"] = fmt
    _check_vjp(lambda a: getattr(JF, name)(a, **kw),
               lambda a: getattr(F, name)(a, **kw), [x])


# (kind, spatial dims, kernel, stride, padding, exclusive, channels-last)
STRING_POOL_CASES = [
    ("max", 2, 3, 2, "SAME", True, False),
    ("max", 2, 3, 1, "VALID", True, True),
    ("max", 3, 3, 2, "SAME", True, True),
    ("avg", 2, 3, 2, "SAME", True, False),
    ("avg", 2, 3, 2, "SAME", False, True),
    ("avg", 3, 3, 2, "VALID", True, False),
]


def _reduce_window_pool(x, kind, n, k, s, pad, exclusive, channel_last):
    """What the reference's ``_pool`` means by a string pad
    (``functional.py:500-501``): ``lax.reduce_window`` given the string.
    The reference's own call stops before it (it concatenates the string
    to a list and raises TypeError), so the port is held to the lax
    call."""
    win = (1,) + (k,) * n + (1,) if channel_last else (1, 1) + (k,) * n
    strides = (1,) + (s,) * n + (1,) if channel_last else (1, 1) + (s,) * n
    if kind == "max":
        return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, win, strides,
                                     pad)
    summed = jax.lax.reduce_window(x, 0.0, jax.lax.add, win, strides, pad)
    if not exclusive:
        return summed / k ** n
    return summed / jax.lax.reduce_window(jnp.ones_like(x), 0.0, jax.lax.add,
                                          win, strides, pad)


@pytest.mark.parametrize("case", STRING_POOL_CASES,
                         ids=[f"{c[0]}_pool{c[1]}d-{c[4]}-{i}" for i, c in
                              enumerate(STRING_POOL_CASES)])
def test_pool_string_padding_matches_reduce_window(case):
    kind, n, k, s, pad, exclusive, channel_last = case
    x_shape = (2, 3) + (9, 8, 7)[:n]
    if channel_last:
        x_shape = _channels_last(x_shape)
    x = _rand(x_shape, 7)
    fmt = {2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}[n][channel_last]
    kw = dict(kernel_size=k, stride=s, padding=pad, data_format=fmt)
    if kind == "avg":
        kw["exclusive"] = exclusive
    _check_vjp(lambda a: _reduce_window_pool(a, kind, n, k, s, pad,
                                             exclusive, channel_last),
               lambda a: getattr(F, f"{kind}_pool{n}d")(a, **kw), [x])


# overlapping windows may pick one input twice: the reference's scatter
# (``.at[].set``) then gives its gradient to one of the duplicates and
# torch's to each, so those cases compare the unpool's values only
@pytest.mark.parametrize("k,s,p,grads", [(2, None, 0, True),
                                         (3, 3, 1, True),
                                         (3, 2, 1, False), (3, 1, 1, False),
                                         ((3, 2), (2, 1), (1, 0), False)])
def test_max_pool2d_mask_and_unpool(k, s, p, grads):
    x = _rand((2, 3, 9, 8), 8)
    out_j, idx_j = JF.max_pool2d(jnp.asarray(x), k, s, p, return_mask=True)
    out_t, idx_t = F.max_pool2d(torch.from_numpy(x), k, s, p,
                                return_mask=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **FWD)
    assert idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    up_j = JF.max_unpool2d(out_j, idx_j, k, s, p, output_size=(9, 8))
    _check_vjp(lambda a: JF.max_unpool2d(a, idx_j, k, s, p,
                                         output_size=(9, 8)),
               lambda a: F.max_unpool2d(a, idx_t, k, s, p,
                                        output_size=(9, 8)),
               [np.asarray(out_j)], grads=grads)
    assert up_j.shape == (2, 3, 9, 8)
    # the default output size
    np.testing.assert_allclose(
        F.max_unpool2d(out_t, idx_t, k, s, p).numpy(),
        np.asarray(JF.max_unpool2d(out_j, idx_j, k, s, p)), **FWD)


def _unique_indices(n_c, pooled, space, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(space, pooled, replace=False)
                     for _ in range(n_c)]).astype(np.int32)


@pytest.mark.parametrize("n", [1, 3])
def test_max_unpool_1d_3d(n):
    if n == 1:
        x = _rand((2, 3, 5), 9)
        idx = _unique_indices(6, 5, 11, 10).reshape(2, 3, 5)
        args = (3, 2, 0)
    else:
        x = _rand((2, 3, 2, 2, 3), 9)
        idx = _unique_indices(6, 12, 5 * 5 * 7, 10).reshape(2, 3, 2, 2, 3)
        args = ((3, 3, 3), 2, 0)
    name = f"max_unpool{n}d"
    _check_vjp(lambda a: getattr(JF, name)(a, jnp.asarray(idx), *args),
               lambda a: getattr(F, name)(a, torch.from_numpy(idx), *args),
               [x])


# (function, input shape, output size, data_format)
ADAPTIVE_CASES = [
    ("adaptive_avg_pool1d", (2, 3, 10), 4, None),
    ("adaptive_avg_pool1d", (2, 3, 10), 5, None),
    ("adaptive_avg_pool2d", (2, 3, 7, 9), (3, 4), "NCHW"),
    ("adaptive_avg_pool2d", (2, 3, 8, 6), (4, 3), "NCHW"),
    ("adaptive_avg_pool2d", (2, 7, 9, 3), (3, None), "NHWC"),
    ("adaptive_avg_pool2d", (2, 3, 7, 7), (1, 1), "NCHW"),
    ("adaptive_avg_pool3d", (2, 3, 5, 7, 6), (2, 3, 4), "NCDHW"),
    ("adaptive_avg_pool3d", (2, 5, 7, 6, 3), (2, None, 3), "NDHWC"),
    ("adaptive_max_pool1d", (2, 3, 10), 3, None),
    ("adaptive_max_pool2d", (2, 3, 7, 9), (3, 4), None),
    ("adaptive_max_pool2d", (2, 3, 8, 6), (2, 3), None),
    ("adaptive_max_pool3d", (2, 3, 5, 7, 6), (2, 3, 4), None),
]


@pytest.mark.parametrize("case", ADAPTIVE_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(ADAPTIVE_CASES)])
def test_adaptive_pool_matches_reference(case):
    name, shape, size, fmt = case
    x = _rand(shape, 11)
    kw = {} if fmt is None else {"data_format": fmt}
    _check_vjp(lambda a: getattr(JF, name)(a, size, **kw),
               lambda a: getattr(F, name)(a, size, **kw), [x])


def _state(jm):
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


@pytest.mark.parametrize("cls,args,x_shape", [
    ("Conv1D", (4, 6, 3), (2, 4, 9)),
    ("Conv2D", (4, 6, 3), (2, 4, 9, 8)),
    ("Conv3D", (4, 6, 3), (2, 4, 5, 6, 4)),
    ("Conv1DTranspose", (4, 6, 3), (2, 4, 5)),
    ("Conv2DTranspose", (4, 6, 3), (2, 4, 5, 4)),
    ("Conv3DTranspose", (4, 6, 3), (2, 4, 3, 4, 3)),
])
def test_conv_layers_match_reference(cls, args, x_shape):
    """The layers' parameters (names, shapes) load from the reference's
    state dict and their forwards agree; their default draws follow the
    reference's bounds (KaimingUniform over fan_in, bias ±1/sqrt(fan_in))."""
    kw = dict(stride=2, padding=1, groups=2)
    pt.seed(3)
    jm = getattr(JC, cls)(*args, **kw)
    tm = layer_from_jax(getattr(TC, cls)(*args, **kw), _state(jm))
    x = _rand(x_shape, 12)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm(jnp.asarray(x))), **FWD)
    fresh = getattr(TC, cls)(*args, **kw)
    fan_in = (args[0] // 2) * args[2] ** len(x_shape[2:])
    bound_w = np.sqrt(2.0) * np.sqrt(3.0 / fan_in)
    assert fresh.weight.abs().max() <= bound_w
    assert fresh.bias.abs().max() <= 1.0 / np.sqrt(fan_in)
    assert fresh.weight.std() > 0.4 * bound_w / np.sqrt(3.0)


@pytest.mark.parametrize("cls,args,x_shape", [
    ("MaxPool1D", (3, 2, 1), (2, 3, 9)),
    ("MaxPool2D", (3, 2, 1), (2, 3, 9, 8)),
    ("MaxPool3D", (2, 2, 0), (2, 3, 4, 6, 4)),
    ("AvgPool1D", (3, 2, 1), (2, 3, 9)),
    ("AvgPool2D", (3, 2, 1), (2, 3, 9, 8)),
    ("AvgPool3D", (2, 2, 0), (2, 3, 4, 6, 4)),
    ("AdaptiveAvgPool1D", (4,), (2, 3, 9)),
    ("AdaptiveAvgPool2D", ((3, 2),), (2, 3, 9, 8)),
    ("AdaptiveAvgPool3D", ((2, 3, 2),), (2, 3, 5, 6, 4)),
    ("AdaptiveMaxPool1D", (4,), (2, 3, 9)),
    ("AdaptiveMaxPool2D", ((3, 2),), (2, 3, 9, 8)),
    ("AdaptiveMaxPool3D", ((2, 3, 2),), (2, 3, 5, 6, 4)),
])
def test_pool_layers_match_reference(cls, args, x_shape):
    x = _rand(x_shape, 13)
    out_j = getattr(JP, cls)(*args)(jnp.asarray(x))
    out_t = getattr(TP, cls)(*args)(torch.from_numpy(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **FWD)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_unpool_layers_match_reference(n):
    shape = {1: (2, 3, 4), 2: (2, 3, 4, 3), 3: (2, 3, 2, 2, 2)}[n]
    space = {1: 8, 2: 8 * 6, 3: 4 * 4 * 4}[n]
    x = _rand(shape, 14)
    per = int(np.prod(shape[2:]))
    idx = _unique_indices(6, per, space, 15).reshape(shape)
    name = f"MaxUnPool{n}D"
    out_j = getattr(JP, name)(2)(jnp.asarray(x), jnp.asarray(idx))
    out_t = getattr(TP, name)(2)(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **FWD)

"""Shape, layout and indexing ops (port of
``paddle_tpu/ops/manipulation.py``).

Paddle's semantics over torch ops: ``squeeze`` ignores axes that are not
of size 1, ``expand`` keeps a dim given as -1, ``split`` takes one -1
section, ``pad`` takes per-dim pairs. Scatters and the ``*_`` variants
return a new tensor and leave their input as it is, as the reference's
do. Data-dependent shapes (``masked_select``, ``nonzero``, ``unique``)
are computed on the tensor's device.
"""
from __future__ import annotations

import builtins as _builtins
import itertools

import torch

from ..framework.dtype import convert_dtype
from ._common import t as _t

__all__ = [
    "reshape", "flatten", "transpose", "moveaxis", "swapaxes", "t", "concat",
    "stack", "unstack", "split", "chunk", "squeeze", "unsqueeze", "expand",
    "expand_as", "broadcast_to", "broadcast_tensors", "tile",
    "repeat_interleave", "roll", "flip", "cast", "slice", "strided_slice",
    "gather", "gather_nd", "scatter", "scatter_nd_add", "scatter_nd",
    "put_along_axis", "take_along_axis", "index_select", "index_sample",
    "masked_select", "masked_fill", "where", "nonzero", "unique",
    "unique_consecutive", "tolist", "numel", "shard_index", "as_real",
    "as_complex", "real", "imag", "conj", "pad", "unbind", "vsplit",
    "hsplit", "dsplit", "reverse", "crop", "diagonal",
    "fill_diagonal_tensor", "diagonal_scatter", "select_scatter",
    "index_fill", "take", "unfold", "as_strided", "view", "view_as",
    "moveaxis_", "reshape_", "flatten_", "squeeze_", "unsqueeze_",
    "scatter_", "put_along_axis_", "unflatten", "masked_scatter",
    "slice_scatter", "column_stack", "row_stack", "tensor_split",
    "atleast_1d", "atleast_2d", "atleast_3d", "block_diag",
    "cartesian_prod", "diag_embed", "combinations",
]


def reshape(x, shape, name=None):
    return torch.reshape(_t(x), tuple(shape))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = _t(x)
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def transpose(x, perm, name=None):
    return _t(x).permute(tuple(perm))


def moveaxis(x, source, destination, name=None):
    return torch.movedim(_t(x), source, destination)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(_t(x), axis0, axis1)


def t(x, name=None):
    x = _t(x)
    if x.ndim > 2:
        raise ValueError("paddle.t only supports tensors with ndim <= 2")
    return x.T if x.ndim == 2 else x


def _tensors(xs):
    xs = list(xs)
    first = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    return [_t(x, like=first) for x in xs]


def concat(x, axis=0, name=None):
    return torch.cat(_tensors(x), dim=axis)


def stack(x, axis=0, name=None):
    return torch.stack(_tensors(x), dim=axis)


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(_t(x), dim=axis))


def _sections(total, num_or_sections):
    sections = list(num_or_sections)
    if -1 in sections:
        known = _builtins.sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = total - known
    return sections


def split(x, num_or_sections, axis=0, name=None):
    x = _t(x)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: {total} is not divisible into "
                             f"{num_or_sections} equal sections")
        return list(torch.split(x, total // num_or_sections, dim=axis))
    return list(torch.split(x, _sections(total, num_or_sections), dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return list(torch.tensor_split(_t(x), chunks, dim=axis))


def squeeze(x, axis=None, name=None):
    x = _t(x)
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, int):
        axis = [axis]
    # paddle ignores axes that are not of size 1
    axes = tuple(a % x.ndim for a in axis if x.shape[a % x.ndim] == 1)
    return torch.squeeze(x, axes) if axes else x


def unsqueeze(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    x = _t(x)
    for a in sorted(a % (x.ndim + 1) for a in axis):
        x = torch.unsqueeze(x, a)
    return x


def expand(x, shape, name=None):
    x = _t(x)
    shape = list(shape)
    offset = len(shape) - x.ndim
    for i, s in enumerate(shape):
        if s == -1:
            shape[i] = x.shape[i - offset]
    return x.expand(tuple(shape))


def expand_as(x, y, name=None):
    return _t(x).expand(_t(y).shape)


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(_t(x), tuple(shape))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*_tensors(inputs)))


def tile(x, repeat_times, name=None):
    return torch.tile(_t(x), tuple(repeat_times))


def repeat_interleave(x, repeats, axis=None, name=None):
    x = _t(x)
    if not isinstance(repeats, int):
        repeats = _t(repeats, like=x)
    return torch.repeat_interleave(x, repeats, dim=axis)


def roll(x, shifts, axis=None, name=None):
    if isinstance(shifts, (list, tuple)):
        shifts = tuple(shifts)
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    if axis is None:
        return torch.roll(_t(x), shifts)
    return torch.roll(_t(x), shifts, axis)


def flip(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(_t(x), tuple(axis))


def cast(x, dtype):
    return _t(x).to(convert_dtype(dtype))


def slice(x, axes, starts, ends):  # noqa: A001 - paddle name
    x = _t(x)
    idx = [_builtins.slice(None)] * x.ndim
    for a, s, e in zip(axes, starts, ends):
        idx[a] = _builtins.slice(s, e)
    return x[tuple(idx)]


def _strided(x, axes, starts, ends, strides):
    """``x[starts:ends:strides]`` along ``axes``; a negative stride walks
    backwards, as numpy's does (torch slicing takes none)."""
    for a, s, e, st in zip(axes, starts, ends, strides):
        n = x.shape[a]
        idx = range(n)[_builtins.slice(s, e, st)]
        x = x.index_select(a, torch.as_tensor(list(idx), dtype=torch.long,
                                              device=x.device))
    return x


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _strided(_t(x), axes, starts, ends, strides)


def gather(x, index, axis=0, name=None):
    x = _t(x)
    index = _t(index, like=x).long()
    out = x.index_select(axis, index.reshape(-1))
    shape = list(x.shape)
    shape[axis:axis + 1] = list(index.shape)
    return out.reshape(shape)


def _index_tuple(index):
    return tuple(torch.movedim(index, -1, 0).long())


def gather_nd(x, index, name=None):
    x = _t(x)
    return x[_index_tuple(_t(index, like=x))]


def scatter(x, index, updates, overwrite=True, name=None):
    x = _t(x)
    index = _t(index, like=x).long()
    updates = _t(updates, like=x).to(x.dtype)
    if overwrite:
        return x.index_put((index,), updates)
    # paddle overwrite=False: zero the rows, then accumulate
    zeroed = x.index_put((index,), torch.zeros_like(updates))
    return zeroed.index_put((index,), updates, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x = _t(x)
    updates = _t(updates, like=x).to(x.dtype)
    return x.index_put(_index_tuple(_t(index, like=x)), updates,
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    updates = _t(updates)
    zeros = torch.zeros(tuple(shape), dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


def put_along_axis(arr, indices, values, axis, reduce="assign"):
    arr = _t(arr)
    indices = _t(indices, like=arr).long()
    values = torch.broadcast_to(_t(values, like=arr).to(arr.dtype),
                                indices.shape)
    if reduce == "assign":
        return arr.scatter(axis, indices, values)
    if reduce == "add":
        return arr.scatter_add(axis, indices, values)
    if reduce in ("multiply", "mul"):
        return arr.scatter_reduce(axis, indices, values, "prod")
    raise ValueError(f"unknown reduce: {reduce}")


def take_along_axis(arr, indices, axis):
    arr = _t(arr)
    return torch.take_along_dim(arr, _t(indices, like=arr).long(), dim=axis)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis=axis)


def index_sample(x, index):
    return take_along_axis(x, index, 1)


def masked_select(x, mask, name=None):
    x = _t(x)
    return x[_t(mask, like=x).bool()]


def masked_fill(x, mask, value, name=None):
    x = _t(x)
    value = _t(value, like=x).to(x.dtype)
    return torch.where(_t(mask, like=x).bool(), value, x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    condition = _t(condition)
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = _t(x, like=condition)
    return torch.where(condition.bool(), x, y)


def nonzero(x, as_tuple=False):
    x = _t(x)
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, name=None):
    x = _t(x)
    if axis is None:
        x = x.reshape(-1)
    vals, inverse, counts = torch.unique(
        x, sorted=True, return_inverse=True, return_counts=True,
        dim=None if axis is None else axis)
    out = [vals]
    if return_index:
        # the first position of each value
        n = inverse.shape[0]
        pos = torch.arange(n, device=x.device)
        first = torch.full((counts.shape[0],), n, dtype=torch.long,
                           device=x.device)
        out.append(first.scatter_reduce(0, inverse, pos, "amin"))
    if return_inverse:
        out.append(inverse)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    x = _t(x)
    if axis is None:
        x = x.reshape(-1)
    res = torch.unique_consecutive(x, return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    return tuple(res) if isinstance(res, tuple) else res


def tolist(x):
    return _t(x).tolist()


def numel(x, name=None):
    x = _t(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):  # noqa: A002
    """The vocab-shard remap of tensor parallelism's embedding."""
    x = _t(input)
    shard_size = (index_num + nshards - 1) // nshards
    lo = shard_id * shard_size
    in_shard = (x >= lo) & (x < lo + shard_size)
    return torch.where(in_shard, x - lo, torch.full_like(x, ignore_value))


def as_real(x, name=None):
    return torch.view_as_real(_t(x)).clone()


def as_complex(x, name=None):
    x = _t(x)
    return torch.complex(x[..., 0], x[..., 1])


def real(x, name=None):
    x = _t(x)
    return torch.real(x).clone() if x.is_complex() else x


def imag(x, name=None):
    x = _t(x)
    return torch.imag(x).clone() if x.is_complex() else torch.zeros_like(x)


def conj(x, name=None):
    return torch.conj(_t(x)).resolve_conj()


def _pad_index(n, lo, hi, mode, device):
    """The source index of each position of a dim of size ``n`` padded by
    ``(lo, hi)`` in ``mode`` (numpy's ``reflect``/``edge``/``wrap``)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    period = 2 * (n - 1)  # reflect, the edge not repeated
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):  # noqa: A002
    """``pad`` gives (low, high) per dim: all dims when its length is
    twice ``x.ndim`` (``[d0_lo, d0_hi, d1_lo, ...]``), else the spatial
    dims of ``data_format``, innermost pair first."""
    x = _t(x)
    pad = list(pad)
    if len(pad) == 2 * x.ndim:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.ndim)]
    else:
        n_spatial = len(pad) // 2
        width = [(0, 0)] * x.ndim
        if data_format.endswith("C"):  # NHWC / NLC / NDHWC
            spatial_axes = list(range(1, 1 + n_spatial))
        else:  # NCHW / NCL / NCDHW
            spatial_axes = list(range(x.ndim - n_spatial, x.ndim))
        for i, ax in enumerate(reversed(spatial_axes)):
            width[ax] = (pad[2 * i], pad[2 * i + 1])
    mode = {"constant": "constant", "reflect": "reflect",
            "replicate": "edge", "circular": "wrap"}[mode]
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, mode="constant", value=value)
    for ax, (lo, hi) in enumerate(width):
        if lo or hi:
            x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                              x.device))
    return x


def unbind(x, axis=0, name=None):
    return list(torch.unbind(_t(x), dim=axis))


def vsplit(x, num_or_indices, name=None):
    return list(torch.vsplit(_t(x), num_or_indices))


def hsplit(x, num_or_indices, name=None):
    return list(torch.hsplit(_t(x), num_or_indices))


def dsplit(x, num_or_indices, name=None):
    return list(torch.dsplit(_t(x), num_or_indices))


def reverse(x, axis, name=None):
    return flip(x, axis)


def crop(x, shape=None, offsets=None, name=None):
    """Slice ``shape`` starting at ``offsets`` (-1 in shape: to the end)."""
    x = _t(x)
    offsets = list(offsets) if offsets is not None else [0] * x.ndim
    shape = list(shape) if shape is not None else list(x.shape)
    idx = tuple(_builtins.slice(o, x.shape[i] if s == -1 else o + s)
                for i, (o, s) in enumerate(zip(offsets, shape)))
    return x[idx]


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_t(x), offset, axis1, axis2)


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``x`` with ``y`` written onto its (dim1, dim2) diagonal."""
    out = _t(x).clone()
    out.diagonal(offset, dim1, dim2).copy_(_t(y, like=out).to(out.dtype))
    return out


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return fill_diagonal_tensor(x, y, offset=offset, dim1=axis1, dim2=axis2)


def select_scatter(x, values, axis, index, name=None):
    """``values`` embedded at position ``index`` along ``axis``."""
    x = _t(x)
    return torch.select_scatter(x, _t(values, like=x).to(x.dtype), axis,
                                index)


def index_fill(x, index, axis, value, name=None):
    x = _t(x)
    return x.index_fill(axis % x.ndim, _t(index, like=x).long(), value)


def take(x, index, mode="raise", name=None):
    """Gather from the flattened ``x``; ``wrap`` wraps an index, ``raise``
    and ``clip`` clamp it (no data-dependent error, as the reference)."""
    x = _t(x).reshape(-1)
    index = _t(index, like=x).long()
    n = x.shape[0]
    index = index % n if mode == "wrap" else index.clamp(-n, n - 1)
    return x[index]


def unfold(x, axis, size, step, name=None):
    """Sliding windows along ``axis``, the window as a new trailing dim."""
    return _t(x).unfold(axis, size, step)


def as_strided(x, shape, stride, offset=0, name=None):
    """The elements a strided view of the flattened ``x`` would alias, as
    a new tensor."""
    x = _t(x).contiguous().reshape(-1)
    return torch.as_strided(x, tuple(shape), tuple(stride), offset).clone()


def view(x, shape_or_dtype, name=None):
    """A reshape (list/tuple) or a bitcast (dtype) that scales the last dim
    by the itemsize ratio, as paddle's does."""
    x = _t(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(tuple(shape_or_dtype))
    dt = convert_dtype(shape_or_dtype)
    ratio = dt.itemsize / x.dtype.itemsize
    if ratio > 1 and x.shape[-1] % int(ratio):
        raise ValueError(f"view: last dim {x.shape[-1]} not divisible by "
                         f"itemsize ratio {int(ratio)}")
    return x.contiguous().view(dt)


def view_as(x, other, name=None):
    return _t(x).reshape(_t(other).shape)


def moveaxis_(x, source, destination, name=None):
    return moveaxis(x, source, destination)


def reshape_(x, shape, name=None):
    return reshape(x, shape)


def flatten_(x, start_axis=0, stop_axis=-1, name=None):
    return flatten(x, start_axis=start_axis, stop_axis=stop_axis)


def squeeze_(x, axis=None, name=None):
    return squeeze(x, axis=axis)


def unsqueeze_(x, axis, name=None):
    return unsqueeze(x, axis)


def scatter_(x, index, updates, overwrite=True, name=None):
    return scatter(x, index, updates, overwrite=overwrite)


def put_along_axis_(arr, indices, values, axis, reduce="assign"):
    return put_along_axis(arr, indices, values, axis, reduce=reduce)


def unflatten(x, axis, shape, name=None):
    """Split one dim into ``shape`` (one -1 is inferred)."""
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError("unflatten shape can have at most one -1")
    return torch.unflatten(_t(x), axis, shape)


def masked_scatter(x, mask, value, name=None):
    """The masked positions of ``x`` filled with consecutive elements of
    ``value`` in row-major order."""
    x = _t(x)
    mask = torch.broadcast_to(_t(mask, like=x).bool(), x.shape)
    vals = _t(value, like=x).reshape(-1).to(x.dtype)
    needed = int(mask.sum())
    if needed > vals.numel():
        raise ValueError(f"masked_scatter: mask selects {needed} elements "
                         f"but value has only {vals.numel()}")
    return x.masked_scatter(mask, vals)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    """``value`` embedded into the strided slice of ``x``."""
    x = _t(x).clone()
    idx = [_builtins.slice(None)] * x.ndim
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[int(ax)] = _builtins.slice(int(st), int(en), int(sd))
    x[tuple(idx)] = _t(value, like=x).to(x.dtype)
    return x


def column_stack(x, name=None):
    return torch.column_stack(_tensors(x))


def row_stack(x, name=None):
    return torch.vstack(_tensors(x))


def tensor_split(x, num_or_indices, axis=0, name=None):
    """Uneven sections, as numpy's ``array_split``."""
    return list(torch.tensor_split(_t(x), num_or_indices, dim=axis))


def _atleast(fn):
    def op(*inputs, name=None):
        out = [fn(_t(x)) for x in inputs]
        return out[0] if len(out) == 1 else out

    return op


atleast_1d = _atleast(torch.atleast_1d)
atleast_2d = _atleast(torch.atleast_2d)
atleast_3d = _atleast(torch.atleast_3d)


def block_diag(inputs, name=None):
    return torch.block_diag(*[torch.atleast_2d(x) for x in _tensors(inputs)])


def cartesian_prod(x, name=None):
    """Cartesian product of 1-D tensors, one row per combination."""
    arrs = [a.reshape(-1) for a in _tensors(x)]
    grids = torch.meshgrid(*arrs, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):  # noqa: A002
    return torch.diag_embed(_t(input), offset, dim1, dim2)


def combinations(x, r=2, with_replacement=False, name=None):
    """All r-combinations of a 1-D tensor."""
    x = _t(x).reshape(-1)
    picker = (itertools.combinations_with_replacement if with_replacement
              else itertools.combinations)
    idx = list(picker(range(x.shape[0]), int(r)))
    if not idx:
        return x.new_zeros((0, int(r)))
    return x[torch.as_tensor(idx, dtype=torch.long, device=x.device)]

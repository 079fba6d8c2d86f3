"""The ``sequence_*`` ops over a padded batch and its lengths (port of
``paddle_tpu/ops/sequence.py``).

A ragged batch is the pair (padded ``[B, T, ...]`` tensor, lengths
``[B]``). ``sequence_pad`` builds the pair from Python sequences (or a
flat tensor and its lengths) on the host, in one buffer; the other ops
are mask arithmetic on the pair, on its device, except those whose output
shape depends on the lengths (``sequence_unpad``, ``sequence_expand``,
``sequence_concat``), which read the lengths back.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._common import device_of, t

__all__ = [
    "sequence_pad", "sequence_unpad", "sequence_pool", "sequence_softmax",
    "sequence_reverse", "sequence_expand", "sequence_expand_as",
    "sequence_first_step", "sequence_last_step", "sequence_concat",
]


def _valid_mask(lengths, maxlen: int):
    """[B, T] bool, True inside each row's valid prefix."""
    return torch.arange(maxlen, device=lengths.device)[None, :] < \
        lengths[:, None]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def sequence_pad(x, pad_value=0.0, maxlen: Optional[int] = None,
                 lengths=None, name=None):
    """Ragged to ``(padded [B, T, ...], lengths [B])``: from a list of
    per-sequence arrays, or a flat ``[sum(L), ...]`` array and
    ``lengths``."""
    device = device_of(x, lengths)
    if lengths is not None:
        flat = _host(x)
        lengths = _host(lengths).astype(np.int64).reshape(-1)
        offs = np.concatenate([[0], np.cumsum(lengths)])
        seqs = [flat[int(offs[i]):int(offs[i + 1])]
                for i in range(lengths.size)]
    else:
        seqs = [_host(s) for s in x]
        lengths = np.asarray([s.shape[0] for s in seqs], np.int64)
    T = int(maxlen) if maxlen is not None else int(lengths.max(initial=0))
    feat = seqs[0].shape[1:] if seqs else ()
    out = np.full((len(seqs), T) + feat, pad_value,
                  seqs[0].dtype if seqs else np.float32)
    for i, s in enumerate(seqs):
        n = min(int(lengths[i]), T)
        out[i, :n] = s[:n]
    return (torch.as_tensor(out, device=device),
            torch.as_tensor(np.minimum(lengths, T), device=device))


def sequence_unpad(x, lengths, name=None) -> List[torch.Tensor]:
    """``(padded, lengths)`` to the list of per-sequence tensors."""
    x = t(x)
    return [x[i, :int(n)] for i, n in enumerate(_host(lengths).reshape(-1))]


def _lengths(lengths, like):
    return t(lengths, like=like).reshape(-1)


def sequence_pool(x, lengths, pool_type: str = "sum", name=None):
    """Masked pooling over the time axis."""
    x = t(x)
    lengths = _lengths(lengths, x)
    B, T = x.shape[0], x.shape[1]
    mask = _valid_mask(lengths, T)
    fmask = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    pool_type = pool_type.lower()
    if pool_type == "sum":
        return torch.sum(torch.where(fmask, x, zero), dim=1)
    if pool_type in ("average", "mean"):
        denom = torch.clamp(lengths, min=1).reshape((B,) + (1,) * (x.ndim - 2))
        return torch.sum(torch.where(fmask, x, zero), dim=1) / denom
    if pool_type == "sqrt":
        denom = torch.sqrt(torch.clamp(lengths, min=1).to(x.dtype))
        denom = denom.reshape((B,) + (1,) * (x.ndim - 2))
        return torch.sum(torch.where(fmask, x, zero), dim=1) / denom
    if pool_type == "max":
        neg = torch.tensor(-float("inf") if x.is_floating_point()
                           else torch.iinfo(x.dtype).min,
                           dtype=x.dtype, device=x.device)
        return torch.amax(torch.where(fmask, x, neg), dim=1)
    if pool_type == "first":
        return sequence_first_step(x, lengths)
    if pool_type == "last":
        return sequence_last_step(x, lengths)
    raise ValueError(f"unknown pool_type {pool_type!r}")


def sequence_first_step(x, lengths=None, name=None):
    return t(x)[:, 0]


def sequence_last_step(x, lengths, name=None):
    x = t(x)
    idx = torch.clamp(_lengths(lengths, x) - 1, min=0).long()
    return torch.take_along_dim(
        x, idx.reshape((-1, 1) + (1,) * (x.ndim - 2)), dim=1).squeeze(1)


def sequence_softmax(x, lengths, name=None):
    """Softmax over each row's valid prefix; padding gets 0."""
    x = t(x)
    if not x.is_floating_point():
        x = x.float()
    mask = _valid_mask(_lengths(lengths, x), x.shape[1])
    mask = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
    z = torch.where(mask, x, torch.tensor(-float("inf"), dtype=x.dtype,
                                          device=x.device))
    p = torch.softmax(z, dim=1)
    return torch.where(mask, p, torch.zeros((), dtype=p.dtype,
                                            device=p.device))


def sequence_reverse(x, lengths, name=None):
    """Each row's valid prefix reversed; padding stays put."""
    x = t(x)
    lengths = _lengths(lengths, x)
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)[None, :]
    src = torch.where(pos < lengths[:, None], lengths[:, None] - 1 - pos, pos)
    return torch.take_along_dim(
        x, src.reshape(src.shape + (1,) * (x.ndim - 2)).long(), dim=1)


def sequence_expand(x, ref_lengths, name=None):
    """Row i of ``x`` repeated ``ref_lengths[i]`` times."""
    x = t(x)
    reps = _lengths(ref_lengths, x).long()
    return torch.repeat_interleave(x, reps, dim=0)


def sequence_expand_as(x, y_lengths, name=None):
    return sequence_expand(x, y_lengths)


def sequence_concat(inputs: Sequence, lengths_list: Sequence, name=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise concatenation of (padded, lengths) pairs: row b is
    ``input0[b][:l0] ++ input1[b][:l1] ++ ...``."""
    arrs = [_host(a) for a in inputs]
    lens = [_host(n).reshape(-1) for n in lengths_list]
    device = device_of(list(inputs))
    B = arrs[0].shape[0]
    total = sum(n.astype(np.int64) for n in lens)
    T = int(total.max(initial=0))
    out = np.zeros((B, T) + arrs[0].shape[2:], arrs[0].dtype)
    for b in range(B):
        pos = 0
        for a, n in zip(arrs, lens):
            k = int(n[b])
            out[b, pos:pos + k] = a[b, :k]
            pos += k
    return (torch.as_tensor(out, device=device),
            torch.as_tensor(total, device=device))

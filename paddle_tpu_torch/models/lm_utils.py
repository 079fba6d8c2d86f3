"""Shared decoder plumbing for the serving and training paths (port of
``paddle_tpu/models/lm_utils.py``): attention, the KV cache, the block
stack with recompute, and the chunked LM loss.

The KV cache is a tuple (one entry per layer) of ``(k, v)`` tensors,
each ``[B, max_length, n_kv_heads, head_dim]``. Where the JAX package
returned an updated copy of the cache (and donated the old buffers), the
port writes into the preallocated tensors in place and returns the same
tensors, so callers keep the reference's ``(out, cache)`` contract.
The int8 cache of the reference is not ported yet.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.parallel.recompute import recompute_wrap
from ..kernels import flash_attention as fa
from ..nn import functional as F
from ..nn.layer import take_rng_key

__all__ = ["chunked_lm_loss", "causal_attention", "repeat_kv",
           "update_kv_cache", "cached_attention", "attend_with_cache",
           "cached_lm_forward", "DecoderBlockList"]


def causal_attention(q, k, v, dropout_p: float = 0.0, training: bool = True,
                     use_flash: bool = True):
    """Causal self-attention on ``[B, L, H, D]``: the flash kernels when
    the gate allows (CUDA tensors), the plain softmax otherwise. With
    dropout, the kernel's Philox seed is drawn from the "dropout" stream
    (``lm_utils.py:47-51``); the plain path draws its mask there too.

    The plain path masks bottom-right aligned (``tril(k=Lk-Lq)``) with
    ``finfo.min``, exactly as the reference; the kernel is top-left
    aligned. The two agree when ``Lq == Lk`` (prefill and training)."""
    p_drop = dropout_p if training else 0.0
    if use_flash and fa.should_use_flash(q, k, None, p_drop):
        # the reference draws randint(key, (), 0, 2**31 - 1)
        seed = take_rng_key("dropout") % (2 ** 31 - 1) if p_drop > 0.0 else 0
        return fa.flash_attention_blhd(q, k, v, causal=True,
                                       dropout_p=p_drop, seed=seed)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril(Lk - Lq)
    s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    if p_drop > 0.0:
        p = F.dropout(p, p=p_drop, training=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# ------------------------------------------------------------- KV cache
def repeat_kv(x, groups: int):
    """``[B, L, Hkv, D] -> [B, L, Hkv*groups, D]`` for GQA (each kv head
    serves ``groups`` consecutive query heads)."""
    if groups == 1:
        return x
    return torch.repeat_interleave(x, groups, dim=2)


def _write_window(buf, new, pos):
    """Write ``new`` ``[B, L, ...]`` into ``buf`` along the length axis at
    ``pos``: a Python int (one slice assignment) or a per-row ``[B]``
    tensor (one indexed write). Starts clamp so the window fits, as
    ``dynamic_update_slice`` does in the reference."""
    L, S = new.shape[1], buf.shape[1]
    new = new.to(buf.dtype)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        start = pos.to(device=buf.device, dtype=torch.long).clamp(0, S - L)
        idx = start[:, None] + torch.arange(L, device=buf.device)
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows, idx] = new
    else:
        start = min(max(int(pos), 0), S - L)
        buf[:, start:start + L] = new
    return buf


def update_kv_cache(cache, k_new, v_new, position_offset):
    """Write ``k_new``/``v_new`` ``[B, L, Hkv, D]`` into the ``(k, v)``
    cache pair at ``position_offset`` (an int, or a per-row ``[B]``
    tensor for the continuous-batching decode step). The cache is stored
    in its own dtype (cast on write) and updated in place."""
    k_cache, v_cache = cache
    return (_write_window(k_cache, k_new, position_offset),
            _write_window(v_cache, v_new, position_offset))


def cached_attention(q, k_cache, v_cache, position_offset):
    """Attention of ``q`` ``[B, L, H, D]`` against the FULL cache
    ``[B, S, Hkv, D]`` with a position mask: the query at absolute
    position ``position_offset + i`` sees keys at positions
    ``<= position_offset + i`` only, so stale or padded cache entries
    beyond a row's frontier never leak in. ``position_offset`` is an int
    or a per-row ``[B]`` tensor. The cache is upcast to q's dtype on read;
    GQA is a grouped einsum (kv heads are never repeated)."""
    B, L, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    groups = H // Hkv
    qg = q.reshape(B, L, Hkv, groups, D)
    s = torch.einsum("blhgd,bshd->bhgls", qg, k_cache.to(q.dtype))
    s = s * (1.0 / math.sqrt(D))
    steps = torch.arange(L, device=q.device)
    if isinstance(position_offset, torch.Tensor):
        qpos = position_offset.to(device=q.device,
                                  dtype=torch.long).reshape(-1, 1) + steps
    else:
        qpos = (steps + int(position_offset))[None]          # [B|1, L]
    allowed = (torch.arange(S, device=q.device)[None, None, :]
               <= qpos[:, :, None])                          # [B|1, L, S]
    s = s.masked_fill(~allowed[:, None, None], torch.finfo(s.dtype).min)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgls,bshd->blhgd", p, v_cache.to(q.dtype))
    return out.reshape(B, L, H, D)


def attend_with_cache(q, k_new, v_new, cache, position_offset,
                      use_flash: bool = True):
    """The cached-decode attention dispatch: always writes ``k_new``/
    ``v_new`` into the cache; the PREFILL shape (several tokens at int
    offset 0) attends block-locally through :func:`causal_attention` (the
    flash kernel on the card); every other shape (one-token decode)
    attends the full cache through :func:`cached_attention`. Returns
    ``(out, (k_cache, v_cache))``."""
    cache = update_kv_cache(cache, k_new, v_new, position_offset)
    is_prefill = (q.shape[1] > 1 and isinstance(position_offset, int)
                  and position_offset == 0)
    if is_prefill:
        groups = q.shape[2] // k_new.shape[2]
        out = causal_attention(q, repeat_kv(k_new, groups),
                               repeat_kv(v_new, groups), dropout_p=0.0,
                               training=False, use_flash=use_flash)
    else:
        out = cached_attention(q, cache[0], cache[1], position_offset)
    return out, cache


def cached_lm_forward(backbone, logits_fn, input_ids, cache,
                      position_offset, gather_last):
    """The serving-side CausalLM forward: run the backbone (cache-threaded
    when given), optionally keep only position ``gather_last`` BEFORE the
    head projection (so serving never materialises ``[B, L, vocab]``),
    and return ``logits`` or ``(logits, cache)``."""
    h = backbone(input_ids, cache=cache, position_offset=position_offset)
    if cache is not None:
        h, cache = h
    if gather_last is not None:
        h = h[:, gather_last:gather_last + 1]
    logits = logits_fn(h)
    return logits if cache is None else (logits, cache)


class DecoderBlockList(nn.Module):
    """N decoder blocks named ``"0" .. "N-1"`` (the reference's
    parameter paths). With ``cfg.use_recompute`` each block's activations
    are recomputed in the backward pass (``cfg.recompute_policy``). With
    ``caches`` (a per-layer tuple of ``(k, v)`` pairs) each block runs its
    cached path and the caches ride back alongside the activations."""

    def __init__(self, cfg, block_cls, **block_kwargs):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            self.add_module(str(i), block_cls(cfg, **block_kwargs))

    def forward(self, x, caches=None, position_offset=0):
        if caches is None:
            recompute = getattr(self.cfg, "use_recompute", False)
            policy = getattr(self.cfg, "recompute_policy", None)
            for blk in self.children():
                x = (recompute_wrap(blk, policy=policy) if recompute
                     else blk)(x)
            return x
        new_caches = []
        for blk, cache in zip(self.children(), caches):
            x, cache = blk(x, cache=cache, position_offset=position_offset)
            new_caches.append(cache)
        return x, tuple(new_caches)


def chunked_lm_loss(h, labels, logits_fn, ce, chunk: int = 256):
    """Shifted next-token loss over ``h`` ``[B, L, hidden]`` without the
    full ``[B, L, vocab]`` logits (``lm_utils.py:229``).

    ``logits_fn(h_chunk)`` is the head projection and ``ce(logits,
    labels)`` the per-token loss; labels are shifted here and label -100
    is ignored. Each sequence chunk's head and loss run under
    ``torch.utils.checkpoint``, so only one chunk's logits exist at a time
    in the forward and again in the backward. The reference pads the last
    chunk with ignored labels; the port runs it short, which sums the same
    per-token losses. Returns the float32 mean over the counted tokens."""
    hs = h[:, :-1]
    ys = torch.as_tensor(labels, device=h.device)[:, 1:]

    def chunk_losses(h_c, y_c):
        per_tok = ce(logits_fn(h_c), y_c)
        valid = (y_c != -100).to(torch.float32)
        return (per_tok * valid).sum(), valid.sum()

    total = torch.zeros((), device=h.device, dtype=torch.float32)
    count = torch.zeros((), device=h.device, dtype=torch.float32)
    for start in range(0, hs.shape[1], chunk):
        h_c, y_c = hs[:, start:start + chunk], ys[:, start:start + chunk]
        if torch.is_grad_enabled():
            s, c = checkpoint(chunk_losses, h_c, y_c, use_reentrant=False)
        else:
            s, c = chunk_losses(h_c, y_c)
        total = total + s
        count = count + c
    return total / torch.clamp(count, min=1.0)

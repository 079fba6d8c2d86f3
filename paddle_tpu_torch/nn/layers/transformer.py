"""Transformer layers (port of ``paddle_tpu/nn/layers/transformer.py``):
``MultiHeadAttention``, the encoder and decoder layers and stacks, and
``Transformer``, on the ``[batch, seq, hidden]`` layout.

Attention goes through :func:`paddle_tpu_torch.nn.functional.
scaled_dot_product_attention`, which takes the flash kernels for CUDA
tensors at a routed head dim (non-causal, a mask as a bias, ``Lq != Lk``
in cross-attention) and the plain softmax otherwise. Both pre-LN and
post-LN (``normalize_before``) are kept. ``TransformerEncoder`` and
``TransformerDecoder`` deep-copy the layer they are given, so every layer
of a stack starts with the same weights (the reference's behaviour).

The layers that make parameters take ``device`` (``None`` means ``cuda``
and raises without one: pass ``device="cpu"``) and ``generator`` (the
``torch.Generator`` the weights are drawn from; without one each
parameter draws from the port's global seed).
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ... import default_device
from .. import functional as F
from .common import Dropout, Linear
from .containers import LayerList
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(nn.Module):
    """q, k, v and output projections around scaled dot-product
    attention. ``forward(query, key=None, value=None, attn_mask=None,
    cache=None)``: key and value default to the query (self-attention);
    with ``cache = (k, v)`` (``[B, L, heads, head_dim]``, e.g.
    :meth:`gen_cache`) the new keys and values are appended to it and
    ``(out, (k, v))`` is returned."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        device = default_device(device)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _split_heads(self, x):
        B, L, _ = x.shape
        return x.reshape(B, L, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        B, L = out.shape[:2]
        out = self.out_proj(out.reshape(B, L, self.embed_dim))
        if cache is not None:
            return out, (k, v)
        return out

    @staticmethod
    def gen_cache(k, v):
        return (k, v)


def _dropout_or(value, default):
    return value if value is not None else default


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a feed-forward block, each with a residual and
    a LayerNorm, after (post-LN, the default) or before
    (``normalize_before=True``) the sublayer."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, generator=None):
        super().__init__()
        device = default_device(device)
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=_dropout_or(attn_dropout, dropout),
            weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(_dropout_or(act_dropout, dropout))
        self._activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        act = getattr(F, self._activation)
        src = self.linear2(self.dropout2(act(self.linear1(src))))
        src = residual + self.dropout(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself, the rest deep copies of it), then ``norm`` when given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention over the encoder's ``memory`` and
    a feed-forward block, each with a residual and a LayerNorm (post-LN,
    or pre-LN with ``normalize_before=True``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, generator=None):
        super().__init__()
        device = default_device(device)
        kw = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        attn_drop = _dropout_or(attn_dropout, dropout)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_drop, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_drop, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(_dropout_or(act_dropout, dropout))
        self._activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, attn_mask=tgt_mask)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        act = getattr(F, self._activation)
        tgt = self.linear2(self.dropout3(act(self.linear1(tgt))))
        tgt = residual + self.dropout(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(nn.Module):
    """``num_layers`` copies of ``decoder_layer`` (deep copies after the
    first), then ``norm`` when given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(nn.Module):
    """Encoder-decoder Transformer; the defaults are Transformer-base
    (d_model 512, 8 heads, 6 + 6 layers, FFN 2048, ReLU, dropout 0.1),
    each stack closed by a LayerNorm. ``forward(src, tgt, src_mask=None,
    tgt_mask=None, memory_mask=None)`` returns the decoder's output."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 generator=None):
        super().__init__()
        device = default_device(device)
        kw = dict(device=device, generator=generator)
        layer_args = (d_model, nhead, dim_feedforward, dropout, activation,
                      attn_dropout, act_dropout, normalize_before,
                      weight_attr, bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*layer_args, **kw),
                num_encoder_layers, LayerNorm(d_model, device=device))
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*layer_args, **kw),
                num_decoder_layers, LayerNorm(d_model, device=device))
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The float32 ``[length, length]`` causal mask: 0 on and below
        the diagonal, ``-inf`` above."""
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=default_device(device)).tril()
        return torch.zeros(keep.shape, device=keep.device).masked_fill(
            ~keep, float("-inf"))

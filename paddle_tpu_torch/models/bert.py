"""BERT model family (port of ``paddle_tpu/models/bert.py``):
word + position + token-type embeddings, a post-LN encoder stack, a tanh
pooler, and the sequence-classification and pretraining (masked LM +
next sentence) heads.

Attention here is plain PyTorch on purpose, not a fallback: the
reference computes it with einsum and softmax outside any Pallas kernel
(``bert.py:90-117``), as XLA-lowered code, so the port computes it with
ordinary torch ops: a ``[B, L]`` 1/0 padding mask as a ``-1e9`` additive
bias, softmax in the scores' dtype. The scores' dtype is float32 for
every floating input: the reference divides them by ``np.sqrt(head_dim)``,
a float64 NumPy scalar, which JAX's promotion turns into float32, so from
the first attention on a bf16 O2 model computes in float32 against its
bf16 weights (``F.linear`` promotes as ``jnp.matmul`` does). The port
keeps that.

Parameter paths and layouts are the reference's, so a JAX
``state_dict()`` loads by name (:func:`paddle_tpu_torch.convert.
bert_from_jax`). Entry points take ``device`` (``None`` means ``cuda``,
raising without one; pass ``device="cpu"``) and ``generator`` (the
``torch.Generator`` the weights are drawn from; without one each draws
from the port's global seed).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import default_device
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layers.common import Dropout, Embedding, Linear
from ..nn.layers.containers import LayerList
from ..nn.layers.norm import LayerNorm

__all__ = ["BertConfig", "bert_tiny", "bert_base", "BertEmbeddings",
           "BertSelfAttention", "BertLayer", "BertPooler", "BertModel",
           "BertForSequenceClassification", "BertForPretraining"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None  # default 4*hidden
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02
    pad_token_id: int = 0

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size


def bert_tiny(**kw) -> BertConfig:
    return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                      num_heads=4, max_position_embeddings=128, **kw)


def bert_base(**kw) -> BertConfig:
    """BERT-base: 30522 word pieces, hidden 768, 12 layers of 12 heads,
    FFN 3072, 512 positions, 2 token types."""
    return BertConfig(**kw)


def _init(cfg):
    return Normal(std=cfg.initializer_range)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None, generator=None):
        super().__init__()
        kw = dict(weight_attr=_init(cfg), device=device, generator=generator)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_epsilon,
                                    device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def _embed_sum(self, input_ids, token_type_ids):
        """The input sum subclasses extend (ERNIE adds a task addend)."""
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        return (self.word_embeddings(input_ids)
                + self.position_embeddings(pos)
                + self.token_type_embeddings(token_type_ids))

    def forward(self, input_ids, token_type_ids=None):
        h = self._embed_sum(input_ids, token_type_ids)
        return self.dropout(self.layer_norm(h))


class BertSelfAttention(nn.Module):
    """Fused qkv projection, plain softmax attention (see the module
    docstring), output projection."""

    def __init__(self, cfg: BertConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(weight_attr=_init(cfg), device=device, generator=generator)
        self.qkv = Linear(h, 3 * h, **kw)
        self.out = Linear(h, h, **kw)
        self.attn_drop = Dropout(cfg.attention_dropout_prob)

    def forward(self, x, attention_mask=None):
        B, L, H = x.shape
        nh = self.cfg.num_heads
        hd = H // nh
        q, k, v = (t.reshape(B, L, nh, hd).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k)
        # the reference's float64 NumPy divisor promotes the scores to
        # float32 (module docstring)
        s = s.to(torch.promote_types(s.dtype, torch.float32)) \
            / math.sqrt(hd)
        if attention_mask is not None:
            # [B, L] 1/0 padding mask -> additive bias
            keep = attention_mask[:, None, None, :].to(s.dtype)
            s = s + (1.0 - keep) * torch.tensor(-1e9, dtype=s.dtype,
                                                device=s.device)
        p = self.attn_drop(torch.softmax(s, dim=-1))
        o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(p.dtype))
        return self.out(o.transpose(1, 2).reshape(B, L, H))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.attention = BertSelfAttention(cfg, **kw)
        self.attn_norm = LayerNorm(cfg.hidden_size,
                                   epsilon=cfg.layer_norm_epsilon,
                                   device=device)
        self.fc1 = Linear(cfg.hidden_size, cfg.ffn_size,
                          weight_attr=_init(cfg), **kw)
        self.fc2 = Linear(cfg.ffn_size, cfg.hidden_size,
                          weight_attr=_init(cfg), **kw)
        self.ffn_norm = LayerNorm(cfg.hidden_size,
                                  epsilon=cfg.layer_norm_epsilon,
                                  device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attention_mask=None):
        # post-LN (original BERT): residual then norm
        x = self.attn_norm(x + self.dropout(
            self.attention(x, attention_mask)))
        return self.ffn_norm(x + self.dropout(
            self.fc2(F.gelu(self.fc1(x)))))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None, generator=None):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size,
                            weight_attr=_init(cfg), device=device,
                            generator=generator)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class BertModel(nn.Module):
    """Embeddings, the encoder stack and the pooler; ``forward`` returns
    ``(sequence_output [B, L, H], pooled_output [B, H])``. Without an
    ``attention_mask`` the pad tokens (``cfg.pad_token_id``) are masked.

    ``embeddings_cls`` is the hook ERNIE uses to swap in its task-aware
    embeddings."""

    embeddings_cls = BertEmbeddings

    def __init__(self, cfg: BertConfig, device=None, generator=None):
        super().__init__()
        device = default_device(device)
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        self.embeddings = self.embeddings_cls(cfg, **kw)
        self.encoder = LayerList([BertLayer(cfg, **kw)
                                  for _ in range(cfg.num_layers)])
        self.pooler = BertPooler(cfg, **kw)

    def _default_mask(self, input_ids):
        return (input_ids != self.cfg.pad_token_id).to(torch.float32)

    def _encode(self, h, attention_mask):
        for layer in self.encoder:
            h = layer(h, attention_mask)
        return h, self.pooler(h)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        if attention_mask is None:
            attention_mask = self._default_mask(input_ids)
        h = self.embeddings(input_ids, token_type_ids)
        return self._encode(h, attention_mask)


class BertForSequenceClassification(nn.Module):
    """The finetune head: pooled output -> ``num_classes`` logits;
    ``forward(input_ids, token_type_ids, attention_mask, labels)`` returns
    the logits, or the mean cross entropy given ``labels``.
    ``_make_encoder`` is the hook for encoder swaps (ERNIE)."""

    def __init__(self, cfg: BertConfig, num_classes: int = 2, device=None,
                 generator=None):
        super().__init__()
        device = default_device(device)
        self.bert = self._make_encoder(cfg, device, generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes,
                                 weight_attr=_init(cfg), device=device,
                                 generator=generator)

    def _make_encoder(self, cfg, device, generator):
        return BertModel(cfg, device=device, generator=generator)

    def _classify(self, pooled, labels):
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return F.cross_entropy(logits, labels)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self._classify(pooled, labels)


class BertForPretraining(nn.Module):
    """Masked-LM and next-sentence heads. The MLM loss gathers only the
    masked positions before the vocab projection (tied to the word
    embedding), so the logits are ``[B, M, vocab]``, never ``[B, L,
    vocab]``. ``forward(input_ids, mlm_positions, mlm_labels, nsp_labels,
    token_type_ids, attention_mask)`` returns the summed loss; positions
    and labels padded with -1 are ignored."""

    def __init__(self, cfg: BertConfig, device=None, generator=None):
        super().__init__()
        device = default_device(device)
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        self.bert = self._make_encoder(cfg, device, generator)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                weight_attr=_init(cfg), **kw)
        self.transform_norm = LayerNorm(cfg.hidden_size,
                                        epsilon=cfg.layer_norm_epsilon,
                                        device=device)
        self.nsp = Linear(cfg.hidden_size, 2, weight_attr=_init(cfg), **kw)

    def _make_encoder(self, cfg, device, generator):
        return BertModel(cfg, device=device, generator=generator)

    def forward(self, input_ids, mlm_positions, mlm_labels, nsp_labels=None,
                token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self._mlm_nsp_loss(seq, pooled, mlm_positions, mlm_labels,
                                  nsp_labels)

    def _mlm_nsp_loss(self, seq, pooled, mlm_positions, mlm_labels,
                      nsp_labels=None):
        pos = mlm_positions.clamp(0, seq.shape[1] - 1).long()
        gathered = torch.gather(
            seq, 1, pos[:, :, None].expand(-1, -1, seq.shape[2]))  # [B, M, H]
        h = self.transform_norm(F.gelu(self.transform(gathered)))
        # the decoder ties the word embedding (standard BERT weight tying)
        vocab_w = self.bert.embeddings.word_embeddings.weight  # [V, H]
        dtype = torch.promote_types(h.dtype, vocab_w.dtype)
        logits = torch.einsum("bmh,vh->bmv", h.to(dtype), vocab_w.to(dtype))
        valid = (mlm_positions >= 0) & (mlm_labels >= 0)
        labels = mlm_labels.clamp(0, self.cfg.vocab_size - 1).long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[:, :, None])[..., 0]
        mlm_loss = (torch.where(valid, nll, torch.zeros_like(nll)).sum()
                    / torch.clamp(valid.sum(), min=1))
        if nsp_labels is None:
            return mlm_loss
        return mlm_loss + F.cross_entropy(self.nsp(pooled), nsp_labels)

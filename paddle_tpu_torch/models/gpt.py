"""GPT decoder-only language model: forward, the pretrain loss (plain and
chunked), recompute, and cached inference (port of
``paddle_tpu/models/gpt.py``).

Parameter paths and layouts are the reference's (``gpt.h.{i}.attn.
qkv_proj.weight`` is ``[hidden, 3*hidden]``, ...), so a JAX
``state_dict()`` loads by name (see :mod:`paddle_tpu_torch.convert`).
Parameters are built in float32 (``amp.decorate`` casts them for O2);
``cfg.dtype`` is the KV cache's storage type, as in the reference.
Weights are drawn from an explicit ``torch.Generator`` on the model's
device; dropout draws from the "dropout" stream of
:mod:`paddle_tpu_torch.nn.layer`. ``sequence_parallel`` is not ported
(there is no mesh yet).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import default_device
from ..distributed.parallel.recompute import recompute_wrap
from ..nn import functional as F
from ..nn.layers.common import (ColumnParallelLinear, Dropout,
                                ParallelCrossEntropy, RowParallelLinear,
                                VocabParallelEmbedding, parallel_matmul)
from ..nn.layers.norm import LayerNorm
from .lm_utils import (DecoderBlockList, attend_with_cache, causal_attention,
                       cached_lm_forward, chunked_lm_loss)

__all__ = ["GPTConfig", "gpt_tiny", "gpt_1p3b", "GPTAttention", "GPTMLP",
           "GPTBlock", "GPTEmbeddings", "GPTModel", "GPTForCausalLM",
           "gpt_loss_fn", "gpt_flops_per_token"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: Optional[int] = None  # default 4*hidden
    max_position_embeddings: int = 2048
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    use_recompute: bool = False
    # recompute only the attention sublayer of each block
    recompute_attn_only: bool = False
    # recompute policy (only None / "full" are ported)
    recompute_policy: Optional[str] = None
    use_flash_attention: bool = True
    # fused head + CE over sequence chunks of this size (0 = off): the full
    # [B, L, vocab] logits never exist (see lm_utils.chunked_lm_loss)
    loss_chunk: int = 0
    dtype: str = "float32"

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size


def gpt_tiny(**overrides) -> GPTConfig:
    cfg = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
               max_position_embeddings=256)
    cfg.update(overrides)
    return GPTConfig(**cfg)


def gpt_1p3b(**overrides) -> GPTConfig:
    """GPT-3 1.3B: hidden 2048, 24 layers, 16 heads of 128, vocab 50304,
    2048 positions, tied embeddings."""
    cfg = dict(vocab_size=50304, hidden_size=2048, num_layers=24, num_heads=16,
               max_position_embeddings=2048)
    cfg.update(overrides)
    return GPTConfig(**cfg)


def _out_std(cfg: GPTConfig) -> float:
    # residual-branch output projections: std / sqrt(2 * num_layers)
    return cfg.initializer_range / math.sqrt(2 * cfg.num_layers)


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv_proj = ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size, std=cfg.initializer_range,
            device=device, generator=generator)
        self.out_proj = RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, std=_out_std(cfg),
            device=device, generator=generator)

    def forward(self, x, cache=None, position_offset=0):
        B, L, _ = x.shape
        # fused qkv: output features laid out (3, heads, head_dim)
        qkv = self.qkv_proj(x).reshape(B, L, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is not None:
            out, cache = attend_with_cache(
                q, k, v, cache, position_offset,
                use_flash=self.cfg.use_flash_attention)
            out = out.reshape(B, L, self.num_heads * self.head_dim)
            return self.out_proj(out), cache
        out = causal_attention(
            q, k, v, dropout_p=self.cfg.attention_dropout_prob,
            training=self.training, use_flash=self.cfg.use_flash_attention)
        out = out.reshape(B, L, self.num_heads * self.head_dim)
        return self.out_proj(out)


class GPTMLP(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        self.fc_in = ColumnParallelLinear(
            cfg.hidden_size, cfg.intermediate_size, std=cfg.initializer_range,
            device=device, generator=generator)
        self.fc_out = RowParallelLinear(
            cfg.intermediate_size, cfg.hidden_size, std=_out_std(cfg),
            device=device, generator=generator)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class GPTBlock(nn.Module):
    """Pre-LN transformer decoder block."""

    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon,
                              device=device)
        self.attn = GPTAttention(cfg, device=device, generator=generator)
        self.ln_2 = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon,
                              device=device)
        self.mlp = GPTMLP(cfg, device=device, generator=generator)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, cache=None, position_offset=0):
        if cache is not None:
            a, cache = self.attn(self.ln_1(x), cache=cache,
                                 position_offset=position_offset)
            x = x + self.dropout(a)
            x = x + self.dropout(self.mlp(self.ln_2(x)))
            return x, cache
        attn = self.attn
        if self.cfg.recompute_attn_only and not self.cfg.use_recompute:
            attn = recompute_wrap(self.attn)
        x = x + self.dropout(attn(self.ln_1(x)))
        return x + self.dropout(self.mlp(self.ln_2(x)))


class GPTEmbeddings(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, std=cfg.initializer_range,
            device=device, generator=generator)
        self.position_embeddings = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, cfg.hidden_size,
                        device=device).normal_(0.0, cfg.initializer_range,
                                               generator=generator))
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, position_offset=0):
        L = input_ids.shape[1]
        h = self.word_embeddings(input_ids)
        if isinstance(position_offset, torch.Tensor) and position_offset.ndim == 1:
            # per-row offsets [B] (continuous-batching decode: every slot
            # sits at its own position): gather rows [B, L, H]
            idx = (position_offset.to(device=h.device, dtype=torch.long)[:, None]
                   + torch.arange(L, device=h.device)[None, :])
            pos = self.position_embeddings[idx]
        else:
            P = self.position_embeddings.shape[0]
            start = min(max(int(position_offset), 0), P - L)
            pos = self.position_embeddings[start:start + L]
        return self.dropout(h + pos)


class GPTModel(nn.Module):
    """Embeddings + N decoder blocks + final LN. Returns hidden states."""

    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg, device=device, generator=generator)
        self.h = DecoderBlockList(cfg, GPTBlock, device=device,
                                  generator=generator)
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon,
                              device=device)

    def forward(self, input_ids, cache=None, position_offset=0):
        x = self.embeddings(input_ids, position_offset=position_offset)
        if cache is not None:
            x, cache = self.h(x, caches=cache, position_offset=position_offset)
            return self.ln_f(x), cache
        return self.ln_f(self.h(x))


class GPTForCausalLM(nn.Module):
    """LM head model: ``forward`` returns logits, the LM loss when given
    labels, or ``(logits, cache)`` on the cached path.

    ``device=None`` builds on ``cuda`` (``RuntimeError`` without a GPU;
    pass ``device="cpu"`` for the CPU). ``generator`` draws the initial
    weights; it must live on ``device`` (default: a new generator there,
    seeded 0)."""

    def __init__(self, cfg: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.tie_word_embeddings:
            raise ValueError("only the tied LM head (tie_word_embeddings="
                             "True) is ported")
        device = default_device(device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device=device, generator=generator)
        self.parallel_ce = ParallelCrossEntropy()

    @property
    def device(self) -> torch.device:
        return self.gpt.ln_f.weight.device

    def _logits(self, h):
        # tied head: h @ word_embeddings^T
        return parallel_matmul(h, self.gpt.embeddings.word_embeddings.weight,
                               transpose_y=True)

    def cache_spec(self) -> dict:
        """Static KV-cache geometry for ``models.generation.init_cache``."""
        return {"num_layers": self.cfg.num_layers,
                "num_kv_heads": self.cfg.num_heads,
                "head_dim": self.cfg.hidden_size // self.cfg.num_heads,
                "max_length": self.cfg.max_position_embeddings,
                "dtype": self.cfg.dtype}

    def forward(self, input_ids, labels=None, cache=None, position_offset=0,
                gather_last=None):
        """Logits ``[B, L, vocab]`` when ``labels`` is None; otherwise the
        LM loss, through :meth:`chunked_lm_loss` when ``cfg.loss_chunk >
        0`` (the full logits never exist). With ``cache`` (per-layer
        ``(k, v)`` pairs from ``models.generation.init_cache``) runs the
        cached path and returns ``(logits, cache)``; ``gather_last`` keeps
        only that position before the head projection."""
        if cache is not None or gather_last is not None:
            return cached_lm_forward(self.gpt, self._logits, input_ids,
                                     cache, position_offset, gather_last)
        if labels is not None and self.cfg.loss_chunk:
            return self.chunked_lm_loss(self.gpt(input_ids), labels,
                                        chunk=self.cfg.loss_chunk)
        logits = self._logits(self.gpt(input_ids))
        if labels is None:
            return logits
        return self.loss(logits, labels)

    def loss(self, logits, labels):
        """Shifted LM loss: predict token t+1 from the prefix up to t; the
        mean over every position, in the logits' dtype."""
        labels = torch.as_tensor(labels, device=logits.device)
        per_tok = self.parallel_ce(logits[:, :-1, :], labels[:, 1:])
        return per_tok.mean()

    def chunked_lm_loss(self, h, labels, chunk: int = 256):
        """Head projection and softmax-CE fused over sequence chunks (see
        :func:`paddle_tpu_torch.models.lm_utils.chunked_lm_loss`)."""
        return chunked_lm_loss(h, labels, self._logits, self.parallel_ce,
                               chunk=chunk)

    def generate(self, input_ids, max_new_tokens: int = 32, **kwargs):
        """KV-cache generation — see
        :func:`paddle_tpu_torch.models.generation.generate`."""
        from .generation import generate

        return generate(self, input_ids, max_new_tokens, **kwargs)


def gpt_loss_fn(model: GPTForCausalLM):
    """``loss_fn`` for ``TrainStep`` on ``(input_ids, labels)`` batches."""

    def loss_fn(outputs, batch):
        return model.loss(outputs, batch[1])

    return loss_fn


def gpt_flops_per_token(cfg: GPTConfig, seq_len: int) -> float:
    """Model FLOPs per token for MFU accounting (forward and backward,
    6N plus the attention term, as the reference counts them)."""
    n_params = (
        cfg.vocab_size * cfg.hidden_size  # embeddings (tied head reused)
        + cfg.max_position_embeddings * cfg.hidden_size
        + cfg.num_layers * (
            4 * cfg.hidden_size * cfg.hidden_size  # qkv + out
            + 2 * cfg.hidden_size * cfg.intermediate_size  # mlp
            + 4 * cfg.hidden_size))  # ln/bias approx
    attn = 12 * cfg.num_layers * cfg.hidden_size * seq_len
    return 6.0 * n_params + attn

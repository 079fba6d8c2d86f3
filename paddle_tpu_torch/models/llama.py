"""Llama decoder-only family: RoPE, RMSNorm, SwiGLU and grouped-query
attention (port of ``paddle_tpu/models/llama.py``).

Parameter paths and layouts are the reference's (``model.layers.{i}.
self_attn.q_proj.weight`` is ``[hidden, hidden]``, no projection has a
bias), so a JAX ``state_dict()`` loads by name (see
:func:`paddle_tpu_torch.convert.llama_from_jax`). Parameters are built in
float32 (``amp.decorate`` casts them for O2); ``cfg.dtype`` is the KV
cache's storage type. Weights are drawn from an explicit
``torch.Generator`` on the model's device with the reference's
initializers. GQA repeats K and V to the query heads before the flash
kernel (equal-head layout); the cache keeps ``num_kv_heads`` and the
cached decode attends it through a grouped einsum. ``sequence_parallel``
is not ported (there is no mesh yet).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import default_device
from ..nn import functional as F
from ..nn.layers.common import (ColumnParallelLinear, ParallelCrossEntropy,
                                RowParallelLinear, VocabParallelEmbedding,
                                parallel_matmul)
from ..nn.layers.norm import RMSNorm
from .lm_utils import (DecoderBlockList, attend_with_cache, causal_attention,
                       cached_lm_forward, chunked_lm_loss, repeat_kv)

__all__ = ["LlamaConfig", "llama_tiny", "llama2_7b", "apply_rotary",
           "LlamaAttention", "LlamaMLP", "LlamaBlock", "LlamaModel",
           "LlamaForCausalLM", "llama_loss_fn", "llama_flops_per_token"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None = MHA; < num_heads = GQA
    intermediate_size: Optional[int] = None  # default: the 8/3 rule
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False  # llama unties
    use_recompute: bool = False
    # recompute policy (only None / "full" are ported)
    recompute_policy: Optional[str] = None
    use_flash_attention: bool = True
    sequence_parallel: bool = False  # not ported: raises
    # fused head + CE over sequence chunks of this size (0 = off)
    loss_chunk: int = 0
    dtype: str = "float32"

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size is None:
            # 2/3 * 4h rounded up to a multiple of 256
            inter = int(8 * self.hidden_size / 3)
            self.intermediate_size = -(-inter // 256) * 256
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {self.num_heads} is not a multiple "
                             f"of num_kv_heads {self.num_kv_heads}")


def llama_tiny(**overrides) -> LlamaConfig:
    cfg = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
               num_kv_heads=2, max_position_embeddings=256)
    cfg.update(overrides)
    return LlamaConfig(**cfg)


def llama2_7b(**overrides) -> LlamaConfig:
    """Llama-2-7B: hidden 4096, 32 layers, 32 heads of 128 (MHA),
    intermediate 11008, vocab 32000, 4096 positions, untied head."""
    cfg = dict(vocab_size=32000, hidden_size=4096, num_layers=32,
               num_heads=32, num_kv_heads=32, intermediate_size=11008,
               max_position_embeddings=4096)
    cfg.update(overrides)
    return LlamaConfig(**cfg)


# ------------------------------------------------------------------ rotary
_ROPE_CACHE = {}


def _rope_tables(head_dim: int, max_len: int, theta: float, device):
    """Float32 cos/sin tables ``[max_len, head_dim]``, computed with numpy
    exactly as the reference does (``llama.py:94-111``) and kept once per
    (head_dim, max_len, theta, device): every layer of every model shares
    one pair (32 layers of llama2_7b would otherwise hold 134 MB of copies
    of the same constants)."""
    device = torch.device(device)
    key = (head_dim, max_len, float(theta), device)
    if key not in _ROPE_CACHE:
        inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2,
                                              dtype=np.float32) / head_dim))
        t = np.arange(max_len, dtype=np.float32)
        freqs = np.outer(t, inv_freq)                  # [L, D/2]
        emb = np.concatenate([freqs, freqs], axis=-1)  # [L, D]
        # made as ordinary tensors even on a first call under
        # inference_mode (serving), so that training can use them later
        with torch.inference_mode(False):
            _ROPE_CACHE[key] = tuple(torch.from_numpy(a).to(device)
                                     for a in (np.cos(emb), np.sin(emb)))
    return _ROPE_CACHE[key]


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(q, k, cos, sin, position_offset=0):
    """Rotary position embedding on ``[B, L, H, D]`` (the rotate-half
    convention). ``position_offset`` is an int, whose window start clamps
    so that it fits the tables (as ``dynamic_slice_in_dim`` does), or a
    per-row ``[B]`` tensor (continuous-batching decode: each slot rotates
    at its own position). The tables are cast to q's dtype first, as the
    reference does, so under O2 the products are bf16."""
    L = q.shape[1]
    if isinstance(position_offset, torch.Tensor) and position_offset.ndim == 1:
        idx = (position_offset.to(device=cos.device, dtype=torch.long)[:, None]
               + torch.arange(L, device=cos.device)[None, :])
        c = cos[idx][:, :, None, :].to(q.dtype)      # [B, L, 1, D]
        s = sin[idx][:, :, None, :].to(q.dtype)
    else:
        start = min(max(int(position_offset), 0), cos.shape[0] - L)
        c = cos[start:start + L][None, :, None, :].to(q.dtype)
        s = sin[start:start + L][None, :, None, :].to(q.dtype)
    return q * c + _rotate_half(q) * s, k * c + _rotate_half(k) * s


def _out_std(cfg: LlamaConfig) -> float:
    # residual-branch output projections: std / sqrt(2 * num_layers)
    return cfg.initializer_range / math.sqrt(2 * cfg.num_layers)


# ------------------------------------------------------------------ layers
class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.hidden_size // cfg.num_heads
        kv_out = cfg.num_kv_heads * self.head_dim
        kw = dict(has_bias=False, device=device, generator=generator)
        std = cfg.initializer_range
        self.q_proj = ColumnParallelLinear(cfg.hidden_size, cfg.hidden_size,
                                           std=std, **kw)
        self.k_proj = ColumnParallelLinear(cfg.hidden_size, kv_out, std=std,
                                           **kw)
        self.v_proj = ColumnParallelLinear(cfg.hidden_size, kv_out, std=std,
                                           **kw)
        self.o_proj = RowParallelLinear(cfg.hidden_size, cfg.hidden_size,
                                        std=_out_std(cfg), **kw)

    def forward(self, x, cache=None, position_offset=0):
        B, L, _ = x.shape
        cfg = self.cfg
        q = self.q_proj(x).reshape(B, L, cfg.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(B, L, cfg.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(B, L, cfg.num_kv_heads, self.head_dim)
        cos, sin = _rope_tables(self.head_dim, cfg.max_position_embeddings,
                                cfg.rope_theta, x.device)
        # RoPE before the cache write: the cache stores rotated keys
        q, k = apply_rotary(q, k, cos, sin, position_offset)
        if cache is not None:
            out, cache = attend_with_cache(
                q, k, v, cache, position_offset,
                use_flash=cfg.use_flash_attention)
            return self.o_proj(out.reshape(B, L, cfg.hidden_size)), cache
        groups = cfg.num_heads // cfg.num_kv_heads
        out = causal_attention(q, repeat_kv(k, groups), repeat_kv(v, groups),
                               dropout_p=0.0, training=self.training,
                               use_flash=cfg.use_flash_attention)
        return self.o_proj(out.reshape(B, L, cfg.hidden_size))


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        kw = dict(has_bias=False, device=device, generator=generator)
        self.gate_proj = ColumnParallelLinear(
            cfg.hidden_size, cfg.intermediate_size,
            std=cfg.initializer_range, **kw)
        self.up_proj = ColumnParallelLinear(
            cfg.hidden_size, cfg.intermediate_size,
            std=cfg.initializer_range, **kw)
        self.down_proj = RowParallelLinear(
            cfg.intermediate_size, cfg.hidden_size, std=_out_std(cfg), **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    """Pre-RMSNorm decoder block."""

    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size,
                                       epsilon=cfg.rms_norm_eps, device=device)
        self.self_attn = LlamaAttention(cfg, device=device,
                                        generator=generator)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, epsilon=cfg.rms_norm_eps, device=device)
        self.mlp = LlamaMLP(cfg, device=device, generator=generator)

    def forward(self, x, cache=None, position_offset=0):
        if cache is not None:
            a, cache = self.self_attn(self.input_layernorm(x), cache=cache,
                                      position_offset=position_offset)
            x = x + a
            return x + self.mlp(self.post_attention_layernorm(x)), cache
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """Token embeddings + N decoder blocks + final RMSNorm. Returns hidden
    states."""

    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, std=cfg.initializer_range,
            device=device, generator=generator)
        self.layers = DecoderBlockList(cfg, LlamaBlock, device=device,
                                       generator=generator)
        self.norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps,
                            device=device)

    def forward(self, input_ids, cache=None, position_offset=0):
        x = self.embed_tokens(input_ids)
        if cache is not None:
            x, cache = self.layers(x, caches=cache,
                                   position_offset=position_offset)
            return self.norm(x), cache
        return self.norm(self.layers(x))


class LlamaForCausalLM(nn.Module):
    """LM head model with :class:`GPTForCausalLM`'s contract: ``forward``
    returns logits, the LM loss when given labels (chunk-fused when
    ``cfg.loss_chunk > 0``), or ``(logits, cache)`` on the cached path.

    ``device=None`` builds on ``cuda`` (``RuntimeError`` without a GPU;
    pass ``device="cpu"`` for the CPU). ``generator`` draws the initial
    weights; it must live on ``device`` (default: a new generator there,
    seeded 0)."""

    def __init__(self, cfg: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.sequence_parallel:
            raise NotImplementedError("sequence_parallel is not ported (it "
                                      "needs a mesh)")
        device = default_device(device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        self.cfg = cfg
        self.model = LlamaModel(cfg, device=device, generator=generator)
        if not cfg.tie_word_embeddings:
            self.lm_head = ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size, std=cfg.initializer_range,
                has_bias=False, device=device, generator=generator)
        self.parallel_ce = ParallelCrossEntropy()

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device

    def _logits(self, h):
        if self.cfg.tie_word_embeddings:
            return parallel_matmul(h, self.model.embed_tokens.weight,
                                   transpose_y=True)
        return self.lm_head(h)

    def cache_spec(self) -> dict:
        """Static KV-cache geometry for ``models.generation.init_cache``
        (GQA: the cache stores ``num_kv_heads``, not ``num_heads``)."""
        return {"num_layers": self.cfg.num_layers,
                "num_kv_heads": self.cfg.num_kv_heads,
                "head_dim": self.cfg.hidden_size // self.cfg.num_heads,
                "max_length": self.cfg.max_position_embeddings,
                "dtype": self.cfg.dtype}

    def forward(self, input_ids, labels=None, cache=None, position_offset=0,
                gather_last=None):
        """Logits ``[B, L, vocab]`` when ``labels`` is None; otherwise the
        LM loss, chunk-fused when ``cfg.loss_chunk > 0``. With ``cache``
        runs the cached path and returns ``(logits, cache)``;
        ``gather_last`` keeps only that position before the head, so
        serving never builds ``[B, L, vocab]``."""
        if cache is not None or gather_last is not None:
            return cached_lm_forward(self.model, self._logits, input_ids,
                                     cache, position_offset, gather_last)
        if labels is not None and self.cfg.loss_chunk:
            return chunked_lm_loss(self.model(input_ids), labels,
                                   self._logits, self.parallel_ce,
                                   chunk=self.cfg.loss_chunk)
        logits = self._logits(self.model(input_ids))
        if labels is None:
            return logits
        return self.loss(logits, labels)

    def loss(self, logits, labels):
        """Shifted LM loss: the mean over every position, in the logits'
        dtype."""
        labels = torch.as_tensor(labels, device=logits.device)
        return self.parallel_ce(logits[:, :-1, :], labels[:, 1:]).mean()

    def generate(self, input_ids, max_new_tokens: int = 32, **kwargs):
        """KV-cache generation — see
        :func:`paddle_tpu_torch.models.generation.generate`."""
        from .generation import generate

        return generate(self, input_ids, max_new_tokens, **kwargs)


def llama_loss_fn(model: LlamaForCausalLM):
    """``loss_fn`` for ``TrainStep`` on ``(input_ids, labels)`` batches."""

    def loss_fn(outputs, batch):
        return model.loss(outputs, batch[1])

    return loss_fn


def llama_flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Model FLOPs per token for MFU accounting: 6N plus the attention
    term (the PaLM formula), GQA-aware, as the reference counts them."""
    head_dim = cfg.hidden_size // cfg.num_heads
    kv = cfg.num_kv_heads * head_dim
    n_params = (
        cfg.vocab_size * cfg.hidden_size
        * (1 if cfg.tie_word_embeddings else 2)
        + cfg.num_layers * (
            cfg.hidden_size * cfg.hidden_size * 2          # q + o
            + cfg.hidden_size * kv * 2                      # k + v
            + 3 * cfg.hidden_size * cfg.intermediate_size   # swiglu
            + 2 * cfg.hidden_size))                         # rmsnorm
    attn = 12 * cfg.num_layers * cfg.hidden_size * seq_len
    return 6.0 * n_params + attn

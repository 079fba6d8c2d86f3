"""The subset of ``paddle_tpu/nn/functional.py`` that the GPT and Llama
serving and training paths and the encoder path (``nn.Transformer``,
BERT, ERNIE) use, in PyTorch.

Weights keep the JAX package's layout: a linear weight is ``[in, out]``
(paddle's convention), not torch's ``[out, in]``, so converted
checkpoints copy straight across.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as _F

from ..amp.auto_cast import autocast_call
from .layer import take_rng_key

__all__ = ["linear", "relu", "tanh", "gelu", "silu", "layer_norm",
           "rms_norm", "dropout", "cross_entropy",
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
    gen = torch.Generator(device=x.device)
    gen.manual_seed(take_rng_key("dropout"))
    keep = torch.rand(mask_shape, generator=gen, device=x.device) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x))


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

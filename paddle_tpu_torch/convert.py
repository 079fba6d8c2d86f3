"""Load the JAX package's weights into the port: GPT, Llama, BERT,
ERNIE, or any ported layer tree (``nn.Transformer``, ...).

The JAX ``Layer.state_dict()`` names map one to one onto the port's
parameters, with the
same layouts (linear weights ``[in, out]``, embeddings ``[vocab,
hidden]``), so conversion is a copy by name. The caller passes the state
as numpy arrays (``{k: np.asarray(v) for k, v in jax_model.state_dict().
items()}``); this module imports nothing of JAX. Arrays in bfloat16
(``ml_dtypes``, the state of a model after ``amp.decorate(level="O2")``)
load into bfloat16 parameters, float32 arrays into float32 ones. The
config's training fields (recompute, ``loss_chunk``, dropout) carry over
with ``cfg``. A reference model injected with LoRA (``paddle_tpu.lora.
apply_lora``) converts with ``lora=`` its ``LoraConfig``'s port twin: the
port model is injected the same way first, and its ``lora_A``/``lora_B``
leaves load by name with the base weights.
"""
from __future__ import annotations

from typing import Dict, Optional, Type

import numpy as np
import torch
from torch import nn

from .models.bert import BertConfig, BertForSequenceClassification
from .models.ernie import ErnieConfig, ErnieForSequenceClassification
from .models.gpt import GPTConfig, GPTForCausalLM
from .models.llama import LlamaConfig, LlamaForCausalLM
from .lora import LoraConfig, apply_lora

__all__ = ["gpt_from_jax", "llama_from_jax", "bert_from_jax",
           "ernie_from_jax", "layer_from_jax"]


def _load_state(model: nn.Module, state: Dict[str, np.ndarray],
                family: str) -> nn.Module:
    """Copy ``state`` into ``model``'s parameters by name and put the
    model in eval mode."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state does not match the port's {family}: missing "
                       f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            value = np.asarray(state[name])
            dtype = (torch.bfloat16 if value.dtype.name == "bfloat16"
                     else torch.float32)
            value = np.array(value, dtype=np.float32)  # a copy
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)}, the "
                                 f"port expects {tuple(p.shape)}")
            p.data = torch.from_numpy(value).to(device=p.device, dtype=dtype)
    model.eval()
    return model


def _injected(model: nn.Module, lora: Optional[LoraConfig]) -> nn.Module:
    return model if lora is None else apply_lora(model, lora)


def gpt_from_jax(state: Dict[str, np.ndarray], cfg: GPTConfig,
                 device=None, lora: Optional[LoraConfig] = None
                 ) -> GPTForCausalLM:
    """A port ``GPTForCausalLM`` for ``cfg`` on ``device`` carrying the
    weights in ``state``, in eval mode (call ``.train()`` to train it);
    with ``lora``, injected with it and carrying the state's adapter
    leaves too. Raises ``KeyError`` on a missing or an extra name and
    ``ValueError`` on a wrong shape."""
    return _load_state(_injected(GPTForCausalLM(cfg, device=device), lora),
                       state, "GPT")


def llama_from_jax(state: Dict[str, np.ndarray], cfg: LlamaConfig,
                   device=None, lora: Optional[LoraConfig] = None
                   ) -> LlamaForCausalLM:
    """A port ``LlamaForCausalLM`` for ``cfg`` on ``device`` carrying the
    weights in ``state``, in eval mode (call ``.train()`` to train it);
    with ``lora``, injected with it and carrying the state's adapter
    leaves too. Raises ``KeyError`` on a missing or an extra name and
    ``ValueError`` on a wrong shape."""
    return _load_state(_injected(LlamaForCausalLM(cfg, device=device), lora),
                       state, "Llama")


def bert_from_jax(state: Dict[str, np.ndarray], cfg: BertConfig,
                  device=None, model_cls: Type[nn.Module] =
                  BertForSequenceClassification, **kwargs) -> nn.Module:
    """A port ``model_cls`` (``BertModel``, ``BertForSequenceClassification``
    with ``num_classes=`` in ``kwargs``, or ``BertForPretraining``) for
    ``cfg`` on ``device`` carrying the weights in ``state``, in eval mode.
    Raises ``KeyError`` on a missing or an extra name and ``ValueError``
    on a wrong shape."""
    return _load_state(model_cls(cfg, device=device, **kwargs), state,
                       model_cls.__name__)


def ernie_from_jax(state: Dict[str, np.ndarray], cfg: ErnieConfig,
                   device=None, model_cls: Type[nn.Module] =
                   ErnieForSequenceClassification, **kwargs) -> nn.Module:
    """:func:`bert_from_jax` for the ERNIE classes (``ErnieModel``,
    ``ErnieForSequenceClassification``, ``ErnieForPretraining``)."""
    return _load_state(model_cls(cfg, device=device, **kwargs), state,
                       model_cls.__name__)


def layer_from_jax(module: nn.Module,
                   state: Dict[str, np.ndarray]) -> nn.Module:
    """Load ``state`` into an already built port layer tree (e.g. an
    ``nn.Transformer`` built with the reference's arguments) by name, in
    place; returns ``module`` in eval mode."""
    return _load_state(module, state, type(module).__name__)

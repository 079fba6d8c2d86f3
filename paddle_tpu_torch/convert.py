"""Load the JAX package's GPT and Llama weights into the port.

The JAX ``GPTForCausalLM.state_dict()`` and ``LlamaForCausalLM.
state_dict()`` names map one to one onto the port's parameters, with the
same layouts (linear weights ``[in, out]``, embeddings ``[vocab,
hidden]``), so conversion is a copy by name. The caller passes the state
as numpy arrays (``{k: np.asarray(v) for k, v in jax_model.state_dict().
items()}``); this module imports nothing of JAX. Arrays in bfloat16
(``ml_dtypes``, the state of a model after ``amp.decorate(level="O2")``)
load into bfloat16 parameters, float32 arrays into float32 ones. The
config's training fields (recompute, ``loss_chunk``, dropout) carry over
with ``cfg``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .models.gpt import GPTConfig, GPTForCausalLM
from .models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["gpt_from_jax", "llama_from_jax"]


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


def gpt_from_jax(state: Dict[str, np.ndarray], cfg: GPTConfig,
                 device=None) -> GPTForCausalLM:
    """A port ``GPTForCausalLM`` for ``cfg`` on ``device`` carrying the
    weights in ``state``, in eval mode (call ``.train()`` to train it).
    Raises ``KeyError`` on a missing or an extra name and ``ValueError``
    on a wrong shape."""
    return _load_state(GPTForCausalLM(cfg, device=device), state, "GPT")


def llama_from_jax(state: Dict[str, np.ndarray], cfg: LlamaConfig,
                   device=None) -> LlamaForCausalLM:
    """A port ``LlamaForCausalLM`` for ``cfg`` on ``device`` carrying the
    weights in ``state``, in eval mode (call ``.train()`` to train it).
    Raises ``KeyError`` on a missing or an extra name and ``ValueError``
    on a wrong shape."""
    return _load_state(LlamaForCausalLM(cfg, device=device), state, "Llama")

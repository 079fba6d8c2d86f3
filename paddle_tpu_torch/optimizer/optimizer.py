"""Optimizers with master weights (port of
``paddle_tpu/optimizer/optimizer.py``: ``Optimizer`` ``init``/``update``,
``Adam`` :171, ``AdamW`` :236).

The reference's pure ``init(params) -> state`` /
``update(grads, state, params) -> (params, state)`` pair is kept, over a
flat ``{name: tensor}`` dict of parameters. Where the JAX package returned
new arrays, the port updates the parameters, moments and master weights
in place (under ``torch.no_grad``) and returns the same dicts: a 1.3B
model then holds one copy of each. The update formula is the reference's,
written out in ``torch._foreach_*`` tensor ops (not ``torch.optim``), so
the parity tests hold it to the same arithmetic.

Master weights ("multi_precision"): for bf16/fp16 parameters ``init``
keeps a float32 copy, ``update`` steps the copy in float32 and casts it
back into the parameter. The learning rate is a float; the ``lr.py``
schedulers and ``grad_clip`` are not ported.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

__all__ = ["Optimizer", "Adam", "AdamW"]

_HALF = (torch.bfloat16, torch.float16)


class Optimizer:
    def __init__(self, learning_rate: float = 0.001, parameters=None,
                 weight_decay: Optional[float] = None, grad_clip=None,
                 multi_precision: bool = False, name=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "only a float learning rate is ported (no lr.py schedulers)")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported")
        self._learning_rate = float(learning_rate)
        self._parameters = parameters
        self.weight_decay = 0.0 if weight_decay is None else weight_decay
        self.multi_precision = multi_precision

    def get_lr(self, step=None) -> float:
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        self._learning_rate = float(value)

    # ------------------------------------------------------------ functional
    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        """The optimizer state of ``params``: the step count, the slots
        and, with ``multi_precision``, float32 master copies of the half
        precision parameters (float32 parameters are their own master)."""
        with torch.no_grad():
            state = {"step": 0}
            state.update(self._init_slots(params))
            if self.multi_precision:
                state["master_weights"] = {
                    k: p.detach().float().clone() if p.dtype in _HALF
                    else p for k, p in params.items()}
        return state

    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]):
        """One step, in place. Returns ``(params, state)``."""
        with torch.no_grad():
            state["step"] += 1
            lr = self.get_lr(state["step"])
            work = state.get("master_weights", params)
            grads32 = {k: g.float() for k, g in grads.items()}
            self._apply(grads32, state, work, lr, params)
            for k, p in params.items():
                if work[k] is not p:
                    p.copy_(work[k])
        return params, state

    # subclass hooks -------------------------------------------------------
    def _init_slots(self, params) -> dict:
        return {}

    def _apply(self, grads, state, work, lr, params) -> None:
        raise NotImplementedError


class Adam(Optimizer):
    """Adam (``optimizer.py:171``); ``weight_decay`` is L2, folded into
    the gradient. ``moment_dtype`` is moment1's storage type (the update
    math is float32); moment2 stays float32, as in the reference."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-08,
                 parameters=None, weight_decay=None, grad_clip=None,
                 lazy_mode: bool = False, multi_precision: bool = False,
                 name=None, moment_dtype=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self._moment_dtype = (getattr(torch, moment_dtype)
                              if isinstance(moment_dtype, str)
                              else moment_dtype or torch.float32)

    def _init_slots(self, params):
        return {
            "moment1": {k: torch.zeros_like(p, dtype=self._moment_dtype)
                        for k, p in params.items()},
            "moment2": {k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()},
        }

    def _decays(self, name: str) -> bool:
        return False

    def _apply(self, grads, state, work, lr, params):
        step = state["step"]
        b1c = 1.0 - self.beta1 ** step
        b2c = 1.0 - self.beta2 ** step
        names = list(work)
        g = [grads[k] for k in names]
        w = [work[k] for k in names]
        if not isinstance(self, AdamW) and self.weight_decay:
            g = torch._foreach_add(g, w, alpha=self.weight_decay)
        m_store = [state["moment1"][k] for k in names]
        m = [x if x.dtype == torch.float32 else x.float() for x in m_store]
        v = [state["moment2"][k] for k in names]
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, g, alpha=1 - self.beta1)
        torch._foreach_mul_(v, self.beta2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.beta2)
        # delta = lr (m / b1c) / (sqrt(v / b2c) + eps)  [+ lr wd p]
        denom = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        delta = torch._foreach_div(m, b1c)
        torch._foreach_mul_(delta, lr)
        torch._foreach_div_(delta, denom)
        del denom
        decayed = [i for i, k in enumerate(names) if self._decays(k)]
        if decayed and self.weight_decay:
            torch._foreach_add_([delta[i] for i in decayed],
                                [w[i] for i in decayed],
                                alpha=lr * self.weight_decay)
        self._step_params(w, delta)
        for store, val in zip(m_store, m):
            if store is not val:
                store.copy_(val)

    @staticmethod
    def _step_params(w: List[torch.Tensor], delta: List[torch.Tensor]):
        # p - delta.astype(p.dtype): float32 work tensors in one pass; a
        # half-precision parameter without a master subtracts in its dtype
        f32 = [i for i, p in enumerate(w) if p.dtype == torch.float32]
        if f32:
            torch._foreach_sub_([w[i] for i in f32], [delta[i] for i in f32])
        for i, p in enumerate(w):
            if p.dtype != torch.float32:
                p.sub_(delta[i].to(p.dtype))


class AdamW(Adam):
    """Adam with decoupled weight decay (``optimizer.py:236``):
    ``delta += lr * weight_decay * p``. ``apply_decay_param_fun(name)``
    picks the parameters that decay (all of them when None)."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-08,
                 parameters=None, weight_decay: float = 0.01,
                 grad_clip=None,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 lazy_mode: bool = False, multi_precision: bool = False,
                 name=None, moment_dtype=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         moment_dtype=moment_dtype)
        self.apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, name: str) -> bool:
        return (self.apply_decay_param_fun is None
                or bool(self.apply_decay_param_fun(name)))

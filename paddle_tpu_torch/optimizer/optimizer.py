"""Optimizers with master weights (port of
``paddle_tpu/optimizer/optimizer.py``: the ``Optimizer`` base and ``SGD``
:130, ``Momentum`` :140, ``Adam`` :171, ``AdamW`` :236, ``Adagrad`` :277,
``RMSProp`` :302, ``Adadelta`` :346, ``Adamax`` :378, ``Lamb`` :407,
``LarsMomentum`` :451, ``DGCMomentum`` :513).

The reference's pure ``init(params) -> state`` /
``update(grads, state, params) -> (params, state)`` pair is kept, over a
flat ``{name: tensor}`` dict of parameters. Where the JAX package returned
new arrays, the port updates the parameters, slots and master weights in
place (under ``torch.no_grad``) and returns the same dicts: a 1.3B model
then holds one copy of each. Each update formula is the reference's,
written out in ``torch._foreach_*`` or plain tensor ops (not
``torch.optim``), so the parity tests hold it to the same arithmetic.

The step count is a 0-d int32 tensor on the parameters' device, as in the
reference, and what depends on it (bias corrections, a scheduled learning
rate) is computed there in float32. So ``update(..., guard=...)`` can
decide on the device whether a step commits, and a skipped step leaves
the count, like every other tensor, as it was (see ``update``).

Master weights ("multi_precision"): for bf16/fp16 parameters ``init``
keeps a float32 copy, ``update`` steps the copy in float32 and casts it
back into the parameter. ``learning_rate`` is a float or an
``lr.LRScheduler``; ``grad_clip`` (``nn.clip``) is applied to the
gradients first.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..framework.debugging import tree_all_finite
from .lr import LRScheduler, ReduceOnPlateau

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "LarsMomentum",
           "DGCMomentum"]

_HALF = (torch.bfloat16, torch.float16)


def _sub_in_dtype(w: List[torch.Tensor], delta: List[torch.Tensor]) -> None:
    """``p - delta.astype(p.dtype)``: float32 tensors in one pass; a half
    precision parameter without a master subtracts in its own dtype."""
    f32 = [i for i, p in enumerate(w) if p.dtype == torch.float32]
    if f32:
        torch._foreach_sub_([w[i] for i in f32], [delta[i] for i in f32])
    for i, p in enumerate(w):
        if p.dtype != torch.float32:
            p.sub_(delta[i].to(p.dtype))


def _sub_in_f32(w: List[torch.Tensor], delta: List[torch.Tensor]) -> None:
    """``(p - delta).astype(p.dtype)`` with float32 ``delta``: a half
    precision parameter is promoted, stepped in float32 and rounded."""
    f32 = [i for i, p in enumerate(w) if p.dtype == torch.float32]
    if f32:
        torch._foreach_sub_([w[i] for i in f32], [delta[i] for i in f32])
    for i, p in enumerate(w):
        if p.dtype != torch.float32:
            p.copy_(p.float() - delta[i])


def _bias_correction(beta: float, step: torch.Tensor) -> torch.Tensor:
    """``1 - beta ** step`` in float32, on the step's device."""
    return 1.0 - torch.pow(beta, step.float())


class Optimizer:
    #: elements whose state a guarded update copies at a time
    GUARD_CHUNK_NUMEL = 1 << 27
    #: updates between two read-backs of the step count (a scheduled
    #: learning rate is looked up from a table of this many steps)
    LR_WINDOW = 256

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay: Optional[float] = None, grad_clip=None,
                 multi_precision: bool = False, name=None):
        self._learning_rate = learning_rate
        self._parameters = parameters
        self.weight_decay = 0.0 if weight_decay is None else weight_decay
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision
        # stateful-API storage
        self._state = None
        self._accumulated_grads = None
        self._lr_window = None

    # ------------------------------------------------------------ LR
    def get_lr(self, step=None):
        """The learning rate: the float, or the scheduler's current value
        (``step`` None) or its ``value_at(step)``."""
        if isinstance(self._learning_rate, LRScheduler):
            if step is None:
                return self._learning_rate.get_lr()
            return self._learning_rate.value_at(int(step))
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = value

    def _lr_at(self, count: torch.Tensor):
        """The learning rate of the update that takes the step count from
        ``count`` to ``count + 1``: a Python float for a float rate; for a
        scheduler ``value_at(step)`` as a 0-d float32 device tensor, looked
        up on the device in a table of LR_WINDOW steps from the last count
        read back, so that the count is read back once a window (or when
        the state was replaced or loaded, or ReduceOnPlateau moved)."""
        sched = self._learning_rate
        if not isinstance(sched, LRScheduler):
            return float(sched)
        key = sched.last_lr if isinstance(sched, ReduceOnPlateau) else None
        win = self._lr_window
        if (win is None or win["count"] is not count
                or win["version"] != count._version or win["key"] != key
                or win["used"] >= self.LR_WINDOW):
            known = int(count)
            table = torch.tensor([float(sched.value_at(known + 1 + i))
                                  for i in range(self.LR_WINDOW)],
                                 dtype=torch.float32)
            win = {"known": known, "used": 0, "key": key,
                   "table": table.to(count.device), "count": count,
                   "version": count._version}
        win["used"] += 1
        self._lr_window = win
        return win["table"][(count - win["known"]).long()]

    def _set_count(self, state: dict, count: torch.Tensor) -> None:
        state["step"] = count
        if self._lr_window is not None:
            self._lr_window.update(count=count, version=count._version)

    # ------------------------------------------------------------ functional
    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        """The optimizer state of ``params``: the step count, the slots
        and, with ``multi_precision``, float32 master copies of the half
        precision parameters (float32 parameters are their own master)."""
        device = next(iter(params.values())).device
        with torch.no_grad():
            state = {"step": torch.zeros((), dtype=torch.int32,
                                         device=device)}
            state.update(self._init_slots(params))
            if self.multi_precision:
                state["master_weights"] = {
                    k: p.detach().float().clone() if p.dtype in _HALF
                    else p for k, p in params.items()}
        return state

    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor], guard=None):
        """One step, in place. Returns ``(params, state)``.

        ``guard`` (optional) decides on the device whether the step
        commits: it is called with a 0-d bool tensor, True iff every
        parameter the update would give (cast to its dtype) is finite, and
        returns a 0-d bool tensor ``skip``. Where ``skip`` is True every
        parameter, master, slot and the step count keeps its bits. That
        takes two passes over the parameters in groups of at most
        GUARD_CHUNK_NUMEL elements: the first makes each group's update on
        copies and keeps only its finiteness; the second snapshots each
        group, updates it in place and puts the snapshot back where
        ``skip``. No pass copies the whole state, and nothing is read back
        to the host."""
        with torch.no_grad():
            if self.grad_clip is not None:
                grads = self.grad_clip(grads)
            count = state["step"]
            step = count + 1
            lr = self._lr_at(count)
            grads32 = {k: g.float() for k, g in grads.items()}
            names = list(params)
            if guard is None:
                self._update_names(names, grads32, state, params, step, lr)
                self._set_count(state, step)
                return params, state
            finite = torch.ones((), dtype=torch.bool, device=count.device)
            for chunk in self._chunks(names, params):
                sub, sub_params = self._copies(chunk, state, params)
                self._update_names(chunk, grads32, sub, sub_params, step, lr)
                finite = finite & tree_all_finite(sub_params)
                del sub, sub_params
            skip = guard(finite)
            for chunk in self._chunks(names, params):
                live = self._tensors(chunk, state, params)
                saved = [t.clone() for t in live]
                self._update_names(chunk, grads32, state, params, step, lr)
                for t, old in zip(live, saved):
                    torch.where(skip, old, t, out=t)
                del saved
            self._set_count(state, torch.where(skip, count, step))
        return params, state

    def _update_names(self, names, grads32, state, params, step, lr) -> None:
        """The update of the parameters ``names`` (in place on ``state``
        and ``params``, which may be copies)."""
        sub = {key: ({k: v[k] for k in names} if isinstance(v, dict) else v)
               for key, v in state.items()}
        sub["step"] = step
        work = sub.get("master_weights", {k: params[k] for k in names})
        self._apply({k: grads32[k] for k in names}, sub, work, lr,
                    {k: params[k] for k in names})
        for k in names:
            if work[k] is not params[k]:
                params[k].copy_(work[k])

    def _tensors(self, names, state, params) -> List[torch.Tensor]:
        """Every tensor the update of ``names`` writes (each once): the
        parameters, their masters and their slots."""
        seen, out = set(), []
        trees = [params] + [v for v in state.values() if isinstance(v, dict)]
        for tree in trees:
            for k in names:
                t = tree[k]
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    def _copies(self, names, state, params):
        """``(state, params)`` restricted to ``names``, every tensor a copy
        (a float32 parameter that is its own master stays one tensor)."""
        memo = {}

        def copy(t):
            if id(t) not in memo:
                memo[id(t)] = t.clone()
            return memo[id(t)]

        sub = {key: ({k: copy(v[k]) for k in names} if isinstance(v, dict)
                     else v) for key, v in state.items()}
        return sub, {k: copy(params[k]) for k in names}

    def _chunks(self, names, params):
        """``names`` in order, in groups of at most GUARD_CHUNK_NUMEL
        elements (a larger tensor alone)."""
        chunk, size = [], 0
        for k in names:
            n = params[k].numel()
            if chunk and size + n > self.GUARD_CHUNK_NUMEL:
                yield chunk
                chunk, size = [], 0
            chunk.append(k)
            size += n
        if chunk:
            yield chunk

    # subclass hooks -------------------------------------------------------
    def _init_slots(self, params) -> dict:
        return {}

    def _apply(self, grads, state, work, lr, params) -> None:
        """Update ``work`` (the masters, or the parameters) and the slots
        of ``state`` in place from the float32 ``grads``."""
        raise NotImplementedError

    def _zeros(self, params):
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    def _decayed(self, g: List[torch.Tensor], w: List[torch.Tensor]):
        """L2 decay folded into the gradient, ``g + weight_decay * p``
        (paddle's default ``weight_decay`` for the non-AdamW
        optimizers)."""
        if self.weight_decay:
            return torch._foreach_add(g, [p.float() for p in w],
                                      alpha=self.weight_decay)
        return g

    # ------------------------------------------------------------ stateful API
    def bind(self, params):
        """Attach a parameter dict for the stateful ``step()`` API."""
        self._parameters = params
        self._state = self.init(params)
        return self

    def step(self, params=None, grads=None):
        """Stateful step over the bound parameters. Returns them."""
        if params is None:
            params = self._parameters
        if grads is None:
            grads = self._accumulated_grads
        if self._state is None:
            self._state = self.init(params)
        params, self._state = self.update(grads, self._state, params)
        self._parameters = params
        self._accumulated_grads = None
        return params

    def clear_grad(self, set_to_zero=True):
        self._accumulated_grads = None

    # ------------------------------------------------------------ state dict
    def state_dict(self):
        out = {"state": self._state}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state_dict):
        self._state = state_dict.get("state", self._state)
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])


def _lists(names, *trees):
    return [[tree[k] for k in names] for tree in trees]


class SGD(Optimizer):
    """``p - lr * (g + wd p)`` (``optimizer.py:130``)."""

    def _apply(self, grads, state, work, lr, params):
        names = list(work)
        g, w = _lists(names, grads, work)
        delta = torch._foreach_mul(self._decayed(g, w), lr)
        _sub_in_f32(w, delta)


class Momentum(Optimizer):
    """``v = momentum v + g``, ``p - lr v`` (or Nesterov's ``p - lr (g +
    momentum v)``), ``optimizer.py:140``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _init_slots(self, params):
        return {"velocity": self._zeros(params)}

    def _apply(self, grads, state, work, lr, params):
        names = list(work)
        g, w, v = _lists(names, grads, work, state["velocity"])
        g = self._decayed(g, w)
        torch._foreach_mul_(v, self.momentum)
        torch._foreach_add_(v, g)
        direction = (torch._foreach_add(g, v, alpha=self.momentum)
                     if self.use_nesterov else v)
        _sub_in_f32(w, torch._foreach_mul(direction, lr))


class Adam(Optimizer):
    """Adam (``optimizer.py:171``); ``weight_decay`` is L2, folded into
    the gradient. ``moment_dtype`` is moment1's storage type (the update
    math is float32); moment2 stays float32, as in the reference."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
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
            "moment2": self._zeros(params),
        }

    def _decays(self, name: str) -> bool:
        return False

    def _apply(self, grads, state, work, lr, params):
        b1c = _bias_correction(self.beta1, state["step"])
        b2c = _bias_correction(self.beta2, state["step"])
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
            if isinstance(lr, torch.Tensor):
                # a scheduled rate: lr * wd is a float32 product
                lr_wd = lr * self.weight_decay
                for i in decayed:
                    delta[i].addcmul_(w[i], lr_wd)
            else:
                torch._foreach_add_([delta[i] for i in decayed],
                                    [w[i] for i in decayed],
                                    alpha=lr * self.weight_decay)
        _sub_in_dtype(w, delta)
        for store, val in zip(m_store, m):
            if store is not val:
                store.copy_(val)


class AdamW(Adam):
    """Adam with decoupled weight decay (``optimizer.py:236``):
    ``delta += lr * weight_decay * p``. ``apply_decay_param_fun(name)``
    picks the parameters that decay (all of them when None)."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
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


class Adagrad(Optimizer):
    """``acc += g^2``, ``p - lr g / (sqrt(acc) + eps)``
    (``optimizer.py:277``)."""

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def _init_slots(self, params):
        return {"moment": {k: torch.full_like(
            p, self.initial_accumulator_value, dtype=torch.float32)
            for k, p in params.items()}}

    def _apply(self, grads, state, work, lr, params):
        names = list(work)
        g, w, acc = _lists(names, grads, work, state["moment"])
        g = self._decayed(g, w)
        torch._foreach_addcmul_(acc, g, g)
        denom = torch._foreach_sqrt(acc)
        torch._foreach_add_(denom, self.epsilon)
        delta = torch._foreach_mul(g, lr)
        torch._foreach_div_(delta, denom)
        _sub_in_dtype(w, delta)


class RMSProp(Optimizer):
    """``ms = rho ms + (1 - rho) g^2`` (centered: minus the mean
    gradient's square), ``mom = momentum mom + lr g / sqrt(ms + eps)``,
    ``p - mom`` (``optimizer.py:302``)."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.rho = rho
        self.epsilon = epsilon
        self.momentum = momentum
        self.centered = centered

    def _init_slots(self, params):
        slots = {"mean_square": self._zeros(params),
                 "momentum_buf": self._zeros(params)}
        if self.centered:
            slots["mean_grad"] = self._zeros(params)
        return slots

    def _apply(self, grads, state, work, lr, params):
        names = list(work)
        g, w, ms, mom = _lists(names, grads, work, state["mean_square"],
                               state["momentum_buf"])
        g = self._decayed(g, w)
        torch._foreach_mul_(ms, self.rho)
        torch._foreach_addcmul_(ms, g, g, value=1 - self.rho)
        if self.centered:
            mg = [state["mean_grad"][k] for k in names]
            torch._foreach_mul_(mg, self.rho)
            torch._foreach_add_(mg, g, alpha=1 - self.rho)
            denom = torch._foreach_addcmul(ms, mg, mg, value=-1)
        else:
            denom = [x.clone() for x in ms]
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_sqrt_(denom)
        step = torch._foreach_mul(g, lr)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(mom, self.momentum)
        torch._foreach_add_(mom, step)
        _sub_in_dtype(w, mom)


class Adadelta(Optimizer):
    """``update = sqrt(u2 + eps) / sqrt(g2 + eps) g`` with running means
    ``g2`` of the squared gradients and ``u2`` of the squared updates,
    ``p - lr update`` (``optimizer.py:346``)."""

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.epsilon = epsilon
        self.rho = rho

    def _init_slots(self, params):
        return {"avg_squared_grad": self._zeros(params),
                "avg_squared_update": self._zeros(params)}

    def _apply(self, grads, state, work, lr, params):
        names = list(work)
        g, w, g2, u2 = _lists(names, grads, work, state["avg_squared_grad"],
                              state["avg_squared_update"])
        g = self._decayed(g, w)
        torch._foreach_mul_(g2, self.rho)
        torch._foreach_addcmul_(g2, g, g, value=1 - self.rho)
        upd = torch._foreach_add(u2, self.epsilon)
        torch._foreach_sqrt_(upd)
        denom = torch._foreach_add(g2, self.epsilon)
        torch._foreach_sqrt_(denom)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, g)
        torch._foreach_mul_(u2, self.rho)
        torch._foreach_addcmul_(u2, upd, upd, value=1 - self.rho)
        _sub_in_dtype(w, torch._foreach_mul(upd, lr))


class Adamax(Optimizer):
    """``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g|)``, ``p - lr / b1c m
    / (u + eps)`` (``optimizer.py:378``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slots(self, params):
        return {"moment": self._zeros(params),
                "inf_norm": self._zeros(params)}

    def _apply(self, grads, state, work, lr, params):
        b1c = _bias_correction(self.beta1, state["step"])
        names = list(work)
        g, w, m, u = _lists(names, grads, work, state["moment"],
                            state["inf_norm"])
        g = self._decayed(g, w)
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, g, alpha=1 - self.beta1)
        torch._foreach_mul_(u, self.beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(g))
        delta = torch._foreach_mul(m, lr / b1c)
        denom = torch._foreach_add(u, self.epsilon)
        torch._foreach_div_(delta, denom)
        _sub_in_dtype(w, delta)


class Lamb(Optimizer):
    """Layer-wise adaptive large-batch optimizer (``optimizer.py:407``):
    the Adam direction plus decay, ``r``, scaled per tensor by the trust
    ratio ``||p|| / ||r||``."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.exclude_from_weight_decay_fn = exclude_from_weight_decay_fn

    def _init_slots(self, params):
        return {"moment1": self._zeros(params),
                "moment2": self._zeros(params)}

    def _apply(self, grads, state, work, lr, params):
        b1c = _bias_correction(self.beta1, state["step"])
        b2c = _bias_correction(self.beta2, state["step"])
        names = list(work)
        g, w, m, v = _lists(names, grads, work, state["moment1"],
                            state["moment2"])
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, g, alpha=1 - self.beta1)
        torch._foreach_mul_(v, self.beta2)
        torch._foreach_addcmul_(v, g, g, value=1 - self.beta2)
        r = torch._foreach_div(m, b1c)
        denom = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_div_(r, denom)
        del denom
        for k, p, ri in zip(names, w, r):
            excluded = (self.exclude_from_weight_decay_fn is not None
                        and self.exclude_from_weight_decay_fn(k))
            p32 = p.float()
            if self.weight_decay and not excluded:
                ri.add_(p32, alpha=self.weight_decay)
            w_norm = torch.linalg.vector_norm(p32)
            r_norm = torch.linalg.vector_norm(ri)
            trust = torch.where((w_norm > 0) & (r_norm > 0),
                                w_norm / r_norm, 1.0)
            ri.mul_(lr * trust)
        _sub_in_dtype(w, r)


class LarsMomentum(Optimizer):
    """LARS (``optimizer.py:451``): momentum whose rate is scaled per
    tensor by ``lars_coeff ||p|| / (||g|| + wd ||p|| + eps)``; names
    containing a fragment of ``exclude_from_weight_decay`` take no
    decay."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-8, exclude_from_weight_decay=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.lars_weight_decay = lars_weight_decay
        self.epsilon = epsilon
        self.exclude_from_weight_decay = exclude_from_weight_decay or []

    def _init_slots(self, params):
        return {"velocity": self._zeros(params)}

    def _excluded(self, name) -> bool:
        return any(frag in str(name) for frag in self.exclude_from_weight_decay)

    def _apply(self, grads, state, work, lr, params):
        for k, p in work.items():
            p32, g32, v = p.float(), grads[k], state["velocity"][k]
            p_norm = torch.sqrt(torch.sum(p32 * p32))
            g_norm = torch.sqrt(torch.sum(g32 * g32))
            wd = 0.0 if self._excluded(k) else self.lars_weight_decay
            local_lr = torch.where(
                (p_norm > 0) & (g_norm > 0),
                self.lars_coeff * p_norm / (g_norm + wd * p_norm
                                            + self.epsilon), 1.0)
            v.mul_(self.momentum).add_(lr * local_lr * (g32 + wd * p32))
            p.copy_(p32 - v)


class DGCMomentum(Optimizer):
    """Deep Gradient Compression over momentum (``optimizer.py:513``):
    each step applies only the top ``1 - s`` fraction (by magnitude) of
    the residual-accumulated, momentum-corrected gradient; the rest keeps
    accumulating. Plain momentum up to ``rampup_begin_step``; the sparsity
    then ramps through ``sparsity`` over ``rampup_step`` steps."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 rampup_begin_step=0, rampup_step=1, sparsity=(0.999,),
                 parameters=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self.momentum = momentum
        self.rampup_begin_step = int(rampup_begin_step)
        self.rampup_step = max(int(rampup_step), 1)
        self.sparsity = tuple(float(s) for s in sparsity)

    def _init_slots(self, params):
        return {"velocity": self._zeros(params),
                "residual": self._zeros(params)}

    def _sparsity_at(self, step: torch.Tensor) -> torch.Tensor:
        levels = torch.tensor(self.sparsity, dtype=torch.float32,
                              device=step.device)
        idx = torch.clamp((step - self.rampup_begin_step)
                          * len(self.sparsity) // self.rampup_step,
                          0, len(self.sparsity) - 1)
        return levels[idx.long()]

    @staticmethod
    def _quantile(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """``jnp.quantile(x, q)`` of a 1-d float32 ``x`` (linear
        interpolation between the two nearest ranks)."""
        s = torch.sort(x).values
        pos = q * (x.numel() - 1)
        lo = torch.floor(pos)
        hi_w = pos - lo
        return s[lo.long()] * (1.0 - hi_w) + s[torch.ceil(pos).long()] * hi_w

    def _apply(self, grads, state, work, lr, params):
        step = state["step"]
        use_dgc = step > self.rampup_begin_step
        q = torch.clamp(self._sparsity_at(step), 0.0, 1.0 - 1e-7)
        for k, p in work.items():
            g, u, v = grads[k], state["velocity"][k], state["residual"][k]
            # momentum correction: accumulate momentum-corrected gradients
            u_new = self.momentum * u + g
            v_new = v + u_new
            thr = self._quantile(torch.abs(v_new).reshape(-1), q)
            mask = (torch.abs(v_new) >= thr).to(v_new.dtype)
            # factor masking: transmitted coordinates reset their state
            p32 = p.float()
            p.copy_(torch.where(use_dgc, p32 - lr * (v_new * mask),
                                p32 - lr * u_new))
            u.copy_(torch.where(use_dgc, u_new * (1.0 - mask), u_new))
            v.copy_(torch.where(use_dgc, v_new * (1.0 - mask), v))

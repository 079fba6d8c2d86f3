"""One-call training and evaluation steps (port of ``TrainStep`` and
``EvalStep`` in ``paddle_tpu/framework/jit.py:243,521``).

The JAX package compiles forward, loss, backward and update into one XLA
program with donated buffers. PyTorch runs eagerly, so a
:class:`TrainStep` call does the same four things in order and there is
no compile cache. Other differences, and why:

- the step trains the model's own parameters in place (the optimizer
  updates them under ``torch.no_grad``) instead of donated copies, so
  ``sync_to_model`` has nothing to copy and ``load_from_model`` only
  re-reads the parameter set;
- randomness: each step opens one :func:`~paddle_tpu_torch.nn.layer.
  rng_context` whose stream seeds are ``split_streams(fold_in(base seed,
  step count))``, as the reference folds the count into its base key
  (``jit.py:347``); ``state_dict`` carries the count and the base seed, so
  a resumed run replays its dropout masks.

Not ported (``ROADMAP.md``): the ``GradScaler`` path (``scaler_guard``),
``finite_guard``/``FLAGS_check_nan_inf``, ``watchdog_call``,
``inject_anomaly`` and ``grad_transform``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import random as framework_random
from ..nn.layer import rng_context

__all__ = ["DEFAULT_RNG_STREAMS", "resolve_inputs_fn", "TrainStep",
           "EvalStep"]

DEFAULT_RNG_STREAMS = ("dropout", "rrelu", "gumbel", "default")


def _grad_dtype(dtype):
    """Accumulate low-precision grads in float32."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def resolve_inputs_fn(inputs_fn, loss_fn):
    """Default batch-to-model-inputs mapping: with a ``loss_fn``,
    ``(inputs, labels)`` batches feed the model their first element;
    otherwise the whole batch is the input."""
    if inputs_fn is not None:
        return inputs_fn
    if loss_fn is not None:
        return lambda b: b[0] if isinstance(b, (tuple, list)) else b
    return lambda b: b


def _to_device(batch, device):
    """Arrays and tensors of a batch (nested tuples/lists/dicts) as tensors
    on ``device``; integer arrays become int64 (torch's index type)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        t = torch.as_tensor(batch, device=device)
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        return t
    return batch


class TrainStep:
    """One-call training: ``loss = step(batch)``.

    ``loss_fn(outputs, batch) -> scalar``; with ``loss_fn=None`` the
    model's forward returns the loss itself (GPT given labels). The call
    runs the forward and the loss under the step's random streams, the
    backward, and the optimizer update, and returns the float32 loss as a
    0-d tensor on the model's device.

    ``grad_accum_steps`` (k > 1) accumulates gradients in float32 and
    applies one update every k-th call with their sum (mean when
    ``grad_accum_avg``). ``trainable`` (a predicate on parameter names)
    freezes the parameters it rejects: they get no gradient and no
    optimizer state."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 loss_fn: Optional[Callable] = None,
                 inputs_fn: Optional[Callable] = None,
                 rng_streams=DEFAULT_RNG_STREAMS, grad_accum_steps: int = 1,
                 grad_accum_avg: bool = True,
                 trainable: Optional[Callable[[str], bool]] = None):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.inputs_fn = resolve_inputs_fn(inputs_fn, loss_fn)
        self._trainable = trainable
        self._rng_streams = tuple(rng_streams)
        self.load_from_model()
        self.opt_state = optimizer.init(self.params)
        self._base_seed = framework_random.next_seed()
        self._count = 0
        self.grad_accum_steps = int(grad_accum_steps)
        self.grad_accum_avg = grad_accum_avg
        self._grad_accum = None
        if self.grad_accum_steps > 1:
            self._grad_accum = {
                k: torch.zeros(p.shape, device=p.device,
                               dtype=_grad_dtype(p.dtype))
                for k, p in self.params.items()}

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def _next_count(self):
        count = self._count
        self._count += 1
        do_update = (self.grad_accum_steps <= 1
                     or self._count % self.grad_accum_steps == 0)
        return count, do_update

    def __call__(self, batch):
        count, do_update = self._next_count()
        batch = _to_device(batch, self.device)
        seeds = framework_random.split_streams(
            framework_random.fold_in(self._base_seed, count),
            self._rng_streams)
        names = list(self.params)
        with rng_context(seeds):
            inputs = self.inputs_fn(batch)
            if not isinstance(inputs, (tuple, list)):
                inputs = (inputs,)
            out = self.model(*inputs)
            raw = out if self.loss_fn is None else self.loss_fn(out, batch)
            loss = raw.float()
            grads = torch.autograd.grad(
                loss, [self.params[k] for k in names], allow_unused=True)
        # an unused parameter's gradient is zero, as jax.grad gives it
        grads = {k: torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        if self._grad_accum is not None:
            for k, g in grads.items():
                self._grad_accum[k].add_(g.to(self._grad_accum[k].dtype))
            if not do_update:
                return loss.detach()
            k_steps = float(self.grad_accum_steps)
            grads = {k: (a / k_steps if self.grad_accum_avg else a)
                     .to(grads[k].dtype)
                     for k, a in self._grad_accum.items()}
            for a in self._grad_accum.values():
                a.zero_()
        self.optimizer.update(grads, self.opt_state, self.params)
        return loss.detach()

    # ----------------------------------------------------------- state sync
    def sync_to_model(self):
        """The step trains the model's own parameters: nothing to copy."""
        return self.model

    def load_from_model(self):
        """(Re)read the model's parameters, split by ``trainable``."""
        named = dict(self.model.named_parameters())
        if self._trainable is None:
            self.params = named
        else:
            self.params = {k: p for k, p in named.items()
                           if self._trainable(k)}
            if not self.params:
                raise ValueError("the trainable= predicate selected no "
                                 "parameters: nothing to optimize")
        for k, p in named.items():
            p.requires_grad_(k in self.params)
        return self

    def state_dict(self) -> dict:
        """A snapshot: parameters, the frozen parameters and buffers, the
        optimizer state, the step count and the base seed (the per-step
        streams are ``fold_in(base seed, count)``, so restoring both
        replays a run's dropout masks)."""
        def snap(tree):
            if isinstance(tree, dict):
                return {k: snap(v) for k, v in tree.items()}
            if isinstance(tree, torch.Tensor):
                return tree.detach().clone()
            return tree

        frozen = {k: p for k, p in self.model.named_parameters()
                  if k not in self.params}
        frozen.update(dict(self.model.named_buffers()))
        sd = {"params": snap(self.params), "buffers": snap(frozen),
              "opt_state": snap(self.opt_state), "count": self._count,
              "base_seed": self._base_seed}
        if self._grad_accum is not None:
            sd["grad_accum"] = snap(self._grad_accum)
        return sd

    def set_state_dict(self, sd: dict) -> None:
        """Restore a :meth:`state_dict` (tensors or numpy arrays) into the
        live parameters and optimizer state."""
        device = self.device

        def load_into(live, saved):
            for k, v in saved.items():
                if isinstance(live.get(k), dict):
                    load_into(live[k], v)
                elif isinstance(live.get(k), torch.Tensor):
                    live[k].copy_(torch.as_tensor(v, device=device))
                else:
                    live[k] = v

        with torch.no_grad():
            load_into(self.params, sd["params"])
            model_state = dict(self.model.named_parameters())
            model_state.update(dict(self.model.named_buffers()))
            load_into(model_state, sd.get("buffers", {}))
            load_into(self.opt_state, sd["opt_state"])
            if "grad_accum" in sd and self._grad_accum is not None:
                load_into(self._grad_accum, sd["grad_accum"])
        self._count = int(sd.get("count", 0))
        if sd.get("base_seed") is not None:
            self._base_seed = int(sd["base_seed"])


class EvalStep:
    """Inference step: ``model(*args)`` without autograd."""

    def __init__(self, model: torch.nn.Module):
        self.model = model

    def __call__(self, *args):
        device = next(self.model.parameters()).device
        with torch.no_grad():
            return self.model(*_to_device(args, device))

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
  a resumed run replays its dropout masks;
- the guarded step (a ``GradScaler``, ``FLAGS_check_nan_inf`` or
  ``watchdog_call``) cannot select between the old and the new state as
  the reference's program does (``jnp.where`` over donated buffers), since
  the update is in place: ``Optimizer.update(guard=...)`` first reduces
  the finiteness of the candidate parameters to one device bool, the
  guard classifies the step on the device (:func:`scaler_guard`,
  :func:`finite_guard`), and the update then commits group by group with
  ``torch.where``, so that a skipped step leaves every parameter, master,
  slot and the step count bit-equal. Nothing is read back to the host
  except under ``FLAGS_check_nan_inf``, which raises. Buffers a forward
  updates in place are not rolled back (no ported layer has one).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import flags
from . import random as framework_random
from ..amp.grad_scaler import scale_loss, unscale_and_check, update_scale
from ..nn.layer import rng_context
from .debugging import tree_all_finite

__all__ = ["DEFAULT_RNG_STREAMS", "resolve_inputs_fn", "finite_guard",
           "raise_if_bad_step", "scaler_guard", "TrainStep", "EvalStep"]

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


def finite_guard(grads, params_finite, extra_ok=None) -> torch.Tensor:
    """The ``FLAGS_check_nan_inf`` gate (``jit.py:119``): a 0-d bool
    tensor, True iff every gradient and every parameter the update would
    give is finite (``params_finite``, from ``Optimizer.update``'s first
    pass), and ``extra_ok`` (e.g. a finite loss) when given. The update
    commits only where it is True."""
    ok = tree_all_finite(grads) & params_finite
    if extra_ok is not None:
        ok = ok & extra_ok
    return ok


def raise_if_bad_step(ok, loss) -> None:
    """Host-side companion to :func:`finite_guard`."""
    if not bool(ok):
        raise FloatingPointError(
            f"NaN/Inf detected in gradients or updated parameters "
            f"(FLAGS_check_nan_inf); update skipped, state preserved. "
            f"loss={float(loss)}")


def scaler_guard(loss, found, scaler_state, params_finite):
    """The GradScaler epilogue (``jit.py:155-191``), on the device.
    ``found`` is ``unscale_and_check``'s non-finite-gradients flag and
    ``params_finite`` whether every parameter the update would give (cast
    to its dtype) is finite.

    A non-finite *loss*, or non-finite updated parameters under finite
    gradients (an optimizer-side blow-up), is an **anomaly**; non-finite
    gradients under a finite loss are an ordinary overflow, but only
    while ``scale > 1``: at scale 1 there is no scaling left to blame, so
    it is an anomaly too. Both keep the old state, and only the benign
    overflow drives the back-off, so that a poisoned batch does not walk
    the scale down.

    Returns ``(skip, new_scaler_state, ok, found_inf)``: ``skip`` whether
    the update must not commit, ``ok = ~anomaly`` and ``found_inf`` the
    benign overflows only."""
    # the parameters' term applies only under finite gradients: overflowed
    # gradients give non-finite candidates, and that case is the ordinary
    # overflow classified before it
    anomaly = (~torch.isfinite(loss)
               | (found & (scaler_state["scale"] <= 1.0))
               | (~found & ~params_finite))
    skip = found | anomaly
    found_inf = found & ~anomaly
    return skip, update_scale(scaler_state, found_inf), ~anomaly, found_inf


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
    optimizer state. ``grad_transform`` maps the gradient dict before the
    update. ``donate`` is accepted for the reference's signature: the
    step updates in place, so there is nothing to donate.

    With ``scaler`` (a :class:`~paddle_tpu_torch.amp.GradScaler`) the loss
    is scaled before the backward, the gradients unscaled to float32 and
    checked, the update skipped on the device on overflow or anomaly
    (:func:`scaler_guard`) and the scale grown or backed off there; the
    overflow flags reach the scaler's counters lazily. Under
    ``FLAGS_check_nan_inf`` (without a scaler) the update commits only
    where :func:`finite_guard` allows, and a bad step raises
    ``FloatingPointError`` with the state preserved."""

    def __init__(self, model: torch.nn.Module, optimizer,
                 loss_fn: Optional[Callable] = None,
                 inputs_fn: Optional[Callable] = None,
                 grad_transform: Optional[Callable] = None,
                 donate: bool = True,
                 rng_streams=DEFAULT_RNG_STREAMS, grad_accum_steps: int = 1,
                 grad_accum_avg: bool = True, scaler=None,
                 trainable: Optional[Callable[[str], bool]] = None):
        del donate
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.inputs_fn = resolve_inputs_fn(inputs_fn, loss_fn)
        self.grad_transform = grad_transform
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
        self.scaler = scaler if (scaler is not None
                                 and getattr(scaler, "enable", True)) else None
        if self.scaler is not None and self.grad_accum_steps > 1:
            raise ValueError(
                "GradScaler with grad_accum_steps > 1 is not supported: the "
                "scale could change mid-accumulation window")
        self.scaler_state = None
        if self.scaler is not None:
            self.scaler_state = {
                k: v.to(self.device) if isinstance(v, torch.Tensor) else v
                for k, v in self.scaler.state.items()}
        # the next step's loss is multiplied by this (1.0; NaN after
        # inject_anomaly: a poisoned batch)
        self._pending_poison = 1.0

    def inject_anomaly(self):
        """Poison the next step's loss (and hence its gradients) with NaN:
        the deterministic fault-injection seam. The guard keeps the state;
        ``watchdog_call`` reports the anomaly."""
        self._pending_poison = float("nan")

    def _take_poison(self) -> float:
        p, self._pending_poison = self._pending_poison, 1.0
        return p

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def _next_count(self):
        count = self._count
        self._count += 1
        do_update = (self.grad_accum_steps <= 1
                     or self._count % self.grad_accum_steps == 0)
        return count, do_update

    def _loss_and_grads(self, batch, count, poison):
        """The forward and the loss (times ``poison``) under the step's
        random streams, and the gradient of the loss (scaled, with a
        scaler) for every parameter: ``(float32 loss, grads)``."""
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
            loss = raw.float() * poison
            scaled = (loss if self.scaler_state is None
                      else scale_loss(loss, self.scaler_state))
            grads = torch.autograd.grad(
                scaled, [self.params[k] for k in names], allow_unused=True)
        # an unused parameter's gradient is zero, as jax.grad gives it
        return loss.detach(), {
            k: torch.zeros_like(self.params[k]) if g is None else g
            for k, g in zip(names, grads)}

    def _merged(self, grads, do_update):
        """Gradient merge: the gradients of the update, or None on a call
        that only accumulates."""
        if self._grad_accum is None:
            return grads
        for k, g in grads.items():
            self._grad_accum[k].add_(g.to(self._grad_accum[k].dtype))
        if not do_update:
            return None
        k_steps = float(self.grad_accum_steps)
        merged = {k: (a / k_steps if self.grad_accum_avg else a)
                  .to(grads[k].dtype) for k, a in self._grad_accum.items()}
        for a in self._grad_accum.values():
            a.zero_()
        return merged

    def _step(self, batch, checked: bool):
        """One call: ``(loss, ok, found_inf)``, the flags 0-d device bools
        on a guarded update (a scaler, or ``checked``) and None otherwise
        (no update, or an unguarded one)."""
        count, do_update = self._next_count()
        loss, grads = self._loss_and_grads(batch, count, self._take_poison())
        grads = self._merged(grads, do_update)
        if grads is None:
            return loss, None, None
        if self.grad_transform is not None:
            grads = self.grad_transform(grads)
        if self.scaler_state is None and not checked:
            self.optimizer.update(grads, self.opt_state, self.params)
            return loss, None, None
        flags_out = {}
        if self.scaler_state is not None:
            grads, found = unscale_and_check(grads, self.scaler_state)

            def guard(params_finite):
                skip, flags_out["scaler"], flags_out["ok"], \
                    flags_out["found"] = scaler_guard(
                        loss, found, self.scaler_state, params_finite)
                return skip
        else:
            def guard(params_finite):
                flags_out["ok"] = finite_guard(grads, params_finite,
                                               extra_ok=torch.isfinite(loss))
                flags_out["found"] = torch.zeros_like(flags_out["ok"])
                return ~flags_out["ok"]

        self.optimizer.update(grads, self.opt_state, self.params, guard=guard)
        if self.scaler_state is not None:
            self.scaler_state = flags_out["scaler"]
            self.scaler._note_step(flags_out["found"])
            # mirror the (lazy) scale so the scaler's get_loss_scaling() and
            # state_dict() stay truthful
            self.scaler.state = dict(self.scaler_state)
        return loss, flags_out["ok"], flags_out["found"]

    def __call__(self, batch):
        check = flags.flag("FLAGS_check_nan_inf")
        loss, ok, _ = self._step(batch, checked=check)
        if check and ok is not None:
            raise_if_bad_step(ok, loss)
        return loss

    def watchdog_call(self, batch):
        """One step through the guarded update: ``(loss, ok, found_inf)``,
        all three lazy device tensors; ``ok``/``found_inf`` are None on
        calls that only accumulate (no update happened to check)."""
        return self._step(batch, checked=True)

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
        if self.scaler_state is not None:
            sd["scaler_state"] = snap(self.scaler_state)
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
            if "scaler_state" in sd and self.scaler_state is not None:
                load_into(self.scaler_state, sd["scaler_state"])
                self.scaler.state = dict(self.scaler_state)
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

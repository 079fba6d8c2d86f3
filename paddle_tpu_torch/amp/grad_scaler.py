"""Dynamic loss scaling (port of ``paddle_tpu/amp/grad_scaler.py``):
``init_scale_state``, ``scale_loss``, ``unscale_and_check``,
``update_scale``, ``GradScaler`` and ``AmpScaler``.

The functional core works on a small state dict whose scale and counters
are 0-d tensors: ``TrainStep(scaler=...)`` keeps them on the card, checks
the gradients, skips the update on overflow and grows or backs off the
scale there, with no read-back to the host per step. The scaler records
each step's overflow flag as a device tensor and reads the pending flags
back in one transfer when its counters are read or ``_PENDING_MAX`` flags
are pending.

bf16 training does not need it; it exists for float16.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..framework.debugging import tree_all_finite

__all__ = ["init_scale_state", "scale_loss", "unscale_and_check",
           "update_scale", "GradScaler", "AmpScaler"]


def init_scale_state(init_loss_scaling=2.0 ** 15, incr_ratio=2.0,
                     decr_ratio=0.5, incr_every_n_steps=1000,
                     decr_every_n_nan_or_inf=2, device=None) -> dict:
    return {
        "scale": torch.tensor(init_loss_scaling, dtype=torch.float32,
                              device=device),
        "good_steps": torch.zeros((), dtype=torch.int32, device=device),
        "bad_steps": torch.zeros((), dtype=torch.int32, device=device),
        "incr_ratio": incr_ratio,
        "decr_ratio": decr_ratio,
        "incr_every_n_steps": incr_every_n_steps,
        "decr_every_n_nan_or_inf": decr_every_n_nan_or_inf,
    }


def scale_loss(loss, state):
    return loss * state["scale"]


def unscale_and_check(grads: Dict[str, torch.Tensor],
                      state) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``(unscaled, found_inf)``: every gradient times ``1 / scale`` as
    float32, and a 0-d bool tensor, True iff one of them is not finite.

    float32 on purpose: in the reference ``g * (1 / scale)`` promotes a
    float16 gradient to float32 (the scale is a float32 array), whereas
    torch keeps float16 for a 0-d tensor operand. Unscaled in float16,
    small gradients would underflow where the reference's do not."""
    inv = 1.0 / state["scale"]
    names = [k for k, g in grads.items() if g is not None]
    unscaled = [grads[k].to(torch.float32, copy=True) for k in names]
    torch._foreach_mul_(unscaled, inv)
    out = dict(grads)
    out.update(zip(names, unscaled))
    return out, ~tree_all_finite(unscaled)


def update_scale(state: dict, found_inf) -> dict:
    """The grow/back-off schedule (the reference's update_loss_scaling),
    on whatever device the state lives: after ``incr_every_n_steps`` good
    steps in a row the scale grows by ``incr_ratio``, after
    ``decr_every_n_nan_or_inf`` overflows in a row it backs off by
    ``decr_ratio``, never below 1. Returns a new state."""
    found = torch.as_tensor(found_inf, device=state["scale"].device)
    good = torch.where(found, 0, state["good_steps"] + 1)
    bad = torch.where(found, state["bad_steps"] + 1, 0)
    grow = good >= state["incr_every_n_steps"]
    shrink = bad >= state["decr_every_n_nan_or_inf"]
    scale = state["scale"]
    scale = torch.where(grow, scale * state["incr_ratio"], scale)
    scale = torch.where(shrink,
                        torch.clamp(scale * state["decr_ratio"], min=1.0),
                        scale)
    return {**state, "scale": scale,
            "good_steps": torch.where(grow, 0, good).to(torch.int32),
            "bad_steps": torch.where(shrink, 0, bad).to(torch.int32)}


class GradScaler:
    """Paddle-shaped wrapper over the functional helpers. In a training
    step pass it to ``TrainStep(scaler=...)``, which does the scaling, the
    check, the skip and the schedule on the card; the methods here serve
    the stateful path.

    Skip accounting: :attr:`skipped_step_count` / :attr:`last_overflow_step`
    report how many optimizer updates the scaler suppressed on overflow and
    the 1-based index of the latest one. A TrainStep records its overflow
    flags lazily (device tensors, no per-step read-back); reading either
    property reads the pending flags."""

    # bounded: a long run that never reads the counters must not retain one
    # device tensor per step; past this many pending flags they are read
    # back (one transfer per _PENDING_MAX update steps)
    _PENDING_MAX = 256

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self.enable = enable
        self.use_dynamic = use_dynamic_loss_scaling
        self.state = init_scale_state(init_loss_scaling, incr_ratio,
                                      decr_ratio, incr_every_n_steps,
                                      decr_every_n_nan_or_inf)
        self._step_counter = 0     # update steps observed
        self._skipped = 0
        self._last_overflow = None
        self._pending = []         # [(step index, lazy found_inf flag)]

    def scale(self, loss):
        if not self.enable:
            return loss
        return scale_loss(loss, self.state)

    def unscale_(self, grads):
        if not self.enable:
            return grads, torch.zeros((), dtype=torch.bool)
        return unscale_and_check(grads, self.state)

    def step(self, optimizer, params, grads):
        """Unscale, update through ``optimizer.step`` and keep the old
        parameters on overflow (as the reference: the optimizer's own
        state still advances), update the scale. Returns the parameters."""
        if not self.enable:
            return optimizer.step(params, grads)
        unscaled, found = unscale_and_check(grads, self.state)
        with torch.no_grad():
            old = {k: p.clone() for k, p in params.items()}
            new_params = optimizer.step(params, unscaled)
            for k, p in new_params.items():
                torch.where(found, old[k], p, out=p)
        if self.use_dynamic:
            self.state = update_scale(self.state, found)
        self._note_step(found)
        return new_params

    # ------------------------------------------------------ skip accounting
    def _note_step(self, found_inf) -> None:
        """Record one update step's overflow flag (a lazy device tensor,
        read back when the counters are read or the buffer fills)."""
        self._step_counter += 1
        self._pending.append((self._step_counter, found_inf))
        if len(self._pending) >= self._PENDING_MAX:
            self._sync_pending()

    def _sync_pending(self) -> None:
        if not self._pending:
            return
        # one transfer for the whole buffer
        flags = torch.stack([torch.as_tensor(f).reshape(())
                             for _, f in self._pending]).cpu().tolist()
        for (idx, _), flag in zip(self._pending, flags):
            if flag:
                self._skipped += 1
                self._last_overflow = idx
        self._pending.clear()

    @property
    def skipped_step_count(self) -> int:
        """Optimizer updates suppressed because unscaled grads overflowed."""
        self._sync_pending()
        return self._skipped

    @property
    def last_overflow_step(self):
        """1-based index of the most recent overflow-skipped step (None if
        no step has ever overflowed)."""
        self._sync_pending()
        return self._last_overflow

    def is_enable(self):
        return self.enable

    def get_loss_scaling(self):
        return float(self.state["scale"])

    def state_dict(self):
        return dict(self.state)

    def set_state_dict(self, sd):
        self.state.update(sd)


AmpScaler = GradScaler

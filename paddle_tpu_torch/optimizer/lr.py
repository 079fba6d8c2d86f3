"""Learning-rate schedulers (port of ``paddle_tpu/optimizer/lr.py``).

The reference's dual API is kept: the stateful ``step()``/``get_lr()`` and
the pure ``value_at(step)``, which the optimizer reads at its own step
count. Schedulers live on the host: ``value_at`` returns a numpy float32
and the port never uses ``torch.optim.lr_scheduler``.

The reference computes every ``value_at`` in float32
(``jnp.asarray(step, jnp.float32)``), so this port does too, with numpy
float32 scalars: the learning rate that reaches an update is the
reference's float32 value, not a float64 neighbour of it. Constants enter
as float32 where the reference's weakly typed Python scalars meet a
float32 array.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["LRScheduler", "ConstantLR", "NoamDecay", "ExponentialDecay",
           "NaturalExpDecay", "InverseTimeDecay", "PolynomialDecay",
           "LinearWarmup", "PiecewiseDecay", "CosineAnnealingDecay",
           "StepDecay", "MultiStepDecay", "LambdaDecay",
           "MultiplicativeDecay", "OneCycleLR", "CyclicLR",
           "ReduceOnPlateau"]

_f32 = np.float32


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.step()

    # stateful API ---------------------------------------------------------
    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = float(self.value_at(self.last_epoch))
        return self.last_lr

    def get_lr(self):
        return self.last_lr

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state.get("last_epoch", self.last_epoch)
        self.last_lr = state.get("last_lr", self.last_lr)

    # pure API -------------------------------------------------------------
    def value_at(self, step) -> np.float32:
        raise NotImplementedError


class ConstantLR(LRScheduler):
    def value_at(self, step):
        return _f32(self.base_lr)


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        step = np.maximum(_f32(step), _f32(1.0))
        a = step ** _f32(-0.5)
        b = step * _f32(self.warmup_steps ** -1.5)
        # base_lr * d_model^-0.5 is a Python product, rounded once
        return _f32(self.base_lr * self.d_model ** -0.5) * np.minimum(a, b)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return _f32(self.base_lr) * _f32(self.gamma) ** _f32(step)


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return _f32(self.base_lr) * np.exp(-_f32(self.gamma) * _f32(step))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return _f32(self.base_lr) / (_f32(1) + _f32(self.gamma) * _f32(step))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        step = _f32(step)
        if self.cycle:
            div = np.ceil(np.maximum(step, _f32(1.0)) / _f32(self.decay_steps))
            decay_steps = _f32(self.decay_steps) * np.maximum(div, _f32(1.0))
        else:
            decay_steps = _f32(self.decay_steps)
            step = np.minimum(step, _f32(self.decay_steps))
        frac = (_f32(1) - step / decay_steps) ** _f32(self.power)
        return (_f32(self.base_lr) - _f32(self.end_lr)) * frac \
            + _f32(self.end_lr)


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(end_lr, last_epoch, verbose)

    def value_at(self, step):
        step_f = _f32(step)
        if step_f < self.warmup_steps:
            frac = np.minimum(step_f / _f32(max(self.warmup_steps, 1)),
                              _f32(1.0))
            return _f32(self.start_lr) + _f32(self.end_lr - self.start_lr) \
                * frac
        if isinstance(self.lr_after, LRScheduler):
            return _f32(self.lr_after.value_at(
                np.maximum(step_f - _f32(self.warmup_steps), _f32(0.0))))
        return _f32(self.lr_after)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def value_at(self, step):
        step = _f32(step)
        for b, v in zip(self.boundaries, self.values):
            if step < b:
                return _f32(v)
        return _f32(self.values[-1])


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        step = _f32(step)
        cos = np.cos(_f32(math.pi) * np.minimum(step, _f32(self.T_max))
                     / _f32(self.T_max))
        return _f32(self.eta_min) + _f32(self.base_lr - self.eta_min) \
            * (_f32(1) + cos) / _f32(2)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        k = np.floor(_f32(step) / _f32(self.step_size))
        return _f32(self.base_lr) * _f32(self.gamma) ** k


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        step = _f32(step)
        k = _f32(sum(1.0 for m in self.milestones if step >= m))
        return _f32(self.base_lr) * _f32(self.gamma) ** k


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return _f32(self.base_lr * self.lr_lambda(step))


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        # the product is sequential: a Python float, rounded once
        lr = self.base_lr
        for i in range(1, int(step) + 1):
            lr *= self.lr_lambda(i)
        return _f32(lr)


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(self.initial_lr, last_epoch, verbose)

    def value_at(self, step):
        step = _f32(step)
        up = self.phase_pct * self.total_steps  # Python floats, rounded once
        up_steps, down_steps = _f32(up), _f32(self.total_steps - up)

        def cos_interp(a, b, frac):
            return _f32(b) + _f32(a - b) * (
                _f32(1) + np.cos(_f32(math.pi) * frac)) / _f32(2)

        if step < up_steps:
            frac_up = np.clip(step / np.maximum(up_steps, _f32(1.0)),
                              _f32(0.0), _f32(1.0))
            return cos_interp(self.initial_lr, self.max_lr,
                              _f32(1) - frac_up)
        frac_down = np.clip((step - up_steps)
                            / np.maximum(down_steps, _f32(1.0)),
                            _f32(0.0), _f32(1.0))
        return cos_interp(self.max_lr, self.end_lr, _f32(1) - frac_down)


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", gamma=1.0,
                 last_epoch=-1, verbose=False):
        self.base_lr_c = base_learning_rate
        self.max_lr = max_learning_rate
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down or step_size_up
        self.mode = mode
        self.gamma = gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def value_at(self, step):
        step = _f32(step)
        cycle_len = _f32(self.step_size_up + self.step_size_down)
        cycle = np.floor(step / cycle_len)
        pos = step - cycle * cycle_len
        if pos < self.step_size_up:
            scale = np.clip(pos / _f32(self.step_size_up), _f32(0.0),
                            _f32(1.0))
        else:
            scale = _f32(1.0) - np.clip(
                (pos - _f32(self.step_size_up)) / _f32(self.step_size_down),
                _f32(0.0), _f32(1.0))
        amp = _f32(self.max_lr - self.base_lr_c)
        if self.mode == "triangular2":
            amp = amp / _f32(2.0) ** cycle
        elif self.mode == "exp_range":
            amp = amp * _f32(self.gamma) ** step
        return _f32(self.base_lr_c) + amp * scale


class ReduceOnPlateau(LRScheduler):
    """Driven by a metric through the stateful ``step(metrics)``;
    ``value_at`` answers the current rate at any step."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.base_lr = learning_rate
        self.last_lr = learning_rate
        self.last_epoch = 0

    def value_at(self, step):
        return _f32(self.last_lr)

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return self.last_lr
        current = float(metrics)
        if self.best is None:
            self.best = current
        better = (current < self.best - self._thr()) if self.mode == "min" \
            else (current > self.best + self._thr())
        if better:
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.last_lr

    def _thr(self):
        if self.threshold_mode == "rel":
            return (abs(self.best) * self.threshold if self.best is not None
                    else 0.0)
        return self.threshold

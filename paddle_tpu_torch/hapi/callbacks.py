"""Training callbacks (port of ``paddle_tpu/hapi/callbacks.py``;
framework-free, so copied and adapted).

``Callback`` base + ``CallbackList`` dispatch, and the stock set:
``ProgBarLogger``, ``ModelCheckpoint``, ``EarlyStopping``, ``LRScheduler``,
``History``. The VisualDL writer is replaced by :class:`ScalarLogger`, a
dependency-free JSONL scalar logger with the same role.
"""
from __future__ import annotations

import json
import numbers
import os
import time
from typing import List, Optional

import numpy as np

__all__ = [
    "Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
    "EarlyStopping", "LRScheduler", "History", "ScalarLogger",
    "config_callbacks",
]


class Callback:
    """Base class (reference ``callbacks.py:98``)."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): pass
    def on_train_end(self, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_train_batch_end(self, step, logs=None): pass
    # self-healing events (Model.fit(recovery=...)): a skipped non-finite
    # step, a watchdog-triggered checkpoint rollback, and a preemption
    # notice honored by checkpoint-and-exit
    def on_train_anomaly(self, logs=None): pass
    def on_rollback(self, logs=None): pass
    def on_preemption(self, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def _call(self, name, *args, **kwargs):
        for cb in self.callbacks:
            getattr(cb, name)(*args, **kwargs)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: self._call(name, *a, **k)
        raise AttributeError(name)


def _fmt_logs(logs):
    parts = []
    for k, v in (logs or {}).items():
        if isinstance(v, (list, tuple)):
            v = ", ".join(f"{x:.4f}" if isinstance(x, numbers.Number) else str(x)
                          for x in v)
            parts.append(f"{k}: [{v}]")
        elif isinstance(v, numbers.Number):
            parts.append(f"{k}: {float(v):.4f}")
        else:
            parts.append(f"{k}: {v}")
    return " - ".join(parts)


class ProgBarLogger(Callback):
    """Per-step/epoch console logger (reference ``callbacks.py:290``)."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            total = self.steps if self.steps else "?"
            print(f"step {step + 1}/{total} - {_fmt_logs(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print(f"epoch {epoch + 1} done in {dt:.1f}s - {_fmt_logs(logs)}")

    def on_eval_begin(self, logs=None):
        self._eval_t0 = time.time()

    def on_eval_end(self, logs=None):
        if self.verbose:
            dt = time.time() - getattr(self, "_eval_t0", time.time())
            print(f"Eval done in {dt:.1f}s - {_fmt_logs(logs)}")


class ModelCheckpoint(Callback):
    """Periodic save (reference ``callbacks.py:457``)."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, f"{epoch}")
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LR scheduler (reference ``callbacks.py:527``)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "learning_rate", None) if opt else None
        return lr if hasattr(lr, "step") else None

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving (reference
    ``callbacks.py:614``)."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.baseline = baseline
        self.min_delta = abs(min_delta)
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "auto":
            mode = "max" if "acc" in monitor or monitor.startswith("f") else "min"
        if mode == "min":
            self.monitor_op = np.less
            self.min_delta *= -1
        else:
            self.monitor_op = np.greater
        self.best_value = np.inf if self.monitor_op == np.less else -np.inf
        self.wait_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        if self.baseline is not None:
            self.best_value = self.baseline

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple)):
            current = current[0]
        if self.monitor_op(current - self.min_delta, self.best_value):
            self.best_value = current
            self.wait_epoch = 0
            if self.save_best_model and self.model is not None and \
                    getattr(self.model, "_save_dir", None):
                self.model.save(os.path.join(self.model._save_dir, "best_model"))
        else:
            self.wait_epoch += 1
        if self.wait_epoch > self.patience:
            if self.model is not None:
                self.model.stop_training = True
            if self.verbose:
                print(f"Early stopping: {self.monitor} did not improve for "
                      f"{self.patience + 1} evals (best {self.best_value:.5f})")


class History(Callback):
    """Records per-epoch logs into ``self.history``."""

    def on_train_begin(self, logs=None):
        self.history = {}

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class ScalarLogger(Callback):
    """JSONL scalar logger — the VisualDL-callback role
    (reference ``callbacks.py:741`` VisualDL) without the dependency."""

    def __init__(self, log_dir="./runs", log_freq=1):
        super().__init__()
        self.log_dir = log_dir
        self.log_freq = log_freq
        self._fh = None
        self._global_step = 0

    def _write(self, tag, logs):
        if self._fh is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        rec = {"tag": tag, "step": self._global_step}
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)):
                v = v[0] if v else None
            if isinstance(v, numbers.Number):
                rec[k] = float(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def on_train_batch_end(self, step, logs=None):
        self._global_step += 1
        if step % self.log_freq == 0:
            self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)

    def on_train_end(self, logs=None):
        if self._fh:
            self._fh.close()
            self._fh = None


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, History) for c in cbks):
        cbks.append(History())
    cb_list = CallbackList(cbks)
    cb_list.set_model(model)
    cb_list.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or [],
    })
    return cb_list

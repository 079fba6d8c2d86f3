"""High-level ``Model`` API (port of ``paddle_tpu/hapi/model.py``).

Keras-style ``prepare``/``fit``/``evaluate``/``predict``/``save``/``load``
over a ``torch.nn.Module`` of the port. The step is the port's
:class:`~paddle_tpu_torch.framework.jit.TrainStep`, which trains the
network's own parameters in place, so ``sync_to_model`` has nothing to
copy. Batches come from :class:`~paddle_tpu_torch.io.DataLoader` as numpy
and reach the network's device in the step (or, with ``prefetch_depth``,
in the device prefetch thread).

Differences from the reference, and why:

- ``predict_batch`` returns numpy, bfloat16 outputs as float32 (numpy has
  no bfloat16 without ``ml_dtypes``);
- ``Model.load`` copies a ``.pdopt``'s optimizer state into the live step
  (the port's update runs in place on device tensors);
- the reference's ``train:step`` tracing spans and correlation ids, and
  the prefetch thread's ``h2d_prefetch`` range, wait for the next slice of
  ROADMAP A6 (the observability modules themselves are ported).
"""
from __future__ import annotations

import contextlib
import os
from typing import List

import numpy as np
import torch

from ..framework import io as framework_io
from ..framework.jit import EvalStep, TrainStep, _to_device
from ..framework.tree import tree_map
from ..io.dataloader import DataLoader
from ..io.dataset import Dataset
from ..metric import Metric
from ..observability import tracing as _tracing
from .callbacks import config_callbacks

__all__ = ["Model", "InputSpec"]


class InputSpec:
    """Shape/dtype spec (reference ``paddle.static.InputSpec``)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"


class _HapiTrainStep(TrainStep):
    """TrainStep variant that also returns the model outputs (for
    train-time metric updates): ``step(batch) -> (loss, out)`` and
    ``watchdog_call(batch) -> (loss, out, ok, found_inf)``. The step body
    is shared with :class:`TrainStep` via ``_return_out``."""

    _return_out = True


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x) if x is not None else None


def _as_loader(data, batch_size, shuffle, num_workers, drop_last=False,
               pad_batches=False, length_buckets=None):
    if data is None or isinstance(data, DataLoader):
        return data
    if isinstance(data, Dataset):
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers, drop_last=drop_last,
                          pad_batches=pad_batches,
                          length_buckets=length_buckets)
    return data  # any iterable of batches


def _strip_mask(batch, loader):
    """Pop the trailing validity mask a padding loader appends.

    Returns ``(batch, mask-or-None)``; the mask filters metric updates so
    the repeated filler rows of a padded tail batch don't skew them.
    """
    if (getattr(loader, "pad_batches", False)
            and isinstance(batch, (tuple, list)) and len(batch) >= 2):
        return tuple(batch[:-1]), _to_numpy(batch[-1])
    return batch, None


def _iter_batches(loader, prefetch_depth=0, device=None):
    """Iterate one epoch, optionally through the async device-prefetch
    pipeline (``prefetch_depth`` > 0 enables it, onto the network's
    ``device``; the iterator is closed on every exit path so no producer
    thread leaks)."""
    if not prefetch_depth:
        yield from loader
        return
    from ..io.device_prefetch import prefetch_to_device

    it = prefetch_to_device(iter(loader), depth=prefetch_depth,
                            device=device)
    try:
        yield from it
    finally:
        it.close()


def _mask_leaf(a, mask):
    if isinstance(a, torch.Tensor):
        if a.ndim >= 1 and a.shape[0] == mask.shape[0]:
            return a[torch.from_numpy(mask).to(a.device)]
        return a
    arr = np.asarray(a)
    if arr.ndim >= 1 and arr.shape[0] == mask.shape[0]:
        return arr[mask]
    return arr


def _mask_rows(arrays, valid_mask):
    """Drop padded rows (batch-dim filter) from every matching array.

    No-op when nothing was actually padded — the mask is a small host
    array by the time it gets here.
    """
    if valid_mask is None:
        return arrays
    mask = np.asarray(valid_mask)
    if mask.all():
        return arrays
    return tuple(_mask_leaf(a, mask) for a in arrays)


def _split_batch(batch, n_labels):
    """(inputs..., labels...) -> (inputs tuple, labels tuple)."""
    if not isinstance(batch, (tuple, list)):
        return (batch,), ()
    batch = tuple(batch)
    if n_labels == 0:
        return batch, ()
    return batch[:-n_labels], batch[-n_labels:]


def _host_value(v):
    return float(v) if isinstance(v, torch.Tensor) else v


class Model:
    """``paddle.Model`` analogue (reference ``paddle_tpu/hapi/model.py:157``)."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._inputs = list(inputs) if inputs is not None else None
        self._labels = list(labels) if labels is not None else None
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self._eval_step = None
        self._save_dir = None
        self.stop_training = False

    # ------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("loss must be callable (a loss Layer or function)")
        self._loss = loss
        metrics = metrics or []
        metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        for m in metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be Metric instances, got {type(m)}")
        self._metrics = list(metrics)
        self._amp_configs = amp_configs
        self._train_step = None  # rebuilt lazily on first fit
        self._eval_step = EvalStep(self.network)
        return self

    @property
    def _n_labels(self):
        return len(self._labels) if self._labels is not None else 1

    @property
    def _device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _loss_on_batch(self, out, batch):
        _, labels = _split_batch(batch, self._n_labels)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return self._loss(*outs, *labels)

    def _ensure_train_step(self):
        if self._train_step is None:
            if self._optimizer is None:
                raise RuntimeError("call prepare(optimizer=..., loss=...) first")
            n_lab = self._n_labels

            def inputs_fn(batch):
                ins, _ = _split_batch(batch, n_lab)
                return ins

            # amp_configs={"scaler": GradScaler(...)} runs the guarded
            # update with dynamic loss scaling (framework/jit.py)
            amp = getattr(self, "_amp_configs", None)
            scaler = amp.get("scaler") if isinstance(amp, dict) else None
            self._train_step = _HapiTrainStep(
                self.network, self._optimizer,
                loss_fn=self._loss_on_batch if self._loss else None,
                inputs_fn=inputs_fn, scaler=scaler,
                trainable=getattr(self, "_lora_trainable", None))
        return self._train_step

    # ------------------------------------------------------- batch methods
    def train_batch(self, inputs, labels=None, valid_mask=None):
        inputs = inputs if isinstance(inputs, (tuple, list)) else [inputs]
        labels = [] if labels is None else (
            labels if isinstance(labels, (tuple, list)) else [labels])
        batch = tuple(inputs) + tuple(labels)
        step = self._ensure_train_step()
        loss, out = step(batch)
        metrics = self._update_metrics(out, tuple(labels), valid_mask)
        return [float(loss)] + metrics if metrics else [float(loss)]

    def eval_batch(self, inputs, labels=None, valid_mask=None):
        inputs = inputs if isinstance(inputs, (tuple, list)) else [inputs]
        labels = [] if labels is None else (
            labels if isinstance(labels, (tuple, list)) else [labels])
        self._sync_eval_weights()
        out = self._eval_step(*inputs)
        losses = []
        if self._loss is not None and labels:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            # the step ran the padded shape; the loss drops the filler
            # ROWS. Padded sequence POSITIONS (from length_buckets) are
            # still in the loss — per-position tasks must ignore pad
            # positions in their own loss/metrics.
            outs = _mask_rows(outs, valid_mask)
            lab = _to_device(_mask_rows(tuple(labels), valid_mask),
                             self._device)
            with torch.no_grad():
                losses = [float(self._loss(*outs, *lab))]
        metrics = self._update_metrics(out, tuple(labels), valid_mask)
        return losses + metrics

    def predict_batch(self, inputs):
        inputs = inputs if isinstance(inputs, (tuple, list)) else [inputs]
        self._sync_eval_weights()
        out = self._eval_step(*inputs)
        return tree_map(_to_numpy, out)

    def generate(self, input_ids, max_new_tokens=32, **kwargs):
        """KV-cache generation for causal-LM networks (anything exposing
        ``.generate``); see ``paddle_tpu_torch.models.generation``."""
        if not hasattr(self.network, "generate"):
            raise TypeError(
                f"{type(self.network).__name__} has no generate(); only "
                f"causal-LM networks support Model.generate")
        self._sync_eval_weights()
        return self.network.generate(input_ids, max_new_tokens, **kwargs)

    def serve(self, slots=4, **kwargs):
        """Continuous-batching server over this network (causal-LM
        families exposing ``cache_spec``). Returns a started
        ``paddle_tpu_torch.serving.InferenceServer`` — ``submit()``
        requests, ``shutdown(drain=True)`` when done. Extra kwargs ride
        through to ``InferenceServer``, ``adapter_store=`` (multi-tenant
        LoRA serving, submit with ``adapter_id=``) among them."""
        if not hasattr(self.network, "cache_spec"):
            raise TypeError(
                f"{type(self.network).__name__} has no cache_spec(); only "
                f"causal-LM networks support Model.serve")
        self._sync_eval_weights()
        from ..serving import InferenceServer

        return InferenceServer(self.network, slots=slots, **kwargs).start()

    def _update_metrics(self, out, labels, valid_mask=None):
        if not self._metrics:
            # don't touch (= device-sync) the outputs on the loss-only path
            return []
        vals = []
        outs = out if isinstance(out, (tuple, list)) else (out,)
        outs = _mask_rows(outs, valid_mask)
        labels = _mask_rows(labels, valid_mask)
        for m in self._metrics:
            computed = m.compute(*outs, *labels)
            if not isinstance(computed, (tuple, list)):
                computed = (computed,)
            m.update(*[_to_numpy(c) for c in computed])
            vals.append(m.accumulate())
        return vals

    def _sync_eval_weights(self):
        """Push the train step's live params back into the network so eval
        and save see the trained weights (the port's step trains them in
        place: nothing to copy)."""
        if self._train_step is not None:
            self._train_step.sync_to_model()

    # ------------------------------------------------------------ fit/eval
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            pad_batches=False, length_buckets=None, prefetch_depth=0,
            recovery=None, lora=None):
        """``pad_batches``/``length_buckets`` make batch shapes stable (see
        ``paddle_tpu_torch.io.batching``); ``prefetch_depth`` > 0 streams
        batches to the network's device through the async H2D pipeline
        while the previous step runs (``io.device_prefetch``).

        ``recovery`` (a :class:`paddle_tpu_torch.framework.supervisor.
        RecoveryPolicy` or its kwargs as a dict) turns on self-healing
        training: a numerics watchdog skips non-finite steps on the device
        and escalates to checkpoint rollback with data replay,
        crash/preemption resume via AutoCheckpoint + data cursor, an
        optional hang watchdog, and SIGTERM checkpoint-and-exit (raises
        ``TrainingPreempted`` after the state is durably saved).

        ``lora`` (a :class:`paddle_tpu_torch.lora.LoraConfig` or its
        kwargs as a dict) switches to adapter fine-tuning: the network is
        injected with ``apply_lora`` (idempotent under the same config)
        and only the ``lora_A``/``lora_B`` leaves train; the base is
        frozen and the optimizer state scales with the rank. Composes
        with ``recovery=`` (the step's snapshot holds the frozen base
        too, so a resumed adapter fit is bit-identical)."""
        if lora is not None:
            from ..lora import LoraConfig, apply_lora, is_lora_param

            lcfg = (lora if isinstance(lora, LoraConfig)
                    else LoraConfig(**lora))
            apply_lora(self.network, lcfg)
            self._lora_trainable = is_lora_param
        else:
            # each fit call decides: a plain fit() after an adapter fit
            # is a full fine-tune again (a frozen base that stayed frozen
            # would plateau with no error)
            self._lora_trainable = None
        if (self._train_step is not None
                and self._train_step._trainable
                is not self._lora_trainable):
            # the step's trainable split does not match this call: rebuild
            # it, with fresh optimizer state over the right set (the step
            # trains the network's own parameters, so nothing is lost)
            self._train_step = None
        loader = _as_loader(train_data, batch_size, shuffle, num_workers,
                            drop_last, pad_batches, length_buckets)
        eval_loader = _as_loader(eval_data, batch_size, False, num_workers,
                                 False, pad_batches, length_buckets)
        self._save_dir = save_dir
        self.stop_training = False
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=steps, log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir,
            metrics=self._metrics_name())

        cbks.on_train_begin()
        history = None
        for cb in cbks:
            if cb.__class__.__name__ == "History":
                history = cb
        if recovery is not None:
            return self._fit_supervised(loader, eval_loader, epochs,
                                        eval_freq, num_workers, cbks,
                                        history, recovery, prefetch_depth)
        logs = None
        try:
            for epoch in range(epochs):
                if self.stop_training:
                    break
                cbks.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                logs = {}
                with contextlib.closing(_iter_batches(
                        loader, prefetch_depth, self._device)) as it:
                    for step_i, batch in enumerate(it):
                        cbks.on_train_batch_begin(step_i)
                        batch, mask = _strip_mask(batch, loader)
                        ins, labels = _split_batch(
                            tuple(batch) if isinstance(batch, (tuple, list))
                            else batch, self._n_labels)
                        # step-boundary correlation id: host-side
                        # bookkeeping only (two clock reads and a buffer
                        # append per step)
                        _tracing.set_current(
                            f"fit-{os.getpid():x}-e{epoch}-b{step_i}")
                        with _tracing.span("train:step", epoch=epoch,
                                           batch=step_i):
                            vals = self.train_batch(ins, labels,
                                                    valid_mask=mask)
                        logs = dict(zip(["loss"] + self._metrics_name(),
                                        vals))
                        cbks.on_train_batch_end(step_i, logs)
                if eval_loader is not None and (epoch % eval_freq == 0 or
                                                epoch == epochs - 1):
                    # eval spans must not file into the last train
                    # batch's lane
                    with _tracing.correlate(None):
                        eval_logs = self.evaluate(eval_loader, verbose=0,
                                                  num_workers=num_workers,
                                                  _callbacks=cbks)
                    logs.update({f"eval_{k}": v
                                 for k, v in eval_logs.items()})
                cbks.on_epoch_end(epoch, logs)
        finally:
            # the last step's correlation id must not outlive the fit: a
            # later generate()/evaluate() on this thread would file its
            # spans into the stale train-step lane
            _tracing.set_current(None)
        cbks.on_train_end(logs)
        return history.history if history is not None else None

    def _fit_supervised(self, loader, eval_loader, epochs, eval_freq,
                        num_workers, cbks, history, recovery, prefetch_depth):
        """The self-healing variant of the fit loop (``recovery=...``).

        Differences from the plain loop: steps dispatch through
        ``watchdog_call`` (lazy numerics flags, read back every
        ``check_interval`` batches), the epoch/batch position is tracked as
        a :class:`DataCursor` recorded into every checkpoint, a rollback
        rewinds ``(epoch, batch)`` to the checkpoint's cursor (optionally
        jumping a ``skip_window`` of offending batches), and a SIGTERM
        checkpoints then raises :class:`TrainingPreempted`.
        """
        from ..framework.supervisor import (RecoveryPolicy, RollbackRequested,
                                            TrainingPreempted,
                                            TrainingSupervisor)
        from ..io.cursor import DataCursor, resume_batches

        policy = (recovery if isinstance(recovery, RecoveryPolicy)
                  else RecoveryPolicy(**recovery))
        step = self._ensure_train_step()
        sup = TrainingSupervisor(step, policy)
        sup.on_anomaly = lambda info: cbks.on_train_anomaly(info)
        sup.on_rollback = lambda info: cbks.on_rollback(info)
        sup.on_preemption = lambda info: cbks.on_preemption(info)
        sup.start()
        logs = {}
        epoch, start_batch = 0, 0
        preempted = False
        it = None
        try:
            cursor = sup.restore()
            if cursor is not None:
                epoch, start_batch = cursor.epoch, cursor.batch_index
                if hasattr(loader, "_epoch_seed"):
                    loader._epoch_seed = cursor.epoch_seed
            while epoch < epochs:
                if self.stop_training:
                    break
                cbks.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                step_i = start_batch - 1
                try:
                    # the seed stream THIS epoch consumes: _epoch_seed is
                    # read-then-incremented when the iterator builds its
                    # worker pool, so snapshot it BEFORE iter() — recording
                    # the post-increment value would replay a resumed epoch
                    # with the NEXT epoch's augmentation streams
                    epoch_seed = getattr(loader, "_epoch_seed", 0)
                    # a resumed/rolled-back epoch fast-forwards at the
                    # sampler level where possible (io/cursor.py); fresh
                    # epochs keep the async prefetch pipeline
                    if start_batch > 0:
                        it = resume_batches(loader, start_batch)
                    else:
                        it = _iter_batches(loader, prefetch_depth,
                                           self._device)
                    offset, start_batch = start_batch, 0
                    for rel_i, batch in enumerate(it):
                        step_i = offset + rel_i
                        if sup.should_skip(epoch, step_i):
                            continue
                        cbks.on_train_batch_begin(step_i)
                        batch, mask = _strip_mask(batch, loader)
                        ins, labels = _split_batch(
                            tuple(batch) if isinstance(batch, (tuple, list))
                            else batch, self._n_labels)
                        next_cursor = DataCursor(
                            epoch=epoch, batch_index=step_i + 1,
                            epoch_seed=epoch_seed,
                            global_step=step._count + 1)
                        sup.before_batch()  # also stamps the step's corr id
                        with _tracing.span("train:step", epoch=epoch,
                                           batch=step_i):
                            loss, out, ok, found = step.watchdog_call(
                                tuple(ins) + tuple(labels))
                        metrics = self._update_metrics(out, tuple(labels),
                                                       mask)
                        # the loss stays LAZY in the logs — forcing it every
                        # step would defeat the batched watchdog sync; it
                        # materialises when a callback formats it
                        logs = dict(zip(["loss"] + self._metrics_name(),
                                        [loss] + metrics))
                        sup.after_batch(epoch, step_i, loss, ok, found,
                                        cursor=next_cursor)
                        cbks.on_train_batch_end(step_i, logs)
                    sup.finish_epoch()  # drains flags; may request rollback
                except RollbackRequested as rb:
                    # leaving the epoch early: its worker pool and prefetch
                    # thread end now, not when the iterator is collected
                    it.close()
                    if rb.cursor is not None:
                        epoch, start_batch = (rb.cursor.epoch,
                                              rb.cursor.batch_index)
                        if hasattr(loader, "_epoch_seed"):
                            loader._epoch_seed = rb.cursor.epoch_seed
                    else:
                        # no checkpoint to return to: the guarded update
                        # preserved the state, so continue past the anomaly
                        start_batch = step_i + 1
                    continue
                logs = {k: _host_value(v) for k, v in logs.items()}
                if eval_loader is not None and (epoch % eval_freq == 0 or
                                                epoch == epochs - 1):
                    # eval spans must not file into the last train batch's
                    # lane (corr stamped by before_batch)
                    with _tracing.correlate(None):
                        eval_logs = self.evaluate(eval_loader, verbose=0,
                                                  num_workers=num_workers,
                                                  _callbacks=cbks)
                    logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
                cbks.on_epoch_end(epoch, logs)
                epoch += 1
            # a final snapshot whose cursor points past the end, so a
            # restarted job notices the run is complete instead of
            # re-training the last window
            sup.save_now(cursor=DataCursor(epoch=epoch, batch_index=0,
                                           epoch_seed=getattr(
                                               loader, "_epoch_seed", 0),
                                           global_step=step._count))
        except TrainingPreempted:
            preempted = True
            raise
        finally:
            if it is not None:
                it.close()
            sup.stop()
            if not preempted:
                cbks.on_train_end(logs or None)
        return history.history if history is not None else None

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, _callbacks=None,
                 pad_batches=False, length_buckets=None):
        loader = _as_loader(eval_data, batch_size, False, num_workers,
                            False, pad_batches, length_buckets)
        cbks = _callbacks or config_callbacks(
            callbacks, model=self, batch_size=batch_size,
            steps=len(loader) if hasattr(loader, "__len__") else None,
            log_freq=log_freq, verbose=verbose, metrics=self._metrics_name(),
            mode="eval")
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        logs = {}
        loss_sum, n = 0.0, 0
        for step_i, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step_i)
            batch, mask = _strip_mask(batch, loader)
            ins, labels = _split_batch(
                tuple(batch) if isinstance(batch, (tuple, list)) else batch,
                self._n_labels)
            vals = self.eval_batch(ins, labels, valid_mask=mask)
            names = (["loss"] if self._loss is not None and labels else []) + \
                self._metrics_name()
            logs = dict(zip(names, vals))
            if "loss" in logs:
                loss_sum += logs["loss"]
                n += 1
            cbks.on_eval_batch_end(step_i, logs)
        if n:
            logs["loss"] = loss_sum / n
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                verbose=1, callbacks=None):
        loader = _as_loader(test_data, batch_size, False, num_workers)
        outputs = []
        for batch in loader:
            batch = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
            batch, mask = _strip_mask(batch, loader)
            # with an inputs spec, anything beyond it (labels) is dropped,
            # as the reference does via self._inputs
            if self._inputs is not None:
                batch = batch[: len(self._inputs)]
            out = self.predict_batch(batch)
            if mask is not None and not mask.all():
                # drop the padded filler rows from the prediction
                out = tree_map(lambda a: _mask_leaf(a, mask), out)
            outputs.append(out)
        if stack_outputs and outputs:
            outputs = tree_map(lambda *xs: np.concatenate(xs, 0), *outputs)
        return outputs

    def _metrics_name(self):
        names = []
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    # ------------------------------------------------------------- save/load
    def save(self, path, training=True):
        """Save ``path + '.pdparams'`` (+ ``'.pdopt'`` when training)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._sync_eval_weights()
        framework_io.save(self.network.state_dict(), path + ".pdparams")
        if training and self._train_step is not None:
            framework_io.save(
                {"opt_state": self._train_step.opt_state,
                 "count": self._train_step._count},
                path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        state = framework_io.load(path + ".pdparams")
        self.network.load_state_dict(state, strict=not skip_mismatch)
        if self._train_step is not None:
            self._train_step.load_from_model()
            if not reset_optimizer and os.path.exists(path + ".pdopt"):
                opt = framework_io.load(path + ".pdopt")
                self._train_step.set_state_dict(
                    {"params": {}, "opt_state": opt["opt_state"],
                     "count": opt.get("count", 0)})
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary

        if input_size is None and self._inputs:
            input_size = [tuple(s.shape) for s in self._inputs]
        return summary(self.network, input_size, dtypes=dtype)

"""Metrics API (port of ``paddle_tpu/metric/__init__.py``).

``Metric`` base with ``compute``/``update``/``accumulate``/``reset``/``name``
and the stock metrics: ``Accuracy``, ``Precision``, ``Recall``, ``Auc``.

``compute`` runs on the step's outputs where they lie (torch ops, on the
card in training); ``update`` accumulates the small per-batch statistics on
host numpy, the split the reference draws. Top-k ranks as the reference's
``jnp.argsort(...)[..., ::-1]`` does: a stable ascending sort reversed, so
among tied scores the later class comes first (``torch.topk`` orders ties
otherwise).
"""
from __future__ import annotations

import abc
from typing import Sequence

import numpy as np

import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _topk_desc(pred: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest scores along the last axis, in the
    reference's order: ``argsort`` ascending (stable), reversed."""
    order = torch.argsort(pred, dim=-1, stable=True)
    return order.flip(-1)[..., :k]


class Metric(abc.ABC):
    """Base metric (reference ``python/paddle/metric/metrics.py:47``)."""

    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        raise NotImplementedError

    @abc.abstractmethod
    def update(self, *args):
        raise NotImplementedError

    @abc.abstractmethod
    def accumulate(self):
        raise NotImplementedError

    @abc.abstractmethod
    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Device-side pre-processing; outputs feed ``update`` on host."""
        return args


class Accuracy(Metric):
    """Top-k accuracy (reference ``metrics.py:153``)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred = _topk_desc(_as_tensor(pred), self.maxk)
        label = _as_tensor(label).to(pred.device)
        if label.ndim == pred.ndim:
            label = label[..., :1]
        else:
            label = label[..., None]
        return (pred == label).float()

    def update(self, correct, *args):
        if isinstance(correct, torch.Tensor):
            correct = correct.cpu().numpy()
        correct = np.asarray(correct)
        accs = []
        for k in self.topk:
            num_corrects = correct[..., :k].any(-1).sum()
            num_samples = correct[..., 0].size
            accs.append(float(num_corrects) / max(num_samples, 1))
            self.total[self.topk.index(k)] += float(num_corrects)
            self.count[self.topk.index(k)] += num_samples
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision (reference ``metrics.py:285``)."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        pred_pos = preds > 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fp += int(np.sum(pred_pos & (labels == 0)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall (reference ``metrics.py:383``)."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        pred_pos = preds > 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fn += int(np.sum(~pred_pos & (labels == 1)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via histogram buckets (reference ``metrics.py:480``; the
    bucketed stat pair is exactly what the reference's distributed AUC
    all-reduces across trainers, ``fleet/metrics.cc``)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self.curve = curve
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        idx = np.minimum(
            (pos_prob * self.num_thresholds).astype(np.int64), self.num_thresholds)
        pos = labels == 1
        np.add.at(self._stat_pos, idx[pos], 1)
        np.add.at(self._stat_neg, idx[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, dtype=np.int64)

    @property
    def stat_pos(self):
        return self._stat_pos

    @property
    def stat_neg(self):
        return self._stat_neg

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            prev_pos, prev_neg = tot_pos, tot_neg
            tot_pos += float(self._stat_pos[i])
            tot_neg += float(self._stat_neg[i])
            auc += self.trapezoid_area(prev_neg, tot_neg, prev_pos, tot_pos)
        denom = tot_pos * tot_neg
        return auc / denom if denom else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy (``paddle.metric.accuracy``)."""
    topk_idx = _topk_desc(_as_tensor(input), k)
    label = _as_tensor(label).to(topk_idx.device)
    if label.ndim == topk_idx.ndim:
        lab = label[..., :1]
    else:
        lab = label[..., None]
    hit = (topk_idx == lab).any(-1)
    return hit.float().mean()

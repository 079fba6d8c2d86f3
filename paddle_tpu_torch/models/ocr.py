"""Text recognition: CRNN with CTC (port of ``paddle_tpu/models/ocr.py``,
the PP-OCR-class recognizer).

Four conv + BN + ReLU blocks collapse a height-32 crop to one row with
stride-(2, 1) steps, so the width becomes the time axis (T = W / 4); a
bidirectional :class:`~paddle_tpu_torch.nn.layers.rnn.LSTM` (a loop over
time in torch ops) and a linear head give time-major logits ``[T, B,
classes]``, trained with :func:`~paddle_tpu_torch.nn.functional.
ctc_loss` and decoded greedily on the host. Layer names are the
reference's (:func:`paddle_tpu_torch.convert.crnn_from_jax`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import default_device
from ..nn import functional as F
from ..nn.layers.common import Linear
from ..nn.layers.conv import Conv2D
from ..nn.layers.norm import BatchNorm2D
from ..nn.layers.rnn import LSTM

__all__ = ["CRNN", "crnn_tiny"]


class _ConvBN(nn.Module):
    def __init__(self, cin, cout, stride, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = Conv2D(cin, cout, 3, stride=stride, padding=1,
                           bias_attr=False, **kw)
        self.bn = BatchNorm2D(cout, **kw)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class CRNN(nn.Module):
    """``forward(images [B, C, 32, W]) -> logits [T, B, classes]``
    (time-major for CTC; T = W/4); ``loss`` wires ``ctc_loss``;
    ``decode`` does greedy collapse. Built on ``device`` (None: ``cuda``;
    it raises without one unless ``device="cpu"``), drawing from
    ``generator`` when one is given."""

    def __init__(self, num_classes: int, in_channels: int = 3,
                 width: int = 32, hidden: int = 64, blank: int = 0, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=default_device(device), generator=generator)
        self.blank = blank
        w = width
        # height 32 -> 1: two (2, 2), one (2, 1), one (4, 1); width / 4
        self.stem = _ConvBN(in_channels, w, (2, 2), **kw)   # 16 x W/2
        self.c2 = _ConvBN(w, w * 2, (2, 2), **kw)           # 8 x W/4
        self.c3 = _ConvBN(w * 2, w * 4, (2, 1), **kw)       # 4 x W/4
        self.c4 = _ConvBN(w * 4, w * 4, (4, 1), **kw)       # 1 x W/4
        self.rnn = LSTM(w * 4, hidden, direction="bidirect",
                        time_major=True, **kw)
        self.head = Linear(2 * hidden, num_classes, **kw)

    def forward(self, images):
        f = self.c4(self.c3(self.c2(self.stem(images))))   # [B, C, 1, T]
        seq = f[:, :, 0, :].permute(2, 0, 1)               # [T, B, C]
        out, _ = self.rnn(seq)
        return self.head(out)                              # [T, B, classes]

    def loss(self, images, labels, label_lengths):
        logits = self.forward(images)
        T, B, _ = logits.shape
        input_lengths = torch.full((B,), T, dtype=torch.long,
                                   device=logits.device)
        return F.ctc_loss(logits, labels, input_lengths, label_lengths,
                          blank=self.blank)

    @staticmethod
    def greedy_collapse(ids, blank: int = 0):
        """Per sequence of ``ids`` ``[T, B]`` (host array): repeats
        collapsed, blanks dropped; a list of id lists."""
        outs = []
        for b in range(ids.shape[1]):
            prev, seq = -1, []
            for t in ids[:, b]:
                if t != prev and t != blank:
                    seq.append(int(t))
                prev = t
            outs.append(seq)
        return outs

    @torch.no_grad()
    def decode(self, images):
        """Greedy CTC decode: argmax per frame on the device, one
        read-back, then repeats collapsed and blanks dropped on the host.
        Returns a list of id lists."""
        ids = torch.argmax(self.forward(images), dim=-1).cpu().numpy()
        return self.greedy_collapse(ids, self.blank)


def crnn_tiny(num_classes: int = 11, **kw) -> CRNN:
    kw.setdefault("width", 8)
    kw.setdefault("hidden", 32)
    return CRNN(num_classes=num_classes, **kw)

"""YOLOv3-style detector (port of ``paddle_tpu/models/yolo.py``): a
DarkNet-style backbone emitting stride 8/16/32 features, one conv neck
and head per scale, trained with :func:`~paddle_tpu_torch.vision.ops.
yolo_loss` and decoded with ``yolo_box`` + ``matrix_nms``.

Layer names and layouts are the reference's, so a reference
``state_dict()`` loads by name (:func:`paddle_tpu_torch.convert.
yolov3_from_jax`). ``predict`` decodes each scale on the device and runs
``matrix_nms`` on the host over one read-back.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import default_device
from ..nn import functional as F
from ..nn.layers.containers import LayerList
from ..nn.layers.conv import Conv2D
from ..nn.layers.norm import BatchNorm2D
from ..vision import ops as V

__all__ = ["ConvBNLayer", "DarkNetLite", "YOLOv3", "DEFAULT_ANCHORS",
           "DEFAULT_ANCHOR_MASKS"]

# canonical COCO-style anchors (width, height in input pixels) per scale
DEFAULT_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
                   116, 90, 156, 198, 373, 326]
DEFAULT_ANCHOR_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]


class ConvBNLayer(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=k // 2,
                           bias_attr=False, **kw)
        self.bn = BatchNorm2D(cout, **kw)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), negative_slope=0.1)


class DarkNetLite(nn.Module):
    """Small DarkNet-style backbone emitting stride 8/16/32 features."""

    def __init__(self, width: int = 32, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        w = width
        self.stem = ConvBNLayer(3, w, 3, **kw)
        self.s4 = ConvBNLayer(w, w * 2, 3, stride=2, **kw)       # /2
        self.s4b = ConvBNLayer(w * 2, w * 2, 3, stride=2, **kw)  # /4
        self.s8 = ConvBNLayer(w * 2, w * 4, 3, stride=2, **kw)   # /8
        self.s16 = ConvBNLayer(w * 4, w * 8, 3, stride=2, **kw)  # /16
        self.s32 = ConvBNLayer(w * 8, w * 16, 3, stride=2, **kw)  # /32

    def forward(self, x):
        x = self.s4b(self.s4(self.stem(x)))
        c8 = self.s8(x)
        c16 = self.s16(c8)
        c32 = self.s32(c16)
        return c8, c16, c32


class YOLOv3(nn.Module):
    """3-scale detector: ``forward(images) -> [head32, head16, head8]``
    raw maps; ``loss`` / ``predict`` wrap the op family. Built on
    ``device`` (None: ``cuda``; it raises without one unless
    ``device="cpu"``), drawing from ``generator`` when one is given."""

    def __init__(self, num_classes: int = 80, width: int = 32,
                 anchors: Sequence[int] = DEFAULT_ANCHORS,
                 anchor_masks: Sequence[Sequence[int]] = DEFAULT_ANCHOR_MASKS,
                 ignore_thresh: float = 0.7, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=default_device(device), generator=generator)
        self.num_classes = num_classes
        self.anchors = list(anchors)
        self.anchor_masks = [list(m) for m in anchor_masks]
        self.ignore_thresh = ignore_thresh
        self.backbone = DarkNetLite(width, **kw)
        w = width
        chans = [w * 16, w * 8, w * 4]  # stride 32, 16, 8
        out_c = [len(m) * (5 + num_classes) for m in self.anchor_masks]
        self.necks = LayerList([ConvBNLayer(c, c, 3, **kw) for c in chans])
        self.heads = LayerList([Conv2D(c, oc, 1, **kw)
                                for c, oc in zip(chans, out_c)])
        self.downsample_ratios = [32, 16, 8]

    def forward(self, images):
        c8, c16, c32 = self.backbone(images)
        return [head(neck(feat)) for feat, neck, head in
                zip((c32, c16, c8), self.necks, self.heads)]

    def loss(self, images, gt_box, gt_label, gt_score=None):
        """Summed multi-scale ``yolo_loss`` (each scale's per-image
        mean)."""
        total = 0.0
        for out, mask, ds in zip(self.forward(images), self.anchor_masks,
                                 self.downsample_ratios):
            total = total + V.yolo_loss(
                out, gt_box, gt_label, anchors=self.anchors,
                anchor_mask=mask, class_num=self.num_classes,
                ignore_thresh=self.ignore_thresh, downsample_ratio=ds,
                gt_score=gt_score).mean()
        return total

    def _decode(self, heads, img_size, conf_thresh):
        """Every scale's ``yolo_box``: boxes ``[N, M, 4]`` and scores
        ``[N, C, M]``."""
        boxes_all, scores_all = [], []
        for out, mask, ds in zip(heads, self.anchor_masks,
                                 self.downsample_ratios):
            scale_anchors = []
            for a in mask:
                scale_anchors += self.anchors[2 * a:2 * a + 2]
            b, s = V.yolo_box(out, img_size, scale_anchors, self.num_classes,
                              conf_thresh, ds)
            boxes_all.append(b)
            scores_all.append(s)
        return (torch.cat(boxes_all, dim=1),
                torch.cat(scores_all, dim=1).transpose(1, 2))

    @torch.no_grad()
    def predict(self, images, img_size, conf_thresh: float = 0.01,
                post_threshold: float = 0.01, nms_top_k: int = 400,
                keep_top_k: int = 100):
        """Decode + matrix-NMS. Returns ``(dets [R, 6], rois_num [N])``
        with rows [label, score, x1, y1, x2, y2]."""
        boxes, scores = self._decode(self.forward(images), img_size,
                                     conf_thresh)
        return V.matrix_nms(boxes, scores, conf_thresh, post_threshold,
                            nms_top_k, keep_top_k, background_label=-1)

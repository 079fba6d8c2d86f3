"""PP-YOLOE (port of ``paddle_tpu/models/ppyoloe.py``): a CSPRepResNet
backbone, a CSP-PAN neck and the anchor-free ET-head, trained with
task-aligned assignment (TAL), varifocal, GIoU and distribution focal
losses, and served after folding every :class:`RepConv` into one conv.

Layer names, layouts and draws are the reference's, so a reference
``state_dict()`` loads by name before and after ``fuse_rep()``
(:func:`paddle_tpu_torch.convert.ppyoloe_from_jax`): a fused
:class:`RepConv` gains the sublayer ``_fused`` beside its two branches,
as the reference's does. Where parity is easy to lose:

- ``CSPPAN._up`` is the reference's ``jax.image.resize(method=
  "nearest")`` at exactly 2x, which repeats each pixel twice along both
  axes;
- the assignment reads detached scores and boxes; a gt's top-k threshold
  is its k-th largest metric and candidates are taken with ``>=`` (ties
  admit more than k anchors); an anchor claimed by several gts goes to
  the first of the largest metrics;
- ``loss`` weighs negatives by ``0.75 p²``, normalises by ``max(Σ q,
  1)``, clips the DFL target below ``reg_max - 0.01`` and sums the three
  terms with weights 1, 2 and 0.5.

``predict`` decodes on the device and runs ``matrix_nms`` on the host
(one read-back of the boxes and scores).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .. import default_device
from ..nn import functional as F
from ..nn.initializer import Constant
from ..nn.layers.containers import LayerList
from ..nn.layers.conv import Conv2D
from ..nn.layers.norm import BatchNorm2D
from ..vision import ops as V

__all__ = ["PPYOLOE", "ppyoloe_tiny", "ppyoloe_s"]


class ConvBNAct(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, act=True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=k // 2,
                           bias_attr=False, **kw)
        self.bn = BatchNorm2D(cout, **kw)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class RepConv(nn.Module):
    """Re-parameterizable conv: training runs 3x3 + 1x1 branches summed;
    :meth:`fuse` folds both (conv + BN each, at the running statistics)
    into one biased 3x3 conv, the sublayer ``_fused``, for serving."""

    def __init__(self, cin, cout, stride=1, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.b3 = ConvBNAct(cin, cout, 3, stride, act=False, **kw)
        self.b1 = ConvBNAct(cin, cout, 1, stride, act=False, **kw)
        self._fused = None

    def forward(self, x):
        if self._fused is not None:
            return F.silu(self._fused(x))
        return F.silu(self.b3(x) + self.b1(x))

    @staticmethod
    def _fold_bn(conv, bn):
        """(conv W, BN) -> equivalent (W', b')."""
        std = torch.sqrt(bn._variance + bn.epsilon)
        w2 = conv.weight * (bn.weight / std)[:, None, None, None]
        b2 = bn.bias - bn.weight * bn._mean / std
        return w2, b2

    @torch.no_grad()
    def fuse(self) -> None:
        """Fold both branches into one 3x3 conv (inference only)."""
        w3, b3 = self._fold_bn(self.b3.conv, self.b3.bn)
        w1, b1 = self._fold_bn(self.b1.conv, self.b1.bn)
        w1 = nn.functional.pad(w1, (1, 1, 1, 1))  # 1x1 -> 3x3
        stride = self.b3.conv.stride
        if isinstance(stride, (tuple, list)):
            stride = stride[0]
        fused = Conv2D(self.b3.conv.in_channels, self.b3.conv.out_channels,
                       3, stride=stride, padding=1, weight_attr=Constant(0.0),
                       bias_attr=Constant(0.0), device=w3.device)
        fused.weight.copy_(w3 + w1)
        fused.bias.copy_(b3 + b1)
        self._fused = fused


class ESE(nn.Module):
    """Effective squeeze-excite: one linear gate on pooled features."""

    def __init__(self, ch, *, device=None, generator=None):
        super().__init__()
        self.fc = Conv2D(ch, ch, 1, device=device, generator=generator)

    def forward(self, x):
        g = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc(g))


class CSPResStage(nn.Module):
    """CSP split + n RepConv blocks + ESE, stride-2 entry."""

    def __init__(self, cin, cout, n, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.down = ConvBNAct(cin, cout, 3, stride=2, **kw)
        mid = cout // 2
        self.split_a = ConvBNAct(cout, mid, 1, **kw)
        self.split_b = ConvBNAct(cout, mid, 1, **kw)
        self.blocks = LayerList([RepConv(mid, mid, **kw) for _ in range(n)])
        self.attn = ESE(cout, **kw)
        self.out_conv = ConvBNAct(cout, cout, 1, **kw)

    def forward(self, x):
        x = self.down(x)
        a = self.split_a(x)
        b = self.split_b(x)
        for blk in self.blocks:
            b = blk(b)
        return self.out_conv(self.attn(torch.cat([a, b], dim=1)))


class CSPRepBackbone(nn.Module):
    """Stem + 3 CSPRep stages emitting stride 8/16/32 features."""

    def __init__(self, width=32, depths=(1, 2, 2), *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        w = width
        self.stem = ConvBNAct(3, w, 3, stride=2, **kw)        # /2
        self.stem2 = ConvBNAct(w, w * 2, 3, stride=2, **kw)   # /4
        self.s8 = CSPResStage(w * 2, w * 4, depths[0], **kw)   # /8
        self.s16 = CSPResStage(w * 4, w * 8, depths[1], **kw)  # /16
        self.s32 = CSPResStage(w * 8, w * 16, depths[2], **kw)  # /32
        self.out_channels = [w * 4, w * 8, w * 16]

    def forward(self, x):
        x = self.stem2(self.stem(x))
        c8 = self.s8(x)
        c16 = self.s16(c8)
        c32 = self.s32(c16)
        return c8, c16, c32


class CSPPAN(nn.Module):
    """PAN neck: top-down then bottom-up fusion with conv blocks."""

    def __init__(self, chans: Sequence[int], *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        c8, c16, c32 = chans
        self.lat32 = ConvBNAct(c32, c16, 1, **kw)
        self.td16 = ConvBNAct(c16 + c16, c16, 3, **kw)
        self.lat16 = ConvBNAct(c16, c8, 1, **kw)
        self.td8 = ConvBNAct(c8 + c8, c8, 3, **kw)
        self.bu16 = ConvBNAct(c8, c16, 3, stride=2, **kw)
        self.fuse16 = ConvBNAct(c16 + c16, c16, 3, **kw)
        self.bu32 = ConvBNAct(c16, c16, 3, stride=2, **kw)
        self.fuse32 = ConvBNAct(c16 + c16, c16, 3, **kw)
        self.out_channels = [c8, c16, c16]

    @staticmethod
    def _up(x):
        """Nearest 2x upsampling: each pixel repeated along H and W."""
        B, C, H, W = x.shape
        return x[:, :, :, None, :, None].expand(B, C, H, 2, W, 2).reshape(
            B, C, 2 * H, 2 * W)

    def forward(self, c8, c16, c32):
        p32 = self.lat32(c32)
        p16 = self.td16(torch.cat([self._up(p32), c16], dim=1))
        p8 = self.td8(torch.cat([self._up(self.lat16(p16)), c8], dim=1))
        n16 = self.fuse16(torch.cat([self.bu16(p8), p16], dim=1))
        n32 = self.fuse32(torch.cat([self.bu32(n16), p32], dim=1))
        return p8, n16, n32


class ETHead(nn.Module):
    """Anchor-free head: per cell, class logits + 4*(reg_max+1) DFL bins;
    the class biases start at -log(99) (a prior of 0.01)."""

    def __init__(self, chans: Sequence[int], num_classes: int, reg_max: int,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.stems = LayerList([ConvBNAct(c, c, 3, **kw) for c in chans])
        self.cls_heads = LayerList([Conv2D(c, num_classes, 1, **kw)
                                    for c in chans])
        with torch.no_grad():
            for h in self.cls_heads:
                h.bias.fill_(-math.log((1 - 0.01) / 0.01))
        self.reg_heads = LayerList(
            [Conv2D(c, 4 * (reg_max + 1), 1, **kw) for c in chans])

    def forward(self, feats):
        cls_out, reg_out = [], []
        for f, stem, ch, rh in zip(feats, self.stems, self.cls_heads,
                                   self.reg_heads):
            h = stem(f)
            B, _, H, W = h.shape
            cls_out.append(ch(h).reshape(B, self.num_classes, H * W))
            reg_out.append(rh(h).reshape(B, 4 * (self.reg_max + 1), H * W))
        return (torch.cat(cls_out, -1).transpose(1, 2),
                torch.cat(reg_out, -1).transpose(1, 2))


class PPYOLOE(nn.Module):
    """``forward(images) -> (cls_logits [B, A, C], reg_logits
    [B, A, 4*(reg_max+1)], anchor_points [A, 2], strides [A])``;
    ``loss`` / ``predict`` implement TAL + VFL/DFL/GIoU and decode + NMS.
    Built on ``device`` (None: ``cuda``; it raises without one unless
    ``device="cpu"``), drawing from ``generator`` when one is given."""

    def __init__(self, num_classes: int = 80, width: int = 32,
                 depths=(1, 2, 2), reg_max: int = 16,
                 strides=(8, 16, 32), tal_topk: int = 13,
                 tal_alpha: float = 1.0, tal_beta: float = 6.0, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=default_device(device), generator=generator)
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.strides = list(strides)
        self.tal_topk = tal_topk
        self.tal_alpha = tal_alpha
        self.tal_beta = tal_beta
        self.backbone = CSPRepBackbone(width, depths, **kw)
        self.neck = CSPPAN(self.backbone.out_channels, **kw)
        self.head = ETHead(self.neck.out_channels, num_classes, reg_max,
                           **kw)

    def fuse_rep(self) -> None:
        """Fold every RepConv for serving (the deploy-time re-param)."""
        for layer in list(self.modules()):
            if isinstance(layer, RepConv):
                layer.fuse()

    # ------------------------------------------------------------ forward
    def _anchors(self, img_hw, device):
        """Cell-center anchor points (input pixels) + per-anchor stride."""
        H, W = img_hw
        pts, strs = [], []
        for s in self.strides:
            hs, ws = H // s, W // s
            yy, xx = torch.meshgrid(torch.arange(hs, device=device),
                                    torch.arange(ws, device=device),
                                    indexing="ij")
            centers = (torch.stack([xx, yy], -1).reshape(-1, 2) + 0.5) * s
            pts.append(centers.to(torch.float32))
            strs.append(torch.full((hs * ws,), s, dtype=torch.float32,
                                   device=device))
        return torch.cat(pts), torch.cat(strs)

    def forward(self, images):
        feats = self.neck(*self.backbone(images))
        cls_logits, reg_logits = self.head(feats)
        pts, strs = self._anchors(tuple(images.shape[2:]), images.device)
        return cls_logits, reg_logits, pts, strs

    def _decode(self, reg_logits, pts, strs):
        """DFL expectation -> (l, t, r, b) -> xyxy in input pixels."""
        B, A, _ = reg_logits.shape
        bins = torch.arange(self.reg_max + 1, dtype=reg_logits.dtype,
                            device=reg_logits.device)
        dist = torch.softmax(reg_logits.reshape(B, A, 4, self.reg_max + 1),
                             dim=-1)
        ltrb = (dist @ bins) * strs[None, :, None]
        x1y1 = pts[None] - ltrb[..., :2]
        x2y2 = pts[None] + ltrb[..., 2:]
        return torch.cat([x1y1, x2y2], dim=-1)  # [B, A, 4]

    # --------------------------------------------------------------- loss
    @staticmethod
    def _iou_union(a, b):
        """Broadcast (iou, union) for xyxy boxes."""
        lt = torch.maximum(a[..., :2], b[..., :2])
        rb = torch.minimum(a[..., 2:], b[..., 2:])
        wh = (rb - lt).clamp_min(0)
        inter = wh[..., 0] * wh[..., 1]
        area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
        area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
        union = (area_a + area_b - inter).clamp_min(1e-9)
        return inter / union, union

    @classmethod
    def _iou_xyxy(cls, a, b):
        """Pairwise IoU: a [..., G, 1, 4] vs b [..., 1, A, 4]."""
        return cls._iou_union(a, b)[0]

    def _assign(self, cls_scores, pred_boxes, pts, gt_boxes, gt_labels):
        """Task-aligned assignment: metric = s^alpha * iou^beta over
        anchors whose center lies inside the gt box; top-k anchors per gt;
        an anchor claimed by several gts goes to the highest metric.
        Returns (fg_mask [B, A], tgt_labels [B, A], tgt_boxes [B, A, 4],
        tgt_scores [B, A])."""
        B, A, C = cls_scores.shape
        G = gt_boxes.shape[1]
        valid = gt_labels >= 0                              # [B, G]
        gb = gt_boxes[:, :, None, :]                        # [B, G, 1, 4]
        px = pts[None, None, :, 0]
        py = pts[None, None, :, 1]
        inside = ((px > gb[..., 0]) & (px < gb[..., 2])
                  & (py > gb[..., 1]) & (py < gb[..., 3]))  # [B, G, A]
        iou = self._iou_xyxy(gb, pred_boxes[:, None, :, :])  # [B, G, A]
        safe_lbl = gt_labels.clamp(0, C - 1).long()
        s = cls_scores.transpose(1, 2).gather(
            1, safe_lbl[:, :, None].expand(B, G, A))        # [B, G, A]
        metric = (s ** self.tal_alpha) * (iou ** self.tal_beta)
        zero = torch.zeros((), device=metric.device)
        metric = torch.where(inside & valid[:, :, None], metric, zero)
        k = min(self.tal_topk, A)
        thresh = torch.topk(metric, k, dim=-1).values[..., -1:]
        cand = (metric >= thresh.clamp_min(1e-12)) & (metric > 0)
        best_gt = torch.argmax(
            torch.where(cand, metric, torch.full((), -1.0,
                                                 device=metric.device)),
            dim=1)                                          # [B, A]
        fg = cand.any(dim=1)                                # [B, A]
        bidx = torch.arange(B, device=metric.device)[:, None]
        tgt_boxes = gt_boxes[bidx, best_gt]                 # [B, A, 4]
        tgt_labels = torch.where(fg, gt_labels[bidx, best_gt].long(),
                                 torch.full((), -1, device=metric.device))
        # per-gt normalised targets: t / max_t * max_iou (the TAL paper)
        max_m = metric.amax(-1, keepdim=True)
        max_iou = torch.where(cand, iou, zero).amax(-1, keepdim=True)
        norm = (metric / max_m.clamp_min(1e-9)) * max_iou    # [B, G, A]
        tgt_scores = norm.gather(1, best_gt[:, None, :])[:, 0]
        tgt_scores = torch.where(fg, tgt_scores, zero)
        return fg, tgt_labels, tgt_boxes, tgt_scores

    def loss(self, images, gt_boxes, gt_labels):
        """VFL (cls) + GIoU (box) + DFL (distribution) with TAL targets.
        ``gt_boxes`` [B, G, 4] xyxy input pixels, ``gt_labels`` [B, G]
        int (-1 padding)."""
        cls_logits, reg_logits, pts, strs = self.forward(images)
        cls_scores = torch.sigmoid(cls_logits)
        pred_boxes = self._decode(reg_logits, pts, strs)
        gt_boxes = torch.as_tensor(gt_boxes, device=images.device).to(
            pred_boxes.dtype)
        gt_labels = torch.as_tensor(gt_labels, device=images.device)
        fg, tgt_lbl, tgt_box, tgt_q = self._assign(
            cls_scores.detach(), pred_boxes.detach(), pts, gt_boxes,
            gt_labels)

        B, A, C = cls_logits.shape
        onehot = nn.functional.one_hot(tgt_lbl.clamp(0, C - 1), C) \
            * fg[..., None]
        q = tgt_q[..., None] * onehot
        p = cls_scores
        weight = torch.where(q > 0, q, 0.75 * p ** 2.0)
        bce = -(q * torch.log(p.clamp(1e-9, 1.0))
                + (1 - q) * torch.log((1 - p).clamp(1e-9, 1.0)))
        norm = tgt_q.sum().clamp_min(1.0)
        cls_loss = (weight * bce).sum() / norm

        giou = self._giou(pred_boxes, tgt_box)
        box_loss = ((1.0 - giou) * tgt_q * fg).sum() / norm

        # DFL: ltrb targets in stride units, split across adjacent bins
        ltrb_t = torch.cat([pts[None] - tgt_box[..., :2],
                            tgt_box[..., 2:] - pts[None]],
                           dim=-1) / strs[None, :, None]
        ltrb_t = ltrb_t.clamp(0, self.reg_max - 0.01)
        lo = torch.floor(ltrb_t)
        hi_w = ltrb_t - lo
        logp = torch.log_softmax(
            reg_logits.reshape(B, A, 4, self.reg_max + 1), dim=-1)
        lo_i = lo.long()

        def pick(idx):
            return logp.gather(-1, idx[..., None])[..., 0]

        dfl = -(pick(lo_i) * (1 - hi_w) + pick(lo_i + 1) * hi_w)
        dfl_loss = (dfl.mean(-1) * tgt_q * fg).sum() / norm
        return cls_loss + 2.0 * box_loss + 0.5 * dfl_loss

    @classmethod
    def _giou(cls, a, b):
        """[..., 4] xyxy GIoU."""
        iou, union = cls._iou_union(a, b)
        clt = torch.minimum(a[..., :2], b[..., :2])
        crb = torch.maximum(a[..., 2:], b[..., 2:])
        cwh = (crb - clt).clamp_min(0)
        carea = (cwh[..., 0] * cwh[..., 1]).clamp_min(1e-9)
        return iou - (carea - union) / carea

    # ------------------------------------------------------------ predict
    @torch.no_grad()
    def predict(self, images, conf_thresh: float = 0.01,
                post_threshold: float = 0.01, nms_top_k: int = 400,
                keep_top_k: int = 100):
        """Decode + matrix-NMS; rows [label, score, x1, y1, x2, y2] and
        the rows of each image (``rois_num``)."""
        cls_logits, reg_logits, pts, strs = self.forward(images)
        boxes = self._decode(reg_logits, pts, strs)
        scores = torch.sigmoid(cls_logits).transpose(1, 2)  # [B, C, A]
        return V.matrix_nms(boxes, scores, conf_thresh, post_threshold,
                            nms_top_k, keep_top_k, background_label=-1)


def ppyoloe_tiny(num_classes: int = 4, **kw) -> PPYOLOE:
    kw.setdefault("width", 8)
    kw.setdefault("depths", (1, 1, 1))
    kw.setdefault("reg_max", 8)
    return PPYOLOE(num_classes=num_classes, **kw)


def ppyoloe_s(num_classes: int = 80, **kw) -> PPYOLOE:
    """PP-YOLOE-s-class capacity: width 32, depths (2, 4, 2)."""
    kw.setdefault("width", 32)
    kw.setdefault("depths", (2, 4, 2))
    return PPYOLOE(num_classes=num_classes, **kw)

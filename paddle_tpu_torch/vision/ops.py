"""Detection and region ops (port of ``paddle_tpu/vision/ops.py``).

Every op takes tensors or arrays and computes on the device of its first
tensor argument (a numpy array becomes a CPU tensor). The box math is
plain torch; the ops whose output length depends on the data (``nms``,
``matrix_nms``, ``generate_proposals``, ``distribute_fpn_proposals``)
read their inputs back to the host once and select there, as the
reference does (``ops.py:482-484``):

- ``nms_mask`` computes the IoU matrix on the device, copies the
  ``iou > threshold`` matrix to the host once and runs the reference's
  greedy sweep there (one pass over the boxes in score order), instead of
  one launch and one read-back per box;
- ``matrix_nms`` is the reference's host numpy routine, its stable
  argsorts included;
- ``yolo_loss`` scatters its targets onto the grid as the reference's
  ``.at[...].set(mode="drop")`` does: rows that are not responsible write
  nowhere, and where two ground truths of an image land in one cell the
  later row wins, as XLA applies duplicate scatter updates in order. The
  winners are picked before the write, so each cell is written once and
  the result is deterministic on the card too.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["nms", "nms_mask", "box_coder", "yolo_box", "prior_box",
           "roi_align", "roi_pool", "psroi_pool", "deform_conv2d",
           "read_file", "decode_jpeg", "sequence_mask", "matrix_nms",
           "distribute_fpn_proposals", "generate_proposals", "yolo_loss"]


def _device(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _f32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor (float64 stays float64: a float64 run is
    the card's yardstick reference)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float64 else x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _host(x, dtype=np.float32) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _pairwise_iou(boxes):
    """IoU matrix for [N, 4] (x1, y1, x2, y2) boxes."""
    area = (boxes[:, 2] - boxes[:, 0]).clamp_min(0) * \
        (boxes[:, 3] - boxes[:, 1]).clamp_min(0)
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[:, None] + area[None, :] - inter
    return inter / union.clamp_min(1e-10)


def _greedy_keep(over: np.ndarray) -> np.ndarray:
    """The reference's ``fori_loop`` sweep: box ``i`` (score order) is kept
    unless it overlaps a kept box before it."""
    n = over.shape[0]
    keep = np.ones(n, bool)
    for i in range(1, n):
        keep[i] = not np.any(over[:i, i] & keep[:i])
    return keep


def nms_mask(boxes, scores, iou_threshold: float = 0.3):
    """Boolean keep-mask (original indexing) of greedy NMS: the IoU matrix
    on the device, the greedy sweep on the host over one read-back of
    ``iou > iou_threshold``; the mask returns to the boxes' device."""
    device = _device(boxes, scores)
    boxes = _f32(boxes, device)
    scores = _f32(scores, device)
    order = torch.argsort(-scores, stable=True)
    over = (_pairwise_iou(boxes[order]) > iou_threshold).cpu().numpy()
    keep_sorted = torch.from_numpy(_greedy_keep(over)).to(device)
    keep = torch.zeros(boxes.shape[0], dtype=torch.bool, device=device)
    keep[order] = keep_sorted
    return keep


def nms(boxes, iou_threshold: float = 0.3, scores=None, category_idxs=None,
        categories=None, top_k: Optional[int] = None, name=None):
    """Greedy NMS returning kept indices sorted by descending score (stable
    among equal scores); suppression only within a category when
    ``category_idxs`` is given (each category's boxes offset past the
    others'), and the first ``top_k``."""
    device = _device(boxes, scores)
    boxes = _f32(boxes, device)
    n = boxes.shape[0]
    if scores is None:
        scores = torch.arange(n, 0, -1, dtype=torch.float32, device=device)
    scores = _f32(scores, device)
    if category_idxs is not None:
        cat = torch.as_tensor(category_idxs, device=device)
        offset = (cat.to(torch.float32)
                  * (boxes.max() - boxes.min() + 1.0))[:, None]
        keep = nms_mask(boxes + offset, scores, iou_threshold)
    else:
        keep = nms_mask(boxes, scores, iou_threshold)
    idx = np.where(keep.cpu().numpy())[0]
    idx = idx[np.argsort(-_host(scores)[idx], kind="stable")]
    if top_k is not None:
        idx = idx[:top_k]
    return torch.as_tensor(idx, device=device)


def box_coder(prior_box, prior_box_var, target_box,
              code_type: str = "encode_center_size", box_normalized: bool = True,
              axis: int = 0, name=None):
    """Encode every target against every prior (``[N, M, 4]``), or decode
    ``[N, M, 4]`` codes against priors broadcast along ``axis``."""
    device = _device(prior_box, target_box, prior_box_var)
    pb = _f32(prior_box, device)
    tb = _f32(target_box, device)
    norm = 0.0 if box_normalized else 1.0
    pb_w = pb[:, 2] - pb[:, 0] + norm
    pb_h = pb[:, 3] - pb[:, 1] + norm
    pb_x = pb[:, 0] + pb_w * 0.5
    pb_y = pb[:, 1] + pb_h * 0.5
    if prior_box_var is None:
        var = torch.ones((1, 4), dtype=torch.float32, device=device)
    else:
        var = _f32(prior_box_var, device)
        if var.ndim == 1:
            var = var[None, :]
    if code_type == "encode_center_size":
        tb_w = tb[:, 2] - tb[:, 0] + norm
        tb_h = tb[:, 3] - tb[:, 1] + norm
        tb_x = tb[:, 0] + tb_w * 0.5
        tb_y = tb[:, 1] + tb_h * 0.5
        out = torch.stack([
            (tb_x[:, None] - pb_x[None, :]) / pb_w[None, :],
            (tb_y[:, None] - pb_y[None, :]) / pb_h[None, :],
            torch.log(torch.abs(tb_w[:, None] / pb_w[None, :])),
            torch.log(torch.abs(tb_h[:, None] / pb_h[None, :])),
        ], dim=-1)
        return out / var[None, :, :]
    if code_type == "decode_center_size":
        exp = (None, slice(None)) if axis == 0 else (slice(None), None)
        pbx, pby = pb_x[exp], pb_y[exp]
        pbw, pbh = pb_w[exp], pb_h[exp]
        v = var[exp[0], exp[1], :] if var.shape[0] > 1 else var[None, :, :]
        tx = tb[..., 0] * v[..., 0] * pbw + pbx
        ty = tb[..., 1] * v[..., 1] * pbh + pby
        tw = torch.exp(v[..., 2] * tb[..., 2]) * pbw
        th = torch.exp(v[..., 3] * tb[..., 3]) * pbh
        return torch.stack([tx - tw / 2, ty - th / 2,
                            tx + tw / 2 - norm, ty + th / 2 - norm], dim=-1)
    raise ValueError(f"unknown code_type {code_type!r}")


def yolo_box(x, img_size, anchors: Sequence[int], class_num: int,
             conf_thresh: float, downsample_ratio: int, clip_bbox: bool = True,
             scale_x_y: float = 1.0, iou_aware: bool = False,
             iou_aware_factor: float = 0.5, name=None):
    """Decode a YOLOv3 head ``[N, A * (5 + class_num), H, W]`` into boxes
    ``[N, A*H*W, 4]`` (image pixels, clipped to ``size - 1``) and scores
    ``[N, A*H*W, class_num]`` (objectness below ``conf_thresh`` zeroes a
    cell's scores)."""
    if iou_aware:
        raise NotImplementedError(
            "yolo_box iou_aware=False only (PP-YOLO's iou-aware channel "
            "layout is not implemented)")
    x = _f32(x)
    n, c, h, w = x.shape
    na = len(anchors) // 2
    an = torch.as_tensor(anchors, dtype=torch.float32,
                         device=x.device).reshape(na, 2)
    x = x.reshape(n, na, 5 + class_num, h, w)
    grid_x = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    grid_y = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    bx = (torch.sigmoid(x[:, :, 0]) * scale_x_y
          - (scale_x_y - 1) / 2 + grid_x) / w
    by = (torch.sigmoid(x[:, :, 1]) * scale_x_y
          - (scale_x_y - 1) / 2 + grid_y) / h
    input_h = downsample_ratio * h
    input_w = downsample_ratio * w
    bw = torch.exp(x[:, :, 2]) * an[None, :, 0, None, None] / input_w
    bh = torch.exp(x[:, :, 3]) * an[None, :, 1, None, None] / input_h
    conf = torch.sigmoid(x[:, :, 4])
    conf = torch.where(conf < conf_thresh, torch.zeros_like(conf), conf)
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    img = _f32(img_size, x.device).reshape(n, 2)  # [h, w]
    ih = img[:, 0, None, None, None]
    iw = img[:, 1, None, None, None]
    x1 = (bx - bw / 2) * iw
    y1 = (by - bh / 2) * ih
    x2 = (bx + bw / 2) * iw
    y2 = (by + bh / 2) * ih
    if clip_bbox:
        zero = torch.zeros((), device=x.device)
        x1 = torch.clamp(x1, zero, iw - 1)
        y1 = torch.clamp(y1, zero, ih - 1)
        x2 = torch.clamp(x2, zero, iw - 1)
        y2 = torch.clamp(y2, zero, ih - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, -1, 4)
    scores = probs.movedim(2, -1).reshape(n, -1, class_num)
    return boxes, scores


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),  # noqa: A002
              variance=(0.1, 0.1, 0.2, 0.2), flip: bool = False,
              clip: bool = False, steps=(0.0, 0.0), offset: float = 0.5,
              min_max_aspect_ratios_order: bool = False, name=None):
    """SSD prior boxes ``[H, W, P, 4]`` (normalised) per feature-map cell,
    and their variances broadcast alike."""
    device = _device(input, image)
    feat_h, feat_w = tuple(input.shape[2:])
    img_h, img_w = tuple(image.shape[2:])
    step_w = steps[0] or img_w / feat_w
    step_h = steps[1] or img_h / feat_h
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    whs = []
    for ms in min_sizes:
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if max_sizes:
                mx = max_sizes[min_sizes.index(ms)]
                whs.append((float(np.sqrt(ms * mx)),) * 2)
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        else:
            for ar in ars:
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
            if max_sizes:
                mx = max_sizes[min_sizes.index(ms)]
                whs.append((float(np.sqrt(ms * mx)),) * 2)
    whs = torch.as_tensor(np.asarray(whs, np.float32), device=device)
    cx = (torch.arange(feat_w, dtype=torch.float32, device=device)
          + offset) * step_w
    cy = (torch.arange(feat_h, dtype=torch.float32, device=device)
          + offset) * step_h
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")  # [H, W]
    boxes = torch.stack([
        (cxg[..., None] - whs[None, None, :, 0] / 2) / img_w,
        (cyg[..., None] - whs[None, None, :, 1] / 2) / img_h,
        (cxg[..., None] + whs[None, None, :, 0] / 2) / img_w,
        (cyg[..., None] + whs[None, None, :, 1] / 2) / img_h,
    ], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = torch.as_tensor(variance, dtype=torch.float32,
                          device=device).expand(boxes.shape)
    return boxes, var


def _bilinear(x, ys, xs):
    """Sample x [C, H, W] at float coords (ys, xs) [...]: bilinear, zero
    outside."""
    c, h, w = x.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0

    def at(yi, xi):
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        yi = yi.clamp(0, h - 1).to(torch.int64)
        xi = xi.clamp(0, w - 1).to(torch.int64)
        return x[:, yi, xi] * valid.to(x.dtype)

    return (at(y0, x0) * (1 - wy1) * (1 - wx1) +
            at(y0, x0 + 1) * (1 - wy1) * wx1 +
            at(y0 + 1, x0) * wy1 * (1 - wx1) +
            at(y0 + 1, x0 + 1) * wy1 * wx1)


def _roi_batch(boxes_num) -> list:
    counts = _host(boxes_num, np.int64)
    return np.repeat(np.arange(len(counts)), counts).tolist()


def roi_align(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = -1, aligned: bool = True, name=None):
    """RoIAlign: ``sampling_ratio``² bilinear samples (2 when not
    positive) averaged per bin. x ``[N, C, H, W]``, boxes ``[R, 4]``,
    ``boxes_num`` ``[N]``; returns ``[R, C, ph, pw]``."""
    x = _f32(x)
    boxes = _f32(boxes, x.device)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    sr = sampling_ratio if sampling_ratio > 0 else 2
    off = 0.5 if aligned else 0.0
    iy = (torch.arange(sr, dtype=torch.float32, device=x.device) + 0.5) / sr
    bins_h = torch.arange(ph, dtype=torch.float32, device=x.device)
    bins_w = torch.arange(pw, dtype=torch.float32, device=x.device)
    out = []
    for b, box in zip(_roi_batch(boxes_num), boxes):
        x1, y1, x2, y2 = box * spatial_scale - off
        rh = torch.clamp_min((y2 - y1) / ph, 1e-6)
        rw = torch.clamp_min((x2 - x1) / pw, 1e-6)
        ys = y1 + (bins_h[:, None] + iy[None, :]) * rh
        xs = x1 + (bins_w[:, None] + iy[None, :]) * rw
        grid_y = ys[:, None, :, None].expand(ph, pw, sr, sr)
        grid_x = xs[None, :, None, :].expand(ph, pw, sr, sr)
        vals = _bilinear(x[b], grid_y.reshape(-1), grid_x.reshape(-1))
        out.append(vals.reshape(x.shape[1], ph, pw, sr * sr).mean(-1))
    if not out:
        return x.new_zeros((0, x.shape[1], ph, pw))
    return torch.stack(out)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
             name=None, max_samples_per_bin: int = 8):
    """RoIPool: the max of a dense sample grid per quantized bin, at most
    ``max_samples_per_bin`` samples an edge (the reference's sampling
    formulation: exact while a bin spans at most that many cells)."""
    x = _f32(x)
    boxes = _f32(boxes, x.device)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    cap = int(max_samples_per_bin)
    H, W = x.shape[2], x.shape[3]
    sr_y = max(4, min(cap, -(-H // ph)))
    sr_x = max(4, min(cap, -(-W // pw)))
    dev = x.device
    iy = torch.arange(sr_y, dtype=torch.float32, device=dev) / sr_y
    ix = torch.arange(sr_x, dtype=torch.float32, device=dev) / sr_x
    bins_h = torch.arange(ph, dtype=torch.float32, device=dev)
    bins_w = torch.arange(pw, dtype=torch.float32, device=dev)
    out = []
    for b, box in zip(_roi_batch(boxes_num), boxes):
        x1, y1, x2, y2 = torch.round(box * spatial_scale)
        # clipped to the map before the bin extents, as the reference
        x1 = x1.clamp(0, W - 1)
        x2 = x2.clamp(0, W - 1)
        y1 = y1.clamp(0, H - 1)
        y2 = y2.clamp(0, H - 1)
        rh = torch.clamp_min(y2 - y1 + 1, 1.0) / ph
        rw = torch.clamp_min(x2 - x1 + 1, 1.0) / pw
        ys = y1 + (bins_h[:, None] + iy[None, :]) * rh
        xs = x1 + (bins_w[:, None] + ix[None, :]) * rw
        gy = ys[:, None, :, None].expand(ph, pw, sr_y, sr_x)
        gx = xs[None, :, None, :].expand(ph, pw, sr_y, sr_x)
        yi = torch.floor(gy).clamp(0, H - 1).to(torch.int64)
        xi = torch.floor(gx).clamp(0, W - 1).to(torch.int64)
        vals = x[b][:, yi.reshape(-1), xi.reshape(-1)]
        out.append(vals.reshape(x.shape[1], ph, pw, sr_y * sr_x).amax(-1))
    if not out:
        return x.new_zeros((0, x.shape[1], ph, pw))
    return torch.stack(out)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
               name=None):
    """Position-sensitive RoI pooling: channel block (i, j) of
    ``[C / (ph * pw), ph, pw]`` feeds output bin (i, j), averaged."""
    x = _f32(x)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    c = x.shape[1]
    if c % (ph * pw):
        raise ValueError(f"channels {c} must divide output {ph}x{pw}")
    co = c // (ph * pw)
    aligned = roi_align(x, boxes, boxes_num, output_size, spatial_scale,
                        sampling_ratio=2, aligned=False)  # [R, C, ph, pw]
    r = aligned.shape[0]
    blocks = aligned.reshape(r, co, ph, pw, ph, pw)
    ii = torch.arange(ph, device=x.device)
    jj = torch.arange(pw, device=x.device)
    return blocks[:, :, ii[:, None], jj[None, :], ii[:, None], jj[None, :]]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable conv v1 (v2 with ``mask``): bilinear samples at the
    offset positions, then one product with the kernel. x ``[N, Cin, H,
    W]``, offset ``[N, 2*kh*kw, Ho, Wo]``, mask ``[N, kh*kw, Ho, Wo]``."""
    x = _f32(x)
    offset = _f32(offset, x.device)
    weight = _f32(weight, x.device)
    if groups != 1 or deformable_groups != 1:
        raise NotImplementedError("groups/deformable_groups > 1")
    n, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    sh, sw = _pair(stride)
    padh, padw = _pair(padding)
    dh, dw = _pair(dilation)
    ho = (h + 2 * padh - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * padw - (dw * (kw - 1) + 1)) // sw + 1
    dev = x.device
    base_y = (torch.arange(ho, device=dev) * sh - padh)[:, None, None] + \
        (torch.arange(kh, device=dev) * dh)[None, :, None]      # [Ho, kh, 1]
    base_x = (torch.arange(wo, device=dev) * sw - padw)[:, None, None] + \
        (torch.arange(kw, device=dev) * dw)[None, :, None]      # [Wo, kw, 1]
    off = offset.reshape(n, kh, kw, 2, ho, wo)
    ys = off[:, :, :, 0] + base_y.permute(1, 2, 0).reshape(1, kh, 1, ho, 1)
    xs = off[:, :, :, 1] + base_x.permute(1, 2, 0).reshape(1, 1, kw, 1, wo)
    if mask is not None:
        m = _f32(mask, dev).reshape(n, kh, kw, ho, wo)
    else:
        m = torch.ones((n, kh, kw, ho, wo), dtype=torch.float32, device=dev)
    cols = torch.stack([
        _bilinear(x[i], ys[i].reshape(-1), xs[i].reshape(-1)).reshape(
            cin, kh, kw, ho, wo) * m[i][None] for i in range(n)])
    cols = cols.reshape(n, cin * kh * kw, ho * wo)
    wmat = weight.reshape(cout, cin * kh * kw)
    out = torch.einsum("ok,nkp->nop", wmat, cols).reshape(n, cout, ho, wo)
    if bias is not None:
        out = out + _f32(bias, dev)[None, :, None, None]
    return out


def read_file(filename: str, name=None):
    """The file's bytes as a uint8 CPU tensor."""
    with open(filename, "rb") as f:
        return torch.from_numpy(np.frombuffer(f.read(), np.uint8).copy())


def decode_jpeg(x, mode: str = "unchanged", name=None):
    """Decode JPEG bytes to a ``[C, H, W]`` uint8 CPU tensor through PIL
    (imported here: nothing else of the port needs it)."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(_host(x, np.uint8).tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None, :, :] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.array(arr))


_DTYPES = {"bool": torch.bool, "int32": torch.int32, "int64": torch.int64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64,
           "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16}


def sequence_mask(lengths, maxlen: Optional[int] = None, dtype="bool",
                  name=None):
    """``[..., maxlen]`` mask of positions below each length."""
    lengths = torch.as_tensor(lengths)
    if maxlen is None:
        maxlen = int(lengths.max())
    mask = torch.arange(maxlen, device=lengths.device) < lengths[..., None]
    dtype = dtype if isinstance(dtype, torch.dtype) else _DTYPES[str(dtype)]
    return mask.to(dtype)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """RoIs to FPN levels by scale, ``floor(refer_level + log2(sqrt(area)
    / refer_scale))`` clipped to the levels: ``(multi_rois, restore_ind,
    rois_num_per_level)``, ``restore_ind`` putting the concatenated levels
    back in input order."""
    device = _device(fpn_rois)
    rois = _host(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = np.sqrt(np.maximum(w * h, 0.0))
    level = np.floor(refer_level + np.log2(scale / refer_scale + 1e-8))
    level = np.clip(level, min_level, max_level).astype(np.int64)
    multi_rois, per_level, order = [], [], []
    for lv in range(min_level, max_level + 1):
        idx = np.where(level == lv)[0]
        multi_rois.append(torch.as_tensor(rois[idx], device=device))
        per_level.append(idx.size)
        order.append(idx)
    order = np.concatenate(order) if order else np.empty(0, np.int64)
    restore = np.empty_like(order)
    restore[order] = np.arange(order.size)
    return (multi_rois, torch.as_tensor(restore, device=device),
            torch.as_tensor(np.asarray(per_level, np.int32), device=device))


def _np_iou(box):
    area = (np.maximum(box[:, 2] - box[:, 0], 0)
            * np.maximum(box[:, 3] - box[:, 1], 0))
    lt = np.maximum(box[:, None, :2], box[None, :, :2])
    rb = np.minimum(box[:, None, 2:], box[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-10)


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2): each box's score decays by its IoU with every
    higher-scored box of its class, over how much that box was overlapped
    itself. bboxes ``[N, M, 4]``, scores ``[N, C, M]``, both read back to
    the host once; rows ``[label, score, x1, y1, x2, y2]`` on the boxes'
    device, with the index and/or ``rois_num`` as the flags ask."""
    device = _device(bboxes, scores)
    bboxes = _host(bboxes)
    scores = _host(scores)
    n, c, m = scores.shape
    outs, idxs, counts = [], [], []
    for b in range(n):
        rows, ridx = [], []
        for cls in range(c):
            if cls == background_label:
                continue
            sc = scores[b, cls]
            keep = np.where(sc > score_threshold)[0]
            if keep.size == 0:
                continue
            order = keep[np.argsort(-sc[keep], kind="stable")][:nms_top_k]
            box = bboxes[b][order]
            s = sc[order]
            iou = _np_iou(box)
            k = order.size
            tri = np.tril(iou, k=-1)
            max_iou_of_higher = np.max(tri, axis=1)
            if use_gaussian:
                decay = np.exp(-(tri ** 2 - max_iou_of_higher[None, :] ** 2)
                               / gaussian_sigma)
            else:
                decay = (1 - tri) / (1 - max_iou_of_higher[None, :] + 1e-10)
            decay = np.where(np.tril(np.ones((k, k), bool), k=-1), decay, 1.0)
            new_s = s * np.min(decay, axis=1)
            rows.append(np.column_stack([np.full(k, cls, np.float32), new_s,
                                         box]))
            ridx.append(order)
        if rows:
            allr = np.concatenate(rows)
            alli = np.concatenate(ridx)
            sel = np.where(allr[:, 1] > post_threshold)[0]
            sel = sel[np.argsort(-allr[sel, 1], kind="stable")][:keep_top_k]
            outs.append(allr[sel])
            idxs.append(alli[sel] + b * m)
            counts.append(sel.size)
        else:
            outs.append(np.zeros((0, 6), np.float32))
            idxs.append(np.zeros(0, np.int64))
            counts.append(0)
    result = [torch.as_tensor(np.concatenate(outs), device=device)]
    if return_index:
        result.append(torch.as_tensor(np.concatenate(idxs), device=device))
    if return_rois_num:
        result.append(torch.as_tensor(np.asarray(counts, np.int32),
                                      device=device))
    return tuple(result) if len(result) > 1 else result[0]


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False, name=None):
    """RPN proposals: decode the anchor deltas, clip to the image, drop
    boxes under ``min_size``, keep the top ``pre_nms_top_n`` by score, NMS,
    keep ``post_nms_top_n``. scores ``[N, A, H, W]``, bbox_deltas ``[N,
    4A, H, W]``, anchors / variances ``[H*W*A, 4]``; returns ``(rois [R,
    4], probs [R, 1][, rois_num])`` on the scores' device."""
    device = _device(scores, bbox_deltas)
    scores = _host(scores)
    deltas = _host(bbox_deltas)
    anchors = _host(anchors).reshape(-1, 4)
    variances = _host(variances).reshape(-1, 4)
    img_size = _host(img_size).reshape(-1, 2)
    n, a, h, w = scores.shape
    off = 1.0 if pixel_offset else 0.0
    all_rois, all_probs, counts = [], [], []
    for b in range(n):
        sc = scores[b].transpose(1, 2, 0).reshape(-1)
        dl = deltas[b].reshape(a, 4, h, w).transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-sc, kind="stable")[:pre_nms_top_n]
        sc, dl = sc[order], dl[order]
        an, var = anchors[order], variances[order]
        aw = an[:, 2] - an[:, 0] + off
        ah = an[:, 3] - an[:, 1] + off
        ax = an[:, 0] + aw * 0.5
        ay = an[:, 1] + ah * 0.5
        cx = var[:, 0] * dl[:, 0] * aw + ax
        cy = var[:, 1] * dl[:, 1] * ah + ay
        bw = np.exp(np.minimum(var[:, 2] * dl[:, 2], 10.0)) * aw
        bh = np.exp(np.minimum(var[:, 3] * dl[:, 3], 10.0)) * ah
        box = np.column_stack([cx - bw / 2, cy - bh / 2,
                               cx + bw / 2 - off, cy + bh / 2 - off])
        ih, iw = img_size[b]
        box[:, 0::2] = np.clip(box[:, 0::2], 0, iw - off)
        box[:, 1::2] = np.clip(box[:, 1::2], 0, ih - off)
        ok = ((box[:, 2] - box[:, 0] + off >= min_size) &
              (box[:, 3] - box[:, 1] + off >= min_size))
        box, sc = box[ok], sc[ok]
        if box.shape[0]:
            keep = nms_mask(box, sc, nms_thresh).numpy()
            sel = np.where(keep)[0]
            sel = sel[np.argsort(-sc[sel], kind="stable")][:post_nms_top_n]
            box, sc = box[sel], sc[sel]
        all_rois.append(box)
        all_probs.append(sc[:, None])
        counts.append(box.shape[0])
    rois = torch.as_tensor(np.concatenate(all_rois), device=device)
    probs = torch.as_tensor(np.concatenate(all_probs), device=device)
    if return_rois_num:
        return rois, probs, torch.as_tensor(np.asarray(counts, np.int32),
                                            device=device)
    return rois, probs


def _bce(logit, target):
    return logit.clamp_min(0) - logit * target + \
        torch.log1p(torch.exp(-logit.abs()))


def _scatter_winners(cell, responsible):
    """Rows ``[N, B]`` that write their cell: responsible, and the last
    responsible row of their image landing on that cell (XLA applies
    duplicate scatter updates in order, so the last one stays)."""
    same = (cell[:, :, None] == cell[:, None, :]) \
        & responsible[:, None, :]                          # [N, B, B']
    nb = cell.shape[1]
    later = torch.arange(nb, device=cell.device)
    later = later[None, :] > later[:, None]                # b' > b
    return responsible & ~(same & later[None]).any(-1)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 loss per image ``[N]``: each ground truth is matched to the
    anchor of best shape IoU; objectness BCE with an ignore band, box
    regression (xy BCE and wh L1, scaled by ``2 - w*h``) and class BCE on
    responsible cells. x ``[N, A*(5+C), H, W]``, gt_box ``[N, B, 4]`` (cx,
    cy, w, h normalised to the image), gt_label ``[N, B]``."""
    x = _f32(x)
    dev, dt = x.device, x.dtype
    gt_box = _f32(gt_box, dev).to(dt)
    gt_label = torch.as_tensor(gt_label, device=dev).to(torch.int64)
    n, c, h, w = x.shape
    na = len(anchor_mask)
    all_an = torch.as_tensor(anchors, dtype=dt, device=dev).reshape(-1, 2)
    mask_arr = torch.as_tensor(anchor_mask, device=dev)
    an = all_an[mask_arr]
    input_size = downsample_ratio * h
    x = x.reshape(n, na, 5 + class_num, h, w)
    pred_xy = torch.sigmoid(x[:, :, 0:2]) * scale_x_y - (scale_x_y - 1) / 2
    pred_wh = x[:, :, 2:4]
    pred_obj = x[:, :, 4]
    pred_cls = x[:, :, 5:]
    nb = gt_box.shape[1]
    valid = (gt_box[:, :, 2] > 0) & (gt_box[:, :, 3] > 0)  # [N, B]

    # responsible anchor: best shape IoU of the gt against every anchor
    gwh = gt_box[:, :, 2:4] * input_size
    inter = (torch.minimum(gwh[:, :, None, 0], all_an[None, None, :, 0]) *
             torch.minimum(gwh[:, :, None, 1], all_an[None, None, :, 1]))
    union = (gwh[:, :, 0] * gwh[:, :, 1])[:, :, None] + \
        (all_an[:, 0] * all_an[:, 1])[None, None, :] - inter
    best_anchor = torch.argmax(inter / union.clamp_min(1e-10), -1)
    hit = best_anchor[..., None] == mask_arr[None, None, :]
    slot = torch.argmax(hit.to(torch.int8), -1)
    responsible = valid & hit.any(-1)

    gi = (gt_box[:, :, 0] * w).to(torch.int32).clamp(0, w - 1).long()
    gj = (gt_box[:, :, 1] * h).to(torch.int32).clamp(0, h - 1).long()
    tx = gt_box[:, :, 0] * w - gi
    ty = gt_box[:, :, 1] * h - gj
    an_s = an[slot]
    tw = torch.log(torch.clamp_min(
        gwh[:, :, 0] / an_s[:, :, 0].clamp_min(1e-8), 1e-8))
    th = torch.log(torch.clamp_min(
        gwh[:, :, 1] / an_s[:, :, 1].clamp_min(1e-8), 1e-8))
    box_scale = 2.0 - gt_box[:, :, 2] * gt_box[:, :, 3]
    score = (_f32(gt_score, dev).to(dt) if gt_score is not None
             else torch.ones((n, nb), dtype=dt, device=dev))

    # the rows that write, each cell at most once
    bidx = torch.arange(n, device=dev)[:, None].expand(n, nb)
    cell = ((bidx * na + slot) * h + gj) * w + gi
    wins = _scatter_winners(cell, responsible)
    at = (bidx[wins], slot[wins], gj[wins], gi[wins])

    def scatter(weight, vals):
        tgt = torch.zeros((n, na, h, w), dtype=dt, device=dev)
        wgt = torch.zeros((n, na, h, w), dtype=dt, device=dev)
        tgt = tgt.index_put(at, vals[wins])
        wgt = wgt.index_put(at, (score * weight)[wins])
        return tgt, wgt

    one = torch.ones((n, nb), dtype=dt, device=dev)
    txg, wxy = scatter(box_scale, tx)
    tyg, _ = scatter(box_scale, ty)
    twg, _ = scatter(box_scale, tw)
    thg, _ = scatter(box_scale, th)
    _, wobj = scatter(one, one)
    has_obj = wobj > 0

    loss_xy = wxy * (_bce(x[:, :, 0], txg) + _bce(x[:, :, 1], tyg))
    loss_wh = wxy * ((pred_wh[:, :, 0] - twg).abs() +
                     (pred_wh[:, :, 1] - thg).abs())

    # objectness: negatives whose best IoU with a gt passes ignore_thresh
    # are ignored
    grid_x = (torch.arange(w, dtype=dt, device=dev)[None, :]
              + pred_xy[:, :, 0]) / w
    grid_y = (torch.arange(h, dtype=dt, device=dev)[:, None]
              + pred_xy[:, :, 1]) / h
    pw_ = torch.exp(pred_wh[:, :, 0].clamp(-10, 10)) * \
        an[None, :, 0, None, None] / input_size
    ph_ = torch.exp(pred_wh[:, :, 1].clamp(-10, 10)) * \
        an[None, :, 1, None, None] / input_size
    px1, py1 = grid_x - pw_ / 2, grid_y - ph_ / 2
    px2, py2 = grid_x + pw_ / 2, grid_y + ph_ / 2
    gx1 = gt_box[:, :, 0] - gt_box[:, :, 2] / 2
    gy1 = gt_box[:, :, 1] - gt_box[:, :, 3] / 2
    gx2 = gt_box[:, :, 0] + gt_box[:, :, 2] / 2
    gy2 = gt_box[:, :, 1] + gt_box[:, :, 3] / 2
    g = (slice(None), None, None, None, slice(None))
    ix1 = torch.maximum(px1[..., None], gx1[g])
    iy1 = torch.maximum(py1[..., None], gy1[g])
    ix2 = torch.minimum(px2[..., None], gx2[g])
    iy2 = torch.minimum(py2[..., None], gy2[g])
    inter_p = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    area_p = (px2 - px1) * (py2 - py1)
    area_g = ((gx2 - gx1) * (gy2 - gy1))[g]
    iou_p = inter_p / (area_p[..., None] + area_g - inter_p).clamp_min(1e-10)
    zero = torch.zeros((), dtype=dt, device=dev)
    iou_p = torch.where(valid[g], iou_p, zero)
    best_iou = iou_p.amax(-1)
    noobj_mask = (~has_obj) & (best_iou < ignore_thresh)
    loss_obj = torch.where(has_obj, wobj * _bce(pred_obj, 1.0), zero) + \
        torch.where(noobj_mask, _bce(pred_obj, 0.0), zero)

    smooth = 1.0 / class_num if (use_label_smooth and class_num > 1) else 0.0
    onehot = nn.functional.one_hot(gt_label.clamp_min(0), class_num).to(dt)
    onehot = onehot * (gt_label >= 0)[..., None]   # jax's one_hot of -1
    onehot = onehot * (1.0 - smooth) + smooth * (1.0 / class_num)
    tcls = torch.zeros((n, na, h, w, class_num), dtype=dt,
                       device=dev).index_put(at, onehot[wins])
    loss_cls = has_obj[..., None] * _bce(pred_cls.movedim(2, -1), tcls)

    return (loss_xy.sum((1, 2, 3)) + loss_wh.sum((1, 2, 3)) +
            loss_obj.sum((1, 2, 3)) + loss_cls.sum((1, 2, 3, 4)))


# ------------------------------------------------------ layer wrappers
class RoIAlign:
    """Layer form of :func:`roi_align`."""

    def __init__(self, output_size, spatial_scale: float = 1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool:
    def __init__(self, output_size, spatial_scale: float = 1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool:
    def __init__(self, output_size, spatial_scale: float = 1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


class DeformConv2D(nn.Module):
    """Layer form of :func:`deform_conv2d`: its kernel is a ``Conv2D``
    sublayer's (``conv.weight`` / ``conv.bias``, the reference's names and
    draws), so it reaches ``parameters()`` and the state dict."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None,
                 generator=None):
        super().__init__()
        from ..nn.layers.conv import Conv2D

        self.conv = Conv2D(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding, dilation=dilation,
                           groups=groups, weight_attr=weight_attr,
                           bias_attr=bias_attr, device=device,
                           generator=generator)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.deformable_groups = deformable_groups

    @property
    def weight(self):
        return self.conv.weight

    @property
    def bias(self):
        return self.conv.bias

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.conv.weight, self.conv.bias,
                             self.stride, self.padding, self.dilation,
                             self.deformable_groups, self.groups, mask)


__all__ += ["RoIAlign", "RoIPool", "PSRoIPool", "DeformConv2D"]

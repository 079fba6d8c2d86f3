"""The port's detection and region ops (``paddle_tpu_torch.vision.ops``)
against the JAX package's, on the CPU, from numpy inputs made from seeds:
every op of the module's ``__all__`` and its layer wrappers, the image
backend switch of ``paddle_tpu_torch.vision``, and ``yolo_loss``'s
values and gradients, including two ground truths in one cell.

Tolerances: the selections (``nms`` indices, ``nms_mask``, ``matrix_nms``
rows, ``distribute_fpn_proposals``, ``generate_proposals``) are bit-equal
(the host parts are the reference's numpy); the float32 box math rtol
1e-6 / atol 1e-6 in input units (one or two float32 roundings of
``exp``/``log`` apart); region ops rtol 1e-5 / atol 1e-5; ``yolo_loss``
rtol 1e-5 and its gradient atol 1e-6 (sums over the grid in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import vision as jvision
from paddle_tpu.vision import ops as J
from paddle_tpu_torch import vision as tvision
from paddle_tpu_torch.vision import ops as T
from torch_threads import few_torch_threads  # noqa: F401

BOX = dict(rtol=1e-6, atol=1e-6)
REGION = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _boxes(rng, n, lo=0.0, hi=90.0):
    xy = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + rng.uniform(4, 30, (n, 2))],
                          axis=1).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_all_names_are_ported():
    assert set(T.__all__) == set(J.__all__)
    for name in J.__all__:
        assert callable(getattr(T, name)), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_iou_and_nms_mask(seed):
    rng = _rng(seed)
    boxes = _boxes(rng, 60)
    scores = rng.random(60).astype(np.float32)
    scores[::7] = scores[0]          # ties keep the stable order
    np.testing.assert_allclose(_np(T._pairwise_iou(_t(boxes))),
                               _np(J._pairwise_iou(jnp.asarray(boxes))),
                               **BOX)
    for thr in (0.1, 0.3, 0.6):
        np.testing.assert_array_equal(
            _np(T.nms_mask(_t(boxes), _t(scores), thr)),
            _np(J.nms_mask(boxes, scores, thr)))


def test_nms_indices_categories_and_top_k():
    rng = _rng(3)
    boxes = _boxes(rng, 50)
    scores = rng.random(50).astype(np.float32)
    cats = rng.integers(0, 3, 50)
    cases = [dict(), dict(scores=scores), dict(scores=scores, top_k=7),
             dict(scores=scores, category_idxs=cats, categories=[0, 1, 2]),
             dict(scores=scores, category_idxs=cats, categories=[0, 1, 2],
                  top_k=5)]
    for kw in cases:
        for thr in (0.2, 0.5):
            want = _np(J.nms(boxes, thr, **kw))
            got = T.nms(_t(boxes), thr, **{
                k: (_t(v) if isinstance(v, np.ndarray) else v)
                for k, v in kw.items()})
            np.testing.assert_array_equal(_np(got), want)
            assert got.dtype == torch.int64


def test_box_coder_encode_and_decode():
    rng = _rng(4)
    priors = _boxes(rng, 6, 0, 50)
    targets = _boxes(rng, 4, 0, 50)
    var1 = np.asarray([0.1, 0.1, 0.2, 0.2], np.float32)
    var2 = rng.uniform(0.1, 0.3, (6, 4)).astype(np.float32)
    for var in (None, var1, var2):
        for normalized in (True, False):
            kw = dict(box_normalized=normalized)
            enc_j = J.box_coder(priors, var, targets, **kw)
            enc_t = T.box_coder(_t(priors), None if var is None else _t(var),
                                _t(targets), **kw)
            np.testing.assert_allclose(_np(enc_t), _np(enc_j), **BOX)
            for axis in (0, 1):
                codes = rng.normal(0, 0.5, (6, 6, 4)).astype(np.float32)
                dec_j = J.box_coder(priors, var, codes, "decode_center_size",
                                    axis=axis, **kw)
                dec_t = T.box_coder(priors, var, codes, "decode_center_size",
                                    axis=axis, **kw)
                np.testing.assert_allclose(_np(dec_t), _np(dec_j), rtol=1e-6,
                                           atol=1e-5)
    with pytest.raises(ValueError):
        T.box_coder(priors, None, targets, "nope")


@pytest.mark.parametrize("clip,scale_x_y", [(True, 1.0), (False, 1.05)])
def test_yolo_box(clip, scale_x_y):
    rng = _rng(5)
    n, na, cls, h, w = 2, 3, 5, 4, 6
    x = rng.normal(size=(n, na * (5 + cls), h, w)).astype(np.float32) * 2
    img = np.asarray([[128, 192], [96, 64]], np.int32)
    kw = dict(anchors=[10, 13, 16, 30, 33, 23], class_num=cls,
              conf_thresh=0.3, downsample_ratio=32, clip_bbox=clip,
              scale_x_y=scale_x_y)
    bj, sj = J.yolo_box(x, img, **kw)
    bt, st = T.yolo_box(_t(x), _t(img), **kw)
    np.testing.assert_allclose(_np(bt), _np(bj), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(_np(st), _np(sj), **BOX)
    assert (_np(st) == 0).any()              # objectness under conf_thresh
    if clip:
        assert _np(bt)[0, :, [0, 2]].max() <= 191.0


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[16.0], aspect_ratios=[1.0, 2.0], flip=True),
    dict(min_sizes=[16.0, 30.0], max_sizes=[30.0, 60.0],
         aspect_ratios=[2.0, 3.0], clip=True),
    dict(min_sizes=[20.0], max_sizes=[40.0], aspect_ratios=[2.0],
         flip=True, min_max_aspect_ratios_order=True, steps=(8.0, 8.0),
         offset=0.25, variance=(0.1, 0.2, 0.3, 0.4))])
def test_prior_box(kw):
    feat = np.zeros((1, 8, 4, 5), np.float32)
    img = np.zeros((1, 3, 64, 80), np.float32)
    bj, vj = J.prior_box(feat, img, **kw)
    bt, vt = T.prior_box(_t(feat), _t(img), **kw)
    np.testing.assert_allclose(_np(bt), _np(bj), **BOX)
    np.testing.assert_array_equal(_np(vt), _np(vj))


def _region_inputs(seed, c=8):
    rng = _rng(seed)
    x = rng.normal(size=(2, c, 12, 14)).astype(np.float32)
    boxes = np.concatenate([_boxes(rng, 3, 0, 8), _boxes(rng, 2, -2, 9)])
    boxes = (boxes / 3.0).astype(np.float32)
    return x, boxes, [3, 2]


@pytest.mark.parametrize("aligned,sr,scale", [(True, -1, 1.0),
                                              (False, 3, 0.5)])
def test_roi_align_and_its_layer(aligned, sr, scale):
    x, boxes, num = _region_inputs(6)
    want = J.roi_align(x, boxes, num, (3, 4), scale, sr, aligned)
    got = T.roi_align(_t(x), _t(boxes), num, (3, 4), scale, sr, aligned)
    np.testing.assert_allclose(_np(got), _np(want), **REGION)
    np.testing.assert_allclose(
        _np(T.RoIAlign(2, scale)(_t(x), _t(boxes), num)),
        _np(J.RoIAlign(2, scale)(x, boxes, num)), **REGION)


def test_roi_align_gradient():
    x, boxes, num = _region_inputs(7)
    g_j = jax.grad(lambda a: J.roi_align(a, boxes, num, 2).sum())(
        jnp.asarray(x))
    tx = _t(x).requires_grad_()
    T.roi_align(tx, _t(boxes), num, 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(g_j), **REGION)


@pytest.mark.parametrize("cap", [8, 3])
def test_roi_pool_and_its_layer(cap):
    x, boxes, num = _region_inputs(8)
    boxes = boxes * 3
    want = J.roi_pool(x, boxes, num, (2, 3), 0.5,
                      max_samples_per_bin=cap)
    got = T.roi_pool(_t(x), _t(boxes), num, (2, 3), 0.5,
                     max_samples_per_bin=cap)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(
        _np(T.RoIPool(2)(_t(x), _t(boxes), num)),
        _np(J.RoIPool(2)(x, boxes, num)))


def test_psroi_pool_and_its_layer():
    x, boxes, num = _region_inputs(9, c=2 * 2 * 3)
    np.testing.assert_allclose(
        _np(T.psroi_pool(_t(x), _t(boxes), num, (2, 3))),
        _np(J.psroi_pool(x, boxes, num, (2, 3))), **REGION)
    np.testing.assert_allclose(
        _np(T.PSRoIPool((2, 3), 0.5)(_t(x), _t(boxes), num)),
        _np(J.PSRoIPool((2, 3), 0.5)(x, boxes, num)), **REGION)
    with pytest.raises(ValueError, match="divide"):
        T.psroi_pool(torch.zeros((1, 3, 4, 4)), torch.zeros((1, 4)), [1], 2)


@pytest.mark.parametrize("stride,padding,dilation,masked", [
    (1, 0, 1, False), (2, 1, 1, True), (1, 2, 2, True)])
def test_deform_conv2d(stride, padding, dilation, masked):
    rng = _rng(10)
    x = rng.normal(size=(2, 3, 9, 10)).astype(np.float32)
    wgt = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    ho = (9 + 2 * padding - (dilation * 2 + 1)) // stride + 1
    wo = (10 + 2 * padding - (dilation * 2 + 1)) // stride + 1
    offset = rng.normal(0, 1.5, (2, 18, ho, wo)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 9, ho, wo)).astype(np.float32) \
        if masked else None
    want = J.deform_conv2d(x, offset, wgt, bias, stride, padding, dilation,
                           mask=mask)
    got = T.deform_conv2d(_t(x), _t(offset), _t(wgt), _t(bias), stride,
                          padding, dilation,
                          mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)
    with pytest.raises(NotImplementedError):
        T.deform_conv2d(_t(x), _t(offset), _t(wgt), groups=2)


def test_deform_conv2d_layer_names_and_forward():
    rng = _rng(11)
    layer = T.DeformConv2D(3, 4, 3, padding=1, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert sorted(layer.state_dict()) == ["conv.bias", "conv.weight"]
    jl = J.DeformConv2D(3, 4, 3, padding=1)
    assert sorted(jl.state_dict()) == sorted(layer.state_dict())
    jl.set_state_dict({k: jnp.asarray(v.detach().numpy().copy())
                       for k, v in layer.state_dict().items()})
    x = rng.normal(size=(1, 3, 6, 6)).astype(np.float32)
    off = rng.normal(0, 1, (1, 18, 6, 6)).astype(np.float32)
    np.testing.assert_allclose(_np(layer(_t(x), _t(off))),
                               _np(jl(x, off)), rtol=1e-5, atol=1e-4)
    assert layer.weight is layer.conv.weight
    assert len(list(layer.parameters())) == 2


def test_read_file_decode_jpeg_and_image_load(tmp_path):
    from PIL import Image

    arr = _rng(12).integers(0, 255, (16, 12, 3)).astype(np.uint8)
    p = str(tmp_path / "t.jpg")
    Image.fromarray(arr).save(p, quality=95)
    raw_t, raw_j = T.read_file(p), J.read_file(p)
    assert raw_t.dtype == torch.uint8
    np.testing.assert_array_equal(_np(raw_t), _np(raw_j))
    for mode in ("unchanged", "rgb", "gray"):
        np.testing.assert_array_equal(_np(T.decode_jpeg(raw_t, mode)),
                                      _np(J.decode_jpeg(raw_j, mode)))
    assert tvision.get_image_backend() == jvision.get_image_backend() == \
        "pil"
    assert np.array_equal(np.asarray(tvision.image_load(p)),
                          np.asarray(jvision.image_load(p)))
    with pytest.raises(ValueError):
        tvision.set_image_backend("nope")
    tvision.set_image_backend("cv2")
    try:
        assert tvision.get_image_backend() == "cv2"
    finally:
        tvision.set_image_backend("pil")
    with pytest.raises(ValueError):
        tvision.image_load(p, backend="nope")


@pytest.mark.parametrize("dtype", ["bool", "float32", "int64"])
def test_sequence_mask(dtype):
    lengths = np.asarray([[1, 3], [0, 4]])
    for maxlen in (None, 5):
        want = _np(J.sequence_mask(lengths, maxlen, dtype))
        got = T.sequence_mask(_t(lengths), maxlen, dtype)
        np.testing.assert_array_equal(_np(got), want)
        assert str(got.dtype).split(".")[-1] == dtype


@pytest.mark.parametrize("pixel_offset", [False, True])
def test_distribute_fpn_proposals(pixel_offset):
    rng = _rng(13)
    rois = np.concatenate([_boxes(rng, 20, 0, 50) * s
                           for s in (0.3, 1.0, 4.0)]).astype(np.float32)
    mj, rj, nj = J.distribute_fpn_proposals(rois, 2, 5, 4, 224,
                                            pixel_offset=pixel_offset)
    mt, rt, nt = T.distribute_fpn_proposals(_t(rois), 2, 5, 4, 224,
                                            pixel_offset=pixel_offset)
    assert len(mt) == len(mj) == 4
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(rt), _np(rj))
    np.testing.assert_array_equal(_np(nt), _np(nj))


def _nms_inputs(seed, n=2, c=4, m=40):
    rng = _rng(seed)
    boxes = np.stack([_boxes(rng, m, 0, 60) for _ in range(n)])
    scores = rng.random((n, c, m)).astype(np.float32) ** 2
    scores[:, :, ::5] = scores[:, :, :1]      # ties: stable order
    return boxes, scores


@pytest.mark.parametrize("kw", [
    dict(), dict(use_gaussian=True, gaussian_sigma=0.5),
    dict(background_label=-1, return_index=True),
    dict(background_label=2, return_index=True, return_rois_num=False),
    dict(nms_top_k=5, keep_top_k=7)])
def test_matrix_nms_rows_bit_equal(kw):
    boxes, scores = _nms_inputs(14)
    args = dict(score_threshold=0.05, post_threshold=0.02, nms_top_k=25,
                keep_top_k=30)
    args.update(kw)
    want = J.matrix_nms(boxes, scores, **args)
    got = T.matrix_nms(_t(boxes), _t(scores), **args)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
    # nothing over the threshold: an empty image
    none = T.matrix_nms(_t(boxes), torch.zeros(scores.shape), 0.5, 0.0, 10,
                        10)
    assert none[0].shape == (0, 6) and _np(none[1]).tolist() == [0, 0]


@pytest.mark.parametrize("pixel_offset", [False, True])
def test_generate_proposals(pixel_offset):
    rng = _rng(15)
    H = W = 8
    A = 3
    base = rng.uniform(0, 48, (H * W * A, 2)).astype(np.float32)
    anchors = np.column_stack([base, base + rng.uniform(4, 16, base.shape)]
                              ).astype(np.float32)
    var = np.full((H * W * A, 4), 1.0, np.float32)
    scores = rng.normal(size=(2, A, H, W)).astype(np.float32)
    deltas = rng.normal(size=(2, 4 * A, H, W)).astype(np.float32) * 0.2
    kw = dict(pre_nms_top_n=64, post_nms_top_n=8, min_size=2.0,
              pixel_offset=pixel_offset, return_rois_num=True)
    want = J.generate_proposals(scores, deltas, [[64, 64], [64, 48]],
                                anchors, var, **kw)
    got = T.generate_proposals(_t(scores), _t(deltas), [[64, 64], [64, 48]],
                               _t(anchors), _t(var), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
    rois, probs = T.generate_proposals(scores, deltas, [[64, 64], [64, 48]],
                                       anchors, var, pre_nms_top_n=64)
    assert rois.shape[1] == 4 and probs.shape[1] == 1


YOLO = dict(anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
                     116, 90, 156, 198, 373, 326],
            class_num=4, ignore_thresh=0.6, downsample_ratio=8)


def _yolo_inputs(seed, n=2, nb=6, h=8, w=10, mask=(0, 1, 2)):
    rng = _rng(seed)
    x = rng.normal(0, 1, (n, len(mask) * 9, h, w)).astype(np.float32)
    gt = np.zeros((n, nb, 4), np.float32)
    gt[:, :4, :2] = rng.uniform(0.05, 0.95, (n, 4, 2))
    gt[:, :4, 2:] = rng.uniform(0.05, 0.6, (n, 4, 2))
    lbl = np.full((n, nb), -1, np.int64)
    lbl[:, :4] = rng.integers(0, 4, (n, 4))
    return x, gt, lbl


def _yolo_both(x, gt, lbl, mask=(0, 1, 2), **extra):
    kw = dict(YOLO, anchor_mask=list(mask), **extra)
    gj_fn = jax.value_and_grad(lambda a: J.yolo_loss(a, gt, lbl, **kw).sum())
    lj, gj = gj_fn(jnp.asarray(x))
    per_j = _np(J.yolo_loss(x, gt, lbl, **kw))
    tx = _t(x).requires_grad_()
    per_t = T.yolo_loss(tx, _t(gt), _t(lbl), **{
        k: (_t(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()})
    per_t.sum().backward()
    return per_t.detach().numpy(), per_j, tx.grad.numpy(), _np(gj)


@pytest.mark.parametrize("mask,extra", [
    ((0, 1, 2), {}), ((3, 4, 5), dict(use_label_smooth=False)),
    ((1, 2, 3), dict(scale_x_y=1.05)),
    ((0, 1, 2), dict(gt_score=np.full((2, 6), 0.5, np.float32)))])
def test_yolo_loss_values_and_gradients(mask, extra):
    x, gt, lbl = _yolo_inputs(16, mask=mask)
    per_t, per_j, g_t, g_j = _yolo_both(x, gt, lbl, mask, **extra)
    np.testing.assert_allclose(per_t, per_j, rtol=1e-5)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-5, atol=1e-6)


def test_yolo_loss_two_ground_truths_in_one_cell_keep_the_later_row():
    """Rows 0 and 2 of image 0 land on the same cell and anchor with
    different offsets, sizes and classes: the reference's scatter keeps
    the later row (XLA applies duplicate updates in order), and so does
    the port, on the CPU and (deterministically) on the card. A padded
    row routed to cell (0, 0) writes nothing there."""
    x, gt, lbl = _yolo_inputs(17)
    gt[0, 0] = [0.33, 0.41, 0.1, 0.12]
    gt[0, 2] = [0.36, 0.44, 0.11, 0.13]      # same cell (3, 2), anchor 0
    lbl[0, 0], lbl[0, 2] = 1, 3
    gt[1, 3] = [0.02, 0.03, 0.0, 0.0]        # invalid, would hit (0, 0)
    per_t, per_j, g_t, g_j = _yolo_both(x, gt, lbl)
    np.testing.assert_allclose(per_t, per_j, rtol=1e-5)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-5, atol=1e-6)
    # the winner is pinned: dropping row 0 changes nothing, dropping
    # row 2 does
    kw = dict(YOLO, anchor_mask=[0, 1, 2])
    base = _np(T.yolo_loss(_t(x), _t(gt), _t(lbl), **kw))
    for row, same in ((0, True), (2, False)):
        g2, l2 = gt.copy(), lbl.copy()
        g2[0, row], l2[0, row] = 0.0, -1
        other = _np(T.yolo_loss(_t(x), _t(g2), _t(l2), **kw))
        want = _np(J.yolo_loss(x, g2, l2, **kw))
        np.testing.assert_allclose(other, want, rtol=1e-5)
        assert np.array_equal(other[0], base[0]) == same, row
    # the planted fault: every row written, in order, duplicates and
    # padding included (what an unmasked index_put_ would do) differs
    cell = torch.zeros(2, 6, dtype=torch.long)
    assert T._scatter_winners(cell, torch.ones(2, 6, dtype=torch.bool)
                              ).sum() == 2


def test_yolo_loss_no_responsible_row():
    x, gt, lbl = _yolo_inputs(18, mask=(6, 7, 8))
    gt[:, :, 2:] = 0.02                       # small boxes: anchors 0-2
    per_t, per_j, g_t, g_j = _yolo_both(x, gt, lbl, mask=(6, 7, 8))
    np.testing.assert_allclose(per_t, per_j, rtol=1e-5)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-5, atol=1e-6)

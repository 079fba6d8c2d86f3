"""Image transforms, functional and composable (port of
``paddle_tpu/vision/transforms.py``; it imports nothing of JAX, so this
is a copy, adapted).

Reference parity: ``python/paddle/vision/transforms/``. Transforms run
on the host in numpy (in DataLoader workers, before the batch reaches the
card): images are HWC uint8 or float arrays (a PIL image is read as its
array), and ``ToTensor`` returns a CHW float32 numpy array in [0, 1], as
the reference's does; the loader's collate makes the tensor. The random
transforms draw from numpy's global generator (``np.random``), as the
reference's do, so ``np.random.seed`` replays them (each DataLoader
worker is seeded apart).
"""
from __future__ import annotations

import numbers
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Compose", "Resize", "CenterCrop", "RandomCrop",
    "RandomHorizontalFlip", "RandomVerticalFlip", "Normalize", "ToTensor",
    "Transpose", "BrightnessTransform", "Pad", "resize", "center_crop",
    "crop", "hflip", "vflip", "normalize", "to_tensor", "pad",
]


def _as_hwc(img) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def _pair(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return int(size[0]), int(size[1])


# ------------------------------------------------------------- functional
def resize(img, size, interpolation: str = "bilinear") -> np.ndarray:
    """Resize HWC image. int size = short side (aspect preserved), like the
    reference."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    if isinstance(size, numbers.Number):
        if h < w:
            oh, ow = int(size), max(1, int(size * w / h))
        else:
            oh, ow = max(1, int(size * h / w)), int(size)
    else:
        oh, ow = _pair(size)
    if (oh, ow) == (h, w):
        return img
    dtype = img.dtype
    x = img.astype(np.float32)
    if interpolation == "nearest":
        ri = (np.arange(oh) * h / oh).astype(np.int64).clip(0, h - 1)
        ci = (np.arange(ow) * w / ow).astype(np.int64).clip(0, w - 1)
        out = x[ri][:, ci]
    else:  # bilinear, align_corners=False convention
        ry = (np.arange(oh) + 0.5) * h / oh - 0.5
        rx = (np.arange(ow) + 0.5) * w / ow - 0.5
        y0 = np.floor(ry).astype(np.int64)
        x0 = np.floor(rx).astype(np.int64)
        wy = (ry - y0)[:, None, None]
        wx = (rx - x0)[None, :, None]
        y0c = y0.clip(0, h - 1)
        y1c = (y0 + 1).clip(0, h - 1)
        x0c = x0.clip(0, w - 1)
        x1c = (x0 + 1).clip(0, w - 1)
        out = ((1 - wy) * (1 - wx) * x[y0c][:, x0c]
               + (1 - wy) * wx * x[y0c][:, x1c]
               + wy * (1 - wx) * x[y1c][:, x0c]
               + wy * wx * x[y1c][:, x1c])
    if np.issubdtype(dtype, np.integer):
        out = np.round(out).clip(np.iinfo(dtype).min,
                                 np.iinfo(dtype).max).astype(dtype)
    else:
        out = out.astype(dtype)
    return out


def crop(img, top: int, left: int, height: int, width: int) -> np.ndarray:
    img = _as_hwc(img)
    return img[top:top + height, left:left + width]


def center_crop(img, output_size) -> np.ndarray:
    img = _as_hwc(img)
    th, tw = _pair(output_size)
    h, w = img.shape[:2]
    top = max(0, (h - th) // 2)
    left = max(0, (w - tw) // 2)
    return crop(img, top, left, th, tw)


def hflip(img) -> np.ndarray:
    return _as_hwc(img)[:, ::-1]


def vflip(img) -> np.ndarray:
    return _as_hwc(img)[::-1]


def pad(img, padding, fill=0, padding_mode: str = "constant") -> np.ndarray:
    img = _as_hwc(img)
    if isinstance(padding, numbers.Number):
        pl = pt = pr = pb = int(padding)
    elif len(padding) == 2:
        pl = pr = int(padding[0])
        pt = pb = int(padding[1])
    else:
        pl, pt, pr, pb = (int(p) for p in padding)
    pads = [(pt, pb), (pl, pr), (0, 0)]
    if padding_mode == "constant":
        return np.pad(img, pads, mode="constant", constant_values=fill)
    return np.pad(img, pads, mode=padding_mode)


def normalize(img, mean, std, data_format: str = "CHW") -> np.ndarray:
    img = np.asarray(img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        return (img - mean[:, None, None]) / std[:, None, None]
    return (img - mean) / std


def to_tensor(img, data_format: str = "CHW") -> np.ndarray:
    """HWC [0,255] uint8 (or float) -> CHW float32 [0,1]."""
    img = _as_hwc(img)
    out = img.astype(np.float32)
    if np.issubdtype(np.asarray(img).dtype, np.integer):
        out = out / 255.0
    if data_format == "CHW":
        out = out.transpose(2, 0, 1)
    return out


# ---------------------------------------------------------------- classes
class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class Resize:
    def __init__(self, size, interpolation: str = "bilinear"):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop:
    def __init__(self, size):
        self.size = size

    def __call__(self, img):
        return center_crop(img, self.size)


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed: bool = False,
                 fill=0):
        self.size = _pair(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill

    def __call__(self, img):
        img = _as_hwc(img)
        if self.padding is not None:
            img = pad(img, self.padding, self.fill)
        th, tw = self.size
        h, w = img.shape[:2]
        if self.pad_if_needed and (h < th or w < tw):
            # pad() tuple order is (left, top, right, bottom)
            img = pad(img, (0, 0, max(0, tw - w), max(0, th - h)), self.fill)
            h, w = img.shape[:2]
        top = np.random.randint(0, h - th + 1)
        left = np.random.randint(0, w - tw + 1)
        return crop(img, top, left, th, tw)


class RandomHorizontalFlip:
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, img):
        return hflip(img) if np.random.rand() < self.prob else _as_hwc(img)


class RandomVerticalFlip:
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, img):
        return vflip(img) if np.random.rand() < self.prob else _as_hwc(img)


class Normalize:
    def __init__(self, mean, std, data_format: str = "CHW"):
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def __call__(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class ToTensor:
    def __init__(self, data_format: str = "CHW"):
        self.data_format = data_format

    def __call__(self, img):
        return to_tensor(img, self.data_format)


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return _as_hwc(img).transpose(self.order)


class Pad:
    def __init__(self, padding, fill=0, padding_mode: str = "constant"):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def __call__(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class BrightnessTransform:
    def __init__(self, value: float):
        self.value = float(value)

    def __call__(self, img):
        img = _as_hwc(img)
        factor = 1.0 + np.random.uniform(-self.value, self.value)
        dtype = img.dtype
        out = img.astype(np.float32) * factor
        if np.issubdtype(dtype, np.integer):
            out = out.clip(0, 255)
        return out.astype(dtype)


# -------------------------------------------------- r4: remaining surface
def _clip_like(out, dtype):
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        out = np.round(out).clip(info.min, info.max)
    return out.astype(dtype)


def adjust_brightness(img, brightness_factor: float):
    img = _as_hwc(img)
    return _clip_like(img.astype(np.float32) * brightness_factor, img.dtype)


def adjust_contrast(img, contrast_factor: float):
    img = _as_hwc(img)
    f = img.astype(np.float32)
    gray_mean = f.mean() if img.shape[-1] == 1 else \
        (f @ np.asarray([0.299, 0.587, 0.114], np.float32)).mean()
    out = gray_mean + contrast_factor * (f - gray_mean)
    return _clip_like(out, img.dtype)


def to_grayscale(img, num_output_channels: int = 1):
    img = _as_hwc(img)
    f = img.astype(np.float32)
    g = f @ np.asarray([0.299, 0.587, 0.114], np.float32) \
        if img.shape[-1] == 3 else f[..., 0]
    g = g[..., None]
    if num_output_channels == 3:
        g = np.repeat(g, 3, axis=-1)
    return _clip_like(g, img.dtype)


def _rgb_to_hsv(f):
    mx, mn = f.max(-1), f.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    h = np.where(mx == r, (g - b) / diff % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4))
    h = h / 6.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    h6 = h * 6.0
    i = np.floor(h6) % 6
    f = h6 - np.floor(h6)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    conds = [(i == k)[..., None] for k in range(6)]
    out = np.select(
        conds,
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return out


def adjust_hue(img, hue_factor: float):
    """hue_factor in [-0.5, 0.5] (reference adjust_hue)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    img = _as_hwc(img)
    scale = 255.0 if np.issubdtype(img.dtype, np.integer) else 1.0
    f = img.astype(np.float32) / scale
    h, s, v = _rgb_to_hsv(f)
    out = _hsv_to_rgb((h + hue_factor) % 1.0, s, v) * scale
    return _clip_like(out, img.dtype)


def adjust_saturation(img, saturation_factor: float):
    img = _as_hwc(img)
    gray = to_grayscale(img, 3).astype(np.float32)
    out = gray + saturation_factor * (img.astype(np.float32) - gray)
    return _clip_like(out, img.dtype)


def erase(img, i: int, j: int, h: int, w: int, v, inplace: bool = False):
    """Fill the [i:i+h, j:j+w] patch with ``v`` (reference ``erase``)."""
    img = _as_hwc(img)
    out = img if inplace else img.copy()
    out[i:i + h, j:j + w] = np.asarray(v, dtype=img.dtype)
    return out


def _inverse_warp(img, inv_matrix, fill=0, interpolation="bilinear",
                  out_hw=None):
    """Sample img (HWC) through a 3x3 INVERSE homography
    (bilinear/nearest); ``out_hw`` sets the output canvas (expand)."""
    img = _as_hwc(img)
    H, W = img.shape[:2]
    Ho, Wo = out_hw or (H, W)
    ys, xs = np.meshgrid(np.arange(Ho), np.arange(Wo), indexing="ij")
    ones = np.ones_like(xs)
    coords = np.stack([xs, ys, ones], 0).reshape(3, -1).astype(np.float32)
    src = inv_matrix @ coords
    sx = src[0] / src[2]
    sy = src[1] / src[2]

    def gather(yy, xx):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        val = img[yy.clip(0, H - 1), xx.clip(0, W - 1)].astype(np.float32)
        val[~inb] = fill
        return val

    if interpolation == "nearest":
        # exact source texels: label/mask-safe (no class blending)
        out = gather(np.round(sy).astype(np.int64),
                     np.round(sx).astype(np.int64))
        return _clip_like(out.reshape((Ho, Wo, img.shape[2])), img.dtype)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    wx = (sx - x0)[:, None]
    wy = (sy - y0)[:, None]
    out = (gather(y0, x0) * (1 - wx) * (1 - wy)
           + gather(y0, x0 + 1) * wx * (1 - wy)
           + gather(y0 + 1, x0) * (1 - wx) * wy
           + gather(y0 + 1, x0 + 1) * wx * wy)
    return _clip_like(out.reshape((Ho, Wo, img.shape[2])), img.dtype)


def _affine_forward(angle, translate, scale, shear, center):
    """Forward map: T(center+translate) @ R @ Shear @ Scale @
    T(-center) — shear is a real x/y skew (tangent terms), not folded
    into the rotation."""
    a = np.deg2rad(angle)
    sx, sy = np.deg2rad(shear[0]), np.deg2rad(shear[1])
    cx, cy = center
    tx, ty = translate
    rot = np.asarray([[np.cos(a), -np.sin(a), 0],
                      [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    sh = np.asarray([[1.0, np.tan(sx), 0], [np.tan(sy), 1.0, 0],
                     [0, 0, 1]], np.float32)
    scl = np.diag([scale, scale, 1.0]).astype(np.float32)

    def trans(x, y):
        m = np.eye(3, dtype=np.float32)
        m[0, 2], m[1, 2] = x, y
        return m

    return trans(cx + tx, cy + ty) @ rot @ sh @ scl @ trans(-cx, -cy)


def _affine_inverse(angle, translate, scale, shear, center):
    return np.linalg.inv(
        _affine_forward(angle, translate, scale, shear, center))


def rotate(img, angle, interpolation="bilinear", expand=False, center=None,
           fill=0):
    img = _as_hwc(img)
    H, W = img.shape[:2]
    c = center or ((W - 1) / 2.0, (H - 1) / 2.0)
    out_hw = None
    fwd = _affine_forward(-angle, (0, 0), 1.0, (0, 0), c)
    if expand:
        a = np.deg2rad(angle)
        Wo = int(np.ceil(abs(W * np.cos(a)) + abs(H * np.sin(a))))
        Ho = int(np.ceil(abs(H * np.cos(a)) + abs(W * np.sin(a))))
        # recenter so the rotated content lands on the enlarged canvas
        fwd = _affine_forward(-angle, ((Wo - W) / 2.0, (Ho - H) / 2.0),
                              1.0, (0, 0), c)
        out_hw = (Ho, Wo)
    return _inverse_warp(img, np.linalg.inv(fwd), fill, interpolation,
                         out_hw)


def affine(img, angle, translate, scale, shear, interpolation="bilinear",
           fill=0, center=None):
    img = _as_hwc(img)
    H, W = img.shape[:2]
    if not isinstance(shear, (tuple, list)):
        shear = (shear, 0.0)
    c = center or ((W - 1) / 2.0, (H - 1) / 2.0)
    return _inverse_warp(
        img, _affine_inverse(-angle, tuple(translate), scale, shear, c),
        fill, interpolation)


def perspective(img, startpoints, endpoints, interpolation="bilinear",
                fill=0):
    """Warp so ``startpoints`` map onto ``endpoints`` (reference
    ``perspective``); solves the 8-dof homography."""
    a, b = [], []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        a.append([sx, sy, 1, 0, 0, 0, -ex * sx, -ex * sy])
        a.append([0, 0, 0, sx, sy, 1, -ey * sx, -ey * sy])
        b += [ex, ey]
    h = np.linalg.solve(np.asarray(a, np.float32),
                        np.asarray(b, np.float32))
    fwd = np.append(h, 1.0).reshape(3, 3)
    return _inverse_warp(_as_hwc(img), np.linalg.inv(fwd), fill,
                         interpolation)


class BaseTransform:
    """Reference ``BaseTransform``: subclasses implement ``_apply_image``
    (and optionally ``_apply_*`` for other keys)."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def _apply_image(self, image):
        raise NotImplementedError

    def _dispatch(self, key, value):
        fn = getattr(self, f"_apply_{key}", None)
        if fn is not None:
            return fn(value)
        return value  # entries with no _apply_<key> pass through untouched

    def __call__(self, inputs):
        if isinstance(inputs, (list, tuple)):
            out = [self._dispatch(k, v) for k, v in zip(self.keys, inputs)]
            out += list(inputs[len(self.keys):])  # extras pass through
            return type(inputs)(out)
        return self._apply_image(inputs)


class ContrastTransform(BaseTransform):
    def __init__(self, value: float, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        return adjust_contrast(
            img, 1.0 + np.random.uniform(-self.value, self.value))


class SaturationTransform(BaseTransform):
    def __init__(self, value: float, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        return adjust_saturation(
            img, 1.0 + np.random.uniform(-self.value, self.value))


class HueTransform(BaseTransform):
    def __init__(self, value: float, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        return adjust_hue(img, np.random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Random brightness/contrast/saturation/hue in random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def _apply_image(self, img):
        for i in np.random.permutation(len(self.transforms)):
            img = self.transforms[int(i)](img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels: int = 1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="bilinear", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if not isinstance(degrees, (tuple, list)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.center, self.fill = center, fill

    def _apply_image(self, img):
        return rotate(img, np.random.uniform(*self.degrees),
                      center=self.center, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="bilinear", fill=0, center=None, keys=None):
        super().__init__(keys)
        if not isinstance(degrees, (tuple, list)):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees, self.translate = degrees, translate
        self.scale, self.shear = scale, shear
        self.fill, self.center = fill, center

    def _apply_image(self, img):
        img = _as_hwc(img)
        H, W = img.shape[:2]
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * W
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * H
        scale = np.random.uniform(*self.scale) if self.scale else 1.0
        if self.shear is None:
            shear = (0.0, 0.0)
        elif len(self.shear) == 4:  # (min_x, max_x, min_y, max_y)
            shear = (np.random.uniform(self.shear[0], self.shear[1]),
                     np.random.uniform(self.shear[2], self.shear[3]))
        else:
            shear = (np.random.uniform(*self.shear), 0.0)
        return affine(img, angle, (tx, ty), scale, shear, fill=self.fill,
                      center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob: float = 0.5, distortion_scale: float = 0.5,
                 interpolation="bilinear", fill=0, keys=None):
        super().__init__(keys)
        self.prob, self.distortion = prob, distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        img = _as_hwc(img)
        if np.random.random() >= self.prob:
            return img
        H, W = img.shape[:2]
        d = self.distortion
        dx, dy = int(W * d / 2), int(H * d / 2)

        def jitter(x, y, sx, sy):
            return (x + sx * np.random.randint(0, dx + 1),
                    y + sy * np.random.randint(0, dy + 1))

        start = [(0, 0), (W - 1, 0), (W - 1, H - 1), (0, H - 1)]
        end = [jitter(0, 0, 1, 1), jitter(W - 1, 0, -1, 1),
               jitter(W - 1, H - 1, -1, -1), jitter(0, H - 1, 1, -1)]
        return perspective(img, start, end, fill=self.fill)


class RandomErasing(BaseTransform):
    def __init__(self, prob: float = 0.5, scale=(0.02, 0.33),
                 ratio=(0.3, 3.3), value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob, self.scale, self.ratio = prob, scale, ratio
        self.value, self.inplace = value, inplace

    def _apply_image(self, img):
        img = _as_hwc(img)
        if np.random.random() >= self.prob:
            return img
        H, W = img.shape[:2]
        for _ in range(10):
            area = H * W * np.random.uniform(*self.scale)
            ratio = np.exp(np.random.uniform(*np.log(self.ratio)))
            h = int(round(np.sqrt(area * ratio)))
            w = int(round(np.sqrt(area / ratio)))
            if h < H and w < W:
                i = np.random.randint(0, H - h + 1)
                j = np.random.randint(0, W - w + 1)
                return erase(img, i, j, h, w, self.value, self.inplace)
        return img


class RandomResizedCrop(BaseTransform):
    """Random area/aspect crop resized to ``size`` (the ImageNet aug)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = _pair(size)
        self.scale, self.ratio = scale, ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        img = _as_hwc(img)
        H, W = img.shape[:2]
        for _ in range(10):
            area = H * W * np.random.uniform(*self.scale)
            ratio = np.exp(np.random.uniform(*np.log(self.ratio)))
            w = int(round(np.sqrt(area * ratio)))
            h = int(round(np.sqrt(area / ratio)))
            if 0 < h <= H and 0 < w <= W:
                top = np.random.randint(0, H - h + 1)
                left = np.random.randint(0, W - w + 1)
                return resize(crop(img, top, left, h, w), self.size,
                              self.interpolation)
        return resize(center_crop(img, min(H, W)), self.size,
                      self.interpolation)


__all__ += ["BaseTransform", "ColorJitter", "ContrastTransform",
            "SaturationTransform", "HueTransform", "Grayscale",
            "RandomAffine", "RandomErasing", "RandomPerspective",
            "RandomResizedCrop", "RandomRotation", "adjust_brightness",
            "adjust_contrast", "adjust_hue", "adjust_saturation", "affine",
            "erase", "perspective", "rotate", "to_grayscale"]

"""The vision model zoo (port of ``paddle_tpu/vision/models.py``): LeNet,
VGG 11/13/16/19 (with and without batch norm), MobileNet V1, V2,
V3-Small and V3-Large, AlexNet, SqueezeNet 1.0/1.1, ShuffleNetV2 (seven
constructors), DenseNet 121/161/169/201/264, GoogLeNet and InceptionV3;
the ResNet family is :mod:`paddle_tpu_torch.models.resnet`'s,
re-exported, as the reference re-exports its own.

The layer graphs, the attribute names and so every parameter's path are
the reference's (NCHW, ``Sequential`` children named by position), so a
reference model's ``state_dict()`` loads by name
(:func:`paddle_tpu_torch.convert.zoo_from_jax`). Each model is built on
``device`` (None: ``cuda``; it raises without one unless
``device="cpu"``), drawing its weights from ``generator`` when one is
given. ``pretrained=True`` raises: the published weights need a
download.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from .. import default_device
from ..models.resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,
                             resnet152, resnext50_32x4d, resnext50_64x4d,
                             resnext101_32x4d, resnext101_64x4d,
                             resnext152_32x4d, resnext152_64x4d,
                             wide_resnet50_2, wide_resnet101_2)
from ..nn import functional as F
from ..nn.layers.activation import Hardswish, ReLU, ReLU6
from ..nn.layers.common import Dropout, Linear
from ..nn.layers.containers import Sequential
from ..nn.layers.conv import Conv2D
from ..nn.layers.norm import BatchNorm2D
from ..nn.layers.pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = [
    "LeNet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19", "MobileNetV1",
    "MobileNetV2", "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v1",
    "mobilenet_v2", "mobilenet_v3_small", "mobilenet_v3_large", "ResNet",
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
    "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
    "resnext152_32x4d", "resnext152_64x4d", "AlexNet", "alexnet",
    "SqueezeNet", "squeezenet1_0", "squeezenet1_1", "ShuffleNetV2",
    "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
    "shufflenet_v2_swish", "DenseNet", "densenet121", "densenet161",
    "densenet169", "densenet201", "densenet264", "GoogLeNet", "googlenet",
    "InceptionV3", "inception_v3",
]


def _finish(model, arch: str, pretrained: bool):
    """The constructors' ``pretrained`` tail: the reference downloads the
    published checkpoint; the port has no network, so it raises."""
    if pretrained:
        raise ValueError(
            f"{arch}(pretrained=True): pretrained weights need a download; "
            f"build with random weights, or load a reference state dict "
            f"with convert.zoo_from_jax")
    return model


def _kw(device, generator):
    """The weight-making layers' keywords, ``device`` resolved once (None:
    the card)."""
    return dict(device=default_device(device), generator=generator)


def _flat(x):
    return x.reshape((x.shape[0], -1))


class LeNet(nn.Module):
    """``paddle.vision.models.LeNet`` (28 x 28 single-channel input)."""

    def __init__(self, num_classes: int = 10, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, generator)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(Linear(400, 120, **kw), Linear(120, 84, **kw),
                                 Linear(84, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.fc(_flat(x))
        return x


_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _vgg_features(cfg: List, batch_norm: bool, kw) -> Sequential:
    layers, c_in = [], 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
            continue
        layers.append(Conv2D(c_in, v, 3, padding=1, **kw))
        if batch_norm:
            layers.append(BatchNorm2D(v, **kw))
        layers.append(ReLU())
        c_in = v
    return Sequential(*layers)


class VGG(nn.Module):
    """``paddle.vision.models.VGG``: ``features``, a 7 x 7 adaptive pool
    and three fully connected layers."""

    def __init__(self, features: nn.Module, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, generator)
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, num_classes, **kw))
        self.num_classes = num_classes

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(_flat(x))
        return x


def _vgg(arch, cfg, pretrained, batch_norm, device=None, generator=None,
         **kw):
    feats = _vgg_features(_VGG_CFGS[cfg], batch_norm,
                          _kw(device, generator))
    return _finish(VGG(feats, device=device, generator=generator, **kw),
                   arch, pretrained)


def vgg11(pretrained=False, batch_norm=False, **kw):
    return _vgg("vgg11", "A", pretrained, batch_norm, **kw)


def vgg13(pretrained=False, batch_norm=False, **kw):
    return _vgg("vgg13", "B", pretrained, batch_norm, **kw)


def vgg16(pretrained=False, batch_norm=False, **kw):
    return _vgg("vgg16", "D", pretrained, batch_norm, **kw)


def vgg19(pretrained=False, batch_norm=False, **kw):
    return _vgg("vgg19", "E", pretrained, batch_norm, **kw)


class _ConvBNReLU(Sequential):
    """Conv (no bias) + BatchNorm + ``act`` (none when ``act`` is None)."""

    def __init__(self, c_in, c_out, k, stride=1, groups=1, act=ReLU, *,
                 kw):
        layers = [Conv2D(c_in, c_out, k, stride=stride, padding=(k - 1) // 2,
                         groups=groups, bias_attr=False, **kw),
                  BatchNorm2D(c_out, **kw)]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


def _scaled(scale):
    return lambda ch: max(int(ch * scale), 8)


class MobileNetV1(nn.Module):
    """Depthwise-separable stack (``mobilenetv1.py``); ``scale`` widens
    every layer (at least 8 channels)."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        c = _scaled(scale)
        cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
               (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
               (1024, 1)]
        layers = [_ConvBNReLU(3, c(32), 3, stride=2, kw=kw)]
        c_in = c(32)
        for out, stride in cfg:
            layers.append(_ConvBNReLU(c_in, c_in, 3, stride=stride,
                                      groups=c_in, kw=kw))   # depthwise
            layers.append(_ConvBNReLU(c_in, c(out), 1, kw=kw))  # pointwise
            c_in = c(out)
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(c(1024), num_classes, **kw)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(_flat(x))
        return x


class InvertedResidual(nn.Module):
    """MobileNetV2's block: expand 1 x 1, depthwise 3 x 3, project 1 x 1;
    the input added back when the shapes allow."""

    def __init__(self, c_in, c_out, stride, expand_ratio, *, kw):
        super().__init__()
        hidden = int(round(c_in * expand_ratio))
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if expand_ratio != 1:
            layers.append(_ConvBNReLU(c_in, hidden, 1, act=ReLU6, kw=kw))
        layers += [
            _ConvBNReLU(hidden, hidden, 3, stride=stride, groups=hidden,
                        act=ReLU6, kw=kw),
            Conv2D(hidden, c_out, 1, bias_attr=False, **kw),
            BatchNorm2D(c_out, **kw),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    """``mobilenetv2.py``'s inverted-residual network."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]  # t, c, n, s
        c = _scaled(scale)
        layers = [_ConvBNReLU(3, c(32), 3, stride=2, act=ReLU6, kw=kw)]
        c_in = c(32)
        for t, ch, n, s in cfg:
            for i in range(n):
                layers.append(InvertedResidual(c_in, c(ch),
                                               s if i == 0 else 1, t, kw=kw))
                c_in = c(ch)
        out_c = max(int(1280 * scale), 1280) if scale > 1.0 else 1280
        layers.append(_ConvBNReLU(c_in, out_c, 1, act=ReLU6, kw=kw))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(Dropout(0.2),
                                         Linear(out_c, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(_flat(x))
        return x


class _SEBlock(nn.Module):
    """Squeeze and excite: ``x * hardsigmoid(fc2(relu(fc1(pool(x)))))``,
    the two fc layers 1 x 1 convolutions."""

    def __init__(self, ch, reduction=4, *, kw):
        super().__init__()
        self.pool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(ch, ch // reduction, 1, **kw)
        self.fc2 = Conv2D(ch // reduction, ch, 1, **kw)

    def forward(self, x):
        s = F.relu(self.fc1(self.pool(x)))
        return x * F.hardsigmoid(self.fc2(s))


class _MBV3Block(nn.Module):
    def __init__(self, c_in, hidden, c_out, k, stride, use_se, act, *, kw):
        super().__init__()
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if hidden != c_in:
            layers.append(_ConvBNReLU(c_in, hidden, 1, act=act, kw=kw))
        layers.append(_ConvBNReLU(hidden, hidden, k, stride=stride,
                                  groups=hidden, act=act, kw=kw))
        if use_se:
            layers.append(_SEBlock(hidden, kw=kw))
        layers += [Conv2D(hidden, c_out, 1, bias_attr=False, **kw),
                   BatchNorm2D(c_out, **kw)]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


# k, hidden, out, squeeze-excite, activation, stride for each block
_MBV3_SMALL = [
    (3, 16, 16, True, ReLU, 2), (3, 72, 24, False, ReLU, 2),
    (3, 88, 24, False, ReLU, 1), (5, 96, 40, True, Hardswish, 2),
    (5, 240, 40, True, Hardswish, 1), (5, 240, 40, True, Hardswish, 1),
    (5, 120, 48, True, Hardswish, 1), (5, 144, 48, True, Hardswish, 1),
    (5, 288, 96, True, Hardswish, 2), (5, 576, 96, True, Hardswish, 1),
    (5, 576, 96, True, Hardswish, 1),
]
_MBV3_LARGE = [
    (3, 16, 16, False, ReLU, 1), (3, 64, 24, False, ReLU, 2),
    (3, 72, 24, False, ReLU, 1), (5, 72, 40, True, ReLU, 2),
    (5, 120, 40, True, ReLU, 1), (5, 120, 40, True, ReLU, 1),
    (3, 240, 80, False, Hardswish, 2), (3, 200, 80, False, Hardswish, 1),
    (3, 184, 80, False, Hardswish, 1), (3, 184, 80, False, Hardswish, 1),
    (3, 480, 112, True, Hardswish, 1), (3, 672, 112, True, Hardswish, 1),
    (5, 672, 160, True, Hardswish, 2), (5, 960, 160, True, Hardswish, 1),
    (5, 960, 160, True, Hardswish, 1),
]


class _MobileNetV3(nn.Module):
    """``mobilenetv3.py``'s network over a block table: a hardswish stem,
    the blocks, a 1 x 1 conv to ``last`` channels, the pool, and a
    ``head``-wide hardswish classifier."""

    def __init__(self, cfg, last, head, scale, num_classes, with_pool,
                 device, generator):
        super().__init__()
        kw = _kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        c = _scaled(scale)
        layers = [_ConvBNReLU(3, c(16), 3, stride=2, act=Hardswish, kw=kw)]
        c_in = c(16)
        for k, hidden, out, se, act, s in cfg:
            layers.append(_MBV3Block(c_in, c(hidden), c(out), k, s, se, act,
                                     kw=kw))
            c_in = c(out)
        layers.append(_ConvBNReLU(c_in, c(last), 1, act=Hardswish, kw=kw))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(c(last), head, **kw), Hardswish(), Dropout(0.2),
                Linear(head, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(_flat(x))
        return x


class MobileNetV3Small(_MobileNetV3):
    """``mobilenetv3.py``'s small variant (hardswish and SE blocks)."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(_MBV3_SMALL, 576, 1024, scale, num_classes,
                         with_pool, device, generator)


class MobileNetV3Large(_MobileNetV3):
    """``mobilenetv3.py``'s large variant (the small one's blocks)."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(_MBV3_LARGE, 960, 1280, scale, num_classes,
                         with_pool, device, generator)


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    return _finish(MobileNetV1(scale=scale, **kw), f"mobilenetv1_{scale}",
                   pretrained)


def mobilenet_v2(pretrained=False, scale=1.0, **kw):
    return _finish(MobileNetV2(scale=scale, **kw), f"mobilenetv2_{scale}",
                   pretrained)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    return _finish(MobileNetV3Small(scale=scale, **kw),
                   f"mobilenet_v3_small_x{scale}", pretrained)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    return _finish(MobileNetV3Large(scale=scale, **kw),
                   f"mobilenet_v3_large_x{scale}", pretrained)


class AlexNet(nn.Module):
    """``alexnet.py``: five convolutions and three fully connected
    layers."""

    def __init__(self, num_classes: int = 1000, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, generator)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2, **kw), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(64, 192, 5, padding=2, **kw), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(192, 384, 3, padding=1, **kw), ReLU(),
            Conv2D(384, 256, 3, padding=1, **kw), ReLU(),
            Conv2D(256, 256, 3, padding=1, **kw), ReLU(),
            MaxPool2D(3, stride=2))
        self.pool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), Linear(256 * 36, 4096, **kw), ReLU(),
                Dropout(0.5), Linear(4096, 4096, **kw), ReLU(),
                Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = _flat(self.pool(self.features(x)))
        return self.classifier(x) if self.num_classes > 0 else x


def alexnet(pretrained=False, **kw):
    return _finish(AlexNet(**kw), "alexnet", pretrained)


class _Fire(nn.Module):
    def __init__(self, c_in, squeeze, e1, e3, *, kw):
        super().__init__()
        self.squeeze = Conv2D(c_in, squeeze, 1, **kw)
        self.expand1 = Conv2D(squeeze, e1, 1, **kw)
        self.expand3 = Conv2D(squeeze, e3, 3, padding=1, **kw)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1(s)), F.relu(self.expand3(s))],
                         dim=1)


class SqueezeNet(nn.Module):
    """``squeezenet.py``: Fire modules, version "1.0" or "1.1"."""

    def __init__(self, version: str = "1.0", num_classes: int = 1000,
                 with_pool: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise ValueError(f"version must be '1.0' or '1.1', "
                             f"got {version!r}")
        kw = _kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def fire(*a):
            return _Fire(*a, kw=kw)

        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2, **kw), ReLU(),
                MaxPool2D(3, stride=2),
                fire(96, 16, 64, 64), fire(128, 16, 64, 64),
                fire(128, 32, 128, 128), MaxPool2D(3, stride=2),
                fire(256, 32, 128, 128), fire(256, 48, 192, 192),
                fire(384, 48, 192, 192), fire(384, 64, 256, 256),
                MaxPool2D(3, stride=2), fire(512, 64, 256, 256))
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2, **kw), ReLU(),
                MaxPool2D(3, stride=2),
                fire(64, 16, 64, 64), fire(128, 16, 64, 64),
                MaxPool2D(3, stride=2),
                fire(128, 32, 128, 128), fire(256, 32, 128, 128),
                MaxPool2D(3, stride=2),
                fire(256, 48, 192, 192), fire(384, 48, 192, 192),
                fire(384, 64, 256, 256), fire(512, 64, 256, 256))
        if num_classes > 0:
            self.head = Sequential(Dropout(0.5),
                                   Conv2D(512, num_classes, 1, **kw), ReLU())
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.head(x)
        if self.with_pool:
            x = self.pool(x)
            if self.num_classes > 0:
                x = _flat(x)
        return x


def squeezenet1_0(pretrained=False, **kw):
    return _finish(SqueezeNet("1.0", **kw), "squeezenet1_0", pretrained)


def squeezenet1_1(pretrained=False, **kw):
    return _finish(SqueezeNet("1.1", **kw), "squeezenet1_1", pretrained)


class _ShuffleUnit(nn.Module):
    """ShuffleNetV2's unit: a stride-2 unit runs two branches over the
    whole input, a stride-1 unit passes half the channels through and
    runs the other half; then ``F.channel_shuffle`` over 2 groups. The
    activation follows the first and the last pointwise conv of the
    branch; the depthwise conv stays linear."""

    def __init__(self, c_in, c_out, stride, act="relu", *, kw):
        super().__init__()
        self.stride = stride
        branch = c_out // 2
        self.act = F.swish if act == "swish" else F.relu
        if stride > 1:
            self.branch1 = Sequential(
                Conv2D(c_in, c_in, 3, stride=stride, padding=1, groups=c_in,
                       bias_attr=False, **kw),
                BatchNorm2D(c_in, **kw),
                Conv2D(c_in, branch, 1, bias_attr=False, **kw),
                BatchNorm2D(branch, **kw))
            b2_in = c_in
        else:
            self.branch1 = None
            b2_in = c_in // 2
        self.pw1 = Sequential(Conv2D(b2_in, branch, 1, bias_attr=False, **kw),
                              BatchNorm2D(branch, **kw))
        self.dw = Sequential(
            Conv2D(branch, branch, 3, stride=stride, padding=1, groups=branch,
                   bias_attr=False, **kw),
            BatchNorm2D(branch, **kw))
        self.pw2 = Sequential(Conv2D(branch, branch, 1, bias_attr=False, **kw),
                              BatchNorm2D(branch, **kw))

    def _branch2(self, x):
        return self.act(self.pw2(self.dw(self.act(self.pw1(x)))))

    def forward(self, x):
        if self.stride > 1:
            out = torch.cat([self.act(self.branch1(x)), self._branch2(x)],
                            dim=1)
        else:
            half = x.shape[1] // 2
            out = torch.cat([x[:, :half], self._branch2(x[:, half:])], dim=1)
        return F.channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    """``shufflenetv2.py``: ``scale`` in {0.25, 0.33, 0.5, 1.0, 1.5, 2.0},
    ReLU or swish units."""

    _stage_out = {0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
                  0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
                  1.5: [24, 176, 352, 704, 1024],
                  2.0: [24, 244, 488, 976, 2048]}

    def __init__(self, scale: float = 1.0, act: str = "relu",
                 num_classes: int = 1000, with_pool: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        outs = self._stage_out[scale]
        self.stem = Sequential(
            Conv2D(3, outs[0], 3, stride=2, padding=1, bias_attr=False, **kw),
            BatchNorm2D(outs[0], **kw), ReLU(),
            MaxPool2D(3, stride=2, padding=1))
        stages, c_in = [], outs[0]
        for stage_i, repeat in enumerate((4, 8, 4)):
            c_out = outs[stage_i + 1]
            stages.append(_ShuffleUnit(c_in, c_out, 2, act, kw=kw))
            for _ in range(repeat - 1):
                stages.append(_ShuffleUnit(c_out, c_out, 1, act, kw=kw))
            c_in = c_out
        self.stages = Sequential(*stages)
        self.final = Sequential(
            Conv2D(c_in, outs[-1], 1, bias_attr=False, **kw),
            BatchNorm2D(outs[-1], **kw), ReLU())
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(outs[-1], num_classes, **kw)

    def forward(self, x):
        x = self.final(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(_flat(x))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return _finish(ShuffleNetV2(0.25, **kw), "shufflenet_v2_x0_25",
                   pretrained)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return _finish(ShuffleNetV2(0.33, **kw), "shufflenet_v2_x0_33",
                   pretrained)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return _finish(ShuffleNetV2(0.5, **kw), "shufflenet_v2_x0_5",
                   pretrained)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return _finish(ShuffleNetV2(1.0, **kw), "shufflenet_v2_x1_0",
                   pretrained)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return _finish(ShuffleNetV2(1.5, **kw), "shufflenet_v2_x1_5",
                   pretrained)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return _finish(ShuffleNetV2(2.0, **kw), "shufflenet_v2_x2_0",
                   pretrained)


def shufflenet_v2_swish(pretrained=False, **kw):
    return _finish(ShuffleNetV2(1.0, act="swish", **kw),
                   "shufflenet_v2_swish", pretrained)


class _DenseLayer(nn.Module):
    """BN-ReLU-conv 1 x 1 to ``bn_size * growth``, BN-ReLU-conv 3 x 3 to
    ``growth``, concatenated after the input."""

    def __init__(self, c_in, growth, bn_size, *, kw):
        super().__init__()
        self.bn1 = BatchNorm2D(c_in, **kw)
        self.conv1 = Conv2D(c_in, bn_size * growth, 1, bias_attr=False, **kw)
        self.bn2 = BatchNorm2D(bn_size * growth, **kw)
        self.conv2 = Conv2D(bn_size * growth, growth, 3, padding=1,
                            bias_attr=False, **kw)

    def forward(self, x):
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        return torch.cat([x, out], dim=1)


class DenseNet(nn.Module):
    """``densenet.py``: dense blocks that concatenate ``growth`` channels a
    layer, transitions that halve the channels and pool; ``layers`` in
    {121, 161, 169, 201, 264}."""

    _cfgs = {121: (32, (6, 12, 24, 16), 64),
             161: (48, (6, 12, 36, 24), 96),
             169: (32, (6, 12, 32, 32), 64),
             201: (32, (6, 12, 48, 32), 64),
             264: (32, (6, 12, 64, 48), 64)}

    def __init__(self, layers: int = 121, bn_size: int = 4,
                 num_classes: int = 1000, with_pool: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, generator)
        growth, blocks, init_c = self._cfgs[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        feats = [Conv2D(3, init_c, 7, stride=2, padding=3, bias_attr=False,
                        **kw),
                 BatchNorm2D(init_c, **kw), ReLU(),
                 MaxPool2D(3, stride=2, padding=1)]
        ch = init_c
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size, kw=kw))
                ch += growth
            if i != len(blocks) - 1:
                feats += [BatchNorm2D(ch, **kw), ReLU(),
                          Conv2D(ch, ch // 2, 1, bias_attr=False, **kw),
                          AvgPool2D(2, stride=2)]
                ch //= 2
        feats += [BatchNorm2D(ch, **kw), ReLU()]
        self.features = Sequential(*feats)
        self._out_ch = ch
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Linear(ch, num_classes, **kw)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(_flat(x))
        return x


def densenet121(pretrained=False, **kw):
    return _finish(DenseNet(121, **kw), "densenet121", pretrained)


def densenet161(pretrained=False, **kw):
    return _finish(DenseNet(161, **kw), "densenet161", pretrained)


def densenet169(pretrained=False, **kw):
    return _finish(DenseNet(169, **kw), "densenet169", pretrained)


def densenet201(pretrained=False, **kw):
    return _finish(DenseNet(201, **kw), "densenet201", pretrained)


def densenet264(pretrained=False, **kw):
    return _finish(DenseNet(264, **kw), "densenet264", pretrained)


class _Inception(nn.Module):
    """GoogLeNet's module: 1 x 1, 3 x 3, 5 x 5 and pool branches."""

    def __init__(self, c_in, c1, r3, c3, r5, c5, cp, *, kw):
        super().__init__()
        self.b1 = Sequential(Conv2D(c_in, c1, 1, **kw), ReLU())
        self.b3 = Sequential(Conv2D(c_in, r3, 1, **kw), ReLU(),
                             Conv2D(r3, c3, 3, padding=1, **kw), ReLU())
        self.b5 = Sequential(Conv2D(c_in, r5, 1, **kw), ReLU(),
                             Conv2D(r5, c5, 5, padding=2, **kw), ReLU())
        self.bp = Sequential(MaxPool2D(3, stride=1, padding=1),
                             Conv2D(c_in, cp, 1, **kw), ReLU())

    def forward(self, x):
        return torch.cat([self.b1(x), self.b3(x), self.b5(x), self.bp(x)],
                         dim=1)


class GoogLeNet(nn.Module):
    """``googlenet.py`` (Inception v1). ``forward`` returns the main
    logits; the reference drops the two auxiliary training heads."""

    def __init__(self, num_classes: int = 1000, with_pool: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def inc(*a):
            return _Inception(*a, kw=kw)

        self.stem = Sequential(
            Conv2D(3, 64, 7, stride=2, padding=3, **kw), ReLU(),
            MaxPool2D(3, stride=2, padding=1),
            Conv2D(64, 64, 1, **kw), ReLU(),
            Conv2D(64, 192, 3, padding=1, **kw), ReLU(),
            MaxPool2D(3, stride=2, padding=1))
        self.blocks = Sequential(
            inc(192, 64, 96, 128, 16, 32, 32),
            inc(256, 128, 128, 192, 32, 96, 64),
            MaxPool2D(3, stride=2, padding=1),
            inc(480, 192, 96, 208, 16, 48, 64),
            inc(512, 160, 112, 224, 24, 64, 64),
            inc(512, 128, 128, 256, 24, 64, 64),
            inc(512, 112, 144, 288, 32, 64, 64),
            inc(528, 256, 160, 320, 32, 128, 128),
            MaxPool2D(3, stride=2, padding=1),
            inc(832, 256, 160, 320, 32, 128, 128),
            inc(832, 384, 192, 384, 48, 128, 128))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.head = Sequential(Dropout(0.4),
                                   Linear(1024, num_classes, **kw))

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.head(_flat(x))
        return x


def googlenet(pretrained=False, **kw):
    return _finish(GoogLeNet(**kw), "googlenet", pretrained)


class _BasicConv(Sequential):
    def __init__(self, ci, co, k, s=1, p=0, *, kw):
        super().__init__(Conv2D(ci, co, k, stride=s, padding=p,
                                bias_attr=False, **kw),
                         BatchNorm2D(co, **kw), ReLU())


class _InceptionA(nn.Module):
    """35 x 35 cell: 1 x 1, 5 x 5, double 3 x 3 and pool branches, 224 +
    ``pool_ch`` channels."""

    def __init__(self, c_in, pool_ch, *, kw):
        super().__init__()
        self.b1 = _BasicConv(c_in, 64, 1, kw=kw)
        self.b5 = Sequential(_BasicConv(c_in, 48, 1, kw=kw),
                             _BasicConv(48, 64, 5, p=2, kw=kw))
        self.b3d = Sequential(_BasicConv(c_in, 64, 1, kw=kw),
                              _BasicConv(64, 96, 3, p=1, kw=kw),
                              _BasicConv(96, 96, 3, p=1, kw=kw))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _BasicConv(c_in, pool_ch, 1, kw=kw))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3d(x), self.bp(x)],
                         dim=1)


class _ReductionA(nn.Module):
    """35 to 17: stride-2 3 x 3, stride-2 double 3 x 3, max pool."""

    def __init__(self, c_in, *, kw):
        super().__init__()
        self.b3 = _BasicConv(c_in, 384, 3, s=2, kw=kw)
        self.b3d = Sequential(_BasicConv(c_in, 64, 1, kw=kw),
                              _BasicConv(64, 96, 3, p=1, kw=kw),
                              _BasicConv(96, 96, 3, s=2, kw=kw))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3d(x), self.pool(x)], dim=1)


class _InceptionB(nn.Module):
    """17 x 17 cell with 1 x 7 / 7 x 1 factorized branches, 768
    channels."""

    def __init__(self, c_in, mid, *, kw):
        super().__init__()

        def bc(*a, **k):
            return _BasicConv(*a, **k, kw=kw)

        self.b1 = bc(c_in, 192, 1)
        self.b7 = Sequential(bc(c_in, mid, 1), bc(mid, mid, (1, 7), p=(0, 3)),
                             bc(mid, 192, (7, 1), p=(3, 0)))
        self.b7d = Sequential(
            bc(c_in, mid, 1), bc(mid, mid, (7, 1), p=(3, 0)),
            bc(mid, mid, (1, 7), p=(0, 3)), bc(mid, mid, (7, 1), p=(3, 0)),
            bc(mid, 192, (1, 7), p=(0, 3)))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             bc(c_in, 192, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                         dim=1)


class _ReductionB(nn.Module):
    """17 to 8: 1280 channels."""

    def __init__(self, c_in, *, kw):
        super().__init__()

        def bc(*a, **k):
            return _BasicConv(*a, **k, kw=kw)

        self.b3 = Sequential(bc(c_in, 192, 1), bc(192, 320, 3, s=2))
        self.b7 = Sequential(bc(c_in, 192, 1), bc(192, 192, (1, 7), p=(0, 3)),
                             bc(192, 192, (7, 1), p=(3, 0)),
                             bc(192, 192, 3, s=2))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], dim=1)


class _InceptionC(nn.Module):
    """8 x 8 cell with expanded 1 x 3 / 3 x 1 splits, 2048 channels."""

    def __init__(self, c_in, *, kw):
        super().__init__()

        def bc(*a, **k):
            return _BasicConv(*a, **k, kw=kw)

        self.b1 = bc(c_in, 320, 1)
        self.b3_stem = bc(c_in, 384, 1)
        self.b3_a = bc(384, 384, (1, 3), p=(0, 1))
        self.b3_b = bc(384, 384, (3, 1), p=(1, 0))
        self.b3d_stem = Sequential(bc(c_in, 448, 1), bc(448, 384, 3, p=1))
        self.b3d_a = bc(384, 384, (1, 3), p=(0, 1))
        self.b3d_b = bc(384, 384, (3, 1), p=(1, 0))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             bc(c_in, 192, 1))

    def forward(self, x):
        s3 = self.b3_stem(x)
        s3d = self.b3d_stem(x)
        return torch.cat([self.b1(x), self.b3_a(s3), self.b3_b(s3),
                          self.b3d_a(s3d), self.b3d_b(s3d), self.bp(x)], dim=1)


class InceptionV3(nn.Module):
    """``inceptionv3.py``: three InceptionA cells, ReductionA, four
    InceptionB, ReductionB, two InceptionC; 2048 channels at 8 x 8 for a
    299 x 299 image. The reference drops the auxiliary head."""

    def __init__(self, num_classes: int = 1000, with_pool: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, generator)
        self.num_classes = num_classes
        self.with_pool = with_pool

        def bc(*a, **k):
            return _BasicConv(*a, **k, kw=kw)

        self.stem = Sequential(
            bc(3, 32, 3, s=2), bc(32, 32, 3), bc(32, 64, 3, p=1),
            MaxPool2D(3, stride=2), bc(64, 80, 1), bc(80, 192, 3),
            MaxPool2D(3, stride=2))
        self.blocks = Sequential(
            _InceptionA(192, 32, kw=kw), _InceptionA(256, 64, kw=kw),
            _InceptionA(288, 64, kw=kw), _ReductionA(288, kw=kw),
            _InceptionB(768, 128, kw=kw), _InceptionB(768, 160, kw=kw),
            _InceptionB(768, 160, kw=kw), _InceptionB(768, 192, kw=kw),
            _ReductionB(768, kw=kw), _InceptionC(1280, kw=kw),
            _InceptionC(2048, kw=kw))
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Sequential(Dropout(0.5), Linear(2048, num_classes, **kw))

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(_flat(x))
        return x


def inception_v3(pretrained=False, **kw):
    return _finish(InceptionV3(**kw), "inception_v3", pretrained)

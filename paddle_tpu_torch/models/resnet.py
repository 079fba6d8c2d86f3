"""The ResNet family (port of ``paddle_tpu/models/resnet.py``):
``BasicBlock``, ``BottleneckBlock``, ``ResNet`` and its 13 constructors,
the grouped ResNeXt and the wide variants among them.

The layer topology and parameter names are the reference's (NCHW, convs
without bias, each followed by a BatchNorm2D), so a reference
``state_dict()`` (parameters and the ``_mean`` / ``_variance`` buffers)
loads by name (:func:`paddle_tpu_torch.convert.resnet_from_jax`).

Under ``amp.decorate(level="O2", dtype="bfloat16")`` the model computes
in the images' dtype, as the reference does: a conv casts its weight to
the input's dtype, and a BatchNorm's or the classifier's bf16 weights
meet float32 activations with JAX's promotion. Float32 images (what
``bench.py``'s ``bench_resnet50`` feeds) therefore give a float32 network
and float32 logits; bf16 images a bf16 one.
"""
from __future__ import annotations

from typing import List, Optional, Type, Union

import torch
from torch import nn

from .. import default_device
from ..nn import functional as F
from ..nn.layers.common import Linear
from ..nn.layers.containers import Sequential
from ..nn.layers.conv import Conv2D
from ..nn.layers.norm import BatchNorm2D
from ..nn.layers.pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
           "wide_resnet101_2", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        if groups != 1 or base_width != 64:
            raise ValueError(
                "BasicBlock only supports groups=1 and base_width=64")
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, **kw)
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **kw)
        self.bn2 = norm_layer(planes, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        kw = dict(device=device, generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, **kw)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=dilation,
                            groups=groups, dilation=dilation, bias_attr=False,
                            **kw)
        self.bn2 = norm_layer(width, **kw)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """``depth_or_layers`` is 18, 34, 50, 101 or 152, or the four stage
    depths; ``width`` the bottleneck's base width, ``groups`` its conv2
    groups; ``num_classes=0`` drops the classifier and ``with_pool=False``
    the global pool. Built on ``device`` (None: ``cuda``; it raises
    without one unless ``device="cpu"``), drawing from ``generator`` when
    one is given."""

    def __init__(self, block: Type[Union[BasicBlock, BottleneckBlock]],
                 depth_or_layers: Union[int, List[int]] = 50, width: int = 64,
                 num_classes: int = 1000, with_pool: bool = True,
                 groups: int = 1, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = default_device(device)
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = (layer_cfg[depth_or_layers]
                  if isinstance(depth_or_layers, int)
                  else list(depth_or_layers))
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width
        self.inplanes = 64
        self.dilation = 1
        self._kw = dict(device=device, generator=generator)

        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, **self._kw)
        self.bn1 = BatchNorm2D(self.inplanes, **self._kw)
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **self._kw)
        del self._kw

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **self._kw),
                BatchNorm2D(planes * block.expansion, **self._kw))
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, self.dilation, **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **self._kw))
        return Sequential(*layers)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.reshape((x.shape[0], -1))
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained=False, arch=None, **kwargs):
    if pretrained:
        raise ValueError(
            f"{arch or f'resnet{depth}'}(pretrained=True): pretrained weights "
            f"need a download; build with random weights, or load a "
            f"reference state dict with convert.resnet_from_jax")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 50, pretrained, arch="wide_resnet50_2",
                   **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet(BottleneckBlock, 101, pretrained, arch="wide_resnet101_2",
                   **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet(BottleneckBlock, 50, pretrained, arch="resnext50_32x4d",
                   **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet(BottleneckBlock, 50, pretrained, arch="resnext50_64x4d",
                   **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet(BottleneckBlock, 101, pretrained, arch="resnext101_32x4d",
                   **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet(BottleneckBlock, 101, pretrained, arch="resnext101_64x4d",
                   **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet(BottleneckBlock, 152, pretrained, arch="resnext152_32x4d",
                   **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet(BottleneckBlock, 152, pretrained, arch="resnext152_64x4d",
                   **kwargs)

"""Container layers (port of ``paddle_tpu/nn/layers/containers.py``).

Each is torch's container with the reference's constructors: children
are named ``"0"``, ``"1"``, ... (or by the names given), so a parameter's
path is the reference's (``layers.3.linear1.weight``) and a converted
state dict loads by name.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]


class Sequential(nn.Sequential):
    """``Sequential(l0, l1, ...)``, ``Sequential(("name", layer), ...)``
    or ``Sequential([("name", layer), ...])``; ``forward`` feeds each
    child's output to the next."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            named = list(layers[0].items())  # torch's slicing passes one
        elif len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            named = [(str(name), layer) for name, layer in layers[0]]
        else:
            named = [(str(layer[0]), layer[1]) if isinstance(layer, tuple)
                     else (str(i), layer) for i, layer in enumerate(layers)]
        super().__init__(OrderedDict(named))


class LayerList(nn.ModuleList):
    """A list of layers named by position; ``insert`` renumbers."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class LayerDict(nn.ModuleDict):
    """Layers by name; ``update`` takes a dict or ``(name, layer)``
    pairs."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(nn.ParameterList):
    """Parameters named by position; a value that is not a parameter is
    wrapped in one."""

    def __init__(self, parameters=None):
        super().__init__(parameters)

    def __setitem__(self, idx, value):
        if not isinstance(value, nn.Parameter):
            value = nn.Parameter(torch.as_tensor(value))
        super().__setitem__(idx, value)

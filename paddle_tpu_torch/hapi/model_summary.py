"""Model summary (port of ``paddle_tpu/hapi/model_summary.py``).

``summary(net, input_size)`` runs one forward on zeros (in eval mode,
restored after) with a hook on every sublayer, prints a table of the
sublayers in the order their forwards finish (name, type, output shape,
own parameters) and returns ``{'total_params': N, 'trainable_params':
M}``. As in the reference every parameter counts as trainable (its
arrays carry no flag); frozen ones included.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["summary"]


def _num_params(layer: torch.nn.Module, include_sublayers: bool = False):
    n = sum(p.numel() for p in layer.parameters(recurse=include_sublayers))
    return n, n


def _shape_of(out):
    if hasattr(out, "shape"):
        return list(out.shape)
    if isinstance(out, (tuple, list)):
        return [_shape_of(o) for o in out]
    return []


def _device(net):
    p = next(net.parameters(), None)
    return p.device if p is not None else torch.device("cpu")


def summary(net: torch.nn.Module, input_size=None, dtypes=None, input=None):  # noqa: A002
    """Print the layer table; returns the parameter counts. ``input_size``
    is one shape or a list of them (zeros of ``dtypes``, float32 by
    default), or ``input`` the network's input itself (run in the
    network's own mode)."""
    rows: List[Tuple[str, str, list, int]] = []

    def make_hook(name):
        def hook(layer, inputs, outputs):
            rows.append((name, type(layer).__name__, _shape_of(outputs),
                         _num_params(layer)[0]))
        return hook

    hooks = [sub.register_forward_hook(make_hook(name))
             for name, sub in net.named_modules() if name]
    try:
        with torch.no_grad():
            if input is not None:
                net(*(input if isinstance(input, (tuple, list)) else (input,)))
            elif input_size is not None:
                sizes = input_size
                if isinstance(sizes, tuple) and sizes and \
                        isinstance(sizes[0], int):
                    sizes = [sizes]
                dts = dtypes or ["float32"] * len(sizes)
                if isinstance(dts, str):
                    dts = [dts] * len(sizes)
                device = _device(net)
                args = tuple(torch.as_tensor(np.zeros(s, dtype=np.dtype(d)),
                                             device=device)
                             for s, d in zip(sizes, dts))
                was_training = net.training
                net.eval()
                try:
                    net(*args)
                finally:
                    net.train(was_training)
            else:
                raise ValueError("summary needs input_size or input")
    finally:
        for h in hooks:
            h.remove()

    total, trainable = _num_params(net, include_sublayers=True)
    name_w = max([len(r[0]) for r in rows] + [10]) + 2
    type_w = max([len(r[1]) for r in rows] + [10]) + 2
    print("-" * (name_w + type_w + 40))
    print(f"{'Layer':<{name_w}}{'Type':<{type_w}}{'Output Shape':<26}"
          f"{'Params':>12}")
    print("=" * (name_w + type_w + 40))
    for name, tname, shape, n in rows:
        print(f"{name:<{name_w}}{tname:<{type_w}}{str(shape):<26}{n:>12,}")
    print("=" * (name_w + type_w + 40))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * (name_w + type_w + 40))
    return {"total_params": total, "trainable_params": trainable}

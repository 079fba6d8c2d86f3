"""FLOPs counting (port of ``paddle_tpu/hapi/dynamic_flops.py``).

The reference traces the network to a jaxpr and counts its primitives.
The port runs one forward on zeros (eval mode, no autograd) under a
``TorchDispatchMode`` and counts the ATen ops it runs, with the
reference's breakdown keys:

- ``conv``: ``2 * in_c / groups * prod(kernel)`` per output element (a
  transposed conv counts its uncropped output, the reference its cropped
  one);
- ``dot_general``: ``2 * M * N * K`` per matmul;
- ``elementwise``: one per output element of the arithmetic and
  transcendental ops (the port's own ops; the reference counts its
  jaxpr's, so the two differ slightly: e.g. its ``relu`` sits inside a
  ``custom_jvp_call`` it does not enter).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["flops", "count_flops", "FlopCounter"]

_aten = torch.ops.aten

_ELEMENTWISE = {
    _aten.add.Tensor, _aten.add.Scalar, _aten.sub.Tensor, _aten.sub.Scalar,
    _aten.rsub.Tensor, _aten.rsub.Scalar, _aten.mul.Tensor, _aten.mul.Scalar,
    _aten.div.Tensor, _aten.div.Scalar, _aten.maximum.default,
    _aten.minimum.default, _aten.clamp.default, _aten.clamp_min.default,
    _aten.clamp_max.default, _aten.relu.default, _aten.pow.Tensor_Scalar,
    _aten.pow.Tensor_Tensor, _aten.exp.default, _aten.log.default,
    _aten.tanh.default, _aten.sigmoid.default, _aten.rsqrt.default,
    _aten.sqrt.default, _aten.neg.default, _aten.abs.default,
    _aten.erf.default, _aten.where.self, _aten.gelu.default,
    _aten.silu.default,
}


def _numel(t) -> float:
    return float(math.prod(t.shape))


class FlopCounter(TorchDispatchMode):
    """Counts FLOPs by the reference's keys of every ATen op run inside
    it (``totals``)."""

    def __init__(self):
        super().__init__()
        self.totals: Dict[str, float] = {}

    def _add(self, key, n):
        self.totals[key] = self.totals.get(key, 0.0) + float(n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet is _aten.convolution:
            w, transposed, groups = args[1], args[6], args[8]
            # the input channels a group's output element reads
            in_c = w.shape[0] // groups if transposed else w.shape[1]
            self._add("conv", _numel(out) * 2.0 * in_c
                      * math.prod(w.shape[2:]))
        elif packet in (_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm):
            a = args[1] if packet in (_aten.addmm, _aten.baddbmm) else args[0]
            self._add("dot_general", 2.0 * _numel(out) * a.shape[-1])
            if packet in (_aten.addmm, _aten.baddbmm):
                self._add("elementwise", _numel(out))
        elif func in _ELEMENTWISE and isinstance(out, torch.Tensor):
            self._add("elementwise", _numel(out))
        return out


def count_flops(net: torch.nn.Module, input_size) -> Dict[str, float]:
    """``{key: FLOPs}`` of one forward of ``net`` on float32 zeros of
    ``input_size`` (one shape or a list of them) on its device, in eval
    mode (restored after)."""
    sizes = input_size
    if isinstance(sizes, tuple) and sizes and isinstance(sizes[0], int):
        sizes = [sizes]
    p = next(net.parameters(), None)
    device = p.device if p is not None else torch.device("cpu")
    args = tuple(torch.zeros(tuple(s), dtype=torch.float32, device=device)
                 for s in sizes)
    was_training = net.training
    net.eval()
    counter = FlopCounter()
    try:
        with torch.no_grad(), counter:
            net(*args)
    finally:
        net.train(was_training)
    return counter.totals


def flops(net: torch.nn.Module, input_size, custom_ops=None,
          print_detail: bool = False) -> int:
    """Total forward FLOPs for one batch of ``input_size``
    (:func:`count_flops` summed); ``custom_ops`` is accepted and not read,
    as in the reference."""
    totals = count_flops(net, input_size)
    total = int(sum(totals.values()))
    if print_detail:
        for k, v in sorted(totals.items(), key=lambda kv: -kv[1]):
            print(f"{k:<24}{v:,.0f}")
        print(f"Total FLOPs: {total:,}")
    return total

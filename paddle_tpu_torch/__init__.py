"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors the JAX package's module layout (``models/gpt.py``,
``serving/engine.py``, ``kernels/flash_attention.py``, ...) so every
module has an obvious counterpart. It imports ``torch`` and nothing of
``jax`` or ``paddle_tpu``; the parity tests are the only place both
packages meet.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``cuda``, and a machine without CUDA raises instead
of quietly falling back. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["default_device"]

DeviceLike = Union[str, torch.device, None]


def default_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly
    or by default) and none is present: the port never falls back to the
    CPU on its own."""
    # The JAX reference runs float32 matmuls at full float32 precision.
    # torch's CUDA matmul default is already full f32, but cuDNN defaults to
    # TF32 (about three decimal digits); both flags are set here, at every
    # entry point, so the precision the port runs at is stated, not assumed.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev

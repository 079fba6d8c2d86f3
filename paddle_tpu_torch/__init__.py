"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors the JAX package's module layout (``models/gpt.py``,
``serving/engine.py``, ``kernels/flash_attention.py``, ...) so every
module has an obvious counterpart, and its top level mirrors the
reference's ``paddle.*`` surface: the tensor ops, dtypes and places,
``to_tensor``, ``grad``, ``no_grad``, ``Tensor``, ``nn``, ``optimizer``
and the rest of what is ported (``ROADMAP.md`` lists what is not). It
imports ``torch`` and nothing of ``jax`` or ``paddle_tpu``; the parity
tests are the only place both packages meet. Importing it builds
nothing: kernels and the native runtime are built by their first call.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``cuda``, creation ops and ``to_tensor`` use the
current device (``cuda`` until ``set_device("cpu")``), and a machine
without CUDA raises instead of quietly falling back. Tests pass
``device="cpu"`` or call ``set_device("cpu")``.
"""
from __future__ import annotations

from typing import Union

import torch

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


# the ops are the top-level tensor API (paddle.add, paddle.matmul, ...)
from .ops import *  # noqa: F401,F403,E402
from .framework.dtype import (  # noqa: F401,E402
    bfloat16, bool_, complex64, complex128, convert_dtype, dtype_name,
    finfo, float16, float32, float64, get_default_dtype, iinfo, int8, int16,
    int32, int64, is_complex, is_floating_point, is_integer,
    set_default_dtype, uint8,
)
from .framework.random import (  # noqa: F401,E402
    default_generator, get_rng_state, next_key, seed, set_rng_state,
)
from .framework.random import (  # noqa: F401,E402
    get_rng_state as get_cuda_rng_state,  # one generator for all devices
    set_rng_state as set_cuda_rng_state,
)
from .framework.io import load, save  # noqa: F401,E402
from .framework.compat import (  # noqa: F401,E402
    CPUPlace, CUDAPinnedPlace, CUDAPlace, LazyGuard, NPUPlace, TPUPlace,
    array_length, array_read, array_write, batch, check_shape,
    create_array, create_parameter, disable_signal_handler, disable_static,
    dtype, enable_static, get_device, in_dynamic_mode, index_add_,
    is_grad_enabled, set_device, set_grad_enabled,
)
from .framework.flags import get_flags, set_flags  # noqa: F401,E402
from .framework.debugging import check_numerics  # noqa: F401,E402
from .framework.jit import EvalStep, TrainStep  # noqa: F401,E402

from . import nn  # noqa: F401,E402
from . import geometric  # noqa: F401,E402
from . import vision  # noqa: F401,E402
from . import utils  # noqa: F401,E402
from . import quantization  # noqa: F401,E402
from . import optimizer  # noqa: F401,E402
from . import metric  # noqa: F401,E402
from . import callbacks  # noqa: F401,E402
from . import io  # noqa: F401,E402
from . import amp  # noqa: F401,E402
from . import distributed  # noqa: F401,E402
from . import kernels  # noqa: F401,E402
from . import models  # noqa: F401,E402
from . import native  # noqa: F401,E402
from . import observability  # noqa: F401,E402
from .hapi import InputSpec, Model, flops, summary  # noqa: F401,E402
from . import profiler  # noqa: F401,E402
from . import eager  # noqa: F401,E402
from . import autograd  # noqa: F401,E402
from . import jit  # noqa: F401,E402
from . import static  # noqa: F401,E402
from . import inference  # noqa: F401,E402
from .framework.supervisor import (  # noqa: F401,E402
    RecoveryPolicy, TrainingPreempted, TrainingSupervisor,
)


def grad(outputs, *args, **kwargs):
    """``paddle.grad`` in two forms: with a callable first argument the
    functional transform (``torch.func.grad``: a function returning the
    gradient with respect to its first argument); with eager Tensors the
    partial gradients of ``outputs`` with respect to ``inputs``
    (:func:`paddle_tpu_torch.eager.grad`), leaving ``.grad`` as it is."""
    if callable(outputs) and not isinstance(outputs, eager.Tensor):
        return torch.func.grad(outputs, *args, **kwargs)
    return eager.grad(outputs, *args, **kwargs)


def value_and_grad(fn, argnums=0, has_aux=False):
    """A function returning ``(value, gradient)`` of ``fn`` (the order of
    ``jax.value_and_grad``; ``torch.func.grad_and_value`` returns them the
    other way round)."""
    both = torch.func.grad_and_value(fn, argnums=argnums, has_aux=has_aux)

    def call(*args, **kwargs):
        g, v = both(*args, **kwargs)
        return v, g

    return call


def no_grad(fn=None):
    """``paddle.no_grad``: a context (``no_grad()``) or a decorator
    (``no_grad(fn)``) inside which the tape records nothing."""
    if fn is None:
        return torch.no_grad()
    return torch.no_grad()(fn)


def stop_gradient(x):
    """``x`` cut from the tape."""
    return x.detach()


class ParamAttr:
    """Parameter attribute bundle (``paddle.ParamAttr``), reduced to the
    fields that matter functionally."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def is_compiled_with_cuda() -> bool:
    """Whether torch was built with CUDA."""
    return torch.backends.cuda.is_built()


def is_compiled_with_xpu() -> bool:
    return False


def device_count() -> int:
    """The number of CUDA devices."""
    return torch.cuda.device_count()


__version__ = "0.1.0"

# late aliases (kept last: `bool` would shadow the builtin above)
from .eager import Tensor  # noqa: F401,E402
from .distributed.parallel import DataParallel  # noqa: F401,E402

bool = bool_  # noqa: F401,A001 - paddle.bool, the dtype


def __getattr__(name):
    # serving pulls in the generation and cache stack, which a plain
    # `import paddle_tpu_torch` does not pay for
    if name == "serving":
        import importlib

        return importlib.import_module(".serving", __name__)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")

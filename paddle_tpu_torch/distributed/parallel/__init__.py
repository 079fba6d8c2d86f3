"""Parallel layers and wrappers (port of
``paddle_tpu/distributed/parallel``): activation recompute, the
tensor-parallel layers, ``DataParallel`` and LocalSGD (``localsgd``)."""
from . import containers_util, localsgd, mp_layers, recompute  # noqa: F401
from .data_parallel import DataParallel  # noqa: F401

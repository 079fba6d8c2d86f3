"""``paddle.callbacks`` namespace (alias of
:mod:`paddle_tpu_torch.hapi.callbacks`, as ``paddle_tpu/callbacks.py``
aliases the reference's)."""
from .hapi.callbacks import (  # noqa: F401
    Callback, CallbackList, EarlyStopping, History, LRScheduler,
    ModelCheckpoint, ProgBarLogger, ScalarLogger, config_callbacks,
)

"""High-level API (port of ``paddle_tpu/hapi``). ``summary`` and ``flops``
wait for ``hapi/model_summary.py`` and ``hapi/dynamic_flops.py`` (ROADMAP
A9)."""
from .callbacks import (Callback, CallbackList, EarlyStopping, History,
                        LRScheduler, ModelCheckpoint, ProgBarLogger,
                        ScalarLogger)
from .model import InputSpec, Model

__all__ = [
    "Model", "InputSpec", "Callback", "CallbackList", "ProgBarLogger",
    "ModelCheckpoint", "EarlyStopping", "LRScheduler", "History",
    "ScalarLogger",
]

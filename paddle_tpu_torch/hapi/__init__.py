"""High-level API (port of ``paddle_tpu/hapi``)."""
from .callbacks import (Callback, CallbackList, EarlyStopping, History,
                        LRScheduler, ModelCheckpoint, ProgBarLogger,
                        ScalarLogger)
from .dynamic_flops import flops
from .model import InputSpec, Model
from .model_summary import summary

__all__ = [
    "Model", "InputSpec", "Callback", "CallbackList", "ProgBarLogger",
    "ModelCheckpoint", "EarlyStopping", "LRScheduler", "History",
    "ScalarLogger", "summary", "flops",
]

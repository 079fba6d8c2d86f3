"""Optimizers and learning-rate schedulers (port of
``paddle_tpu/optimizer``)."""
from . import lr  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        DGCMomentum, Lamb, LarsMomentum, Momentum, Optimizer,
                        RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Adadelta", "Adamax", "Lamb", "LarsMomentum",
           "DGCMomentum"]

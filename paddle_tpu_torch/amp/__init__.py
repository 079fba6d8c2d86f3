"""Mixed precision (port of ``paddle_tpu/amp``): ``auto_cast`` (O1),
``decorate`` (O2) and ``GradScaler`` (dynamic loss scaling for float16)."""
from .auto_cast import (amp_guard, auto_cast, autocast_call, decorate,
                        get_autocast_dtype, is_autocast_enabled)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "autocast_call", "decorate",
           "is_autocast_enabled", "get_autocast_dtype", "GradScaler",
           "AmpScaler"]

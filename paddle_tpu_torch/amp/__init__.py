"""Mixed precision (port of ``paddle_tpu/amp``): ``decorate`` at O2."""
from .auto_cast import decorate

__all__ = ["decorate"]

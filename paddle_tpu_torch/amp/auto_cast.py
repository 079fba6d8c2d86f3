"""``amp.decorate`` at level O2 (port of
``paddle_tpu/amp/auto_cast.py:81``).

O2 ("pure" low precision) casts every floating parameter of the models to
``dtype`` and turns on the optimizers' ``multi_precision``, so they keep
float32 master weights. Parameters change type in place (``param.data``),
so a module keeps its ``nn.Parameter`` objects. O1 (per-op autocast) is
not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["decorate"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight: Optional[bool] = None):
    """Cast ``models``' floating parameters to ``dtype`` and give
    ``optimizers`` master weights (unless ``master_weight=False``).
    Returns what was passed: ``model``, or ``(model, optimizer)``, with
    lists where lists were given."""
    if level != "O2":
        raise NotImplementedError(f"amp level {level!r} is not ported; "
                                  f"only O2 is")
    d = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    with torch.no_grad():
        for m in model_list:
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(d)
    if optimizers is None:
        return model_list[0] if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for opt in opt_list:
        if master_weight is not False:
            opt.multi_precision = True
    return (model_list[0] if single else model_list,
            opt_list[0] if opt_single else opt_list)

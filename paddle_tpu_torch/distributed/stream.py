"""paddle.distributed.stream — stream variants of the collectives (port of
``paddle_tpu/distributed/stream.py``).

Reference parity: ``python/paddle/distributed/communication/stream/``
(collectives launched on a caller-chosen CUDA stream with
``sync_op``/``use_calc_stream``). The port's collectives run on the
current stream, so the two knobs are accepted and ignored, as the JAX
reference accepts and ignores them; the math is :mod:`.collective`'s and
:mod:`.api_compat`'s.
"""
from __future__ import annotations

from . import api_compat as _a
from . import collective as _c


def _wrap(fn):
    def call(*args, sync_op=True, use_calc_stream=False, **kw):
        return fn(*args, **kw)

    call.__name__ = fn.__name__
    call.__doc__ = (f"stream variant of {fn.__module__}.{fn.__name__} "
                    "(sync_op/use_calc_stream accepted and ignored: it runs "
                    "on the current stream)")
    return call


all_reduce = _wrap(_c.all_reduce)
all_gather = _wrap(_c.all_gather)
alltoall = _wrap(_c.alltoall)
alltoall_single = _wrap(_a.alltoall_single)
broadcast = _wrap(_c.broadcast)
reduce_scatter = _wrap(_c.reduce_scatter)
scatter = _wrap(_a.scatter)
send = _wrap(_a.send)
recv = _wrap(_a.recv)

__all__ = ["all_reduce", "all_gather", "alltoall", "alltoall_single",
           "broadcast", "reduce_scatter", "scatter", "send", "recv"]

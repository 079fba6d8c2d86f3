"""The tensor op library (port of ``paddle_tpu/ops``): ordinary PyTorch
ops under paddle's names and arguments. None of them is a hand-written
kernel; the reference's are plain ``jnp`` too.

The names this package exports (and ``paddle_tpu_torch`` re-exports at
the top level) take eager Tensors as well as torch tensors: given one,
an op runs through :func:`paddle_tpu_torch.eager.apply_op`. The functions
of the submodules themselves take torch tensors only.
"""
from . import creation, linalg, logic, manipulation, math, random, \
    search, sequence, stat
from ..eager import eager_aware as _eager_aware

__all__ = []
for _mod in (creation, math, manipulation, linalg, logic, search, random,
             stat, sequence):
    for _name in _mod.__all__:
        _fn = getattr(_mod, _name)
        # to_tensor unwraps an eager Tensor itself and returns plain data
        globals()[_name] = _fn if _name == "to_tensor" else _eager_aware(_fn)
    __all__ += _mod.__all__
__all__ += ["creation", "math", "manipulation", "linalg", "logic", "search",
            "random", "stat", "sequence"]
del _mod, _name, _fn

"""Random ops (port of ``paddle_tpu/ops/random.py``).

Each op takes ``key=``, a ``torch.Generator`` on the result's device,
where the reference takes a JAX key; without one it draws from a
generator seeded from the port's global seed
(:func:`paddle_tpu_torch.framework.random.next_seed`), so ``seed(s)``
replays a run's draws bit for bit. The draws are torch's, not JAX's:
they agree with the reference in distribution, never bit for bit.
"""
from __future__ import annotations

import torch

from ..framework.compat import current_device
from ..framework.dtype import convert_dtype, get_default_dtype
from ..framework.random import next_key
from ._common import t

__all__ = [
    "uniform", "rand", "randn", "normal", "standard_normal", "randint",
    "randint_like", "randperm", "multinomial", "bernoulli", "poisson",
    "exponential_", "uniform_", "normal_",
]


def _key(key, device):
    return next_key(device) if key is None else key


def _float(dtype):
    return get_default_dtype() if dtype is None else convert_dtype(dtype)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, key=None,  # noqa: A002
            name=None):
    device = current_device()
    out = torch.empty(tuple(shape), dtype=_float(dtype), device=device)
    return out.uniform_(min, max, generator=_key(key, device))


def rand(shape, dtype=None, key=None, name=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0, key=key)


def randn(shape, dtype=None, key=None, name=None):
    device = current_device()
    return torch.randn(tuple(shape), dtype=_float(dtype), device=device,
                       generator=_key(key, device))


def normal(mean=0.0, std=1.0, shape=None, key=None, name=None):
    if shape is None:
        shape = tuple(mean.shape) if hasattr(mean, "shape") else ()
    like = mean if isinstance(mean, torch.Tensor) else \
        std if isinstance(std, torch.Tensor) else None
    device = like.device if like is not None else current_device()
    out = torch.randn(tuple(shape), dtype=get_default_dtype(),
                      device=device, generator=_key(key, device))
    return out * std + mean


def standard_normal(shape, dtype=None, key=None, name=None):
    return randn(shape, dtype=dtype, key=key)


def randint(low=0, high=None, shape=(1,), dtype="int64", key=None,
            name=None):
    if high is None:
        low, high = 0, low
    device = current_device()
    return torch.randint(low, high, tuple(shape), dtype=convert_dtype(dtype),
                         device=device, generator=_key(key, device))


def randint_like(x, low=0, high=None, dtype=None, key=None, name=None):
    x = t(x)
    if high is None:
        low, high = 0, low
    dtype = x.dtype if dtype is None else convert_dtype(dtype)
    return torch.randint(low, high, tuple(x.shape), dtype=dtype,
                         device=x.device, generator=_key(key, x.device))


def randperm(n, dtype="int64", key=None, name=None):
    device = current_device()
    return torch.randperm(n, dtype=convert_dtype(dtype), device=device,
                          generator=_key(key, device))


def multinomial(x, num_samples=1, replacement=False, key=None, name=None):
    x = t(x)
    return torch.multinomial(x, num_samples, replacement=replacement,
                             generator=_key(key, x.device))


def bernoulli(x, key=None, name=None):
    x = t(x)
    return torch.bernoulli(x, generator=_key(key, x.device))


def poisson(x, key=None, name=None):
    x = t(x)
    return torch.poisson(x, generator=_key(key, x.device))


def exponential_(x, lam=1.0, key=None, name=None):
    """Exponential draws shaped like ``x`` (a new tensor, as the
    reference's)."""
    x = t(x)
    return torch.empty_like(x).exponential_(lam, generator=_key(key, x.device))


def uniform_(x, min=-1.0, max=1.0, key=None, name=None):  # noqa: A002
    x = t(x)
    return torch.empty_like(x).uniform_(min, max,
                                        generator=_key(key, x.device))


def normal_(x, mean=0.0, std=1.0, key=None, name=None):
    x = t(x)
    return torch.empty_like(x).normal_(mean, std,
                                       generator=_key(key, x.device))

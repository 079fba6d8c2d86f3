"""Eager dygraph: ``Tensor`` with ``.backward()`` and ``.grad`` (port of
``paddle_tpu/eager/__init__.py``).

The JAX package records its own tape: every eager op runs through
``jax.vjp`` and ``backward()`` walks the nodes in reverse, because a
``jax.Array`` has no autograd. Here the tape is torch's autograd graph. A
:class:`Tensor` holds a ``torch.Tensor``; its ``stop_gradient`` is paddle's,
the inverse of ``requires_grad``, and True for data. An op or a layer
called with eager Tensors unwraps them at that boundary, runs on plain
torch tensors (so a model's kernels see what they see under
``TrainStep``) and wraps what comes out; torch records the graph as it
goes. Code that passes no eager Tensor runs as before.

What the reference's tape does, and how the port keeps it:

- ``.grad`` accumulates over ``backward()`` calls on every tensor that
  requires grad, intermediates too (their wrappers ask torch to retain
  it); the roots of a backward get none;
- a hook fires once, with the tensor's whole gradient, and what it returns
  flows on upstream (torch's tensor hooks);
- several roots run in one joint pass (``torch.autograd.backward``);
- :func:`grad` returns gradients without touching ``.grad``;
- strict mode refuses a silent conversion of a tensor that requires grad
  to a numpy array.

Usage::

    import paddle_tpu_torch as paddle
    model = MyNet()
    opt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=model)
    for x, y in loader:
        loss = F.cross_entropy(model(paddle.to_tensor(x)), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
"""
from __future__ import annotations

import functools
import inspect
import weakref
from typing import Any, Callable, Dict

import torch

__all__ = [
    "Tensor", "to_tensor", "enable", "enabled", "no_grad", "grads_of",
    "clear_grads", "apply_op", "run_backward", "grad", "eager_aware",
    "eager_layer_call", "module_step", "PyLayer", "PyLayerContext",
    "saved_tensors_hooks", "set_strict", "strict_enabled",
]

#: ``paddle.no_grad`` for the tape: a context manager and a decorator
no_grad = torch.no_grad

# Strict tape mode (default on): converting a tensor that requires grad to
# a numpy array while the tape records would silently detach it; the guard
# raises instead. Convert deliberately with .detach()/.numpy() or under
# no_grad().
_strict = [True]


def set_strict(flag: bool) -> bool:
    """Toggle the Tensor-to-array leak guard; returns the previous value."""
    prev, _strict[0] = _strict[0], bool(flag)
    return prev


def strict_enabled() -> bool:
    return _strict[0]


def _as_torch(data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data
    from ..ops._common import t

    return t(data)


class Tensor:
    """An eager tensor: a ``torch.Tensor`` under paddle's names.

    ``stop_gradient`` is True for data; an op on a tensor that requires
    grad gives one that requires grad."""

    __slots__ = ("_data", "__weakref__")

    def __init__(self, data, stop_gradient: bool = True):
        data = _as_torch(_unwrap(data))
        if stop_gradient and data.requires_grad:
            data = data.detach()
        elif not stop_gradient and not data.requires_grad:
            data.requires_grad_(True)
        self._data = data

    # ------------------------------------------------------------- basics
    @property
    def stop_gradient(self) -> bool:
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        if value:
            if self._data.is_leaf:
                self._data.requires_grad_(False)
            else:
                self._data = self._data.detach()
        elif not self._data.requires_grad:
            self._data.requires_grad_(True)

    @property
    def grad(self):
        """The accumulated gradient (a ``torch.Tensor``), or None."""
        return self._data.grad

    @grad.setter
    def grad(self, value) -> None:
        self._data.grad = None if value is None else _unwrap(value)

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def size(self):
        return self._data.numel()

    def numpy(self):
        d = self._data.detach().cpu()
        return (d.float() if d.dtype == torch.bfloat16 else d).numpy()

    def item(self):
        return self._data.item()

    def detach(self) -> "Tensor":
        return Tensor(self._data.detach())

    def register_hook(self, hook: Callable):
        """``hook(grad) -> grad | None``, fired once with this tensor's
        whole gradient during a backward; a returned tensor replaces the
        gradient for ``.grad`` and for what flows upstream. Returns a
        handle with ``remove()``."""
        if not self._data.requires_grad:
            raise RuntimeError(
                "cannot register a backward hook on a tensor that stops "
                "gradient (set stop_gradient=False first)")

        def run(g):
            r = hook(Tensor(g))
            return None if r is None else _unwrap(r)

        return self._data.register_hook(run)

    # -- raw-array conversion (strict-mode leak guard) --------------------
    def _guard_convert(self):
        if _strict[0] and torch.is_grad_enabled() and self._data.requires_grad:
            raise RuntimeError(
                "converting a grad-requiring eager Tensor to a raw array "
                "would silently detach it from the autograd tape; call "
                ".detach() / .numpy() explicitly or convert under "
                "eager.no_grad() (or eager.set_strict(False))")

    def __array__(self, dtype=None, copy=None):
        self._guard_convert()
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """numpy ufuncs on Tensors compute in numpy after the leak guard
        and return an ndarray."""
        arrays = []
        for x in inputs:
            if isinstance(x, Tensor):
                x._guard_convert()
                arrays.append(x.numpy())
            else:
                arrays.append(x)
        return getattr(ufunc, method)(*arrays, **kwargs)

    def clone(self) -> "Tensor":
        return apply_op(torch.clone, self)

    def clear_grad(self):
        self._data.grad = None

    # -- in place, refused on a tensor the tape tracks
    def _inplace_guard(self, opname: str):
        if torch.is_grad_enabled() and self._data.requires_grad:
            raise RuntimeError(
                f"{opname} on a grad-requiring tensor would invalidate the "
                "tape; detach() first or run under eager.no_grad()")

    def fill_(self, value) -> "Tensor":
        self._inplace_guard("fill_")
        with torch.no_grad():
            self._data.fill_(value)
        return self

    def zero_(self) -> "Tensor":
        return self.fill_(0)

    def fill_diagonal_(self, value, offset: int = 0,
                       wrap: bool = False) -> "Tensor":
        self._inplace_guard("fill_diagonal_")
        h, w = self._data.shape[-2], self._data.shape[-1]
        if offset >= 0:
            n = max(0, min(h, w - offset))
            r0, c0 = 0, offset
        else:
            n = max(0, min(h + offset, w))
            r0, c0 = -offset, 0
        rows = list(range(r0, r0 + n))
        cols = list(range(c0, c0 + n))
        if wrap and h > w and offset == 0:
            # tall matrices restart the diagonal every w + 1 rows
            r = w + 1
            while r < h:
                k = min(w, h - r)
                rows += list(range(r, r + k))
                cols += list(range(0, k))
                r += w + 1
        if rows:
            dev = self._data.device
            with torch.no_grad():
                self._data[..., torch.tensor(rows, device=dev),
                           torch.tensor(cols, device=dev)] = value
        return self

    def astype(self, dtype) -> "Tensor":
        from ..framework.dtype import convert_dtype

        d = convert_dtype(dtype)
        return apply_op(lambda x: x.to(d), self)

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={self._data.dtype}, "
                f"stop_gradient={self.stop_gradient},\n{self.numpy()})")

    def __len__(self):
        return self._data.shape[0]

    def __float__(self):
        return float(self._data.detach())

    def __int__(self):
        return int(self._data.detach())

    def __bool__(self):
        return bool(self._data)

    # ------------------------------------------------------------ backward
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        """Reverse accumulation from this tensor, seeded with ones (or
        ``grad_tensor``): ``.grad`` gathers on every tensor that requires
        grad except this one."""
        if not self._data.requires_grad:
            raise RuntimeError("backward() on a tensor with no grad history")
        seed = (torch.ones_like(self._data) if grad_tensor is None
                else _as_torch(_unwrap(grad_tensor)).to(self._data.device))
        run_backward([(self, seed)], retain_graph=retain_graph)

    # ---------------------------------------------------------- operators
    def __add__(self, o):
        return apply_op(torch.add, self, o)

    def __radd__(self, o):
        return apply_op(lambda x: o + x, self)

    def __sub__(self, o):
        return apply_op(torch.sub, self, o)

    def __rsub__(self, o):
        return apply_op(lambda x: o - x, self)

    def __mul__(self, o):
        return apply_op(torch.mul, self, o)

    def __rmul__(self, o):
        return apply_op(lambda x: o * x, self)

    def __truediv__(self, o):
        return apply_op(torch.true_divide, self, o)

    def __rtruediv__(self, o):
        return apply_op(lambda x: o / x, self)

    def __matmul__(self, o):
        return apply_op(torch.matmul, self, o)

    def __pow__(self, o):
        return apply_op(torch.pow, self, o)

    def __neg__(self):
        return apply_op(torch.neg, self)

    def __getitem__(self, idx):
        return apply_op(lambda x, i: x[i], self, idx)

    # comparisons give data tensors (no grad)
    def __eq__(self, o):
        return Tensor(self._data == _unwrap(o))

    def __ne__(self, o):
        return Tensor(self._data != _unwrap(o))

    def __lt__(self, o):
        return Tensor(self._data < _unwrap(o))

    def __le__(self, o):
        return Tensor(self._data <= _unwrap(o))

    def __gt__(self, o):
        return Tensor(self._data > _unwrap(o))

    def __ge__(self, o):
        return Tensor(self._data >= _unwrap(o))

    def __hash__(self):
        return id(self)

    # common methods, through the tape
    def reshape(self, shape):
        return apply_op(lambda x: x.reshape(tuple(shape)), self)

    def transpose(self, perm=None):
        return apply_op(lambda x: x.permute(
            tuple(range(x.ndim))[::-1] if perm is None else tuple(perm)),
            self)

    def flatten(self, start_axis=0, stop_axis=-1):
        from .. import ops

        return apply_op(ops.manipulation.flatten, self, start_axis,
                        stop_axis)

    def sum(self, axis=None, keepdim=False):
        from .. import ops

        return apply_op(ops.math.sum, self, axis, keepdim=keepdim)

    def mean(self, axis=None, keepdim=False):
        from .. import ops

        return apply_op(ops.math.mean, self, axis, keepdim)

    def max(self, axis=None, keepdim=False):
        from .. import ops

        return apply_op(ops.math.max, self, axis, keepdim)

    def min(self, axis=None, keepdim=False):
        from .. import ops

        return apply_op(ops.math.min, self, axis, keepdim)

    def matmul(self, other):
        return self.__matmul__(other)

    def __getattr__(self, name):
        # any other method: the op of that name, through the tape
        if name.startswith("_"):
            raise AttributeError(name)
        from .. import ops

        fn = getattr(ops, name, None)
        if fn is None or not callable(fn) or inspect.ismodule(fn):
            raise AttributeError(name)

        def method(*args, **kwargs):
            return apply_op(fn, self, *args, **kwargs)

        return method


def _unwrap(x):
    return x._data if isinstance(x, Tensor) else x


def _unwrap_tree(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_unwrap_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: _unwrap_tree(v) for k, v in x.items()}
    return x


# the intermediates whose .grad torch keeps (for grad() to restore it)
_retained: "weakref.WeakSet[torch.Tensor]" = weakref.WeakSet()


def _wrap(t: torch.Tensor) -> Tensor:
    out = Tensor.__new__(Tensor)
    out._data = t
    if t.requires_grad and not t.is_leaf:
        t.retain_grad()  # the reference's tape gives intermediates .grad
        _retained.add(t)
    return out


def _wrap_tree(x):
    if isinstance(x, torch.Tensor):
        return _wrap(x)
    if isinstance(x, (list, tuple)):
        items = [_wrap_tree(v) for v in x]
        return type(x)(items) if not hasattr(x, "_fields") else tuple(items)
    if isinstance(x, dict):
        return {k: _wrap_tree(v) for k, v in x.items()}
    return x


def _has_tensor(args, kwargs) -> bool:
    for a in (*args, *kwargs.values()):
        if isinstance(a, Tensor):
            return True
        if isinstance(a, (list, tuple)) and any(isinstance(b, Tensor)
                                                for b in a):
            return True
    return False


def to_tensor(data, dtype=None, stop_gradient: bool = True) -> Tensor:
    """An eager Tensor of ``data`` (kept on its device when it is a
    tensor, else on the current device)."""
    from ..framework.dtype import convert_dtype

    arr = _as_torch(_unwrap(data))
    if dtype is not None:
        arr = arr.to(convert_dtype(dtype))
    return Tensor(arr, stop_gradient=stop_gradient)


def apply_op(fn: Callable, *args, **kwargs) -> Any:
    """``fn`` on the torch tensors inside ``args`` and ``kwargs`` (eager
    Tensors unwrapped, nested lists and tuples too); the result's tensors
    come back as eager Tensors. Torch records the graph."""
    out = fn(*_unwrap_tree(args), **_unwrap_tree(kwargs))
    return _wrap_tree(out)


def eager_aware(fn: Callable) -> Callable:
    """``fn`` made to take eager Tensors (through :func:`apply_op`); a call
    without one runs ``fn`` itself."""
    if getattr(fn, "__eager_wrapped__", False):
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _has_tensor(args, kwargs):
            return apply_op(fn, *args, **kwargs)
        return fn(*args, **kwargs)

    wrapped.__eager_wrapped__ = True
    return wrapped


def _roots(roots_and_seeds):
    tensors, seeds = [], []
    for t, seed in roots_and_seeds:
        tensors.append(t._data)
        seeds.append(_as_torch(_unwrap(seed)).to(t._data.device))
    return tensors, seeds


def run_backward(roots_and_seeds, retain_graph: bool = False) -> None:
    """One joint reverse pass from several ``(root, seed)`` pairs: a
    tensor reached from several roots gets its whole gradient before its
    hooks fire. The roots get no ``.grad`` of their own."""
    tensors, seeds = _roots(roots_and_seeds)
    before = [t.grad for t in tensors]
    torch.autograd.backward(tensors, seeds, retain_graph=retain_graph)
    for t, g in zip(tensors, before):
        t.grad = g


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """Gradients of ``outputs`` with respect to ``inputs``, as a list,
    without touching any ``.grad`` (``paddle.grad``). A non-leaf input
    gets its whole gradient; an input that no output reaches raises
    unless ``allow_unused``, which gives None for it."""
    if create_graph:
        raise NotImplementedError(
            "create_graph=True is not supported on the eager tape; use the "
            "functional autodiff in paddle_tpu.incubate.autograd "
            "(jvp/vjp/Hessian) for higher-order gradients")
    if not only_inputs:
        raise NotImplementedError(
            "only_inputs=False is deprecated in the reference and "
            "unsupported here")
    if no_grad_vars is not None:
        raise NotImplementedError(
            "no_grad_vars is unsupported; mark tensors stop_gradient "
            "before building the graph instead")
    outputs = [outputs] if isinstance(outputs, Tensor) else list(outputs)
    inputs = [inputs] if isinstance(inputs, Tensor) else list(inputs)
    for t in outputs + inputs:
        if not isinstance(t, Tensor):
            raise TypeError("grad() outputs/inputs must be eager Tensors")
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    grad_outputs = list(grad_outputs)
    if len(grad_outputs) != len(outputs):
        raise ValueError("grad_outputs must match outputs in length")
    tensors, seeds = _roots(
        (t, torch.ones_like(t._data) if g is None else g)
        for t, g in zip(outputs, grad_outputs))
    # an output differentiated with respect to itself gets its seed
    # (through the input's hooks), as the reference gives it
    ident = {}
    for i, t in enumerate(inputs):
        for o, s in zip(tensors, seeds):
            if o is t._data:
                ident[i] = s if i not in ident else ident[i] + s
    wanted = [i for i, t in enumerate(inputs)
              if t._data.requires_grad and i not in ident]
    found = {}
    if wanted:
        # torch fills the retained .grad of intermediates here too; the
        # reference's grad() leaves every .grad as it was
        kept = [(t, t.grad) for t in list(_retained)]
        got = torch.autograd.grad(
            tensors, [inputs[i]._data for i in wanted], seeds,
            retain_graph=bool(retain_graph), allow_unused=True)
        for t, g in kept:
            t.grad = g
        found = dict(zip(wanted, got))
    results = []
    for i, t in enumerate(inputs):
        g = found.get(i)
        if i in ident:
            g = ident[i] if g is None else g + ident[i]
            hooks = t._data._backward_hooks or {}
            for h in hooks.values():
                r = h(g)
                g = g if r is None else r
        if g is None and not allow_unused:
            raise RuntimeError(
                "one of the inputs is unreachable from outputs; pass "
                "allow_unused=True to get None for it")
        results.append(None if g is None else Tensor(g))
    return results


# --------------------------------------------------------- layer integration
def eager_layer_call(module: torch.nn.Module, *args, **kwargs):
    """Call any ``torch.nn.Module`` with eager Tensors: they are unwrapped,
    the module runs on torch tensors (its parameters and in-place buffer
    updates as in any call) and its outputs come back wrapped."""
    return _wrap_tree(module(*_unwrap_tree(args), **_unwrap_tree(kwargs)))


def grads_of(layer: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Accumulated gradients of a module's parameters (name -> tensor)."""
    return {k: p.grad for k, p in layer.named_parameters()
            if p.grad is not None}


def clear_grads(layer: torch.nn.Module) -> None:
    for p in layer.parameters():
        p.grad = None


def module_step(opt, model: torch.nn.Module):
    """The stateful ``opt.step()`` over a bound module: every parameter
    updates from its ``.grad`` (zeros where it has none, so that decoupled
    weight decay still reaches it), through the optimizer's master weights
    under O2 as ``TrainStep`` updates them; then the gradients are
    cleared. Returns the parameters."""
    params = dict(model.named_parameters())
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in params.items()}
    if opt._state is None:
        opt._state = opt.init(params)
    opt.update(grads, opt._state, params)
    clear_grads(model)
    return params


# --------------------------------------------------------------- dispatch
_enabled = [False]


def enabled() -> bool:
    return _enabled[0]


def enable():
    """Make ``nn.functional`` take eager Tensors. Idempotent. The ops take
    them already, layers too (``nn.Layer.__call__``, or
    :func:`eager_layer_call` for any module), and ``Optimizer.step()``
    over a bound module reads ``.grad``; code that passes no eager Tensor
    runs as before."""
    if _enabled[0]:
        return
    from ..nn import functional as F

    _wrap_module(F)
    _enabled[0] = True


def _wrap_module(mod):
    """Each public function of ``mod`` made :func:`eager_aware`."""
    for name in getattr(mod, "__all__", dir(mod)):
        fn = getattr(mod, name, None)
        if name.startswith("_") or not inspect.isfunction(fn):
            continue
        setattr(mod, name, eager_aware(fn))


from .py_layer import (PyLayer, PyLayerContext,  # noqa: E402
                       saved_tensors_hooks)

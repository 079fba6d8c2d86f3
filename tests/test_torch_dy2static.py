"""dy2static in the port (``paddle_tpu_torch.jit.dy2static``) against the
JAX package's, on the CPU: each of ``tests/test_dy2static.py``'s 61 cases
is one case of :func:`test_case`, run through both packages' ``to_static``
/ ``convert_control_flow`` on the same inputs. A case is written once over
a backend (``JAX`` or ``TORCH``: the package's converter and the array
functions the case calls); the JAX side compiles where the reference test
does (``jax.jit``), the port runs eagerly, where a tensor predicate is
concrete and plain Python decides. Each side keeps the reference test's
own assertions, and the two sides' results must agree (f32 rtol 1e-6, or
exactly for Python values).

Then the capture cases: a tensor-dependent ``if``, an unbounded ``while``
and a bounded ``while`` under ``jit.save``, whose reloaded programs take
both branches (and different trip counts) correctly on fresh inputs; the
bounded loop differentiated by autograd as capture lowers it; and the
twin of ``tests/test_namespace_longtail.py``'s translator controls.
"""
import functools
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.jit import TrainStep as JTrainStep
from paddle_tpu.jit import not_to_static as j_not_to_static
from paddle_tpu.jit import to_static as j_to_static
from paddle_tpu.jit.dy2static import convert_control_flow as j_convert
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu.optimizer import AdamW as JAdamW

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.framework.jit import TrainStep as TTrainStep
from paddle_tpu_torch.jit import dy2static as tdy
from paddle_tpu_torch.jit import not_to_static as t_not_to_static
from paddle_tpu_torch.jit import to_static as t_to_static
from paddle_tpu_torch.jit.dy2static import convert_control_flow as t_convert
from paddle_tpu_torch.optimizer import SGD as TSGD
from paddle_tpu_torch.optimizer import AdamW as TAdamW


class _Backend:
    """What a case needs of a package: its converter, its array functions
    and its way of compiling (the port runs eagerly)."""

    def __init__(self, name, **fns):
        self.name = name
        self.__dict__.update(fns)


JAX = _Backend(
    "jax", to_static=j_to_static, convert=j_convert,
    not_to_static=j_not_to_static, nn=jnn, F=JF, TrainStep=JTrainStep,
    SGD=JSGD, AdamW=JAdamW, compile=jax.jit,
    sum=jnp.sum, mean=jnp.mean, max=jnp.max, sqrt=jnp.sqrt,
    norm=jnp.linalg.norm, zeros_like=jnp.zeros_like, abs=jnp.abs,
    zeros=lambda shape=(), dtype=None: jnp.zeros(shape, dtype or jnp.float32),
    ones=lambda shape, dtype=None: jnp.ones(shape, dtype or jnp.float32),
    asarray=lambda x, dtype=None: jnp.asarray(x, dtype), int32=jnp.int32,
    grad=lambda f, x: jax.grad(f)(x), seed=jpt.seed,
    tensor=lambda x: jnp.asarray(x))


def _torch_grad(f, x):
    x = x.clone().requires_grad_(True)
    f(x).backward()
    return x.grad


TORCH = _Backend(
    "torch", to_static=t_to_static, convert=t_convert,
    not_to_static=t_not_to_static, nn=tnn, F=TF, TrainStep=TTrainStep,
    SGD=TSGD, AdamW=TAdamW, compile=lambda f, **kw: f,
    sum=torch.sum, mean=torch.mean, max=torch.max, sqrt=torch.sqrt,
    norm=torch.linalg.norm, zeros_like=torch.zeros_like, abs=torch.abs,
    zeros=lambda shape=(), dtype=None: torch.zeros(shape,
                                                   dtype=dtype or torch.float32),
    ones=lambda shape, dtype=None: torch.ones(shape,
                                              dtype=dtype or torch.float32),
    asarray=lambda x, dtype=None: torch.as_tensor(x, dtype=dtype),
    int32=torch.int32, grad=_torch_grad, seed=None,
    tensor=lambda x: torch.as_tensor(np.asarray(x)))


def _n(x):
    """A result as numpy (tensors, arrays, numbers; tuples element-wise)."""
    if isinstance(x, (tuple, list)):
        return [_n(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


CASES = {}


class _Trajectory(list):
    """Losses of a training run: the two packages' float32 steps agree to
    rtol 1e-4 (optimizer arithmetic in another order), not 1e-6."""


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _layer_pair(B, make):
    """The reference's layer and, for the port, a twin carrying its
    weights: ``make(backend)`` builds the layer in a package."""
    jpt.seed(0)
    jm = make(JAX)
    if B is JAX:
        return jm
    return layer_from_jax(make(TORCH), {k: np.asarray(v)
                                        for k, v in jm.state_dict().items()})


# ------------------------------------------------------------ the cases
@case
def tensor_if_under_jit(B):
    def f(x):
        if B.mean(x) > 0:
            out = x * 2.0
        else:
            out = x - 1.0
        return out

    g = B.to_static(f)
    out = [_n(g(B.tensor([1.0, 2.0]))), _n(g(B.tensor([-1.0, -2.0])))]
    np.testing.assert_allclose(out[0], [2.0, 4.0])
    np.testing.assert_allclose(out[1], [-2.0, -3.0])
    return out


@case
def if_defined_only_in_branches(B):
    def f(x):
        if B.sum(x) > 0:
            y = x + 1.0
        else:
            y = x - 1.0
        return y

    g = B.to_static(f)
    out = [_n(g(B.tensor([2.0]))), _n(g(B.tensor([-2.0])))]
    np.testing.assert_allclose(out, [[3.0], [-3.0]])
    return out


@case
def tensor_while_under_jit(B):
    def f(x):
        while B.sum(x) < 100.0:
            x = x * 2.0
        return x

    out = _n(B.to_static(f)(B.tensor([1.0, 1.0])))
    assert 100.0 <= out.sum() < 200.0
    return out


@case
def tensor_for_range_under_jit(B):
    def f(n, x):
        for i in range(n):
            x = x + B.asarray(i, x.dtype)
        return x

    g = B.to_static(f)
    out = float(g(B.asarray(4), B.zeros()))
    assert out == 0 + 1 + 2 + 3
    assert float(g(3, B.zeros())) == 3.0
    return out


@case
def for_over_tensor_rows_scan(B):
    def f(xs):
        acc = B.zeros(xs.shape[1:], xs.dtype)
        for row in xs:
            acc = acc + row
        return acc

    xs = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = _n(B.to_static(f)(B.tensor(xs)))
    np.testing.assert_allclose(out, xs.sum(0))
    return out


@case
def nested_if_in_while(B):
    def f(x):
        steps = B.zeros((), B.int32)
        while B.sum(x) < 50.0:
            if B.max(x) > 4.0:
                x = x + 10.0
            else:
                x = x * 2.0
            steps = steps + 1
        return x, steps

    x, steps = B.to_static(f)(B.tensor([1.0]))
    assert float(B.sum(x)) >= 50.0 and int(steps) > 0
    return _n((x, steps))


@case
def eager_semantics_preserved(B):
    def f(x, flag):
        if flag:
            y = x + 1
        else:
            y = x - 1
        total = 0
        for i in range(3):
            total = total + i
        while total < 10:
            total = total + 2
        return y, total

    g = B.convert(f)
    assert g.__d2s_converted__
    assert g(5, True) == (6, 11) and g(5, False) == (4, 11)
    assert f(5, True) == g(5, True)
    return [g(5, True), g(5, False)]


@case
def closure_and_globals_survive(B):
    scale = 3.0

    def f(x):
        if B.sum(x) > 0:
            y = x * scale  # closure read
        else:
            y = x / scale
        return y

    out = _n(B.to_static(f)(B.tensor([2.0])))
    np.testing.assert_allclose(out, [6.0])
    return out


@case
def undef_branch_poisons_loudly(B):
    def f(x):
        if B.sum(x) > 0:
            y = x * 2.0
        return y

    g = B.convert(f)
    out = _n(g(B.tensor([1.0])))
    np.testing.assert_allclose(out, [2.0])
    with pytest.raises(RuntimeError, match="not defined on every path"):
        np.asarray(g(B.tensor([-1.0]))) * 1.0
    return out


@case
def escape_statements_keep_python_semantics(B):
    def f(x, n):
        if n > 2:
            return x * 10
        total = x
        for i in range(10):
            if i >= n:
                break
            total = total + 1
        return total

    g = B.convert(f)
    assert g(1, 5) == 10 and g(1, 2) == 3
    return [g(1, 5), g(1, 2)]


@case
def foreign_decorator_skips_conversion(B):
    def doubler(fn):
        @functools.wraps(fn)
        def inner(*a):
            return fn(*a) * 2
        return inner

    @doubler
    def f(x):
        if x > 0:
            y = x
        else:
            y = -x
        return y

    assert B.convert(f) is f
    assert f(4) == 8
    return f(4)


@case
def generator_skips_conversion(B):
    def gen(xs, flag):
        if flag:
            yield 1
        for x in xs:
            yield x

    assert B.convert(gen) is gen
    return list(gen([10], True))


@case
def def_and_import_inside_branch(B):
    def f(x, flag):
        if flag:
            def act(v):
                return v * 2
        else:
            def act(v):
                return v
        return act(x)

    g = B.convert(f)
    assert g(3, True) == 6 and g(3, False) == 3

    def h(flag):
        if flag:
            import math as m
        else:
            import cmath as m
        return m.sqrt(4)

    assert B.convert(h)(True) == 2.0
    return [g(3, True), g(3, False), B.convert(h)(True)]


@case
def del_inside_branch(B):
    def f(x, flag):
        if flag:
            tmp = x * 2
            y = tmp
            del tmp
        else:
            y = x
        return y

    g = B.convert(f)
    assert g(5, True) == 10 and g(5, False) == 5
    return [g(5, True), g(5, False)]


@case
def super_method_skips_conversion(B):
    class Base:
        def run(self, x):
            return x + 1

    class Sub(Base):
        def run(self, x):
            if x > 0:
                y = super().run(x)
            else:
                y = x
            return y

    assert B.convert(Sub.run) is Sub.run
    assert Sub().run(3) == 4
    return Sub().run(3)


@case
def walrus_in_while_test_skips_conversion(B):
    def f(xs):
        it = iter(xs)
        total = 0
        while (v := next(it)) > 0:
            total = total + v
        return total

    out = B.convert(f)([3, 5, -1])
    assert out == 8
    return out


@case
def not_to_static_marker(B):
    @B.not_to_static
    def f(x):
        if B.sum(x) > 0:
            y = x
        else:
            y = -x
        return y

    assert B.convert(f) is f
    return _n(f(B.tensor([-2.0])))


def _dyn_net(K):
    nn = K.nn

    class DynNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin_a = nn.Linear(4, 4)
            self.lin_b = nn.Linear(4, 4)

        def forward(self, x):
            if K.mean(x) > 0:
                out = self.lin_a(x)
            else:
                out = self.lin_b(x)
            return out

    return DynNet()


@case
def layer_with_dynamic_forward(B):
    net = _layer_pair(B, _dyn_net)
    x = np.random.default_rng(0).normal(size=(2, 4)).astype(np.float32)
    pos, neg = B.tensor(np.abs(x)), B.tensor(-np.abs(x) - 1.0)
    ref_pos, ref_neg = _n(net.lin_a(pos)), _n(net.lin_b(neg))
    g = B.to_static(net)
    out = [_n(g(pos)), _n(g(neg))]
    np.testing.assert_allclose(out[0], ref_pos, rtol=1e-5)
    np.testing.assert_allclose(out[1], ref_neg, rtol=1e-5)
    return out


@case
def loop_bound_makes_while_differentiable(B):
    def f(x):
        while B.sum(x) < 10.0:
            x = x * 2.0
        return B.sum(x)

    x0 = B.tensor(np.asarray([1.0, 0.5], np.float32))
    ref = float(B.to_static(f)(x0))
    assert float(B.to_static(f, loop_bound=16)(x0)) == ref
    grad = _n(B.grad(B.convert(f, loop_bound=16), x0))
    np.testing.assert_allclose(grad, [8.0, 8.0], rtol=1e-6)
    return [ref, grad]


@case
def loop_bound_double_where_grad_is_finite(B):
    def f(x):
        while B.sum(x) > 2.0:
            x = x * B.sqrt(B.sum(x) - 2.0) * 0.1
        return B.sum(x)

    g = B.convert(f, loop_bound=8)
    x0 = B.tensor(np.asarray([3.0, 1.5], np.float32))
    val = float(g(x0))
    grad = _n(B.grad(g, x0))
    assert np.isfinite(val) and np.isfinite(grad).all()
    return [val, grad]


def _halver(K):
    nn = K.nn

    class Halver(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)
            while K.norm(h) > 2.0:
                h = h * 0.5
            return h

    return Halver()


@case
def loop_bound_trains_while_model(B):
    net = _layer_pair(B, _halver)
    B.to_static(net, loop_bound=12)
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32) * 4
    y = np.tanh(x)
    step = B.TrainStep(net, B.SGD(learning_rate=0.05),
                       loss_fn=lambda out, b: ((out - B.tensor(b[1])) ** 2
                                               ).mean())
    losses = [float(_n(step((x, y)))) for _ in range(30)]
    assert losses[-1] < losses[0], losses
    return _Trajectory(losses)


def _clip_rnn(K):
    nn = K.nn

    class ClipRNN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.cell = nn.Linear(8, 8)

        def forward(self, x):
            h = x
            n = K.zeros((), K.int32)
            while K.norm(h) < 10.0:
                h = self.cell(h) + h
                n = n + 1
            return h, n

    return ClipRNN()


@case
def dynamic_rnn_style_model(B):
    net = _layer_pair(B, _clip_rnn)
    h, n = B.to_static(net)(B.tensor(np.full((8,), 0.1, np.float32)))
    assert float(np.linalg.norm(_n(h))) >= 10.0 and int(n) >= 1
    return _n((h, n))


@case
def return_in_both_branches_converts(B):
    def f(x):
        if B.mean(x) > 0:
            return x * 2.0
        else:
            return x - 1.0

    g = B.compile(B.to_static(f))
    out = [_n(g(B.tensor([1.0, 2.0]))), _n(g(B.tensor([-1.0, -2.0])))]
    np.testing.assert_allclose(out, [[2.0, 4.0], [-2.0, -3.0]])
    return out


@case
def guard_clause_return_converts(B):
    def f(x):
        if B.sum(x) > 10.0:
            return x * 0.0
        y = x + 1.0
        y = y * 2.0
        return y

    g = B.compile(B.to_static(f))
    out = [_n(g(B.tensor([20.0]))), _n(g(B.tensor([1.0])))]
    np.testing.assert_allclose(out, [[0.0], [4.0]])
    return out


@case
def elif_chain_returns_convert(B):
    def f(x):
        s = B.sum(x)
        if s > 10.0:
            return x * 3.0
        elif s > 0.0:
            return x * 2.0
        else:
            return -x

    g = B.compile(B.to_static(f))
    out = [_n(g(B.tensor([v]))) for v in (20.0, 2.0, -2.0)]
    np.testing.assert_allclose(out, [[60.0], [4.0], [2.0]])
    return out


@case
def bare_and_implicit_none_returns_match_python(B):
    def f(x, flag):
        if flag:
            return x + 1.0

    g = B.convert(f)
    assert g.__d2s_converted__
    out = _n(g(B.tensor([1.0]), True))
    np.testing.assert_allclose(out, [2.0])
    assert g(B.tensor([1.0]), False) is None
    return out


@case
def return_inside_loop_stays_python(B):
    def f(xs):
        for i in range(3):
            if i == 2:
                return xs + i
        return xs

    out = _n(B.to_static(f)(B.tensor([1.0])))
    np.testing.assert_allclose(out, [3.0])
    return out


@case
def mixed_assignment_and_return_branch(B):
    def f(x):
        if B.sum(x) < 0:
            return B.zeros_like(x)
        else:
            y = x * 3.0
        return y + 1.0

    g = B.compile(B.to_static(f))
    out = [_n(g(B.tensor([-1.0]))), _n(g(B.tensor([2.0])))]
    np.testing.assert_allclose(out, [[0.0], [7.0]])
    return out


@case
def augassign_keeps_branch_result_live(B):
    def f(x):
        if x > 0:
            y = x
        else:
            y = -x
        y += 1.0
        return x * 2.0

    g = B.convert(f)
    assert g(2.0) == 4.0 and g(-2.0) == -4.0
    return [g(2.0), g(-2.0)]


@case
def closure_defined_before_if_keeps_name_live(B):
    def f(x, cond):
        def g():
            return y

        if cond:
            y = x * 2
        else:
            y = x
        return g()

    h = B.convert(f)
    assert h(3.0, True) == 6.0 and h(3.0, False) == 3.0
    return [h(3.0, True), h(3.0, False)]


@case
def loop_else_reads_keep_inner_if_results(B):
    def f(items, cond):
        for i in items:
            if cond:
                y = i
            else:
                y = -i
        else:
            out = y + 1
        return out

    g = B.convert(f)
    assert g([1.0, 2.0], True) == 3.0 and g([1.0, 2.0], False) == -1.0

    def fw(n, cond):
        i = 0
        while i < n:
            if cond:
                y = i
            else:
                y = -i
            i += 1
        else:
            out = y + 10
        return out

    gw = B.convert(fw)
    assert gw(3, True) == 12 and gw(3, False) == 8
    return [g([1.0, 2.0], True), gw(3, False)]


@case
def match_case_bodies_still_convert(B):
    def f(x, tag):
        match tag:
            case "double":
                if B.sum(x) > 0:
                    y = x * 2.0
                else:
                    y = x - 1.0
            case _:
                y = x
        return y

    g = B.convert(f)
    assert g.__d2s_converted__
    out = [_n(B.compile(g, static_argnums=1)(B.tensor([1.0]), "double")),
           _n(g(B.tensor([-1.0]), "double")), _n(g(B.tensor([5.0]), "other"))]
    np.testing.assert_allclose(out, [[2.0], [-2.0], [5.0]])
    return out


def _ref_break_while(x):
    s = np.asarray(x, np.float32)
    i = 0.0
    while i < 8.0:
        s = s * np.float32(1.5)
        if s.sum() > 40.0:
            break
        i = i + 1.0
    return s, i


@case
def tensor_break_in_while_converts(B):
    def f(x):
        s = x
        i = B.zeros(())
        while i < 8.0:
            s = s * 1.5
            if B.sum(s) > 40.0:
                break
            i = i + 1.0
        return s, i

    g = B.compile(B.to_static(f))
    out = []
    for start in ([4.0, 4.0], [0.1, 0.1]):
        s_ref, i_ref = _ref_break_while(start)
        s_got, i_got = g(B.tensor(np.asarray(start, np.float32)))
        np.testing.assert_allclose(_n(s_got), s_ref, rtol=1e-6)
        assert float(i_got) == i_ref
        out.append(_n((s_got, i_got)))
    return out


@case
def tensor_continue_in_while_converts(B):
    def f(x):
        total = B.zeros(())
        i = B.zeros(())
        while i < 6.0:
            i = i + 1.0
            if B.sum(x) * i % 2.0 < 1.0:
                continue
            total = total + i
        return total

    def ref(xsum):
        total, i = 0.0, 0.0
        while i < 6.0:
            i += 1.0
            if xsum * i % 2.0 < 1.0:
                continue
            total += i
        return total

    g = B.compile(B.to_static(f))
    out = [float(g(B.tensor([1.0]))), float(g(B.tensor([0.5])))]
    assert out == [ref(1.0), ref(0.5)]
    return out


@case
def general_escape_shapes_keep_python_semantics(B):
    def f(x, n):
        total = x
        i = 0
        while True:
            if i >= n:
                total = total + 100
                break
            total = total + 1
            i += 1
        return total

    assert B.convert(f)(1, 3) == 104

    def fe(n):
        i = 0
        while i < 5:
            if i == 2:
                break
            i += 1
        else:
            i = 100
        return i

    ge = B.convert(fe)
    assert ge(3) == 2 == fe(3) and ge(1) == 2 == fe(1)

    def fne(n):
        i = 0
        while i < n:
            i += 1
        else:
            i = i + 1000
        return i

    gne = B.convert(fne)
    assert gne(3) == 1003 == fne(3) and gne(0) == 1000 == fne(0)

    def fw(vals):
        s = 0
        k = 0
        while (v := vals[k]) > 0:
            if v > 100:
                break
            s += v
            k += 1
        return s

    gw = B.convert(fw)
    assert gw([1, 2, 3, -1]) == 6 == fw([1, 2, 3, -1])
    assert gw([1, 2, 500, -1]) == 3 == fw([1, 2, 500, -1])
    return [B.convert(f)(1, 3), ge(3), gne(3), gw([1, 2, 3, -1])]


@case
def break_with_statements_converts_under_jit(B):
    def f(x):
        s = x
        i = B.zeros(())
        while i < 8.0:
            if B.sum(s) > 40.0:
                s = s - 5.0
                break
            else:
                s = s * 1.5
            i = i + 1.0
        return s, i

    def ref(x):
        s = np.asarray(x, np.float32)
        i = 0.0
        while i < 8.0:
            if s.sum() > 40.0:
                s = s - np.float32(5.0)
                break
            else:
                s = s * np.float32(1.5)
            i = i + 1.0
        return s, i

    g = B.compile(B.to_static(f))
    out = []
    for start in ([4.0, 4.0], [30.0, 30.0], [0.1, 0.1]):
        s_ref, i_ref = ref(start)
        s_got, i_got = g(B.tensor(np.asarray(start, np.float32)))
        np.testing.assert_allclose(_n(s_got), s_ref, rtol=1e-6)
        assert float(i_got) == i_ref
        out.append(_n((s_got, i_got)))
    return out


@case
def break_under_else_converts_under_jit(B):
    def f(x):
        s = x
        i = B.zeros(())
        while i < 6.0:
            if B.sum(s) < 100.0:
                s = s * 2.0
            else:
                break
            i = i + 1.0
        return s, i

    def ref(x):
        s = np.asarray(x, np.float32)
        i = 0.0
        while i < 6.0:
            if s.sum() < 100.0:
                s = s * np.float32(2.0)
            else:
                break
            i = i + 1.0
        return s, i

    g = B.compile(B.to_static(f))
    out = []
    for start in ([3.0, 3.0], [60.0, 60.0]):
        s_ref, i_ref = ref(start)
        s_got, i_got = g(B.tensor(np.asarray(start, np.float32)))
        np.testing.assert_allclose(_n(s_got), s_ref, rtol=1e-6)
        assert float(i_got) == i_ref
        out.append(_n((s_got, i_got)))
    return out


@case
def while_else_with_tensor_break_converts_under_jit(B):
    def f(x):
        s = x
        i = B.zeros(())
        while i < 4.0:
            s = s * 2.0
            if B.sum(s) > 50.0:
                break
            i = i + 1.0
        else:
            s = s + 1000.0
        return s

    def ref(x):
        s = np.asarray(x, np.float32)
        i = 0.0
        while i < 4.0:
            s = s * np.float32(2.0)
            if s.sum() > 50.0:
                break
            i = i + 1.0
        else:
            s = s + np.float32(1000.0)
        return s

    g = B.compile(B.to_static(f))
    out = []
    for start in ([20.0, 20.0], [0.5, 0.5]):
        got = _n(g(B.tensor(np.asarray(start, np.float32))))
        np.testing.assert_allclose(got, ref(start), rtol=1e-6)
        out.append(got)
    return out


@case
def for_range_else_with_tensor_break_converts(B):
    def f(x):
        found = B.zeros(())
        for i in range(5):
            if x[i] > 10.0:
                found = B.zeros(()) + i
                break
        else:
            found = B.asarray(-1.0)
        return found

    def ref(x):
        for i in range(5):
            if x[i] > 10.0:
                return float(i)
        return -1.0

    g = B.compile(B.to_static(f))
    hit = np.asarray([1.0, 2.0, 50.0, 3.0, 4.0], np.float32)
    miss = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    out = [float(g(B.tensor(hit))), float(g(B.tensor(miss)))]
    assert out == [ref(hit), ref(miss)]
    return out


@case
def mixed_break_continue_nested_ifs_convert(B):
    def f(x):
        total = B.zeros(())
        i = B.zeros(())
        while i < 10.0:
            i = i + 1.0
            v = B.sum(x) * i
            if v % 3.0 < 1.0:
                continue
            elif v > 20.0:
                total = total + 100.0
                break
            total = total + v
        return total, i

    def ref(xsum):
        total, i = 0.0, 0.0
        while i < 10.0:
            i += 1.0
            v = xsum * i
            if v % 3.0 < 1.0:
                continue
            elif v > 20.0:
                total += 100.0
                break
            total += v
        return total, i

    g = B.compile(B.to_static(f))
    out = []
    for xv in (1.0, 2.5, 0.3):
        t_ref, i_ref = ref(xv)
        t_got, i_got = g(B.tensor(np.asarray([xv], np.float32)))
        np.testing.assert_allclose(float(t_got), t_ref, rtol=1e-6)
        assert float(i_got) == i_ref
        out.append([float(t_got), float(i_got)])
    return out


@case
def escape_inside_try_stays_python(B):
    def f(vals):
        s = 0
        i = 0
        while i < len(vals):
            try:
                if vals[i] < 0:
                    break
                s += vals[i]
            finally:
                i += 1
        return s

    g = B.convert(f)
    assert g([1, 2, -1, 5]) == 3 == f([1, 2, -1, 5])
    assert g([1, 2, 3]) == 6 == f([1, 2, 3])
    return [g([1, 2, -1, 5]), g([1, 2, 3])]


@case
def break_mid_loop_concrete_matches_python(B):
    tests = []

    def f(xs):
        i = 0
        out = []
        while tests.append(i) or i < len(xs):
            if xs[i] < 0:
                break
            out.append(xs[i])
            i += 1
        return out

    g = B.convert(f)
    tests.clear()
    assert g([1, 2, -1, 4]) == [1, 2]
    n_evals = len(tests)
    tests.clear()
    assert f([1, 2, -1, 4]) == [1, 2]
    assert n_evals == len(tests)
    return n_evals


@case
def for_range_with_tensor_break_converts(B):
    def f(x):
        h = x
        steps = B.zeros(())
        for i in range(10):
            h = h * 1.4
            if B.sum(h) > 30.0:
                break
            steps = steps + 1.0
        return h, steps

    def ref(x):
        h = np.asarray(x, np.float32)
        steps = 0.0
        for i in range(10):
            h = h * np.float32(1.4)
            if h.sum() > 30.0:
                break
            steps += 1.0
        return h, steps

    g = B.compile(B.to_static(f))
    out = []
    for start in ([2.0, 2.0], [0.01, 0.01]):
        h_ref, s_ref = ref(start)
        h_got, s_got = g(B.tensor(np.asarray(start, np.float32)))
        np.testing.assert_allclose(_n(h_got), h_ref, rtol=1e-5)
        assert float(s_got) == s_ref
        out.append(_n((h_got, s_got)))
    return out


@case
def for_range_with_continue_and_step(B):
    def f(vals):
        total = 0
        for i in range(8, 0, -2):
            if vals[i % len(vals)] < 0:
                continue
            total = total + i
        return total, i

    g = B.convert(f)
    out = []
    for vals in ([1, -1, 1], [1, 1, 1], [-1, -1, -1]):
        assert g(vals) == f(vals)
        out.append(g(vals))
    return out


@case
def for_range_break_keeps_loop_var_semantics(B):
    def f(n, lim):
        acc = 0
        for i in range(n):
            if acc >= lim:
                break
            acc += i
        return acc, i

    g = B.convert(f)
    assert g(10, 6) == f(10, 6) and g(10, 1000) == f(10, 1000)
    return [g(10, 6), g(10, 1000)]


@case
def for_range_arg_eval_order_and_side_effects(B):
    def f(it):
        total = 0
        for i in range(next(it), next(it), -1):
            if total > 1000:
                break
            total = total + i
        return total

    out = B.convert(f)(iter([10, 3, 7]))
    assert out == f(iter([10, 3, 7])) == 10 + 9 + 8 + 7 + 6 + 5 + 4
    return out


@case
def nested_break_does_not_rewrite_outer_for(B):
    def f(n, x):
        total = B.zeros(())
        for i in range(n):
            j = 0
            while j < 5:
                total = total + x
                j += 1
                if j >= 5:
                    break
        return total

    out = float(B.to_static(f, loop_bound=3)(B.asarray(20), B.asarray(1.0)))
    assert out == 100.0
    return out


@case
def starred_range_args_stay_python_but_function_still_converts(B):
    def f(x, bounds):
        if B.sum(x) > 0:
            y = x * 2.0
        else:
            y = -x
        total = 0
        for i in range(*bounds):
            if i > 2:
                break
            total = total + i
        return y, total

    g = B.convert(f)
    assert g.__d2s_converted__
    y, total = g(B.tensor([1.0]), (0, 10))
    np.testing.assert_allclose(_n(y), [2.0])
    assert total == 0 + 1 + 2
    return [_n(y), total]


@case
def zero_trip_for_target_poisons_on_use(B):
    def f(n, lim):
        acc = 0
        for i in range(n):
            if acc >= lim:
                break
            acc += i
        return acc, i

    acc, i = B.convert(f)(0, 5)
    assert acc == 0
    with pytest.raises(RuntimeError, match="not defined on every path"):
        i + 1
    return acc


@case
def for_range_break_not_truncated_by_loop_bound(B):
    def f(x):
        s = B.zeros(())
        for i in range(10):
            s = s + x
            if B.sum(s) > 1e9:
                break
        return s

    def f2(x):
        s = B.zeros(())
        for i in range(10):
            s = s + x
            if B.sum(s) > 4.5:
                break
        return s

    out = [float(B.compile(B.to_static(f, loop_bound=3))(B.asarray(1.0))),
           float(B.compile(B.to_static(f2, loop_bound=3))(B.asarray(1.0)))]
    assert out == [10.0, 5.0]
    return out


@case
def for_range_break_validates_range_args(B):
    def f(x, n):
        s = 0
        for i in range(n):
            if s > 100:
                break
            s += 1
        return s

    g = B.convert(f)
    with pytest.raises(TypeError):
        g(1, 2.5)
    assert g(1, 3) == 3
    return g(1, 3)


@case
def zero_step_range_raises_even_with_traced_bounds(B):
    def f(a, b):
        s = B.zeros(())
        for i in range(a, b, 0):
            s = s + 1.0
            if B.sum(s) > 3.0:
                break
        return s

    with pytest.raises(ValueError, match="must not be zero"):
        B.to_static(f)(B.asarray(5), B.asarray(0))
    return 0


def _iter_refine(B):
    nn = B.nn

    class IterRefine(nn.Layer):
        def __init__(self):
            super().__init__()
            self.proj = nn.Linear(4, 4)

        @B.to_static(loop_bound=6)
        def forward(self, x):
            h = self.proj(x)
            i = B.zeros(())
            while i < 4.0:
                if B.mean(h * h) > 9.0:
                    h = h * 0.5
                    break
                h = h + 0.2 * self.proj(h)
                i = i + 1.0
            else:
                h = h + 0.01
            return h

    return IterRefine


@case
def method_decoration_trains_under_trainstep(B):
    jpt.seed(0)
    jm = _iter_refine(JAX)()
    model = jm if B is JAX else layer_from_jax(
        _iter_refine(TORCH)(), {k: np.asarray(v)
                                for k, v in jm.state_dict().items()})
    step = B.TrainStep(model, B.AdamW(learning_rate=5e-3),
                       loss_fn=lambda out, b: B.F.mse_loss(out,
                                                           B.tensor(b[1])))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    t = rng.standard_normal((8, 4)).astype(np.float32)
    losses = [float(_n(step((x, t)))) for _ in range(8)]
    assert losses[-1] < losses[0]
    step.sync_to_model()
    out = _n(model(B.tensor(x)))
    h = _n(model.proj(B.tensor(x)))
    i = 0.0
    while i < 4.0:
        if (h * h).mean() > 9.0:
            h = h * 0.5
            break
        h = h + 0.2 * _n(model.proj(B.tensor(h)))
        i += 1.0
    else:
        h = h + 0.01
    np.testing.assert_allclose(out, h, rtol=1e-5)
    return _Trajectory(losses)


@case
def break_in_nested_loop_else_binds_outer(B):
    def f(n):
        out = 0
        i = 0
        while i < n:
            j = 0
            while j < 2:
                j += 1
            else:
                if i == 2:
                    break
            i += 1
        else:
            out = 999
        return out, i

    g = B.convert(f)
    assert g(5) == (0, 2) == f(5) and g(2) == (999, 2) == f(2)
    return [g(5), g(2)]


@case
def detached_loop_else_keeps_earlier_liveness(B):
    def f(t):
        if t > 0:
            y = 1.0
        else:
            y = 2.0
        i = 0
        while i < 3:
            i += 1
        else:
            z = y + 10.0
        return z

    g = B.convert(f)
    assert g(1) == 11.0 == f(1) and g(-1) == 12.0 == f(-1)

    def h(t):
        if t > 0:
            y = 1.0
        else:
            y = 2.0
        for i in range(3):
            pass
        else:
            z = y + 10.0
        return z

    g2 = B.convert(h)
    assert g2(1) == 11.0 == h(1) and g2(-1) == 12.0 == h(-1)

    def k(t, n):
        if t > 0:
            y = 1.0
        else:
            y = 2.0
        i = 0
        z = 0.0
        while i < 5:
            if i >= n:
                break
            i += 1
        else:
            z = y + 10.0
        return z

    g3 = B.convert(k)
    assert g3(1, 99) == 11.0 == k(1, 99) and g3(1, 2) == 0.0 == k(1, 2)
    return [g(1), g2(-1), g3(1, 99)]


@case
def method_to_static_warns_on_dropped_jit_kwargs(B):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")

        class M(B.nn.Layer):
            @B.to_static(loop_bound=4, donate_argnums=1)
            def forward(self, x):
                return x

    assert any("ignores jit options" in str(w.message) for w in rec)
    return 1


@case
def for_else_reading_loop_target_stays_exact(B):
    def f(x):
        i = 99
        s = x
        for i in range(3):
            s = s + 1.0
        else:
            z = i * 1.0
        return s + z

    assert B.convert(f)(0.0) == 5.0 == f(0.0)

    def h(x):
        s = x
        for i in range(3):
            s = s + 1.0
        else:
            z = i * 1.0
        return s + z

    assert B.convert(h)(0.0) == 5.0 == h(0.0)

    def k(vals):
        for v in vals:
            pass
        else:
            t = v
        return t

    assert B.convert(k)([1, 2, 7]) == 7 == k([1, 2, 7])
    return [B.convert(f)(0.0), B.convert(k)([1, 2, 7])]


@case
def for_range_else_reading_target_stays_python(B):
    def f(n, x):
        z = -1
        for i in range(n):
            if x > 10:
                break
        else:
            z = i
        return z

    g = B.convert(f)
    assert g(3, 5) == 2 == f(3, 5) and g(3, 50) == -1 == f(3, 50)
    with pytest.raises(UnboundLocalError):
        f(0, 5)
    with pytest.raises(UnboundLocalError):
        g(0, 5)
    return [g(3, 5), g(3, 50)]


@case
def for_over_tensor_with_break_converts(B):
    def f(xs):
        total = B.zeros(())
        for row in xs:
            s = B.sum(row)
            if s > 10.0:
                break
            total = total + s
        return total

    def ref(xs):
        total = 0.0
        for row in np.asarray(xs):
            s = row.sum()
            if s > 10.0:
                break
            total += s
        return total

    g = B.compile(B.to_static(f))
    xs1 = np.asarray([[1, 2], [3, 4], [20, 1], [5, 5]], np.float32)
    xs2 = np.asarray([[1, 2], [3, 4]], np.float32)
    out = [float(g(B.tensor(xs1))), float(g(B.tensor(xs2)))]
    np.testing.assert_allclose(out, [ref(xs1), ref(xs2)])
    return out


@case
def for_over_list_with_break_eager_parity(B):
    def f(vals, cap):
        out = []
        for v in vals:
            if v > cap:
                break
            out.append(v)
        else:
            out.append(-1)
        return out

    g = B.convert(f)
    assert g([1, 2, 9, 3], 5) == [1, 2] == f([1, 2, 9, 3], 5)
    assert g([1, 2, 3], 5) == [1, 2, 3, -1] == f([1, 2, 3], 5)
    return [g([1, 2, 9, 3], 5), g([1, 2, 3], 5)]


@case
def for_over_generator_with_break_stays_python(B):
    def f(n):
        gen = (i * i for i in range(n))
        total = 0
        for v in gen:
            if v > 9:
                break
            total += v
        return total

    assert B.convert(f)(10) == f(10) == 0 + 1 + 4 + 9

    def h(d):
        keys = []
        for k in d:
            if k == "stop":
                break
            keys.append(k)
        return keys

    d = {"a": 1, "stop": 2, "b": 3}
    assert B.convert(h)(d) == h(d) == ["a"]
    return [B.convert(f)(10), B.convert(h)(d)]


def _assert_same(a, b, path="result"):
    if isinstance(a, _Trajectory):
        np.testing.assert_allclose(b, a, rtol=1e-4, err_msg=path)
        return
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
        return
    if isinstance(a, str) or isinstance(b, str):
        assert a == b, path
        return
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=1e-6,
                               err_msg=path)


def test_the_reference_cases_are_all_here():
    assert len(CASES) == 61


@pytest.mark.parametrize("name", sorted(CASES))
def test_case(name):
    """One of tests/test_dy2static.py's cases through both packages."""
    want = CASES[name](JAX)
    got = CASES[name](TORCH)
    _assert_same(want, got)


# ---------------------------------------------------------- capture
def _branchy(K):
    nn = K.nn

    class Branchy(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin_a = nn.Linear(4, 4)
            self.lin_b = nn.Linear(4, 4)

        def forward(self, x):
            if x.mean() > 0:
                out = self.lin_a(x) * 2.0
            else:
                out = self.lin_b(x) - 1.0
            return out

    return Branchy()


def _doubler(K):
    nn = K.nn

    class Doubler(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)
            n = (h * 0).sum()
            while (h * h).sum() < 100.0:
                # a parameter read inside the loop: the capture lifts it
                h = h * 2.0 + self.lin.bias * 0.0
                n = n + 1.0
            return h, n

    return Doubler()


def _counter(K):
    nn = K.nn

    class Counter(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)
            # a trip count the data decides: 2 or 3
            k = (K.mean(x) > 0).astype("int32") if K is JAX else \
                (K.mean(x) > 0).to(K.int32)
            for i in range(k + 2):
                h = h + 1.0 + self.lin.bias * 0.0
            return h

    return Counter()


def _graph_targets(program):
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function"]


@pytest.mark.parametrize("kind", ["if", "while", "bounded_while",
                                  "for_range"])
def test_captured_control_flow_reloads_and_takes_both_paths(kind, tmp_path):
    """A tensor-dependent ``if`` (``torch.cond``), ``while``
    (``while_loop``), bounded ``while`` (a masked loop of N trips) and
    ``for`` over a range of tensor length (``while_loop``) captured by
    ``jit.save``: the reloaded program gives what the eager model and the
    JAX package's compiled ``to_static`` give, on fresh inputs that take
    each branch or a different number of trips."""
    make = {"if": _branchy, "for_range": _counter}.get(kind, _doubler)
    bound = 12 if kind == "bounded_while" else None
    jm = _layer_pair(JAX, make)
    tm = _layer_pair(TORCH, make)
    jg = j_to_static(jm, loop_bound=bound)
    tg = t_to_static(tm, loop_bound=bound)
    path = str(tmp_path / kind)
    program = tjit.save(tg, path, input_spec=[tjit.InputSpec([None, 4],
                                                             "float32")])
    targets = _graph_targets(program)
    if kind == "if":
        assert any("cond" in t for t in targets), targets
    elif kind in ("while", "for_range"):
        assert any("while_loop" in t for t in targets), targets
    else:
        assert not any("while_loop" in t for t in targets)
        assert sum("where" in t for t in targets) >= 2 * bound
    loaded = tjit.load(path, device="cpu")
    rng = np.random.default_rng(1)
    seen = set()
    for scale, shift, rows in ((1.0, 3.0, 3), (1.0, -3.0, 5), (0.01, 0.0, 2),
                               (2.0, 0.5, 4)):
        x = (rng.standard_normal((rows, 4)) * scale + shift).astype(
            np.float32)
        got = loaded(torch.from_numpy(x))
        want = tg(torch.from_numpy(x))
        ref = jg(jnp.asarray(x))
        for g, w, r in zip(*(v if isinstance(v, tuple) else (v,)
                             for v in (got, want, ref))):
            np.testing.assert_array_equal(g.numpy(), w.detach().numpy())
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-5)
        seen.add(float(got[1]) if isinstance(got, tuple)
                 else float(x.mean() > 0))
    assert len(seen) >= 2, seen   # both branches, or two trip counts


def test_bounded_loop_as_captured_is_differentiated_by_autograd(
        monkeypatch):
    """Under capture a bounded ``while`` is the masked loop of N trips;
    run that lowering on real tensors (capture forced on) and autograd
    differentiates it: the reference's d/dx of ``sum(x)`` doubled until
    over 10 is 8, and the double select keeps a dead step's NaN out."""
    def f(x):
        while torch.sum(x) < 10.0:
            x = x * 2.0
        return torch.sum(x)

    def h(x):
        while torch.sum(x) > 2.0:
            x = x * torch.sqrt(torch.sum(x) - 2.0) * 0.1
        return torch.sum(x)

    monkeypatch.setattr(tdy, "_capturing", lambda: True)
    for fn, x0, want in ((f, [1.0, 0.5], [8.0, 8.0]), (h, [3.0, 1.5], None)):
        g = t_convert(fn, loop_bound=16)
        x = torch.tensor(x0, requires_grad=True)
        val = g(x)
        val.backward()
        assert torch.isfinite(x.grad).all()
        jval = j_convert(_jax_twin(fn), loop_bound=16)
        np.testing.assert_allclose(float(val.detach()),
                                   float(jval(jnp.asarray(x0))),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            x.grad.numpy(), np.asarray(jax.grad(jval)(jnp.asarray(x0))),
            rtol=1e-6)
        if want is not None:
            np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6)


def _jax_twin(fn):
    """``fn`` with torch's reductions replaced by jnp's (same source)."""
    glb = dict(fn.__globals__, torch=jnp)
    return type(fn)(fn.__code__, glb, fn.__name__, fn.__defaults__,
                    fn.__closure__)


# ------------------------------------------------ translator controls
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_jit_translator_controls(pkg):
    """Twin of tests/test_namespace_longtail.py's: the switch is read at
    call time. Enabled, the converted function runs (traced once by the
    reference's jit, every call by the port's eager one); disabled, the
    original runs on every call, in both packages."""
    jit_mod = jpt.jit if pkg == "jax" else tjit
    zeros = (lambda: jnp.zeros(())) if pkg == "jax" else (
        lambda: torch.zeros(()))
    inst = jit_mod.ProgramTranslator.get_instance()
    assert inst is jit_mod.ProgramTranslator.get_instance()
    calls = []

    def f(x):
        # the code object running: the converted rebuild or the original
        calls.append(sys._getframe().f_code.co_filename)
        if x.sum() > 100:
            x = x - 1
        return x + 1

    g = jit_mod.to_static(f)
    assert float(g(zeros())) == 1.0
    float(g(zeros()))
    enabled = len(calls)
    assert enabled == (1 if pkg == "jax" else 2)
    assert all(c.startswith("<dy2static") for c in calls)
    inst.enable(False)
    try:
        float(g(zeros()))
        float(g(zeros()))
        assert len(calls) == enabled + 2
        assert calls[-1] == calls[-2] == __file__
    finally:
        inst.enable(True)
    assert float(g(zeros())) == 1.0
    assert len(calls) == enabled + 2 + (0 if pkg == "jax" else 1)

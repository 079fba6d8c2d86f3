"""The port's tensor ops (``paddle_tpu_torch.ops``, the top-level tensor
API) against the JAX package's (``paddle_tpu.ops``) on the CPU.

One parametrised case per public function of the reference's
``ops/*.py``: the same seeded numpy inputs go through both (the reference
eagerly, not under ``jit``), and every output is held to the other at
``tests/op_test.py``'s per-dtype tolerance (float32 rtol 1e-5 / atol
1e-6, float64 1e-7 / 1e-8; integers and booleans exactly). Where the
case's first input is floating and its output a float tensor, the
gradient of a fixed random weighting of the output goes through both
eager tapes (the reference's ``eager.apply_op`` over ``jax.vjp``, the
port's over torch's autograd) and is held at the same tolerance.

Not compared value by value, and why:

- the random ops draw from torch generators, not JAX keys: they are held
  to shape, dtype, range, moments within a stated bound, and bit-equal
  replay under a fixed seed (``test_random_op``);
- ``svd``, ``qr``, ``eig``, ``eigh`` and ``lu`` are fixed only up to sign,
  phase or pivoting: their reconstructions and invariants are compared;
- index results are int64 in the port where the reference's come back
  int32 (JAX runs without 64-bit types although its code asks for int64):
  values are compared, and ``test_index_width_divergence`` pins the
  widths (ROADMAP.md section C).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as R
import paddle_tpu_torch as paddle
import paddle_tpu_torch.ops as P
from paddle_tpu import eager as jeager
from paddle_tpu_torch import eager
from paddle_tpu_torch.framework import compat

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_op_cases as C  # noqa: E402
from torch_threads import few_torch_threads  # noqa: F401

CASES = C.CASES


@pytest.fixture(autouse=True)
def _cpu():
    prev = compat._current[0]
    paddle.set_device("cpu")
    yield
    compat._current[0] = prev


def _to(lib, x):
    if lib == "torch":
        return C.to_torch(x)
    if isinstance(x, np.ndarray):
        return jnp.asarray(x)
    if isinstance(x, np.generic):
        return x
    if isinstance(x, list):
        return [_to(lib, v) for v in x]
    if isinstance(x, tuple):
        return tuple(_to(lib, v) for v in x)
    return x


def _call_factors(name, args, kw):
    if name != "lu_unpack":
        want = getattr(R, name)(*_to("jax", args), **kw)
    else:
        want = R.lu_unpack(*R.lu(jnp.asarray(args[0])))
    return C.call_port_factors(name, args, kw), want


def _grad_check(name, args, kw, out):
    """The gradient of ``sum(w * out)`` with respect to the first input
    through both eager tapes."""
    w = np.random.default_rng(1).uniform(0.5, 1.5, out.shape).astype(
        out.dtype)
    jx = jeager.Tensor(jnp.asarray(args[0]), stop_gradient=False)
    jout = jeager.apply_op(getattr(R, name), jx, *_to("jax", args[1:]), **kw)
    (jout * jnp.asarray(w)).sum().backward()
    tx = eager.Tensor(torch.from_numpy(args[0].copy()), stop_gradient=False)
    tout = eager.apply_op(getattr(P, name), tx, *_to("torch", args[1:]),
                          **kw)
    (tout * torch.from_numpy(w)).sum().backward()
    rtol, atol = C.TOL[np.dtype(np.float32)]
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad),
                               rtol=rtol, atol=atol,
                               err_msg=f"{name}: gradient")


@pytest.mark.parametrize("name,spec", CASES, ids=[c[0] for c in CASES])
def test_op_matches_reference(name, spec):
    args, kw = spec(C.G(name))
    if name in C.FACTORS:
        got, want = _call_factors(name, args, kw)
        C.factors_check(name, args, got, want)
        return
    want = getattr(R, name)(*_to("jax", args), **kw)
    got = getattr(P, name)(*_to("torch", args), **kw)
    C.compare(got, want, name)
    out = C.leaves(got)
    if (name not in C.NO_GRAD and args and isinstance(args[0], np.ndarray)
            and args[0].dtype == np.float32 and len(out) == 1
            and out[0].dtype == np.float32 and out[0].size):
        _grad_check(name, args, kw, out[0])


def test_every_reference_op_has_a_case():
    import inspect

    want = set()
    for mod in (R.creation, R.math, R.manipulation, R.linalg, R.logic,
                R.search, R.random, R.stat, R.sequence):
        for n in dir(mod):
            fn = getattr(mod, n)
            if (not n.startswith("_") and callable(fn)
                    and not inspect.ismodule(fn)
                    and getattr(fn, "__module__", "").startswith(
                        "paddle_tpu.ops")):
                want.add(n)
    have = {c[0] for c in CASES} | set(C.RANDOM) | {"set_printoptions"}
    assert want == have
    assert want <= set(P.__all__)


@pytest.mark.parametrize("name", C.RANDOM)
def test_random_op(name):
    """Bit-equal replay under a fixed seed, range and moments
    (``torch_op_cases.check_random``), and the shape and range of the
    reference's draws of the same op."""
    a = C.check_random(name, "cpu")
    ref = {"uniform": lambda: R.uniform((400, 50), min=-2.0, max=3.0),
           "randint": lambda: R.randint(-3, 5, (400, 50)),
           "multinomial": lambda: R.multinomial(jnp.asarray([0.1, 0.2, 0.7]),
                                                20000, True)}.get(name)
    if ref is not None:
        r = np.asarray(ref())
        assert tuple(a.shape) == r.shape
        assert float(a.min()) >= float(r.min()) - 1 and \
            float(a.max()) <= float(r.max()) + 1


def test_index_width_divergence():
    """Index results are int64, the width the reference's code asks for;
    the reference returns int32 because JAX runs without 64-bit types.
    float64 data stays float64 (the reference's becomes float32)."""
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    for name, args in (("argmax", (x,)), ("argsort", (x,)),
                       ("nonzero", (x > 0,)), ("topk", (x, 2))):
        got = C.leaves(getattr(P, name)(*_to("torch", args)))[-1]
        want = C.leaves(getattr(R, name)(*_to("jax", args)))[-1]
        assert got.dtype == np.int64 and want.dtype == np.int32, name
    assert P.arange(5).dtype == torch.int64
    assert np.asarray(R.arange(5)).dtype == np.int32
    assert P.cast(torch.ones(2), "int64").dtype == torch.int64
    assert P.to_tensor(np.ones(2)).dtype == torch.float64
    assert np.asarray(R.to_tensor(np.ones(2))).dtype == np.float32


def test_ops_follow_inputs_and_creation_follows_the_device():
    """Creation ops use the current device (here the CPU, set by the
    fixture); without it they would ask for the card, which raises
    without one. Ops on tensors follow their inputs."""
    assert P.zeros([2]).device.type == "cpu"
    assert P.to_tensor([1.0], place=paddle.CPUPlace()).device.type == "cpu"
    compat._current[0] = "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.zeros([2])
        with pytest.raises(RuntimeError, match="CUDA"):
            P.to_tensor([1.0])
    assert P.add(torch.ones(2), 1.0).device.type == "cpu"


def test_ops_take_eager_tensors():
    x = eager.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3),
                        stop_gradient=False)
    out = paddle.concat([x, x * 2], axis=0)
    assert isinstance(out, eager.Tensor) and out.shape == [4, 3]
    paddle.sum(out).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.full((2, 3), 3.0))

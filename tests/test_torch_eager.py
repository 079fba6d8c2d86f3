"""The port's eager dygraph front door (``paddle_tpu_torch.eager``, the
top-level ``to_tensor``/``grad``/``no_grad``, ``nn.Layer``, ``PyLayer``,
``autograd``) against the JAX package's, on the CPU.

One counterpart per case of ``tests/test_eager.py``, each asserting what
the reference asserts and, where the case computes a number, that the
reference computes the same one; then the reference's dygraph loop
(``model(x)``, ``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``)
on a small GPT in both packages, the weights carried across by
``convert.gpt_from_jax``.

Tolerances, float32: rtol 1e-5 / atol 1e-6 on single ops and layers (the
op tests' tolerance), and on the AdamW loop the training tests' (losses
1e-5 relative, parameters 1e-4 absolute after three steps at lr 1e-3: an
element whose gradient is as small as its rounding error may step the
other way on one side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as paddle
from paddle_tpu import eager as jeager
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import autograd, eager, nn
from paddle_tpu_torch.convert import gpt_from_jax
from paddle_tpu_torch.framework import compat
from paddle_tpu_torch.models.gpt import gpt_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, AdamW

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu_eager():
    prev = compat._current[0]
    paddle.set_device("cpu")
    eager.enable()
    jeager.enable()
    yield
    compat._current[0] = prev


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_tensor_basics():
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = eager.to_tensor(data)
    r = jeager.to_tensor(data)
    assert t.shape == r.shape == [2, 3]
    assert t.stop_gradient and r.stop_gradient
    assert float(t.sum()) == float(r.sum()) == 15.0
    _close((t + 1).numpy(), (r + 1).numpy())
    _close((t * 2 - t).numpy(), t.numpy())


def test_backward_simple():
    x = eager.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    (x * x).sum().backward()
    _close(x.grad, [2.0, 4.0, 6.0])


def test_backward_chain_and_accumulation():
    x = eager.to_tensor([2.0], stop_gradient=False)
    (x * 3).backward()
    (x * 5).backward()
    _close(x.grad, [8.0])  # 3 + 5
    x.clear_grad()
    assert x.grad is None


def test_no_grad():
    x = eager.to_tensor([1.0], stop_gradient=False)
    with eager.no_grad():
        y = x * 2
    assert y.stop_gradient and y._data.grad_fn is None


def test_top_level_no_grad_stops_the_tape():
    """The reference's top-level no_grad is a no-op marker (its tape
    records under it); paddle's stops recording, and so does the port's
    (ROADMAP.md section C)."""
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with paddle.no_grad():
        y = x * 2
    assert y.stop_gradient
    xr = pt.to_tensor([1.0], stop_gradient=False)
    with pt.no_grad():
        yr = xr * 2
    assert not yr.stop_gradient  # the reference's fault, not copied

    @paddle.no_grad
    def double(v):
        return v * 2

    assert double(x).stop_gradient
    assert paddle.is_grad_enabled()
    with paddle.set_grad_enabled(False):
        assert not paddle.is_grad_enabled()
    assert paddle.is_grad_enabled()


def test_branching_graph():
    """Diamond graph: z = x*y + x."""
    x = eager.to_tensor([3.0], stop_gradient=False)
    y = eager.to_tensor([4.0], stop_gradient=False)
    (x * y + x).backward()
    _close(x.grad, [5.0])
    _close(y.grad, [3.0])


def test_intermediate_grad_like_the_reference():
    """The reference's tape leaves ``.grad`` on intermediates that
    require grad, and none on the root."""
    def run(mod):
        x = mod.to_tensor([1.0, 2.0], stop_gradient=False)
        mid = x * 3
        out = (mid * mid).sum()
        out.backward()
        return x.grad, mid.grad, out.grad

    got, want = run(eager), run(jeager)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            _close(g, w)


def test_layer_backward_and_grads():
    paddle.seed(0)
    fc = nn.Linear(4, 2, device="cpu")
    x = eager.to_tensor(np.random.default_rng(0).standard_normal(
        (3, 4)).astype(np.float32))
    out = eager.eager_layer_call(fc, x)
    assert isinstance(out, eager.Tensor)
    (out * out).mean().backward()
    g = eager.grads_of(fc)
    assert set(g) == {"weight", "bias"}
    assert float(g["weight"].abs().sum()) > 0

    # the reference's Linear with the same weights gives the same grads
    jfc = pt.nn.Linear(4, 2)
    jfc.set_state_dict({k: jnp.asarray(v.detach().numpy())
                        for k, v in fc.state_dict().items()})
    jout = jfc(jeager.to_tensor(x.numpy()))
    (jout * jout).mean().backward()
    for k, v in jeager.grads_of(jfc).items():
        _close(g[k], v)


def test_functional_dispatch():
    x = eager.to_tensor(np.random.default_rng(1).standard_normal(
        (2, 5)).astype(np.float32), stop_gradient=False)
    out = F.relu(x)
    assert isinstance(out, eager.Tensor)
    out.sum().backward()
    _close(x.grad, (x.numpy() > 0).astype(np.float32))


class _Net(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(8, 16, device="cpu")
        self.fc2 = nn.Linear(16, 4, device="cpu")

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


def test_reference_style_training_loop_matches_trainstep():
    """model -> loss.backward() -> opt.step() matches TrainStep losses,
    and the reference's own loop on the same weights."""
    from paddle_tpu_torch.framework.jit import TrainStep

    rng = np.random.default_rng(0)
    xs = rng.standard_normal((4, 8, 8)).astype(np.float32)
    ys = rng.integers(0, 4, (4, 8))

    paddle.seed(7)
    model_a = _Net()
    model_b = _Net()
    model_b.set_state_dict(model_a.state_dict())

    opt = SGD(learning_rate=0.1, parameters=model_a)
    eager_losses = []
    for x, y in zip(xs, ys):
        out = model_a(eager.to_tensor(x))
        loss = F.cross_entropy(out, eager.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager_losses.append(float(loss))

    step = TrainStep(model_b, SGD(learning_rate=0.1),
                     loss_fn=lambda out, b: F.cross_entropy(out, b[1]))
    step_losses = [float(step((x, y))) for x, y in zip(xs, ys)]
    _close(eager_losses, step_losses)

    class JNet(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pt.nn.Linear(8, 16)
            self.fc2 = pt.nn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(pt.nn.functional.relu(self.fc1(x)))

    jm = JNet()
    paddle.seed(7)
    fresh = _Net()
    jm.set_state_dict({k: jnp.asarray(v.detach().numpy())
                       for k, v in fresh.state_dict().items()})
    jopt = pt.optimizer.SGD(learning_rate=0.1, parameters=jm)
    ref_losses = []
    for x, y in zip(xs, ys):
        loss = pt.nn.functional.cross_entropy(jm(jeager.to_tensor(x)),
                                              jeager.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        ref_losses.append(float(loss))
    _close(eager_losses, ref_losses)


def test_buffers_update_eagerly():
    bn = nn.BatchNorm1D(4, device="cpu")
    x = eager.to_tensor(np.random.default_rng(2).standard_normal(
        (8, 4)).astype(np.float32))
    before = bn._mean.detach().clone()
    eager.eager_layer_call(bn, x)
    assert not torch.allclose(before, bn._mean)


def test_ops_method_delegation():
    x = eager.to_tensor(np.random.default_rng(3).standard_normal(
        (3, 4)).astype(np.float32), stop_gradient=False)
    out = x.exp()
    assert isinstance(out, eager.Tensor)
    out.sum().backward()
    _close(x.grad, np.exp(x.numpy()))


# ---------------------------------------------------------------- PyLayer
def test_pylayer_custom_backward():
    class CusTanh(eager.PyLayer):
        @staticmethod
        def forward(ctx, x):
            y = x.tanh()
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor()
            return dy * (1 - y * y)

    x = eager.to_tensor([0.3, -1.2, 2.0], stop_gradient=False)
    out = CusTanh.apply(x)
    assert isinstance(out, eager.Tensor)
    out.sum().backward()
    _close(x.grad, 1 - np.tanh(x.numpy()) ** 2)


def test_pylayer_scaled_backward_and_ctx_attrs():
    """A deliberately wrong custom grad proves the user's backward
    replaces the traced one; ctx carries attributes and kwargs."""

    class ScaleGrad(eager.PyLayer):
        @staticmethod
        def forward(ctx, x, factor=10.0):
            ctx.factor = factor
            return x * 2

        @staticmethod
        def backward(ctx, dy):
            return dy * ctx.factor

    x = eager.to_tensor([1.0, 2.0], stop_gradient=False)
    ScaleGrad.apply(x, factor=7.0).sum().backward()
    _close(x.grad, [7.0, 7.0])


def test_pylayer_multi_input_output():
    """backward runs once with every output's gradient; an output that
    gets none passes zeros."""
    calls = []

    class Swap(eager.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            return b * 2, a * 3

        @staticmethod
        def backward(ctx, da, db):
            calls.append((da.numpy().copy(), db.numpy().copy()))
            return db * 3, da * 2

    a = eager.to_tensor([1.0], stop_gradient=False)
    b = eager.to_tensor([1.0], stop_gradient=False)
    o0, o1 = Swap.apply(a, b)
    (o0 * 5 + o1 * 7).backward()
    assert len(calls) == 1
    _close(calls[0][0], [5.0])
    _close(calls[0][1], [7.0])
    _close(a.grad, [21.0])
    _close(b.grad, [10.0])

    calls.clear()
    o0, o1 = Swap.apply(a, b)
    o0.sum().backward()
    assert len(calls) == 1
    _close(calls[0][1], [0.0])


def test_pylayer_training_loop():
    """PyLayer composes with layers and the optimizer in a paddle-shaped
    loop: its losses equal those of the same loop through torch's own
    square, and they fall."""
    class Square(eager.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 2 * x

    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    runs = []
    for square in (Square.apply, lambda v: v * v):
        paddle.seed(3)
        fc = nn.Linear(4, 4, device="cpu")
        opt = SGD(learning_rate=0.05, parameters=fc)
        losses = []
        for _ in range(5):
            loss = square(eager.eager_layer_call(fc, eager.to_tensor(x))
                          ).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        runs.append(losses)
    _close(runs[0], runs[1])
    assert runs[0][-1] < runs[0][0]


def test_pylayer_backward_arity_check():
    class Bad(eager.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            return a + b

        @staticmethod
        def backward(ctx, dy):
            return dy  # should be 2 grads

    a = eager.to_tensor([1.0], stop_gradient=False)
    b = eager.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="grad"):
        Bad.apply(a, b).backward()


def test_saved_tensors_hooks_pack_unpack():
    packed, unpacked = [], []

    def pack(t):
        packed.append(t)
        return ("wrapped", t)

    def unpack(p):
        unpacked.append(p)
        assert p[0] == "wrapped"
        return p[1]

    class Identity(eager.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * 1

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * paddle.ones_like(x)

    x = eager.to_tensor([5.0], stop_gradient=False)
    with eager.saved_tensors_hooks(pack, unpack):
        out = Identity.apply(x)
    out.backward()
    assert len(packed) == 1 and len(unpacked) == 1
    _close(x.grad, [1.0])


# ------------------------------------------------------------------ hooks
def test_register_hook_observes_and_modifies():
    x = eager.to_tensor([1.0, 2.0], stop_gradient=False)
    seen = []
    h = x.register_hook(lambda g: (seen.append(g.numpy().copy()), g * 2)[1])
    (x * 3).sum().backward()
    _close(seen[0], [3.0, 3.0])
    _close(x.grad, [6.0, 6.0])
    h.remove()
    x.clear_grad()
    (x * 3).sum().backward()
    _close(x.grad, [3.0, 3.0])
    assert len(seen) == 1


def test_register_hook_fires_once_with_accumulated_grad():
    x = eager.to_tensor([1.0], stop_gradient=False)
    y = x * 2
    calls = []
    y.register_hook(lambda g: calls.append(g.numpy().copy()))
    (y * 3 + y).backward()
    assert len(calls) == 1
    _close(calls[0], [4.0])
    _close(x.grad, [8.0])


def test_register_hook_modified_grad_flows_upstream():
    x = eager.to_tensor([1.0], stop_gradient=False)
    y = x * 5
    y.register_hook(lambda g: g * 0)
    (y * 2).backward()
    _close(x.grad, [0.0])


def test_register_hook_requires_grad():
    t = eager.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="stop"):
        t.register_hook(lambda g: g)


# ------------------------------------------------------------ strict mode
def test_strict_mode_blocks_silent_detach():
    x = eager.to_tensor([1.0], stop_gradient=False)
    y = x * 2
    with pytest.raises(RuntimeError, match="detach"):
        np.asarray(y)
    with pytest.raises(RuntimeError, match="detach"):
        np.exp(y)
    assert float(y.detach().numpy()[0]) == 2.0
    assert float(y.numpy()[0]) == 2.0
    with eager.no_grad():
        assert float(np.asarray(y)[0]) == 2.0
    t = eager.to_tensor([3.0])
    assert float(np.asarray(t)[0]) == 3.0
    prev = eager.set_strict(False)
    try:
        assert float(np.asarray(y)[0]) == 2.0
    finally:
        eager.set_strict(prev)


def test_autograd_facade_backward():
    assert autograd.PyLayer is eager.PyLayer
    x = eager.to_tensor([1.0], stop_gradient=False)
    autograd.backward([x * 2, x * 3])
    _close(x.grad, [5.0])


def test_autograd_backward_joint_hooks():
    x = eager.to_tensor([1.0], stop_gradient=False)
    z = x * 2
    calls = []
    z.register_hook(lambda g: calls.append(g.numpy().copy()))
    autograd.backward([z * 3, z * 5],
                      grad_tensors=[None, torch.tensor([2.0])])
    assert len(calls) == 1
    _close(calls[0], [13.0])
    _close(x.grad, [26.0])


def test_front_door_to_tensor_tape():
    x = paddle.to_tensor([[1.0, 2.0]], stop_gradient=False)
    assert isinstance(x, paddle.Tensor)
    (x * x).sum().backward()
    _close(x.grad, [[2.0, 4.0]])
    # the default stays plain data, as the reference's plain array
    plain = paddle.to_tensor([[1.0, 2.0]])
    assert isinstance(plain, torch.Tensor) and plain.dtype == torch.float32
    assert plain.device.type == "cpu"


def test_partial_grad_api():
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    w = paddle.to_tensor([3.0, 4.0], stop_gradient=False)
    y = (x * w).sum()
    gx, gw = paddle.grad([y], [x, w])
    _close(gx, [3.0, 4.0])
    _close(gw, [1.0, 2.0])
    assert x.grad is None and w.grad is None

    x2 = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y2 = x2 * 2.0
    (g2,) = paddle.grad([y2], [x2],
                        grad_outputs=[paddle.to_tensor([10.0, 100.0])])
    _close(g2, [20.0, 200.0])

    z = paddle.to_tensor([5.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="allow_unused"):
        paddle.grad([y2], [z])
    x3 = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y3 = (x3 * x3).sum()
    got = paddle.grad([y3], [x3, z], allow_unused=True)
    assert got[1] is None
    _close(got[0], [2.0, 4.0])

    # a non-leaf input gets its whole gradient, and no .grad is written
    x4 = paddle.to_tensor([2.0], stop_gradient=False)
    mid = x4 * 3.0
    out = (mid * mid).sum()
    (gmid,) = paddle.grad([out], [mid], retain_graph=True)
    _close(gmid, [12.0])
    assert mid.grad is None and x4.grad is None

    with pytest.raises(NotImplementedError, match="incubate.autograd"):
        paddle.grad([out], [x4], create_graph=True)

    # a callable first argument keeps the functional form
    f = paddle.grad(lambda v: (v * v).sum())
    _close(f(torch.tensor([3.0])), [6.0])


def test_device_facts_describe_the_card():
    """The reference's set_device("gpu") raises and is_compiled_with_cuda
    is False (facts of the JAX build); the port's describe the card and
    torch's build (ROADMAP.md section C)."""
    with pytest.raises(ValueError):
        pt.set_device("gpu")
    assert pt.is_compiled_with_cuda() is False
    assert paddle.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert paddle.device_count() == torch.cuda.device_count()
    if torch.cuda.is_available():
        assert paddle.set_device("gpu") == "gpu:0"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            paddle.set_device("gpu")
        assert paddle.get_device() == "cpu"


def test_value_and_grad_order():
    """(value, grad), the reference's order (torch's is the other way)."""
    fn = lambda v: (v * v).sum()  # noqa: E731
    value, g = paddle.value_and_grad(fn)(torch.tensor([3.0, 4.0]))
    rv, rg = pt.value_and_grad(fn)(jnp.asarray([3.0, 4.0]))
    _close(value, rv)
    _close(g, rg)


def test_partial_grad_identity_and_mode_restore():
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    (g,) = paddle.grad([x], [x])
    _close(g, [1.0, 1.0])
    assert paddle.in_dynamic_mode()


def test_partial_grad_identity_runs_hooks():
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    x.register_hook(lambda g: g * 2)
    (g,) = paddle.grad([x], [x])
    _close(g, [2.0, 2.0])


# ------------------------------------------------------- Layer's methods
def test_layer_methods():
    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter([3, 2])
            self.b = self.create_parameter([2], is_bias=True)
            self.add_sublayer("fc", nn.Linear(2, 2, device="cpu"))
            self.register_buffer("count", torch.zeros(()),
                                 persistable=False)

        def forward(self, x):
            return self.fc(x @ self.w + self.b)

    blk = Block()
    assert isinstance(blk.parameters(), list) and len(blk.parameters()) == 4
    assert [n for n, _ in blk.named_sublayers()] == ["fc"]
    assert len(blk.sublayers(include_self=True)) == 2
    assert "count" not in blk.state_dict()
    assert sorted(blk.state_dict(include_sublayers=False)) == ["b", "w"]
    _close(blk.b.detach(), np.zeros(2))
    seen = []
    h = blk.register_forward_post_hook(
        lambda layer, inputs, out: seen.append(out.shape))
    out = blk(eager.to_tensor(np.ones((4, 3), np.float32)))
    assert isinstance(out, eager.Tensor) and seen == [torch.Size([4, 2])]
    h.remove()
    out.sum().backward()
    assert blk.w.grad is not None
    blk.clear_gradients()
    assert all(p.grad is None for p in blk.parameters())
    missing, unexpected = blk.set_state_dict(
        {"w": np.full((3, 2), 0.5, np.float32), "extra": np.zeros(1)})
    assert unexpected == ["extra"] and "b" in missing
    _close(blk.w.detach(), np.full((3, 2), 0.5))
    blk.to("bfloat16")
    assert blk.w.dtype == torch.bfloat16 and blk.count.dtype == torch.float32
    state = nn.param_state(blk)
    out, bufs = nn.functional_call(
        blk.float(), {k: torch.zeros_like(v) for k, v in state.items()},
        nn.buffer_state(blk), torch.ones(1, 3))
    _close(out.detach(), np.zeros((1, 2)))
    assert set(bufs) == {"count"}


# ------------------------------------------- the dygraph loop on a small GPT
def test_gpt_dygraph_loop_matches_reference():
    """Three AdamW steps of ``loss = model(ids, ids); loss.backward();
    opt.step(); opt.clear_grad()`` on a two-layer GPT in both packages:
    the same losses and final parameters."""
    nodrop = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                  num_layers=2, hidden_size=64, num_heads=4,
                  max_position_embeddings=64)
    pt.seed(11)
    jm = JaxGPT(jax_gpt_tiny(**nodrop)).train()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = gpt_from_jax(state, gpt_tiny(**nodrop), device="cpu").train()
    jopt = JaxAdamW(learning_rate=1e-3, parameters=jm)
    topt = AdamW(learning_rate=1e-3, parameters=tm)
    batches = np.random.default_rng(5).integers(0, 1024, (3, 2, 16))
    jl, tl = [], []
    for ids in batches:
        loss = jm(jeager.to_tensor(ids), jeager.to_tensor(ids))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss))
        loss = tm(paddle.to_tensor(ids), paddle.to_tensor(ids))
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(float(loss))
        assert all(p.grad is None for p in tm.parameters())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    got = dict(tm.named_parameters())
    for k, v in jm.state_dict().items():
        if k in got:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v),
                                       rtol=0, atol=1e-4, err_msg=k)

"""The port's recompute (paddle_tpu_torch.distributed.parallel.recompute):
the reference's named policies, ``recompute_sequential`` and
``RecomputeLayer``, against no recompute and against the JAX package's.

Every policy must give the gradients of no recompute (bit for bit: the
recomputed forward runs the same ops in the same order, and a dropout
inside it draws the seeds the forward drew), and the JAX package's under
the same policy (float32: outputs 1e-5, gradients rtol 2e-4 / atol
2e-5, the reference's). What a policy keeps is observable: the tensors
autograd saves (saved-tensor hooks) and the products that run again in
the backward pass (an aten dispatch count).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as pt
from paddle_tpu.distributed.parallel import recompute as JR
from paddle_tpu.nn.layer import Layer as JaxLayer
from paddle_tpu.nn.layer import functional_call, param_state
from paddle_tpu.nn.layers import containers as JC
from paddle_tpu.nn.layers.common import Linear as JaxLinear
from paddle_tpu.nn.layers.transformer import \
    TransformerEncoderLayer as JaxEncoderLayer
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.distributed.parallel import recompute as R
from paddle_tpu_torch.nn.layer import rng_context
from paddle_tpu_torch.nn.layers import containers as C
from paddle_tpu_torch.nn.layers.common import Linear
from paddle_tpu_torch.nn.layers.transformer import TransformerEncoderLayer

FWD = dict(rtol=1e-5, atol=1e-5)
BWD = dict(rtol=2e-4, atol=2e-5)
E, NH, FF = 32, 4, 64


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _layer(dropout=0.0, seed=1):
    pt.seed(seed)
    jl = JaxEncoderLayer(E, NH, FF, dropout=dropout)
    state = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    tl = layer_from_jax(TransformerEncoderLayer(E, NH, FF, dropout=dropout,
                                                device="cpu"), state)
    return jl.train(), tl.train()


def _torch_grads(module, x, w, rngs=None):
    module.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_()
    with rng_context(rngs or {"dropout": 0}):
        out = module(xt)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), xt.grad, {k: p.grad.clone()
                                   for k, p in module.named_parameters()}


@pytest.mark.parametrize("policy", R.POLICIES)
def test_every_policy_gives_the_gradients_of_no_recompute(policy):
    """With dropout on: the recomputed forward draws the forward's masks."""
    _, tl = _layer(dropout=0.2)
    x, w = _rand((2, 9, E), 0), _rand((2, 9, E), 1)
    plain = _torch_grads(tl, x, w)
    wrapped = _torch_grads(R.RecomputeLayer(tl, policy), x, w)
    assert torch.equal(wrapped[0], plain[0])
    assert torch.equal(wrapped[1], plain[1])
    for k, g in plain[2].items():
        assert torch.equal(wrapped[2]["inner." + k], g), k


@pytest.mark.parametrize("policy", R.POLICIES)
def test_every_policy_matches_jax(policy):
    jl, tl = _layer()
    jrl, trl = JR.RecomputeLayer(jl, policy), R.RecomputeLayer(tl, policy)
    x, w = _rand((2, 9, E), 2), _rand((2, 9, E), 3)

    def loss(p):
        out, _ = functional_call(jrl, p, None, jnp.asarray(x))
        return jnp.sum(out * w), out

    (_, o_j), g_j = jax.value_and_grad(loss, has_aux=True)(param_state(jrl))
    o_t, _, g_t = _torch_grads(trl, x, w)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **FWD)
    assert set(g_t) == set(g_j)
    for k in g_j:
        np.testing.assert_allclose(g_t[k].numpy(), np.asarray(g_j[k]),
                                   err_msg=k, **BWD)


def _saved_count(policy):
    """Tensors autograd packs for the backward pass while the wrapped
    layer runs (a checkpointed region keeps its own and packs nothing
    here)."""
    _, tl = _layer()
    fn = R.recompute_wrap(tl, policy)
    count = [0]

    def pack(t):
        count[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(torch.from_numpy(_rand((2, 9, E), 4)).requires_grad_())
    return count[0]


def test_save_nothing_saves_fewer_tensors_than_save_anything():
    nothing, anything = _saved_count("save_nothing"), \
        _saved_count("save_anything")
    assert nothing < anything
    assert _saved_count(None) == _saved_count("full") == nothing


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm"):
            self.counts["mm"] += 1
        elif name in ("bmm", "baddbmm"):
            self.counts["bmm"] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(policy):
    """Matrix products the backward pass runs: its own gradients plus
    whatever the policy did not keep and so computes again."""
    _, tl = _layer()
    fn = R.recompute_wrap(tl, policy)
    with rng_context({"dropout": 0}):
        out = fn(torch.from_numpy(_rand((2, 9, E), 5)).requires_grad_())
    with _CountProducts() as mode:
        out.sum().backward()
    return mode.counts


def test_dot_policies_keep_the_products_they_name():
    """save_dots keeps every product, so the backward recomputes none;
    save_dots_no_batch keeps the linear layers' 2-D products and
    recomputes the attention's batched ones; save_nothing recomputes
    both; save_anything recomputes nothing."""
    counts = {p: _backward_products(p) for p in
              ("save_anything", "save_dots", "save_dots_no_batch",
               "save_nothing")}
    assert counts["save_dots"] == counts["save_anything"]
    assert counts["save_dots_no_batch"]["mm"] == counts["save_dots"]["mm"]
    assert counts["save_dots_no_batch"]["bmm"] > counts["save_dots"]["bmm"]
    assert counts["save_nothing"]["mm"] > counts["save_dots_no_batch"]["mm"]
    assert counts["save_nothing"]["bmm"] == \
        counts["save_dots_no_batch"]["bmm"]


def test_unknown_policy_raises():
    with pytest.raises(ValueError):
        R.RecomputeLayer(torch.nn.Identity(), "save_some")
    with pytest.raises(ValueError):
        R.recompute(lambda x: x, torch.ones(1), policy="save_some")


def test_recompute_layer_keeps_the_reference_parameter_paths():
    jl, tl = _layer()
    assert sorted(JR.RecomputeLayer(jl).state_dict()) == \
        sorted(dict(R.RecomputeLayer(tl).named_parameters()))


@pytest.mark.parametrize("segments", [1, 2, 3])
def test_recompute_sequential_matches_jax(segments):
    """A Sequential split into ``segments`` recomputed chunks: output and
    gradients against the reference's and against running it plain."""
    sizes = [(6, 8), (8, 8), (8, 5), (5, 4)]
    pt.seed(3)
    jseq = JC.Sequential(*[JaxLinear(a, b) for a, b in sizes])
    tseq = layer_from_jax(C.Sequential(*[Linear(a, b, device="cpu")
                                         for a, b in sizes]),
                          {k: np.asarray(v)
                           for k, v in jseq.state_dict().items()}).train()
    x = _rand((3, 6), 6)

    class Segmented(JaxLayer):
        def __init__(self):
            super().__init__()
            self.seq = jseq

        def forward(self, xs):
            return JR.recompute_sequential({"segments": segments},
                                           list(self.seq), xs)

    jwrap = Segmented()

    def loss(p):
        out, _ = functional_call(jwrap, p, None, jnp.asarray(x))
        return jnp.sum(jnp.tanh(out)), out

    (_, o_j), g_j = jax.value_and_grad(loss, has_aux=True)(
        param_state(jwrap))
    xt = torch.from_numpy(x).requires_grad_()
    out = R.recompute_sequential({"segments": segments}, tseq, xt)
    torch.tanh(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o_j), **FWD)
    for k, p in tseq.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(g_j["seq." + k]), err_msg=k,
                                   **BWD)
    plain = tseq(torch.from_numpy(x))
    assert torch.equal(out.detach(), plain.detach())


def test_recompute_sequential_passes_tuples_between_chunks():
    def split(x):
        return x * 2.0, x + 1.0

    def join(a, b):
        return a * b

    x = torch.linspace(-1, 1, 5, requires_grad=True)
    got = R.recompute_sequential({"segments": 2}, [split, join], x)
    got.sum().backward()
    assert torch.equal(got, (x * 2.0) * (x + 1.0))
    torch.testing.assert_close(x.grad, 4.0 * x.detach() + 2.0)


def test_recompute_function_takes_a_policy():
    _, tl = _layer()
    x = torch.from_numpy(_rand((2, 9, E), 7))
    with rng_context({"dropout": 0}):
        a = R.recompute(tl, x, policy="save_dots")
    assert torch.equal(a, tl(x))

"""The port's ResNet family (``paddle_tpu_torch.models.resnet``)
against the JAX package's, on the CPU: forwards in train and eval mode
(resnet18, a [1, 1, 1, 1] bottleneck ResNet, resnext50_32x4d,
wide_resnet50_2), ``EvalStep`` leaving ``_mean`` / ``_variance``
bit-equal, ``flops`` and ``summary``, ``resnet_from_jax`` and the 13
constructors, and ``DistributedTrainStep``'s refusal. The training runs
are ``tests/test_torch_resnet_train.py``'s, which shares these helpers.

Weights come from the port's seeded draws and cross by name; the
reference is built under a zero global initializer (its per-parameter
draws compile one XLA program per shape and would take most of the
file's time) and then given the port's state. Inputs are numpy arrays
from seeds.

Tolerances (float32): eval-mode forwards rtol 1e-4 / atol 1e-5.
Training-mode forwards normalise layer4 by the statistics of batch x 1 x
1 values at 32 x 32 images, which amplifies float32 rounding: both
float32 implementations lie up to 1.6e-4 of the largest logit from a
float64 run of the port (resnext50_32x4d, batch 8), so the atol there is
3e-4 x max|logit|, and the new running statistics rtol 1e-3 / atol 1e-5.
bf16 bounds are the reference's 2e-2.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework.jit import EvalStep as JEvalStep
from paddle_tpu.hapi.dynamic_flops import count_jaxpr_flops
from paddle_tpu.hapi.model_summary import summary as jsummary
from paddle_tpu.models import resnet as JR
from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.layer import buffer_state, functional_call, param_state
from paddle_tpu_torch import hapi
from paddle_tpu_torch.convert import resnet_from_jax
from paddle_tpu_torch.framework.jit import EvalStep
from paddle_tpu_torch.hapi.dynamic_flops import count_flops
from paddle_tpu_torch.hapi.model_summary import summary
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum

EVAL = dict(rtol=1e-4, atol=1e-5)
STATS = dict(rtol=1e-3, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
CLASSES = 10


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads for these files' CPU convolutions: the tier-1
    run puts six test processes on the machine's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(t):
    return t.detach().float().cpu().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _port(name, seed=0, **kw):
    if name in ("bottleneck_1111", "basic_1111"):
        block = TR.BottleneckBlock if name == "bottleneck_1111" \
            else TR.BasicBlock
        return TR.ResNet(block, [1, 1, 1, 1], device="cpu",
                         generator=torch.Generator().manual_seed(seed), **kw)
    return getattr(TR, name)(device="cpu",
                             generator=torch.Generator().manual_seed(seed),
                             **kw)


def _twin(tm, name, **kw):
    """The reference model of ``name`` carrying ``tm``'s state."""
    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        if name in ("bottleneck_1111", "basic_1111"):
            block = JR.BottleneckBlock if name == "bottleneck_1111" \
                else JR.BasicBlock
            jm = JR.ResNet(block, [1, 1, 1, 1], **kw)
        else:
            jm = getattr(JR, name)(**kw)
    finally:
        JI.set_global_initializer(None, None)
    # copies: on the CPU jnp.asarray may alias the numpy view of a torch
    # tensor, which the port's in-place updates would then move
    state = {k: jnp.asarray(v.detach().numpy().copy())
             for k, v in tm.state_dict().items()}
    missing, unexpected = jm.set_state_dict(state)
    assert not missing and not unexpected
    return jm


def _random_statistics(tm, seed):
    """Non-trivial running statistics in every BatchNorm of ``tm``."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, b in tm.named_buffers():
            if name.endswith("_mean"):
                b.copy_(torch.from_numpy(rng.normal(0, 0.2, b.shape)))
            else:
                b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape)))


def _jax_forward(jm, x):
    """The reference's forward and new buffers, compiled once."""
    f = jax.jit(lambda p, b, a: functional_call(jm, p, b, a))
    out, new_buf = f(param_state(jm), buffer_state(jm), jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in new_buf.items()}


@pytest.mark.parametrize("name", ["resnet18", "bottleneck_1111",
                                  "resnext50_32x4d", "wide_resnet50_2"])
def test_forward_train_and_eval(name):
    tm = _port(name, num_classes=CLASSES)
    _random_statistics(tm, 1)
    jm = _twin(tm, name, num_classes=CLASSES)
    x = _rand((8, 3, 32, 32), 2)
    jm.eval()
    out_j, _ = _jax_forward(jm, x)
    with torch.no_grad():
        out_t = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out_t.numpy(), out_j, **EVAL)
    jm.train()
    out_j, buf_j = _jax_forward(jm, x)
    with torch.no_grad():
        out_t = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-4,
                               atol=3e-4 * np.abs(out_j).max())
    for k, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), buf_j[k], err_msg=k, **STATS)


def _batches(n, seed, size=32, batch=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((batch, 3, size, size)).astype(np.float32)
        y = rng.integers(0, CLASSES, batch)
        out.append((x, y))
    return out


def _bits(model):
    return {k: b.detach().clone() for k, b in model.named_buffers()}


def _same_bits(model, saved):
    return all(torch.equal(b, saved[k]) for k, b in model.named_buffers())


def test_eval_step_leaves_statistics_and_matches_the_reference():
    """``EvalStep`` runs the model in its own mode (a training-mode
    BatchNorm normalises by the batch, as the reference's does) and leaves
    every buffer bit-equal; in eval mode it normalises by the running
    statistics."""
    tm = _port("resnet18", 9, num_classes=CLASSES)
    _random_statistics(tm, 10)
    jm = _twin(tm, "resnet18", num_classes=CLASSES)
    x = _rand((8, 3, 32, 32), 11)
    for mode in ("train", "eval"):
        getattr(tm, mode)()
        getattr(jm, mode)()
        saved = _bits(tm)
        out_t = EvalStep(tm)(x)
        out_j = np.asarray(JEvalStep(jm)(jnp.asarray(x)))
        assert _same_bits(tm, saved)
        atol = 3e-4 * np.abs(out_j).max() if mode == "train" else 1e-5
        np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-4,
                                   atol=atol)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_flops_match_the_reference(name):
    """``conv`` and ``dot_general`` equal the reference's at 224 x 224
    (grouped convs counted per group); the total within 1 %."""
    tm = getattr(TR, name)(device="cpu")
    jm = _twin(tm, name)
    jm.eval()

    def fwd(p, b, a):
        return functional_call(jm, p, b, a)[0]

    ref = count_jaxpr_flops(jax.make_jaxpr(fwd)(
        param_state(jm), buffer_state(jm),
        jax.ShapeDtypeStruct((1, 3, 224, 224), jnp.float32)))
    got = count_flops(tm, (1, 3, 224, 224))
    assert got["conv"] == ref["conv"]
    assert got["dot_general"] == ref["dot_general"]
    assert abs(sum(got.values()) - sum(ref.values())) <= 0.01 * sum(
        ref.values())
    assert hapi.flops(tm, (1, 3, 224, 224)) == int(sum(got.values()))
    assert tm.training   # restored


def test_flops_count_groups_like_the_reference():
    tm = _port("resnext50_32x4d", num_classes=CLASSES)
    jm = _twin(tm, "resnext50_32x4d", num_classes=CLASSES)
    jm.eval()
    ref = count_jaxpr_flops(jax.make_jaxpr(
        lambda p, b, a: functional_call(jm, p, b, a)[0])(
        param_state(jm), buffer_state(jm),
        jax.ShapeDtypeStruct((1, 3, 64, 64), jnp.float32)))
    got = count_flops(tm, (1, 3, 64, 64))
    assert got["conv"] == ref["conv"]
    assert got["dot_general"] == ref["dot_general"]


def test_summary_matches_the_reference():
    """The same rows (layer, type, output shape, own parameters) in the
    same order, and the same counts; ``Model.summary`` too."""
    tm = _port("resnet18", num_classes=CLASSES).train()
    jm = _twin(tm, "resnet18", num_classes=CLASSES)
    jm.train()
    outs = []
    for fn, net in ((jsummary, jm), (summary, tm)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = fn(net, (2, 3, 32, 32))
        outs.append((res, buf.getvalue()))
    assert outs[0][0] == outs[1][0]
    assert outs[0][0]["total_params"] == sum(
        p.numel() for p in tm.parameters())
    assert outs[0][1] == outs[1][1]
    assert tm.training
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = hapi.Model(tm).summary((2, 3, 32, 32))
    assert res == outs[1][0]


def test_resnet_from_jax_loads_a_reference_state_dict():
    """A reference ResNet's ``state_dict()`` (parameters and buffers)
    loads by name, by depth or constructor name, buffers float32; the
    13 constructors build; ``pretrained=True`` raises."""
    tm = _port("resnet18", 14, num_classes=CLASSES)
    _random_statistics(tm, 15)
    jm = _twin(tm, "resnet18", num_classes=CLASSES)
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    assert any(k.endswith("._variance") for k in state)
    for ctor in (18, "resnet18", TR.resnet18):
        back = resnet_from_jax(state, ctor, device="cpu",
                               num_classes=CLASSES)
        assert not back.training
        for k, v in back.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), state[k])
    with pytest.raises(KeyError):
        resnet_from_jax({k: v for k, v in state.items()
                         if not k.endswith("_mean")}, 18, device="cpu",
                        num_classes=CLASSES)
    # each constructor asks for the reference's (block, depth, width,
    # groups): recorded instead of built (the largest has 127M parameters)
    calls = {}
    for mod in (TR, JR):
        def record(block, depth, width=64, num_classes=1000, with_pool=True,
                   groups=1, **kw):
            return (block.__name__, depth, width, groups)
        real = mod.ResNet
        mod.ResNet = record
        try:
            calls[mod] = {n: getattr(mod, n)() for n in TR.__all__[3:]}
        finally:
            mod.ResNet = real
    assert len(calls[TR]) == 13 and calls[TR] == calls[JR]
    with pytest.raises(ValueError):
        TR.resnet50(pretrained=True, device="cpu")
    with pytest.raises(RuntimeError):
        torch.cuda.is_available() or TR.resnet18()


def test_distributed_train_step_refuses_training_batch_norm():
    """Under ZeRO (or data parallelism) a training-mode BatchNorm would
    take per-rank statistics where the reference's cover the global
    batch: refused, naming A8; eval-mode BatchNorm or no ZeRO run."""
    from paddle_tpu_torch.distributed import init_mesh, set_mesh
    from paddle_tpu_torch.distributed.shard import DistributedTrainStep

    tm = _port("basic_1111", 16, num_classes=CLASSES)
    try:
        with pytest.raises(NotImplementedError, match="A8"):
            DistributedTrainStep(tm.train(), Momentum(0.1), mesh=init_mesh(),
                                 sharding_stage=1,
                                 loss_fn=lambda o, b: F.cross_entropy(o, b[1]))
        DistributedTrainStep(tm.eval(), Momentum(0.1), mesh=init_mesh(),
                             sharding_stage=1,
                             loss_fn=lambda o, b: F.cross_entropy(o, b[1]))
        step = DistributedTrainStep(
            tm.train(), Momentum(0.1), mesh=init_mesh(),
            loss_fn=lambda o, b: F.cross_entropy(o, b[1]))
        x, y = _batches(1, 17)[0]
        assert np.isfinite(float(step((x, y))))
    finally:
        set_mesh(None)

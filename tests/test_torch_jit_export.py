"""The port's deployment path (``paddle_tpu_torch.jit``, ``.inference``,
``.static``, the C API) against the JAX package's, on the CPU: a twin of
each of ``tests/test_jit_export.py``'s tests, run through both packages
on the same numpy inputs and weights, then the slice as a whole
(``gpt_tiny`` and a small ResNet saved by both packages and served by
both predictors), the JAX package's ``.pdiparams`` read by the port, and
the flash-attention forward as a registered operator (its CPU and fake
implementations, and a captured program that keeps it).

The JAX package cannot capture GPT with a dynamic length (its embedding
slice compares symbolic dims), so its GPT artifacts are one per length
with a dynamic batch; the port's is one artifact for both.

Tolerance: f32 rtol 1e-5 / atol 1e-6 between the packages (the
reference test's); a program against its own eager model is equal.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate_predictor
from paddle_tpu.jit import InputSpec as JInputSpec
from paddle_tpu.models import resnet as JR
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu.nn import initializer as JI

import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.convert import gpt_from_jax, layer_from_jax
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.jit import InputSpec, TranslatedLayer
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
NO_DROP = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)


def _small_net(pkg_nn):
    class SmallNet(pkg_nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pkg_nn.Linear(8, 16)
            self.fc2 = pkg_nn.Linear(16, 4)
            self.bn = pkg_nn.BatchNorm1D(16)
            self.drop = pkg_nn.Dropout(0.5)

        def forward(self, x):
            h = pkg_nn.functional.relu(self.bn(self.fc1(x)))
            return self.fc2(self.drop(h))

    return SmallNet()


def _state(jm):
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _pair(seed=0):
    """A reference SmallNet with non-trivial running statistics and the
    port's SmallNet carrying its state."""
    jpt.seed(seed)
    jm = _small_net(jnn)
    rng = np.random.default_rng(seed + 100)
    jm.set_state_dict({"bn._mean": jnp.asarray(rng.normal(0, 0.3, 16),
                                               jnp.float32),
                       "bn._variance": jnp.asarray(rng.uniform(0.5, 1.5, 16),
                                                   jnp.float32)})
    tm = layer_from_jax(_small_net(tnn), _state(jm))
    return jm, tm


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(t):
    return t.detach().float().cpu().numpy()


def _both_saved(tmp_path, jm, tm, specs, name="net"):
    jpath, tpath = str(tmp_path / "jax" / name), str(tmp_path / "torch" / name)
    jpt.jit.save(jm, jpath, input_spec=[JInputSpec(*s) for s in specs])
    tjit.save(tm, tpath, input_spec=[InputSpec(*s) for s in specs])
    return jpath, tpath


def test_save_load_value_parity(tmp_path):
    jm, tm = _pair()
    jm.eval()
    tm.eval()
    x = _x((4, 8))
    jpath, tpath = _both_saved(tmp_path, jm, tm, [((4, 8), "float32")])
    loaded = tjit.load(tpath, device="cpu")
    assert isinstance(loaded, TranslatedLayer)
    got = _np(loaded(_t(x)))
    want = _np(tm(_t(x)))
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jpt.jit.load(jpath)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, **TOL)


def test_save_captures_eval_mode(tmp_path):
    """Dropout is inert in the saved program although the layer was in
    training mode when saved; the mode is restored."""
    jm, tm = _pair()
    jm.train()
    tm.train()
    jpath, tpath = _both_saved(tmp_path, jm, tm, [((2, 8), "float32")])
    assert tm.training and jm.training
    x = np.ones((2, 8), np.float32)
    got = _np(tjit.load(tpath, device="cpu")(_t(x)))
    np.testing.assert_array_equal(got, _np(tm.eval()(_t(x))))
    ref = np.asarray(jpt.jit.load(jpath)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, **TOL)


def _two_dyn(pkg_nn):
    class TwoDyn(pkg_nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pkg_nn.Linear(8, 4)

        def forward(self, a, b):
            return self.fc(a) + self.fc(b)

    return TwoDyn()


def test_multi_dynamic_inputs_share_scope(tmp_path):
    """Two inputs with a dynamic batch share the one ``batch`` dim."""
    jpt.seed(1)
    jm = _two_dyn(jnn).eval()
    tm = layer_from_jax(_two_dyn(tnn), _state(jm))
    specs = [((None, 8), "float32"), ((None, 8), "float32")]
    jpath, tpath = _both_saved(tmp_path, jm, tm, specs)
    a, b = _x((5, 8), 1), _x((5, 8), 2)
    got = tjit.load(tpath, device="cpu")(_t(a), _t(b))
    assert got.shape == (5, 4)
    ref = jpt.jit.load(jpath)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    # a batch the two inputs disagree on is refused
    with pytest.raises(Exception):
        tjit.load(tpath, device="cpu")(_t(a), _t(_x((3, 8))))


def test_predictor_unset_input_clear_error(tmp_path):
    jm, tm = _pair()
    jpath, tpath = _both_saved(tmp_path, jm, tm, [((2, 8), "float32")])
    cfg = Config(tpath)
    cfg.disable_gpu()
    for predictor in (create_predictor(cfg), jcreate_predictor(
            JConfig(jpath))):
        # output handles are addressable before the first run
        assert predictor.get_output_names() == ["out0"]
        assert predictor.get_output_handle("out0").shape is None
        with pytest.raises(RuntimeError, match="inputs not set"):
            predictor.run()


def test_predictor_cpu_device_selection(tmp_path):
    jm, tm = _pair()
    jpath, tpath = _both_saved(tmp_path, jm, tm, [((2, 8), "float32")])
    config = Config(tpath)
    assert config.device == "cuda"    # the card by default
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_predictor(config)
    config.disable_gpu()
    predictor = create_predictor(config)
    assert predictor._layer._device == torch.device("cpu")
    x = np.ones((2, 8), np.float32)
    got = predictor.run([x])[0]
    np.testing.assert_array_equal(got, _np(tm.eval()(_t(x))))
    jc = JConfig(jpath)
    jc.disable_gpu()
    np.testing.assert_allclose(got, jcreate_predictor(jc).run([x])[0], **TOL)


def test_dynamic_batch_export(tmp_path):
    jm, tm = _pair()
    jpath, tpath = _both_saved(tmp_path, jm, tm, [((None, 8), "float32")])
    loaded, jloaded = tjit.load(tpath, device="cpu"), jpt.jit.load(jpath)
    for bs in (1, 3, 17):
        x = _x((bs, 8), bs)
        out = loaded(_t(x))
        assert out.shape == (bs, 4)
        np.testing.assert_allclose(_np(out), np.asarray(jloaded(
            jnp.asarray(x))), **TOL)


def test_translated_layer_state_dict_roundtrip(tmp_path):
    jm, tm = _pair()
    jpath, tpath = _both_saved(tmp_path, jm, tm, [((2, 8), "float32")])
    loaded, jloaded = tjit.load(tpath, device="cpu"), jpt.jit.load(jpath)
    sd = loaded.state_dict()
    # the reference's dot-free names, parameters then buffers
    assert list(sd) == list(jloaded.state_dict())
    x = np.ones((2, 8), np.float32)
    want = _np(loaded(_t(x)))
    zeroed = {k: torch.zeros_like(v) for k, v in sd.items()}
    loaded.set_state_dict(zeroed)
    assert not np.allclose(_np(loaded(_t(x))), want)
    loaded.set_state_dict(sd)
    np.testing.assert_allclose(_np(loaded(_t(x))), want, rtol=1e-6)
    # the same state gives the same program output in both packages
    jloaded.set_state_dict({k: jnp.asarray(_np(v)) for k, v in sd.items()})
    np.testing.assert_allclose(np.asarray(jloaded(jnp.asarray(x))), want,
                               **TOL)


def test_predictor_handle_api(tmp_path):
    jm, tm = _pair(1)
    x = _x((4, 8), 1)
    jpath, tpath = _both_saved(tmp_path, jm, tm, [((4, 8), "float32")])
    config = Config(tpath + ".pdmodel")
    config.disable_gpu()
    outs = {}
    for key, predictor in (("torch", create_predictor(config)),
                           ("jax", jcreate_predictor(JConfig(
                               jpath + ".pdmodel")))):
        names = predictor.get_input_names()
        assert len(names) == 1
        predictor.get_input_handle(names[0]).copy_from_cpu(x)
        outs[key] = predictor.run()
        h = predictor.get_output_handle(predictor.get_output_names()[0])
        np.testing.assert_array_equal(h.copy_to_cpu(), outs[key][0])
    np.testing.assert_array_equal(outs["torch"][0], _np(tm.eval()(_t(x))))
    np.testing.assert_allclose(outs["torch"][0], outs["jax"][0], **TOL)


def test_save_requires_input_spec(tmp_path):
    _, tm = _pair()
    with pytest.raises(ValueError):
        tjit.save(tm, str(tmp_path / "x"))
    with pytest.raises(ValueError):
        jpt.jit.save(_small_net(jnn), str(tmp_path / "y"))


def _two_in(pkg_nn):
    class TwoIn(pkg_nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pkg_nn.Linear(4, 2)

        def forward(self, a, b):
            return self.fc(a) + self.fc(b)

    return TwoIn()


def test_save_multi_input_and_example_arrays(tmp_path):
    jpt.seed(2)
    jm = _two_in(jnn).eval()
    tm = layer_from_jax(_two_in(tnn), _state(jm))
    a = np.ones((3, 4), np.float32)
    b = np.full((3, 4), 2.0, np.float32)
    jpt.jit.save(jm, str(tmp_path / "j"), input_spec=[jnp.asarray(a),
                                                     jnp.asarray(b)])
    tjit.save(tm, str(tmp_path / "t"), input_spec=[a, b])  # example arrays
    out = _np(tjit.load(str(tmp_path / "t"), device="cpu")(_t(a), _t(b)))
    np.testing.assert_array_equal(out, _np(tm(_t(a), _t(b))))
    ref = np.asarray(jpt.jit.load(str(tmp_path / "j"))(jnp.asarray(a),
                                                        jnp.asarray(b)))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.skipif(shutil.which("g++") is None or shutil.which("cc") is None,
                    reason="the C API builds with g++ and the demo with cc")
def test_c_api_consumer_matches_python_predictor(tmp_path):
    """The plain-C consumer (tools/torch_infer_demo.c, dlopen'ing the C
    inference API) reproduces the Python Predictor's outputs, and those of
    the reference's Predictor on the same weights."""
    from paddle_tpu_torch.inference import build_capi, build_demo

    jm, tm = _pair(4)
    jpath, tpath = _both_saved(tmp_path, jm, tm, [((2, 8), "float32")],
                               "cmodel")
    x = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
    cfg = Config(tpath)
    cfg.disable_gpu()
    ref = create_predictor(cfg).run([x])[0]
    lib, demo = build_capi(), build_demo()
    # the library and the demo live under build/native/, not in the tree
    for built in (lib, demo):
        assert os.path.dirname(built) == os.path.join(REPO, "build",
                                                      "native")
    inp = tmp_path / "input.bin"
    inp.write_bytes(x.tobytes())
    pkgs = [p for p in sys.path if "site-packages" in p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO] + pkgs),
               PT_INFER_DEVICE="cpu")
    proc = subprocess.run([demo, lib, tpath, str(inp), "2", "8"],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].split() == ["shape", "2", "4"]
    got = np.asarray([float(v) for v in lines[1:]], np.float32).reshape(2, 4)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, jcreate_predictor(JConfig(jpath)).run(
        [x])[0], **TOL)


# ------------------------------------------------------- the slice whole
def test_gpt_tiny_served_by_both_predictors(tmp_path):
    """gpt_tiny saved by both packages (the port's weights through
    ``gpt_from_jax``): the port's one artifact with a dynamic batch and
    length against the reference's, at two batch sizes and two lengths;
    the reference's ``.pdiparams`` read into the port's program."""
    jpt.seed(11)
    jm = JGPT(jgpt_tiny(**NO_DROP)).eval()
    tm = gpt_from_jax(_state(jm), gpt_tiny(**NO_DROP), device="cpu")
    tpath = str(tmp_path / "torch" / "gpt")
    tjit.save(tm, tpath, input_spec=[InputSpec([None, None], "int64")])
    cfg = Config(tpath)
    cfg.disable_gpu()
    pred = create_predictor(cfg)
    # the program holds no weights: they are its inputs, in .pdiparams
    assert pred._layer.program.example_inputs is None
    assert os.path.getsize(tpath + ".pdmodel") < \
        os.path.getsize(tpath + ".pdiparams") / 4
    rng = np.random.default_rng(5)
    for L in (16, 40):
        jpath = str(tmp_path / "jax" / f"gpt_L{L}")
        jpt.jit.save(jm, jpath, input_spec=[JInputSpec([None, L], "int32")])
        jpred = jcreate_predictor(JConfig(jpath))
        for B in (1, 3):
            ids = rng.integers(0, 1024, (B, L))
            got = pred.run([ids])[0]
            assert got.shape == (B, L, 1024)
            np.testing.assert_array_equal(got, _np(tm(_t(ids))))
            ref = jpred.run([ids.astype(np.int32)])[0]
            np.testing.assert_allclose(got, ref, **TOL)
    # the reference's parameter file, read as it is by the port's program
    shutil.copy(jpath + ".pdiparams", tpath + ".pdiparams")
    ids = rng.integers(0, 1024, (2, L))
    got = tjit.load(tpath, device="cpu")(_t(ids))
    np.testing.assert_allclose(_np(got), np.asarray(jpt.jit.load(jpath)(
        jnp.asarray(ids, jnp.int32))), **TOL)


def test_jax_pdiparams_load_into_port_program(tmp_path):
    """A ``.pdiparams`` the JAX package wrote gives the port's program of a
    model of the same class (other weights) the reference's output."""
    jm, _ = _pair(7)
    _, tm = _pair(8)           # another seed: other weights
    jpath, tpath = _both_saved(tmp_path, jm, tm, [((None, 8), "float32")])
    shutil.copy(jpath + ".pdiparams", tpath + ".pdiparams")
    x = _x((5, 8), 3)
    got = _np(tjit.load(tpath, device="cpu")(_t(x)))
    np.testing.assert_allclose(got, np.asarray(jpt.jit.load(jpath)(
        jnp.asarray(x))), **TOL)
    # and the port's own file round-trips bf16 as bf16, by its bits
    tm16 = _small_net(tnn).to(torch.bfloat16).eval()
    tjit.save(tm16, str(tmp_path / "bf16"),
              input_spec=[InputSpec((None, 8), "bfloat16")])
    loaded = tjit.load(str(tmp_path / "bf16"), device="cpu")
    for k, v in tm16.state_dict().items():
        flat = ("p_" if k in dict(tm16.named_parameters()) else "b_") + \
            k.replace(".", "__")
        assert loaded.state_dict()[flat].dtype == v.dtype
        assert torch.equal(loaded.state_dict()[flat], v)


def test_small_resnet_eval_with_running_statistics(tmp_path):
    """A small ResNet in eval mode with non-trivial running statistics:
    the reference's weights and buffers through ``resnet_from_jax``, both
    packages' predictors on one dynamic-batch artifact each."""
    from paddle_tpu_torch.convert import resnet_from_jax

    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        jm = JR.ResNet(JR.BasicBlock, [1, 1, 1, 1], num_classes=10)
    finally:
        JI.set_global_initializer(None, None)
    port = TR.ResNet(TR.BasicBlock, [1, 1, 1, 1], num_classes=10,
                     device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    state = {}
    for k, v in port.state_dict().items():
        a = v.numpy().copy()
        if k.endswith("_mean"):
            a = rng.normal(0, 0.2, a.shape).astype(np.float32)
        elif k.endswith("_variance"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        state[k] = a
    jm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    jm.eval()
    tm = resnet_from_jax(state, lambda **kw: TR.ResNet(
        TR.BasicBlock, [1, 1, 1, 1], **kw), device="cpu", num_classes=10)
    spec = [([None, 3, 32, 32], "float32")]
    jpath, tpath = _both_saved(tmp_path, jm, tm, spec, "resnet")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    cfg = Config(tpath)
    cfg.disable_gpu()
    pred, jpred = create_predictor(cfg), jcreate_predictor(JConfig(jpath))
    for B in (1, 4):
        x = _x((B, 3, 32, 32), B)
        got = pred.run([x])[0]
        np.testing.assert_array_equal(got, _np(tm(_t(x))))
        np.testing.assert_allclose(got, jpred.run([x])[0], **TOL)
    # capture and serving left the running statistics as they were
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_framework_jit_wrapper_twin():
    """``framework.jit.jit`` on a Layer and on a function: the port's
    eager wrapper against the reference's compiled one, on the same
    weights and inputs; it reads the Layer's current state, keeps the
    reference's attributes and counts its calls."""
    from paddle_tpu.framework.jit import jit as jjit
    from paddle_tpu_torch.framework.jit import jit as tjit_fn

    jm, tm = _pair(11)
    jm.eval()
    tm.eval()
    jw, tw = jjit(jm), tjit_fn(tm)
    assert tw.__wrapped_layer__ is tm
    assert tw.__cc_name__.startswith("jit:SmallNet")
    x = _x((5, 8))
    np.testing.assert_allclose(_np(tw(_t(x))), np.asarray(jw(jnp.asarray(x))),
                               **TOL)
    with torch.no_grad():   # the wrapper sees a changed weight
        tm.fc2.bias.add_(1.0)
    np.testing.assert_array_equal(_np(tw(_t(x))), _np(tm(_t(x))))
    assert tw.cache_stats() == {"calls": 2}

    def f(a, scale):
        return a * scale + 1.0

    jf = jjit(f, static_argnums=1)
    tf = tjit_fn(static_argnums=1)(f)
    assert tf.__name__ == "f" and tf.__cc_name__.startswith("jit:f")
    np.testing.assert_allclose(_np(tf(_t(x), 3.0)),
                               np.asarray(jf(jnp.asarray(x), 3.0)), **TOL)
    assert tf.cache_stats() == {"calls": 1}


# --------------------------------------- the forward as a registered op
def _qkv(B, H, L, D, fused: bool, seed=0):
    g = torch.Generator().manual_seed(seed)
    if fused:  # the GPT path's views of one [B, L, 3, H, D] tensor
        t = torch.randn(B, L, 3, H, D, generator=g)
        return tuple(t[:, :, i].transpose(1, 2) for i in range(3))
    return tuple(torch.randn(B, H, L, D, generator=g) for _ in range(3))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dropout_p,seed", [(0.0, 0), (0.25, 2 ** 64 - 3)])
def test_operator_cpu_and_fake_against_reference(fused, dropout_p, seed):
    from torch._subclasses.fake_tensor import FakeTensorMode

    q, k, v = _qkv(2, 4, 24, 64, fused)
    bias = torch.randn(1, 4, 24, 24)
    op = torch.ops.paddle_tpu_torch.flash_attention_fwd
    o, lse = op(q, k, v, bias, True, dropout_p, fa._int64_seed(seed))
    keep = (fa.dropout_mask(seed, 2, 4, 24, 24, dropout_p)
            if dropout_p else None)
    o_ref, lse_ref = fa.reference_attention_fwd(q, k, v, causal=True,
                                                bias=bias, keep_mask=keep)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    # the wrapper takes the seed as it is, above 2^63 included
    o2, _ = fa.flash_attention_fwd(q, k, v, causal=True, bias=bias,
                                   dropout_p=dropout_p, seed=seed)
    assert torch.equal(o2, o_ref)
    # O in q's row layout, as the kernel writes it; the fake says the same
    assert o.stride() == fa._empty_like_rows(q).stride()
    with FakeTensorMode() as mode:
        fq, fk, fv, fb = (mode.from_tensor(t) for t in (q, k, v, bias))
        fo, flse = op(fq, fk, fv, fb, True, dropout_p, fa._int64_seed(seed))
    assert fo.shape == o.shape and fo.stride() == o.stride()
    assert flse.shape == lse.shape and flse.stride() == lse.stride()
    assert flse.dtype == torch.float32 and fo.dtype == q.dtype
    assert fa._uint64_seed(fa._int64_seed(seed)) == seed


def test_operator_has_cuda_kernel_and_counts_only_there():
    name = "paddle_tpu_torch::flash_attention_fwd"
    assert torch._C._dispatch_has_kernel_for_dispatch_key(name, "CUDA")
    fa.reset_launch_counts()
    q, k, v = _qkv(1, 2, 16, 64, True)
    fa.flash_attention_fwd(q, k, v, causal=True)
    assert fa.flash_attention_fwd.launches == 0   # the plain version


def test_captured_program_keeps_the_operator(tmp_path):
    """gpt_tiny captured on the CPU holds one operator node a layer and
    no softmax (while exporting, the kernel gate admits any device, so the
    program launches the kernel once moved to the card), and its reloaded
    program equals the eager model, which runs the plain path, through the
    operator's CPU implementation. Two heads of 64: the kernels' smallest
    head dim."""
    tm = GPTForCausalLM(gpt_tiny(num_heads=2, **NO_DROP), device="cpu").eval()
    path = str(tmp_path / "gpt")
    program = tjit.save(tm, path, input_spec=[InputSpec([None, None],
                                                        "int64")])
    op = torch.ops.paddle_tpu_torch.flash_attention_fwd.default
    loaded = tjit.load(path, device="cpu")
    for graph in (program.graph, loaded.program.graph):
        nodes = [n for n in graph.nodes if n.op == "call_function"]
        assert sum(n.target is op for n in nodes) == tm.cfg.num_layers
        assert not any("softmax" in str(n.target) for n in nodes)
    ids = np.random.default_rng(0).integers(0, 1024, (2, 33))
    np.testing.assert_array_equal(_np(loaded(_t(ids))), _np(tm(_t(ids))))
    assert fa.flash_attention_fwd.launches == 0


def test_kernel_gate_admits_cpu_tensors_only_while_exporting(monkeypatch):
    q = torch.zeros(2, 16, 4, 64)
    assert not fa.should_use_flash(q, q, None, 0.0)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert fa.should_use_flash(q, q, None, 0.0)
    # what has no route stays plain while exporting too
    assert not fa.should_use_flash(q.double(), q.double(), None, 0.0)
    assert not fa.should_use_flash(q[..., :48], q[..., :48], None, 0.0)


def test_static_surface(tmp_path):
    """``static``: InputSpec is hapi's, ``data`` makes one, the inference
    model round trip is jit's, and the op-append machinery raises the
    migration error."""
    assert tstatic.InputSpec is tpt.hapi.InputSpec is tjit.InputSpec
    spec = tstatic.data("x", [None, 8])
    assert spec.shape == (None, 8) and spec.name == "x"
    jm, tm = _pair(9)
    tstatic.save_inference_model(str(tmp_path / "m"), [spec], tm)
    loaded = tstatic.load_inference_model(str(tmp_path / "m"), device="cpu")
    x = _x((3, 8))
    np.testing.assert_array_equal(_np(loaded(_t(x))), _np(tm.eval()(_t(x))))
    prog = tstatic.default_main_program()
    assert prog.clone(for_test=True) is prog
    with tstatic.program_guard(prog), tstatic.name_scope("a"):
        pass
    for call in (prog.global_block, lambda: tstatic.Executor().run(),
                 tstatic.CompiledProgram):
        with pytest.raises(NotImplementedError, match="torch"):
            call()

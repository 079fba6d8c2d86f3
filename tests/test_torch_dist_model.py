"""Multi-rank pipelined serving in the port (``paddle_tpu_torch.inference.
DistModel`` over ``paddle_tpu_torch.distributed.rpc``) against the JAX
package's, on the CPU: twins of ``tests/test_dist_model.py``'s three
tests. The stages carry the reference's weights (``layer_from_jax``); the
outputs must equal the port's single-process Predictor on the whole model
and agree with the reference's Predictor (f32 rtol 1e-5 / atol 1e-6).

The rpc store is a ``KVServer`` this process binds first (port 0) and
hands to every rank, so no other process can take its port between a
probe and the bind; every wait is bounded.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
from paddle_tpu.hapi.model import InputSpec as JInputSpec
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate_predictor
from paddle_tpu.jit import save as jjit_save

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.convert import layer_from_jax
from paddle_tpu_torch.distributed.launch.kv_server import KVServer
from paddle_tpu_torch.hapi import InputSpec
from paddle_tpu_torch.inference import (Config, DistModel, DistModelConfig,
                                        create_predictor, save_dist_model)
from paddle_tpu_torch.jit import save as jit_save

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
SPEC = [InputSpec([None, 8], dtype="float32")]


def _stages(nn):
    stage0 = nn.Sequential(nn.Linear(8, 32), nn.ReLU())
    stage1 = nn.Sequential(nn.Linear(32, 16), nn.ReLU(), nn.Linear(16, 4))
    return stage0, stage1, nn.Sequential(stage0, stage1)


def _build_stages():
    """The port's two stages and whole model, carrying the reference's
    seeded weights; and the reference's whole model."""
    jpt.seed(7)
    j0, j1, jfull = _stages(jnn)
    t0, t1, tfull = _stages(tnn)
    layer_from_jax(tfull, {k: np.asarray(v)
                           for k, v in jfull.state_dict().items()})
    return t0, t1, tfull, jfull


def _x():
    return np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32)


def _reference(tmp_path, jfull, x):
    path = str(tmp_path / "jax_full")
    jjit_save(jfull, path, input_spec=[JInputSpec([None, 8],
                                                  dtype="float32")])
    return jcreate_predictor(JConfig(path)).run([x])[0]


def _predictor(path):
    cfg = Config(path)
    cfg.disable_gpu()
    return create_predictor(cfg)


def test_save_dist_model_artifacts(tmp_path):
    stage0, stage1, full, _ = _build_stages()
    prefix = str(tmp_path / "dm")
    save_dist_model([stage0, stage1], prefix, input_spec=SPEC)
    for i in (0, 1):
        assert os.path.exists(f"{prefix}.stage{i}.pdmodel")
        assert os.path.exists(f"{prefix}.stage{i}.pdiparams")
    assert os.path.exists(prefix + ".distmeta.json")
    # stage 1's input spec came from stage 0's output: [None, 32]
    x = _x()
    h = _predictor(f"{prefix}.stage0").run([x])[0]
    assert h.shape == (6, 32)
    out = _predictor(f"{prefix}.stage1").run([h])[0]
    with torch.no_grad():
        np.testing.assert_array_equal(out, full(torch.from_numpy(x)).numpy())


def test_dist_model_single_rank_parity(tmp_path):
    """nranks=1 degenerates to the plain Predictor, micro-batching
    included."""
    stage0, stage1, full, jfull = _build_stages()
    prefix = str(tmp_path / "dm1")
    save_dist_model([tnn.Sequential(stage0, stage1)], prefix, input_spec=SPEC)
    jit_save(full, str(tmp_path / "full"), input_spec=SPEC)
    x = _x()
    ref = _predictor(str(tmp_path / "full")).run([x])
    np.testing.assert_allclose(ref[0], _reference(tmp_path, jfull, x), **TOL)
    kv = KVServer(0).start()
    try:
        dm = DistModel(DistModelConfig(
            model_prefix=prefix, rank=0, nranks=1,
            master_endpoint=f"127.0.0.1:{kv.port}", device="cpu",
            rpc_timeout=60.0))
        try:
            np.testing.assert_array_equal(dm.run([x])[0], ref[0])
            np.testing.assert_allclose(dm.run([x], num_micro=3)[0], ref[0],
                                       **TOL)
            # num_micro > batch clamps instead of making empty micro-batches
            np.testing.assert_allclose(dm.run([x], num_micro=50)[0], ref[0],
                                       **TOL)
        finally:
            dm.shutdown(timeout=30.0)
    finally:
        kv.stop()


RANK1 = textwrap.dedent("""
    import sys
    from paddle_tpu_torch.inference import DistModel, DistModelConfig
    dm = DistModel(DistModelConfig(model_prefix=sys.argv[1], rank=1,
                                   nranks=2, master_endpoint=sys.argv[2],
                                   device="cpu", rpc_timeout=60.0))
    dm.serve(timeout=120.0)
    print("RANK1_DONE", flush=True)
""")

RANK0 = textwrap.dedent("""
    import sys
    import numpy as np
    from paddle_tpu_torch.inference import (Config, DistModel,
                                            DistModelConfig, create_predictor)
    prefix, ep, full_prefix = sys.argv[1:4]
    x = np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32)
    cfg = Config(full_prefix)
    cfg.disable_gpu()
    ref = create_predictor(cfg).run([x])
    dm = DistModel(DistModelConfig(model_prefix=prefix, rank=0, nranks=2,
                                   master_endpoint=ep, device="cpu",
                                   rpc_timeout=60.0))
    out = dm.run([x])
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-5, atol=1e-6)
    # micro-batch amplification: 3 pipelined micro-batches, same result
    out_mb = dm.run([x], num_micro=3)
    np.testing.assert_allclose(out_mb[0], ref[0], rtol=1e-5, atol=1e-6)
    np.save(sys.argv[4], out[0])
    print("DIST_MODEL_OK", flush=True)
    dm.shutdown(timeout=120.0)
""")


def test_dist_model_two_process_parity(tmp_path):
    """Two processes, each loading only its stage: the output equals the
    single-process Predictor on the whole model and the reference's."""
    stage0, stage1, full, jfull = _build_stages()
    prefix = str(tmp_path / "dm2")
    full_prefix = str(tmp_path / "full2")
    save_dist_model([stage0, stage1], prefix, input_spec=SPEC)
    jit_save(full, full_prefix, input_spec=SPEC)
    out_path = str(tmp_path / "out.npy")
    kv = KVServer(0).start()
    ep = f"127.0.0.1:{kv.port}"
    env = dict(os.environ, PYTHONPATH=REPO)
    r1 = subprocess.Popen([sys.executable, "-c", RANK1, prefix, ep],
                          env=env, cwd=REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True)
    try:
        r0 = subprocess.run([sys.executable, "-c", RANK0, prefix, ep,
                             full_prefix, out_path], env=env, cwd=REPO,
                            capture_output=True, text=True, timeout=240)
        assert r0.returncode == 0, r0.stderr
        assert "DIST_MODEL_OK" in r0.stdout
        out1, err1 = r1.communicate(timeout=120)
        assert "RANK1_DONE" in out1, err1
    finally:
        if r1.poll() is None:  # failure path: don't leak the serving rank
            r1.kill()
            r1.communicate()
        kv.stop()
    np.testing.assert_allclose(np.load(out_path),
                               _reference(tmp_path, jfull, _x()), **TOL)

"""The port's public namespaces against the reference's: every public
name of ``paddle_tpu``, ``paddle_tpu.nn`` and ``paddle_tpu.distributed``
exists in ``paddle_tpu_torch``, ``paddle_tpu_torch.nn`` and
``paddle_tpu_torch.distributed``, except the names still to be ported,
and that list is the one ROADMAP.md keeps (between its ``not-yet-ported``
marks); ``paddle_tpu_torch.nn.functional`` has every public name of the
reference's.
Importing the port builds nothing and loads neither JAX nor the
reference.

The namespaces are read in a fresh interpreter: in a test process, what
other tests imported (``paddle_tpu.analysis``, ``paddle_tpu_torch.
serving``) shows up as attributes of the packages."""
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import paddle_tpu_torch

REPO = Path(__file__).resolve().parents[1]

# names the reference's namespace holds that are no API: implementation
# imports leaking through its star imports
NOT_API = {"annotations", "jax", "jnp", "np", "slice_builtin"}
# the same in ``nn.functional``: its typing and dtype helpers
NOT_API_F = NOT_API | {"Optional", "Sequence", "Tuple", "Union",
                       "convert_dtype"}

_READ = """
import json, sys
import paddle_tpu, paddle_tpu.nn, paddle_tpu_torch, paddle_tpu_torch.nn
import paddle_tpu.distributed, paddle_tpu_torch.distributed
pub = lambda m: sorted(n for n in dir(m) if not n.startswith("_"))
print(json.dumps({"ref": pub(paddle_tpu), "port": pub(paddle_tpu_torch),
                  "ref_nn": pub(paddle_tpu.nn),
                  "port_nn": pub(paddle_tpu_torch.nn),
                  "ref_f": pub(paddle_tpu.nn.functional),
                  "port_f": pub(paddle_tpu_torch.nn.functional),
                  "ref_dist": pub(paddle_tpu.distributed),
                  "port_dist": pub(paddle_tpu_torch.distributed)}))
"""


@functools.lru_cache(maxsize=None)
def _names():
    out = subprocess.run([sys.executable, "-c", _READ], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = json.loads(out.stdout.strip().splitlines()[-1])
    return {k: set(v) - NOT_API for k, v in names.items()}


def _roadmap_list(label):
    text = (REPO / "ROADMAP.md").read_text()
    block = text.split("<!-- not-yet-ported: begin -->")[1].split(
        "<!-- not-yet-ported: end -->")[0]
    line = next(l for l in block.splitlines()
                if l.startswith(f"- {label}:"))
    return set(re.findall(r"`([A-Za-z0-9_]+)`", line))


def test_top_level_names():
    n = _names()
    assert n["ref"] - n["port"] == _roadmap_list("top level")


def test_nn_names():
    n = _names()
    assert n["ref_nn"] - n["port_nn"] == _roadmap_list("nn")


def test_functional_names():
    n = _names()
    assert n["ref_f"] - n["port_f"] - NOT_API_F == set()


def test_distributed_names():
    n = _names()
    assert n["ref_dist"] - n["port_dist"] == _roadmap_list("distributed")


def test_distributed_binds_its_submodules_on_a_plain_import():
    code = ("import paddle_tpu_torch.distributed as d; "
            "print(d.load_state.__module__, d.FaultPlan.__name__, "
            "d.GraphTable.__name__, d.QueueDataset.__name__, "
            "d.rpc.__name__, d.checkpoint.__name__, d.ps.__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        "paddle_tpu_torch.distributed.checkpoint", "FaultPlan",
        "GraphTable", "QueueDataset", "paddle_tpu_torch.distributed.rpc",
        "paddle_tpu_torch.distributed.checkpoint",
        "paddle_tpu_torch.distributed.ps"]


def test_front_door_names():
    p = paddle_tpu_torch
    for name in ("to_tensor", "grad", "no_grad", "Tensor", "set_device",
                 "CPUPlace", "CUDAPlace", "float32", "bfloat16", "matmul",
                 "TrainStep", "save", "load", "seed"):
        assert hasattr(p, name), name
    assert p.nn.Layer is paddle_tpu_torch.nn.layer.Layer
    assert p.bool is p.bool_
    # serving stays lazy: not imported by the package, imported on use
    assert "serving" not in _names()["port"]
    assert p.serving.__name__ == "paddle_tpu_torch.serving"


def test_import_builds_and_loads_nothing_else():
    code = ("import sys, paddle_tpu_torch as p; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')), p.native._lib)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] None"

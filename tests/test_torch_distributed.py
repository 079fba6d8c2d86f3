"""The port's hybrid-parallel training (``paddle_tpu_torch.distributed``)
against the JAX package's, on the CPU.

Twins of ``tests/test_distributed.py`` (the collectives, data-parallel
loss parity, the TP layers, the TP step, ZeRO stages 1-3, gradient merge,
fleet) and the GPT/Llama cases: ``gpt_tiny`` at sdp = 2 with ZeRO-2 and
the overlap buckets, at sdp = 2 with ZeRO-3, at mp = 2 and at dp 2 x mp 2,
and ``llama_tiny`` with GQA at mp = 2.

The port runs in one world of four gloo ranks on loopback for the whole
file (``torch_world``: fresh interpreters that never import jax; a mesh
of two takes ranks 0 and 1). The reference runs in this process on the
same mesh shape, taken from its 8-device virtual CPU mesh, with the same
numpy weights and inputs. Tolerance: the reference's own, rtol 1e-4 and
atol 1e-5 (float32), on the losses, on SGD-trained parameters and on
the optimizer moments. Adam-trained parameters are held to 3e-4
absolute instead, under a third of one step at lr 1e-3: Adam divides
each gradient element by its own running RMS, so an element whose
gradient is as small as its float32 rounding error takes a different
step on the two sides (up to 1.2e-4 after five steps here).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import distributed as jdist
from paddle_tpu.distributed import collective as JC
from paddle_tpu.distributed.mesh import init_mesh as jinit_mesh
from paddle_tpu.distributed.mesh import set_mesh as jset_mesh
from paddle_tpu.distributed.parallel.mp_layers import (
    ColumnParallelLinear as JCol, RowParallelLinear as JRow,
    VocabParallelEmbedding as JVocab)
from paddle_tpu.framework.jax_compat import shard_map
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as jllama_tiny
from paddle_tpu import optimizer as jopt

from torch_world import World
from torch_threads import few_torch_threads  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
ADAM_ATOL = 3e-4
NO_DROP = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
               use_flash_attention=False)


@pytest.fixture(scope="module")
def world():
    w = World(4, timeout=150)
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _no_jax_mesh():
    yield
    jset_mesh(None)


def _state(layer):
    return {k: np.asarray(v) for k, v in layer.state_dict().items()}


def _close(got, want, what="", atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=atol, err_msg=what)


def _jax_run(model, opt, mesh_shape, batches, loss_fn=None, **kw):
    """The reference's DistributedTrainStep on ``mesh_shape`` (taken from
    the first devices of the 8-device mesh): its losses, full params and
    optimizer moments."""
    mesh = jinit_mesh(dict(mesh_shape))
    step = jdist.DistributedTrainStep(model, opt, loss_fn=loss_fn,
                                      mesh=mesh, **kw)
    losses = [float(step(b)) for b in batches]
    params = {k: np.asarray(v) for k, v in step.params.items()}
    opt_state = {slot: {k: np.asarray(v) for k, v in val.items()}
                 for slot, val in step.opt_state.items()
                 if isinstance(val, dict)}
    jset_mesh(None)
    return losses, params, opt_state


def _compare(port, losses, params, opt_state=None, param_atol=ATOL):
    _close(port["losses"], losses, "losses")
    assert port["params"].keys() == params.keys()
    for k in params:
        _close(port["params"][k], params[k], k, atol=param_atol)
    for slot, vals in (opt_state or {}).items():
        for k, v in vals.items():
            _close(port["opt_state"][slot][k], v, f"{slot}/{k}")


# ------------------------------------------------------------ collectives
@pytest.fixture(scope="module")
def collective_results(world):
    return world.run("collectives", 4)


def _ref_blocks(fn, x, n=4, in_spec=JP("dp"), out_spec=JP("dp")):
    mesh = jinit_mesh(dp=n)
    out = np.asarray(shard_map(fn, mesh=mesh, in_specs=in_spec,
                               out_specs=out_spec)(jnp.asarray(x)))
    jset_mesh(None)
    return np.split(out, n)


def test_collective_allreduce(collective_results):
    x = np.arange(4.0, dtype=np.float32)
    for op, key in ((JC.ReduceOp.SUM, "all_reduce"),
                    (JC.ReduceOp.MAX, "all_reduce_max"),
                    (JC.ReduceOp.AVG, "all_reduce_avg")):
        want = _ref_blocks(lambda v: JC.all_reduce(v, op=op, group="dp"), x)
        for r in range(4):
            np.testing.assert_allclose(collective_results[r][key], want[r],
                                       rtol=1e-6, err_msg=key)


def test_collective_allgather_alltoall(collective_results):
    g = _ref_blocks(lambda v: JC.all_gather(v, group="dp", axis=0),
                    np.arange(8.0).reshape(4, 2), in_spec=JP("dp", None),
                    out_spec=JP("dp", None))
    a = _ref_blocks(lambda v: JC.alltoall(v, group="dp", split_axis=1,
                                          concat_axis=1),
                    np.arange(16.0).reshape(4, 4), in_spec=JP("dp", None),
                    out_spec=JP("dp", None))
    for r in range(4):
        np.testing.assert_array_equal(collective_results[r]["all_gather"],
                                      g[r])
        np.testing.assert_array_equal(collective_results[r]["alltoall"],
                                      a[r])


def test_collective_broadcast_ppermute(collective_results):
    x = np.arange(4.0, dtype=np.float32)
    b = _ref_blocks(lambda v: JC.broadcast(v, src=3, group="dp"), x)
    right = _ref_blocks(lambda v: JC.shift_right(v, group="dp"), x)
    left = _ref_blocks(lambda v: JC.shift_left(v, group="dp"), x)
    for r in range(4):
        res = collective_results[r]
        np.testing.assert_array_equal(res["broadcast"], b[r])
        np.testing.assert_array_equal(res["shift_right"], right[r])
        np.testing.assert_array_equal(res["shift_left"], left[r])
        assert res["axis_index"] == r and res["axis_size"] == 4


def test_reduce_scatter(collective_results):
    want = _ref_blocks(lambda v: JC.reduce_scatter(v, group="dp"),
                       np.ones((4, 4), np.float32), in_spec=JP(None, None),
                       out_spec=JP("dp", None))
    for r in range(4):
        np.testing.assert_array_equal(
            collective_results[r]["reduce_scatter"], want[r])
        # AVG of (r + 1) over 4 ranks
        np.testing.assert_allclose(
            collective_results[r]["reduce_scatter_avg"],
            np.full((1, 4), 2.5))


def test_all_reduce_buckets_matches_mapped_all_reduce(collective_results):
    for r in range(4):
        for got, want in zip(collective_results[r]["buckets"],
                             collective_results[r]["mapped"]):
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ DP parity
class JMLP(jnn.Layer):
    def __init__(self, sizes=(16, 32, 4)):
        super().__init__()
        self._n = len(sizes) - 1
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            setattr(self, f"fc{i + 1}", jnn.Linear(a, b))

    def forward(self, x):
        for i in range(1, self._n):
            x = JF.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self._n}")(x)


def _jmlp(seed, sizes=(16, 32, 4)):
    pt.seed(seed)
    return JMLP(sizes)


def _clone(model, sizes=(16, 32, 4)):
    other = JMLP(sizes)
    other.set_state_dict(model.state_dict())
    return other


def test_data_parallel_loss_parity(world):
    """The TestDistBase pattern: the distributed loss (dp = 4 ranks)
    equals the single-device loss and the reference's distributed one."""
    model = _jmlp(0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    y = rng.integers(0, 4, (32,))
    loss_fn = lambda out, b: JF.cross_entropy(out, b[1])  # noqa: E731
    single = pt.TrainStep(_clone(model), jopt.SGD(learning_rate=0.1),
                          loss_fn=loss_fn)
    single_losses = [float(single((x, y))) for _ in range(5)]
    losses, params, _ = _jax_run(_clone(model), jopt.SGD(learning_rate=0.1),
                                 {"dp": 4}, [(x, y)] * 5, loss_fn=loss_fn)
    job = dict(kind="mlp", state=_state(model), mesh={"dp": 4},
               opt=("SGD", {"learning_rate": 0.1}), loss="ce",
               batches=[(x, y)] * 5)
    res = world.run("train", job)
    _compare(res[0], losses, params)
    _close(res[0]["losses"], single_losses, "single-device losses")
    for r in range(1, 4):     # every rank reports the global loss
        assert res[r]["losses"] == res[0]["losses"]


# ------------------------------------------------------------ TP layers
def _tp_layer_states():
    pt.seed(3)
    col = JCol(16, 32, gather_output=False)
    row = JRow(32, 16, input_is_parallel=True)
    emb = JVocab(64, 16)
    return col, row, emb


@pytest.fixture(scope="module")
def tp_layer_results(world):
    col, row, emb = _tp_layer_states()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    ids = rng.integers(0, 64, (4, 8))
    res = world.run("tp_layers", {"dp": 2, "mp": 2}, _state(col),
                    _state(row), _state(emb), x, ids)
    return col, row, emb, x, ids, res


def test_tensor_parallel_layers(tp_layer_results):
    col, row, emb, x, ids, res = tp_layer_results
    wc, bc = np.asarray(col.weight), np.asarray(col.bias)
    wr, br = np.asarray(row.weight), np.asarray(row.bias)
    ref = (x @ wc + bc) @ wr + br

    def loss(p):
        h = x @ p["col.weight"] + p["col.bias"]
        return jnp.sum((h @ p["row.weight"] + p["row.bias"]) ** 2)

    grads = jax.grad(loss)({"col.weight": wc, "col.bias": bc,
                            "row.weight": wr, "row.bias": br})
    for r in range(4):
        out = res[r]
        np.testing.assert_allclose(out["out"], ref, rtol=1e-4, atol=1e-4)
        for k, g in grads.items():
            np.testing.assert_allclose(out["grads"][k], np.asarray(g),
                                       rtol=1e-4, atol=1e-3, err_msg=k)
        # the declared specs, and each rank's block of them
        assert out["specs"]["col.weight"] == (None, "mp")
        assert out["specs"]["row.weight"] == ("mp", None)
        assert out["local"] == {"col.weight": (16, 16), "col.bias": (16,),
                                "row.weight": (16, 16), "row.bias": (16,)}
    specs = jdist.param_specs(col, jinit_mesh(dp=2, mp=4))
    assert specs["weight"] == JP(None, "mp")


def test_vocab_parallel_embedding(tp_layer_results):
    _, _, emb, _, ids, res = tp_layer_results
    ref = np.asarray(emb.weight)[ids]
    for r in range(4):
        np.testing.assert_allclose(res[r]["emb"], ref, rtol=1e-6)
        assert res[r]["emb_local"] == (32, 16)


def test_vocab_parallel_cross_entropy(world):
    """The vocab-parallel softmax over mp = 4 slices of the logits against
    the reference's ``cross_entropy`` (ignore_index included) and its
    gradient."""
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 5, 32)) * 4).astype(np.float32)
    labels = rng.integers(0, 32, (3, 5))
    labels[0, :2] = -100

    def loss(z):
        return JF.cross_entropy(z, jnp.asarray(labels), reduction="none",
                                ignore_index=-100)

    want = np.asarray(loss(jnp.asarray(logits)))
    grad = np.asarray(jax.grad(lambda z: jnp.mean(loss(z)))(
        jnp.asarray(logits)))
    res = world.run("vocab_ce", {"mp": 4}, logits, labels)
    for r in range(4):
        np.testing.assert_allclose(res[r]["loss"], want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res[r]["grad"], grad, rtol=1e-5,
                                   atol=1e-6)


class JTPNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.col = JCol(16, 64, gather_output=False)
        self.row = JRow(64, 16, input_is_parallel=True)

    def forward(self, x):
        return self.row(JF.relu(self.col(x)))


def test_distributed_step_with_tp(world):
    """DP x MP hybrid: mp layers inside a DistributedTrainStep at dp 2 x
    mp 2, eleven Adam steps, against the reference's step on the same
    mesh."""
    pt.seed(5)
    model = JTPNet()
    state = _state(model)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.standard_normal((8, 16)).astype(np.float32)
    batches = [(x, y)] * 11
    losses, params, moments = _jax_run(
        model, jopt.Adam(learning_rate=1e-2), {"dp": 2, "mp": 2}, batches,
        loss_fn=lambda o, b: JF.mse_loss(o, b[1]))
    job = dict(kind="tpnet", state=state, mesh={"dp": 2, "mp": 2},
               opt=("Adam", {"learning_rate": 1e-2}), loss="mse",
               batches=batches)
    res = world.run("train", job)
    _compare(res[0], losses, params, moments, param_atol=ADAM_ATOL)
    assert res[0]["losses"][-1] < res[0]["losses"][0]
    assert res[0]["specs"]["col.weight"] == ((None, "mp"), 1)
    assert res[0]["local_params"]["col.weight"] == (16, 32)


# ------------------------------------------------------------ ZeRO stages
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_sharding_stages(world, stage):
    """ZeRO over sdp = 4: losses, parameters and moments equal the
    reference's; the moments (and at stage 3 the parameters) are stored
    as sdp shards."""
    sizes = (64, 1024, 64)
    model = _jmlp(7, sizes)
    state = _state(model)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    y = rng.standard_normal((16, 64)).astype(np.float32)
    batches = [(x, y)] * 3
    losses, params, moments = _jax_run(
        model, jopt.Adam(learning_rate=1e-3), {"sdp": 4}, batches,
        loss_fn=lambda o, b: JF.mse_loss(o, b[1]), batch_axes=("sdp",),
        sharding_stage=stage)
    job = dict(kind="mlp", cfg={"sizes": sizes}, state=state,
               mesh={"sdp": 4}, opt=("Adam", {"learning_rate": 1e-3}),
               loss="mse", batches=batches,
               step={"batch_axes": ("sdp",), "sharding_stage": stage})
    res = world.run("train", job)
    _compare(res[0], losses, params, moments, param_atol=ADAM_ATOL)
    for r in range(4):
        out = res[r]
        # fc1.weight [64, 1024]: the moments split dim 0 over sdp (the
        # first free dim); at stage 3 the parameter is split on its
        # largest dim, and its moments follow it there
        want = (64, 256) if stage >= 3 else (16, 1024)
        assert out["local_opt"]["moment1"]["fc1.weight"] == want
        want = (64, 256) if stage >= 3 else (64, 1024)
        assert out["local_params"]["fc1.weight"] == want
        assert out["statusz"]["sharding_stage"] == stage


# ------------------------------------------------------------ gradient merge
def test_gradient_merge_matches_big_batch(world):
    """k_steps=4 on batch B == one step on batch 4B (SGD, avg=True), at
    dp = 4, and both equal the reference's."""
    model = _jmlp(11)
    state = _state(model)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((32, 16)).astype(np.float32)
    y = rng.integers(0, 4, (32,))
    quarters = [(x[i * 8:(i + 1) * 8], y[i * 8:(i + 1) * 8])
                for i in range(4)]
    loss_fn = lambda out, b: JF.cross_entropy(out, b[1])  # noqa: E731
    _, ref_params, _ = _jax_run(_clone(model), jopt.SGD(learning_rate=0.1),
                                {"dp": 4}, quarters, loss_fn=loss_fn,
                                grad_accum_steps=4)
    base = dict(kind="mlp", state=state, mesh={"dp": 4},
                opt=("SGD", {"learning_rate": 0.1}), loss="ce")
    merged = world.run("train", dict(base, batches=quarters,
                                     step={"grad_accum_steps": 4}))[0]
    big = world.run("train", dict(base, batches=[(x, y)]))[0]
    for k in ref_params:
        np.testing.assert_allclose(merged["params"][k], big["params"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        _close(merged["params"][k], ref_params[k], k)


# ------------------------------------------------------------ fleet
def test_fleet_init_and_hcg_and_gradient_merge_wiring(world):
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.fleet import DistributedStrategy

    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 1}
    mesh = jfleet.init(is_collective=True, strategy=s)
    hcg = jfleet.get_hybrid_communicate_group()
    res = world.run("fleet_hcg", s.hybrid_configs,
                    {"k_steps": 3, "avg": False})
    for r, out in enumerate(res):
        assert out["shape"] == {"dp": 2, "mp": 2} == dict(mesh.shape)
        assert out["mp"] == hcg.get_model_parallel_world_size() == 2
        assert out["dp"] == hcg.get_data_parallel_world_size() == 2
        assert (out["dp_rank"], out["mp_rank"]) == divmod(r, 2)
        assert out["nranks"] == 4 and out["worker_num"] == 4
        assert out["worker_index"] == r and out["first"] == (r == 0)
        assert out["merge"] == (3, False)
    jfleet._fleet_state.update(strategy=None)


def test_fleet_ps_functions_raise():
    # the parameter-server mode is ported: the five functions drive the PS
    # context as the reference's do, and none of them raises any more
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.ps import get_ps_context

    ctx = get_ps_context()
    assert fleet.init_server() is ctx and ctx._running
    assert fleet.run_server() is ctx
    fleet.init_worker()
    fleet.stop_worker()
    assert not ctx._running
    assert not hasattr(fleet, "_ps_not_ported")


# ------------------------------------------------------------ GPT / Llama
def _gpt_state(**kw):
    pt.seed(11)
    cfg = {**NO_DROP, **kw}
    return JGPT(jgpt_tiny(**cfg)), cfg


def _ids(seed, shape=(4, 32), vocab=1024):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("mesh,step", [
    ({"sdp": 2}, {"sharding_stage": 2, "overlap_grad_reduce": True,
                  "bucket_size_mb": 0.25}),
    ({"sdp": 2}, {"sharding_stage": 3}),
    ({"mp": 2}, {}),
    ({"dp": 2, "mp": 2}, {}),
], ids=["sdp2_zero2_overlap", "sdp2_zero3", "mp2", "dp2_mp2"])
def test_gpt_tiny_hybrid_parity(world, mesh, step):
    """``gpt_tiny`` trained 5 AdamW steps on the port's mesh against the
    reference's DistributedTrainStep on the same mesh shape: losses,
    gathered parameters and moments."""
    jm, cfg = _gpt_state(loss_chunk=16)
    state = _state(jm)
    batches = [(_ids(i), _ids(i)) for i in range(5)]
    losses, params, moments = _jax_run(
        jm.train(), jopt.AdamW(learning_rate=1e-3), mesh, batches,
        sharding_stage=step.get("sharding_stage", 0))
    job = dict(kind="gpt", cfg=cfg, state=state, mesh=mesh,
               opt=("AdamW", {"learning_rate": 1e-3}), batches=batches,
               step=step)
    res = world.run("train", job)
    _compare(res[0], losses, params, moments, param_atol=ADAM_ATOL)
    n = int(np.prod(list(mesh.values())))
    assert all(r is None for r in res[n:])    # ranks off the mesh idle
    if "mp" in mesh:
        # whole heads per rank: qkv [h, 3h] keeps 3 blocks of h/mp
        assert res[0]["specs"]["gpt.h.0.attn.qkv_proj.weight"] == (
            (None, "mp"), 3)
        assert res[0]["local_params"]["gpt.h.0.attn.qkv_proj.weight"] == (
            128, 192)
        assert res[0]["local_params"][
            "gpt.embeddings.word_embeddings.weight"] == (512, 128)


@pytest.mark.parametrize("recompute", [False, True],
                         ids=["plain", "recompute"])
def test_zero3_gathers_each_block_on_use(world, recompute):
    """ZeRO-3 holds a decoder block's parameters whole only while it
    runs: in the forward, block i alone; in the backward (a recomputed
    forward included), block i and at most the block after it (freed as
    its last gradient lands); after the step, none. The losses and
    parameters of this ``gpt_tiny`` (4 layers at hidden 256, so that the
    blocks' matrices reach the stage's 2**16-element threshold) still
    match the reference's ZeRO-3 step."""
    jm, cfg = _gpt_state(loss_chunk=16, num_layers=4, hidden_size=256,
                         use_recompute=recompute)
    state = _state(jm)
    batches = [(_ids(i), _ids(i)) for i in range(3)]
    losses, params, _ = _jax_run(
        jm.train(), jopt.AdamW(learning_rate=1e-3), {"sdp": 2}, batches,
        sharding_stage=3)
    job = dict(kind="gpt", cfg=cfg, state=state, mesh={"sdp": 2},
               opt=("AdamW", {"learning_rate": 1e-3}), batches=batches,
               step={"sharding_stage": 3})
    res = world.run("zero3_residency", job)[0]
    _compare(res, losses, params, param_atol=ADAM_ATOL)
    assert any(k.startswith("gpt.h.3.") for k in res["stored"])
    steps, cur = [], []
    for ev in res["events"]:
        if ev[0] == "after":
            steps.append((cur, ev[2]))
            cur = []
        else:
            cur.append(ev)
    assert len(steps) == len(batches)
    for events, after in steps:
        assert events[:4] == [("fwd", i, [i]) for i in range(4)]
        backward = events[4:]
        assert any(ev == "grad" for ev, _, _ in backward)
        assert recompute == any(ev == "fwd" for ev, _, _ in backward)
        assert {i for _, i, held in backward if i in held} == {0, 1, 2, 3}
        for _, i, held in backward:   # the last gradient of i sees i freed
            assert set(held) <= {i, i + 1}, (i, held)
        assert after == []


def test_llama_tiny_gqa_mp2_parity(world):
    """``llama_tiny`` (4 heads, 2 KV heads) at mp = 2: each rank holds 2
    query heads and 1 KV head."""
    pt.seed(13)
    cfg = dict(use_flash_attention=False, loss_chunk=16)
    jm = JLlama(jllama_tiny(**cfg))
    state = _state(jm)
    batches = [(_ids(20 + i), _ids(20 + i)) for i in range(5)]
    losses, params, moments = _jax_run(
        jm.train(), jopt.AdamW(learning_rate=1e-3), {"mp": 2}, batches)
    job = dict(kind="llama", cfg=cfg, state=state, mesh={"mp": 2},
               opt=("AdamW", {"learning_rate": 1e-3}), batches=batches)
    res = world.run("train", job)
    _compare(res[0], losses, params, moments, param_atol=ADAM_ATOL)
    local = res[0]["local_params"]
    assert local["model.layers.0.self_attn.k_proj.weight"] == (128, 32)
    assert local["model.layers.0.self_attn.q_proj.weight"] == (128, 64)


def test_llama_kv_heads_must_split_over_mp(world):
    pt.seed(13)
    cfg = dict(use_flash_attention=False, num_kv_heads=1)
    jm = JLlama(jllama_tiny(**cfg))
    job = dict(kind="llama", cfg=cfg, state=_state(jm), mesh={"mp": 2},
               opt=("AdamW", {"learning_rate": 1e-3}), batches=[])
    res = world.run("train_error", job)
    for r in (0, 1):
        assert res[r].startswith("ValueError") and "num_kv_heads" in res[r]


# ------------------------------------------------------------ the port's own
def test_ranks_never_import_jax(world):
    assert world.run("loaded_modules") == [[]] * 4


def test_dropout_replays_bit_exact_on_each_rank(world):
    """At p > 0 the masks are the port's own (dp ranks fold their batch
    index into the step's seed): a fixed seed replays bit for bit on
    every rank of dp 2 x mp 2."""
    jm, cfg = _gpt_state(loss_chunk=16)
    cfg = dict(cfg, hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    job = dict(kind="gpt", cfg=cfg, state=_state(jm), mesh={"dp": 2, "mp": 2},
               opt=("AdamW", {"learning_rate": 1e-3}),
               batches=[(_ids(i), _ids(i)) for i in range(3)])
    a = world.run("train", job)
    b = world.run("train", job)
    for r in range(4):
        assert a[r]["losses"] == b[r]["losses"]
        for k, v in a[r]["params"].items():
            np.testing.assert_array_equal(v, b[r]["params"][k], err_msg=k)
    nodrop = world.run("train", dict(job, cfg=dict(cfg, **NO_DROP)))
    assert a[0]["losses"][1:] != nodrop[0]["losses"][1:]


def test_global_norm_clip_over_shards(world):
    """ClipGradByGlobalNorm at dp 2 x mp 2 sums each gradient shard's
    squares once over the ranks: the clipped trajectory equals the
    reference's."""
    from paddle_tpu.nn import clip as jclip

    pt.seed(5)
    model = JTPNet()
    state = _state(model)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.standard_normal((8, 16)).astype(np.float32)
    batches = [(x, y)] * 4
    losses, params, moments = _jax_run(
        model, jopt.AdamW(learning_rate=1e-2,
                          grad_clip=jclip.ClipGradByGlobalNorm(0.05)),
        {"dp": 2, "mp": 2}, batches,
        loss_fn=lambda o, b: JF.mse_loss(o, b[1]))
    job = dict(kind="tpnet", state=state, mesh={"dp": 2, "mp": 2},
               opt=("AdamW", {"learning_rate": 1e-2, "clip_norm": 0.05}),
               loss="mse", batches=batches)
    _compare(world.run("train", job)[0], losses, params, moments,
             param_atol=ADAM_ATOL)


def test_o2_bf16_zero2_against_the_reference(world):
    """bf16 O2 (bf16 parameters, float32 masters sharded with the
    moments) at sdp = 2 with ZeRO-2: the losses within 2e-2 relative of
    the reference's O2 step, as ``test_torch_train.py`` holds bf16."""
    from paddle_tpu import amp as jamp

    jm, cfg = _gpt_state(loss_chunk=16)
    state = _state(jm)
    batches = [(_ids(i), _ids(i)) for i in range(3)]
    jm, jo = jamp.decorate(jm.train(), jopt.AdamW(learning_rate=1e-3),
                           level="O2")
    losses, _, _ = _jax_run(jm, jo, {"sdp": 2}, batches, sharding_stage=2)
    job = dict(kind="gpt", cfg=cfg, state=state, mesh={"sdp": 2},
               opt=("AdamW", {"learning_rate": 1e-3}), o2=True,
               batches=batches, step={"sharding_stage": 2})
    res = world.run("train", job)[0]
    np.testing.assert_allclose(res["losses"], losses, rtol=2e-2)
    assert res["local_opt"]["master_weights"][
        "gpt.h.0.mlp.fc_in.weight"] == (64, 512)


def test_world_of_one_equals_train_step():
    """Without a world the mesh is one rank: DistributedTrainStep then
    takes the same steps as TrainStep, bit for bit."""
    import torch
    from paddle_tpu_torch.distributed import init_mesh, set_mesh
    from paddle_tpu_torch.distributed.shard import DistributedTrainStep
    from paddle_tpu_torch.framework import random as trandom
    from paddle_tpu_torch.framework.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.optimizer import AdamW

    ids = _ids(0, (2, 16))
    runs = []
    for dist_step in (False, True):
        trandom.seed(0)
        m = GPTForCausalLM(gpt_tiny(num_layers=1), device="cpu").train()
        if dist_step:
            mesh = init_mesh()
            step = DistributedTrainStep(m, AdamW(learning_rate=1e-3),
                                        mesh=mesh)
            with pytest.raises(NotImplementedError, match="A8"):
                step.enable_integrity()
        else:
            step = TrainStep(m, AdamW(learning_rate=1e-3))
        runs.append(([float(step((ids, ids))) for _ in range(3)],
                     {k: v.detach().clone() for k, v in
                      m.named_parameters()}))
        set_mesh(None)
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_init_parallel_env_needs_a_working_nccl(monkeypatch):
    """NCCL (the default off the CPU) without a CUDA device raises; it is
    never swapped for gloo."""
    import torch
    import torch.distributed as tdist
    from paddle_tpu_torch.distributed import env

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        env.init_parallel_env(backend="nccl", device="cuda")
    with pytest.raises(RuntimeError, match="NCCL"):
        env.init_parallel_env()
    assert not tdist.is_initialized()


def test_supervisor_drives_the_distributed_step(tmp_path):
    """``TrainingSupervisor`` takes a DistributedTrainStep as it takes
    TrainStep: the guarded call, the anomaly count, a checkpoint of the
    gathered state and its restore (a world of one)."""
    import torch
    from paddle_tpu_torch.distributed import init_mesh, set_mesh
    from paddle_tpu_torch.distributed.shard import DistributedTrainStep
    from paddle_tpu_torch.framework import random as trandom
    from paddle_tpu_torch.framework.supervisor import (RecoveryPolicy,
                                                       TrainingSupervisor)
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch.optimizer import AdamW

    trandom.seed(0)
    m = GPTForCausalLM(gpt_tiny(num_layers=1, **NO_DROP), device="cpu")
    step = DistributedTrainStep(m.train(), AdamW(learning_rate=1e-3),
                                mesh=init_mesh(), sharding_stage=1)
    sup = TrainingSupervisor(step, RecoveryPolicy(
        checkpoint_dir=str(tmp_path), save_interval_steps=10 ** 6,
        check_interval=1, max_consecutive=3, async_save=False)).start()
    try:
        batch = (_ids(0, (2, 16)), _ids(0, (2, 16)))
        for i in range(2):
            sup.before_batch()
            loss, ok, found = step.watchdog_call(batch)
            sup.after_batch(0, i, loss, ok, found)
        sup.save_now()
        saved = step.full_params()
        step.inject_anomaly()
        loss, ok, found = step.watchdog_call(batch)
        assert not bool(ok)
        sup.after_batch(0, 2, loss, ok, found)
        assert sup.watchdog.anomalies == 1
        step(batch)
        assert not all(torch.equal(v, saved[k])
                       for k, v in step.full_params().items())
        sup.restore()
        assert step._count == 2
        for k, v in step.full_params().items():
            assert torch.equal(v, saved[k]), k
    finally:
        sup.stop()
        set_mesh(None)

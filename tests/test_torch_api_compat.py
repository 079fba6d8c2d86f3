"""The port's distributed API long tail (``paddle_tpu_torch.distributed.
api_compat`` and ``stream``) against the JAX package's, on the CPU.

Twins of ``tests/test_distributed_compat.py``: groups (the port's are
real ``torch.distributed`` groups, made collectively), ``ParallelEnv``,
every P2P form over the world's backend (the reference's go through an
rpc mailbox), ``reduce``'s zeros off ``dst``, ``scatter``'s chunk, the
uneven ``alltoall_single`` refused, ``all_gather_object``, the stream
variants, ``group_sharded_parallel`` at each level training ``gpt_tiny``
at sdp = 2 to the reference's losses and parameters for the same stage,
``save_group_sharded_model`` read by the reference's ``framework.io.
load``, the entry configs and ``split``'s refusal.

The port runs in a world of two gloo ranks (``torch_world``: fresh
interpreters that never import jax); the reference in this process on
two of its eight virtual CPU devices, with the same numpy inputs and
weights. Tolerances: the collectives and transfers are exact; training
as ``tests/test_torch_distributed.py`` holds it (rtol 1e-4, atol 1e-5 on
the losses, 3e-4 absolute on Adam-trained parameters).
"""
import os

import numpy as np
import pytest

import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.mesh import init_mesh as jinit_mesh
from paddle_tpu.distributed.mesh import set_mesh as jset_mesh
from paddle_tpu.framework.jax_compat import shard_map
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu import optimizer as jopt

from torch_world import World
from torch_threads import few_torch_threads  # noqa: F401

RTOL, ATOL, ADAM_ATOL = 1e-4, 1e-5, 3e-4
NO_DROP = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
               use_flash_attention=False)


@pytest.fixture(scope="module")
def world():
    w = World(2, timeout=150)
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _no_jax_mesh():
    yield
    jset_mesh(None)


def _shard_map(fn, x, n=2, in_spec=JP("dp"), out_spec=JP("dp")):
    """The reference's ``fn`` inside shard_map on ``n`` devices: each
    rank's block of the output."""
    mesh = jinit_mesh(dp=n)
    out = np.asarray(shard_map(fn, mesh=mesh, in_specs=in_spec,
                               out_specs=out_spec)(jnp.asarray(x)))
    jset_mesh(None)
    return np.split(out, n)


# ------------------------------------------------------------ groups
def test_groups_are_collective_and_group_zero_is_the_world(world):
    res = world.run("api_groups")
    for r, got in enumerate(res):
        # both ranks made both groups, in the same order: the same ids
        assert got["ids"] == res[0]["ids"]
        assert got["pair_rank"] == r and got["nranks"] == 2
        assert got["solo_member"] == (r == 1)
        assert got["world"] == (0, [0, 1], True)
        assert got["lookup"]
        assert got["env"] == (r, 2, 2, r, 0)
    # reduce over the pair keeps the sum on its rank 1, zeros on rank 0;
    # the one-rank group is the identity on its member
    np.testing.assert_array_equal(res[0]["pair_reduce"], [0.0])
    np.testing.assert_array_equal(res[1]["pair_reduce"], [3.0])
    np.testing.assert_array_equal(res[1]["solo_reduce"], [2.0])
    # the reference's bookkeeping agrees on the world and ParallelEnv
    assert jdist.get_group(0).ranks == [0]
    assert jdist.ParallelMode.SHARDING_PARALLEL == 3
    env = jdist.ParallelEnv()
    assert env.rank == 0 and env.world_size == 1


# ------------------------------------------------------------ P2P
def test_p2p_every_form(world):
    res = world.run("api_p2p")
    got, dtype = res[1]["recv_nobuf"]
    np.testing.assert_array_equal(got, np.arange(6.0).reshape(2, 3))
    assert dtype == "torch.float32"
    buf, same = res[0]["recv_buf"]
    np.testing.assert_array_equal(buf, [5.0])
    assert same                                   # filled in place
    got, dtype = res[1]["irecv"]
    np.testing.assert_array_equal(got, [[1, 2], [3, 4]])
    assert dtype == "torch.int64"
    np.testing.assert_array_equal(res[1]["tags"][0], [2.0])
    np.testing.assert_array_equal(res[1]["tags"][1], [1.0])
    np.testing.assert_array_equal(res[0]["batch"], [10.0, 11.0])
    returned, buf = res[1]["batch"]
    np.testing.assert_array_equal(returned, [2.5, 2.5, 2.5])
    np.testing.assert_array_equal(buf, [2.5, 2.5, 2.5])
    np.testing.assert_array_equal(res[1]["stream"], [7, 8])


# ------------------------------------------------------------ collectives
def test_collectives_match_the_reference(world):
    x = np.arange(8.0, dtype=np.float32).reshape(2, 4) + 1.0
    rows = np.stack([np.full((2,), 3.0 * i + 1) for i in range(2)]).astype(
        np.float32)
    res = world.run("api_collectives", x, rows)
    g = jdist.new_group([0, 1], axis="dp")
    want_reduce = _shard_map(lambda v: jdist.reduce(v, dst=1, group=g), x)
    want_max = _shard_map(lambda v: jdist.reduce(
        v, dst=0, op=jdist.ReduceOp.MAX, group="dp"), x)
    want_reduce0 = _shard_map(lambda v: jdist.reduce(v, dst=0, group=g), x)
    flat = x.reshape(-1)
    want_scatter = _shard_map(
        lambda v: jdist.scatter(jnp.asarray(flat), src=0, group="dp"), x)
    want_scatter1 = _shard_map(
        lambda v: jdist.scatter(jnp.asarray(flat), src=1, group="dp"), x)
    want_list = _shard_map(lambda v: jdist.scatter(
        None, [jnp.asarray(r) for r in rows], src=1, group="dp"), x)
    a2a_in = np.stack([np.arange(4.0) + 10 * r for r in range(2)]).astype(
        np.float32)
    want_a2a = _shard_map(lambda v: jdist.alltoall_single(v[0])[None],
                          a2a_in)
    for r in range(2):
        got = res[r]
        np.testing.assert_array_equal(got["reduce"], want_reduce[r])
        np.testing.assert_array_equal(got["reduce_max"], want_max[r])
        np.testing.assert_array_equal(got["reduce_axis"], want_reduce0[r])
        np.testing.assert_array_equal(got["scatter"], want_scatter[r])
        np.testing.assert_array_equal(got["scatter_axis"], want_scatter1[r])
        chunk, buf = got["scatter_list"]
        np.testing.assert_array_equal(chunk, want_list[r])
        np.testing.assert_array_equal(buf, want_list[r])
        np.testing.assert_array_equal(got["alltoall"], want_a2a[r][0])
        np.testing.assert_array_equal(
            got["alltoall_into"],
            np.concatenate([np.arange(4.0)[2 * r:2 * r + 2] * (s + 1)
                            for s in range(2)]))
        np.testing.assert_array_equal(got["stream_all_reduce"],
                                      x.sum(0, keepdims=True))
        np.testing.assert_array_equal(got["wait"], x[r:r + 1])
        assert "uneven" in got["uneven"]
        assert got["objects"] == [{"rank": 0, "s": ""}, {"rank": 1, "s": "x"}]
    # the reference refuses the same uneven split; its single-process
    # all_gather_object is the identity, as the port's is alone
    with pytest.raises(NotImplementedError):
        jdist.alltoall_single(jnp.ones((8,)), in_split_sizes=[1, 7])
    assert jdist.all_gather_object([], {"a": 1}) == [{"a": 1}]
    from paddle_tpu_torch import distributed as D

    assert D.all_gather_object([], {"a": 1}) == [{"a": 1}]


def test_stream_variants_and_entry_configs():
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import stream

    from paddle_tpu.distributed import stream as jstream

    assert stream.__all__ == jstream.__all__
    for name in stream.__all__:
        assert callable(getattr(stream, name))
    for cls, args in (("CountFilterEntry", (5,)),
                      ("ShowClickEntry", ("s", "c")),
                      ("ProbabilityEntry", (0.5,))):
        assert getattr(D, cls)(*args).accessor_kwargs() == \
            getattr(jdist, cls)(*args).accessor_kwargs()
    with pytest.raises(NotImplementedError, match="ColumnParallelLinear"):
        D.split(None, (4, 8), "linear")
    with pytest.raises(ValueError):
        D.group_sharded_parallel(None, object(), "bogus")


# ------------------------------------------------------------ ZeRO entry
def _gpt(**kw):
    pt.seed(11)
    cfg = {**NO_DROP, "loss_chunk": 16, "num_layers": 1, **kw}
    return JGPT(jgpt_tiny(**cfg)), cfg


def _ids(seed, shape=(4, 32), vocab=1024):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("level,stage", [("os", 1), ("os_g", 2),
                                         ("p_g_os", 3)])
def test_group_sharded_parallel_trains_to_the_reference(world, level, stage,
                                                        tmp_path):
    """``group_sharded_parallel`` tags the stage and ``gpt_tiny`` trains
    at sdp = 2 to the reference's losses and parameters for the same
    tag; ``save_group_sharded_model`` writes files the reference loads."""
    jm, cfg = _gpt()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    batches = [(_ids(i), _ids(i)) for i in range(3)]
    opt = jopt.AdamW(learning_rate=1e-3)
    jm, opt, _ = jdist.group_sharded_parallel(jm.train(), opt, level)
    assert opt._group_sharded_stage == stage
    mesh = jinit_mesh(sdp=2)
    step = jdist.DistributedTrainStep(jm, opt, mesh=mesh)
    losses = [float(step(b)) for b in batches]
    params = {k: np.asarray(v) for k, v in step.params.items()}
    jset_mesh(None)
    out = str(tmp_path / "saved")
    job = dict(kind="gpt", cfg=cfg, state=state, mesh={"sdp": 2},
               opt=("AdamW", {"learning_rate": 1e-3}), batches=batches,
               gsp=level)
    res = world.run("group_sharded_save", job, out)
    for got in res:
        assert got["stage"] == stage
        assert not got["split_hook_left"]
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=RTOL,
                               atol=ATOL)
    for k in params:
        np.testing.assert_allclose(res[0]["params"][k], params[k],
                                   rtol=RTOL, atol=ADAM_ATOL, err_msg=k)
    # rank 0 wrote the gathered model; the reference's loader reads it
    saved = pt.load(os.path.join(out, "model.pdparams"))
    assert set(saved) == set(params)
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(v), res[0]["params"][k])
    opt_state = pt.load(os.path.join(out, "model.pdopt"))
    assert set(opt_state["state"]["moment1"]) == set(params)


def test_recv_fails_at_its_own_deadline(world):
    """Twin of the reference's deadline test
    (``tests/test_distributed_compat.py:193``): a receive from a peer that
    sends nothing fails at the caller's ``timeout``, not the transport's.
    Last in the file: the abandoned receive stays posted in gloo."""
    res = world.run("api_deadline")
    took, err = res[0]
    assert "within 1.0s" in err, err
    assert 0.9 <= took < 10.0
    assert res[1] is None

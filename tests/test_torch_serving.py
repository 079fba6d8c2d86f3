"""The port's serving stack (paddle_tpu_torch.serving) against the JAX
package's, plus the port's own serving invariants.

The JAX ``InferenceServer`` and the port's serve the same converted
``gpt_tiny`` weights; greedy token streams must be identical. Sampled
streams cannot equal the JAX package's (``torch.Generator`` is not
``jax.random``), so the port is held to the reference's invariant on its
own: a served sampled stream equals a solo ``generate()`` with the same
seed, whatever its slot or batch companions.
"""
import ast
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.io.batching import bucket_for as jax_bucket_for
from paddle_tpu.models.generation import filter_logits as jax_filter_logits
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import InferenceServer as JaxServer
from paddle_tpu_torch.convert import gpt_from_jax
from paddle_tpu_torch.io.batching import bucket_for
from paddle_tpu_torch.models.generation import (filter_logits,
                                                per_row_generators,
                                                sample_logits_rows)
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving import (Deadline, FifoScheduler,
                                      InferenceServer, QueueFull, Request,
                                      SchedulerClosed)

GEO = dict(max_length=64, prefill_buckets=(32,))
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    pt.seed(23)
    jm = JaxGPT(jax_gpt_tiny(hidden_dropout_prob=0.0,
                             attention_dropout_prob=0.0))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = gpt_from_jax(state, gpt_tiny(hidden_dropout_prob=0.0,
                                      attention_dropout_prob=0.0),
                      device="cpu")
    return jm, tm


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 1024, (n,)).astype(np.int32)


def test_greedy_streams_match_jax_server(pair):
    jm, tm = pair
    prompts = [(_prompt(9, 1), 10), (_prompt(14, 2), 7), (_prompt(5, 3), 12)]
    jsrv = JaxServer(jm, slots=2, **GEO)
    tsrv = InferenceServer(tm, slots=2, device="cpu", **GEO)
    try:
        jh = [jsrv.submit(p, max_new_tokens=n) for p, n in prompts]
        th = [tsrv.submit(p, max_new_tokens=n) for p, n in prompts]
        for (p, n), a, b in zip(prompts, jh, th):
            ja, tb = a.result(timeout=300), b.result(timeout=300)
            assert tb.shape == (n,)
            np.testing.assert_array_equal(tb, ja)
    finally:
        jsrv.shutdown(drain=False, timeout=60)
        tsrv.shutdown(drain=False, timeout=60)


def test_served_streams_match_solo_generate(pair):
    """Three staggered requests (greedy + seeded top-p sampling) in a
    two-slot batch: each equals its solo batch-1 generate()."""
    _, tm = pair
    p0, p1, p2 = _prompt(9, 4), _prompt(12, 5), _prompt(6, 6)
    solo0 = tm.generate(p0[None], max_new_tokens=10, **GEO)[0]
    solo1 = tm.generate(p1[None], max_new_tokens=7, do_sample=True,
                        temperature=0.8, top_p=0.9, seed=5, **GEO)[0]
    solo2 = tm.generate(p2[None], max_new_tokens=5, do_sample=True,
                        seed=9, **GEO)[0]
    with InferenceServer(tm, slots=2, device="cpu", **GEO) as srv:
        h0 = srv.submit(p0, max_new_tokens=10)
        time.sleep(0.05)  # h1/h2 arrive while h0 is mid-decode
        h1 = srv.submit(p1, max_new_tokens=7, do_sample=True,
                        temperature=0.8, top_p=0.9, seed=5)
        h2 = srv.submit(p2, max_new_tokens=5, do_sample=True, seed=9)
        np.testing.assert_array_equal(h0.result(timeout=120), solo0)
        np.testing.assert_array_equal(h1.result(timeout=120), solo1)
        np.testing.assert_array_equal(list(h2.stream()), solo2)
        snap = srv.snapshot()
    assert snap["requests_completed"] == 3
    assert snap["tokens_emitted"] == 22
    assert h0.ttft_s is not None and h0.ttft_s > 0


def test_eos_stops_request_early(pair):
    _, tm = pair
    p = _prompt(9, 7)
    full = tm.generate(p[None], max_new_tokens=6, **GEO)[0]
    eos = int(full[2])
    solo = tm.generate(p[None], max_new_tokens=6, eos_token_id=eos, **GEO)[0]
    with InferenceServer(tm, slots=2, device="cpu", **GEO) as srv:
        got = srv.submit(p, max_new_tokens=6, eos_token_id=eos).result(60)
    first_eos = list(full).index(eos)
    np.testing.assert_array_equal(got, full[:first_eos + 1])
    np.testing.assert_array_equal(solo, full[:first_eos + 1])


def test_worker_fault_requeues_and_recovers(pair):
    """A fault in the decode step resets the engine and requeues the
    in-flight request; it regenerates from its seed, so the result is
    identical to a clean run."""
    _, tm = pair
    p = _prompt(11, 8)
    solo = tm.generate(p[None], max_new_tokens=6, do_sample=True, seed=3,
                       **GEO)[0]
    with InferenceServer(tm, slots=2, device="cpu", **GEO) as srv:
        real_step, faults = srv.engine.step, []

        def flaky_step():
            if not faults:
                faults.append(1)
                raise RuntimeError("injected decode fault")
            return real_step()

        srv.engine.step = flaky_step
        with pytest.warns(RuntimeWarning, match="injected decode fault"):
            got = srv.submit(p, max_new_tokens=6, do_sample=True,
                             seed=3).result(timeout=60)
        snap = srv.snapshot()
    np.testing.assert_array_equal(got, solo)
    assert snap["requests_requeued"] == 1 and snap["prefills"] == 2


@pytest.fixture(scope="module")
def pair_d256():
    """gpt_tiny at head dim 256 (hidden 512, 2 heads of 256, 2 layers),
    seeded in JAX and converted by name."""
    over = dict(hidden_size=512, num_heads=2, hidden_dropout_prob=0.0,
                attention_dropout_prob=0.0)
    pt.seed(31)
    jm = JaxGPT(jax_gpt_tiny(**over))
    jm.eval()
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, gpt_from_jax(state, gpt_tiny(**over), device="cpu")


def test_d256_prefill_logits_and_greedy_stream_match_jax(pair_d256):
    """Head dim 256, the shape of the D = 256 prefill that runs the
    float32 tensor-core forward on the card: the bucketed prefill's
    last-token logits agree with the JAX model's within 1e-4 absolute
    (float32, two frameworks' summation orders through two layers), and
    the port's served greedy stream equals the JAX server's."""
    import jax.numpy as jnp
    from paddle_tpu.models import generation as jgen
    from paddle_tpu_torch.models import generation as tgen

    jm, tm = pair_d256
    assert tm.cfg.hidden_size // tm.cfg.num_heads == 256
    P = 21
    prompt = _prompt(P, 12)
    ids = np.zeros((1, 32), np.int32)
    ids[0, :P] = prompt
    lj, _ = jm(jnp.asarray(ids), cache=jgen.init_cache(jm, 1, 64),
               position_offset=0, gather_last=P - 1)
    with torch.no_grad():
        lt, _ = tm(torch.as_tensor(ids, dtype=torch.long),
                   cache=tgen.init_cache(tm, 1, 64), position_offset=0,
                   gather_last=P - 1)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    jsrv = JaxServer(jm, slots=2, **GEO)
    tsrv = InferenceServer(tm, slots=2, device="cpu", **GEO)
    try:
        want = jsrv.submit(prompt, max_new_tokens=8).result(timeout=300)
        got = tsrv.submit(prompt, max_new_tokens=8).result(timeout=300)
    finally:
        jsrv.shutdown(drain=False, timeout=60)
        tsrv.shutdown(drain=False, timeout=60)
    assert got.shape == (8,)
    np.testing.assert_array_equal(got, want)


def test_server_without_device_needs_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    _, tm = pair
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(tm, slots=2, **GEO)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt_tiny())


def test_queue_full_and_closed():
    sched = FifoScheduler(max_queue_depth=2, max_prefills_per_step=1)
    sched.submit(Request(prompt=[1]))
    sched.submit(Request(prompt=[2]))
    with pytest.raises(QueueFull):
        sched.submit(Request(prompt=[3]))
    admit, expired = sched.take(free_slots=4)
    assert [r.prompt for r in admit] == [[1]] and expired == []
    sched.seal()
    with pytest.raises(SchedulerClosed):
        sched.submit(Request(prompt=[4]))
    assert [r.prompt for r in sched.close()] == [[2]]


def test_deadline_expires_in_queue():
    sched = FifoScheduler()
    late = Request(prompt=np.array([1, 2]), deadline=Deadline(0.0))
    fine = Request(prompt=np.array([3]), deadline=Deadline(60.0))
    sched.submit(late)
    sched.submit(fine)
    assert sched.pop_expired() == [late]
    admit, expired = sched.take(free_slots=2)
    assert admit == [fine] and expired == []


@pytest.mark.parametrize("length", [1, 31, 32, 33, 100, 4096, 5000])
def test_bucket_for_matches_jax(length):
    buckets = (32, 64, 128, 256, 512, 1024, 2048, 4096)
    assert bucket_for(length, buckets) == jax_bucket_for(length, buckets)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.9),
                                         (7, 0.5)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(8).standard_normal((1, 64)).astype(np.float32)
    fj = np.asarray(jax_filter_logits(logits, 0.7, top_k, top_p))
    ft = filter_logits(torch.from_numpy(logits), 0.7, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(ft), np.isinf(fj))
    np.testing.assert_allclose(ft[~np.isinf(ft)], fj[~np.isinf(fj)],
                               rtol=1e-6)


def test_top_p_one_is_exact_noop():
    logits = torch.randn(1, 300, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(filter_logits(logits, 1.0, 0, 1.0).numpy(),
                                  logits.numpy())


def test_row_generators_are_placement_invariant():
    """Row 0 of a batch-1 derivation equals the same (seed, position)
    row of any other batch; rows and positions draw different streams."""
    logits = torch.zeros(3, 1000)
    solo = sample_logits_rows(logits[:1], per_row_generators(5, 1, 12))
    rows = sample_logits_rows(logits, per_row_generators(5, 3, 12))
    assert int(rows[0]) == int(solo[0])
    assert len({int(t) for t in rows}) == 3
    later = sample_logits_rows(logits[:1], per_row_generators(5, 1, 13))
    assert int(later[0]) != int(solo[0])


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_or_reference_package():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "tools").glob("torch_*.py"))
    assert len(files) > 10
    scanned = {f.relative_to(REPO).as_posix() for f in files}
    for path in ("paddle_tpu_torch/framework/jit.py",
                 "paddle_tpu_torch/framework/random.py",
                 "paddle_tpu_torch/nn/layer.py",
                 "paddle_tpu_torch/optimizer/optimizer.py",
                 "paddle_tpu_torch/amp/auto_cast.py",
                 "paddle_tpu_torch/distributed/parallel/recompute.py",
                 "paddle_tpu_torch/models/llama.py",
                 "paddle_tpu_torch/convert.py",
                 "tools/torch_train_profile.py"):
        assert path in scanned
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu", "flax")]
    assert bad == []

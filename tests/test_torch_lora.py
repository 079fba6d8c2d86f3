"""The port's multi-tenant LoRA (``paddle_tpu_torch.lora`` and its
serving and training integration) against the JAX package's, on the CPU.

Two halves:

1. **Twins** of ``tests/test_lora.py`` on the port alone (its router
   tests wait for the port's router): per-tenant exactness of a mixed
   batch against solo ``generate()``, registry safety (LRU, pins,
   versions, format and fingerprint guards), the serving metrics, and the
   frozen-base fit. The port's ``TrainStep`` has no ``buffers`` pytree:
   its fit twin checks the frozen base on the model and in the step's
   snapshot.
2. **Cross-package** checks at ``gpt_tiny`` and ``llama_tiny`` (2 KV
   heads), JAX with ``use_flash_attention=False``: the base fingerprint,
   the adapter salt and the pool's digest chain byte-equal; adapter
   checkpoints byte-equal and loading in either package; the injected
   forward within 1e-5 (float32); a mixed batch of three tenants plus the
   base token-equal to the port's solo ``generate()`` (greedy and seeded)
   and, greedy, to the JAX server's; ``Model.fit(lora=...)`` losses within
   1e-5 relative and adapter leaves within 1e-4 absolute (the tolerances
   of ``tests/test_torch_hapi.py`` and ``tests/test_torch_train.py``); and
   a CPU twin of ``tools/lora_soak.py``: an adapter fit with ``recovery=``
   preempted by SIGTERM and resumed, bit-identical to an uninterrupted
   one, then saved, loaded into an ``AdapterStore`` and served
   token-equal to solo.
"""
import os
import signal
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import hapi as jhapi
from paddle_tpu import lora as jlora
from paddle_tpu.amp import decorate as jdecorate
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.serving import InferenceServer as JaxServer
from paddle_tpu.serving.prefix_cache import chain_digests as jax_chain_digests
from paddle_tpu_torch import amp, hapi
from paddle_tpu_torch.convert import gpt_from_jax, llama_from_jax
from paddle_tpu_torch.distributed.checkpoint import load_state, save_state
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.framework.supervisor import (RecoveryPolicy,
                                                   TrainingPreempted)
from paddle_tpu_torch.lora import (AdapterError, AdapterFormatError,
                                   AdapterStore, LoraConfig, adapter_rows,
                                   apply_lora, applied_config,
                                   base_fingerprint, clear_adapter,
                                   is_lora_param, load_adapter, lora_paths,
                                   lora_state, save_adapter, set_adapter)
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.serving import InferenceServer
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.prefix_cache import chain_digests
from torch_threads import few_torch_threads  # noqa: F401

GEO = dict(max_length=48, prefill_buckets=(12,))
LCFG = LoraConfig(rank=4, alpha=8.0)
RTOL = 1e-5


def _tiny_cfg(**over):
    base = dict(hidden_size=64, num_layers=2, num_heads=2, vocab_size=256,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_dropout_prob=0.0, use_flash_attention=False)
    base.update(over)
    return gpt_tiny(**base)


def _gpt(seed=7, **over):
    return GPTForCausalLM(_tiny_cfg(**over), device="cpu",
                          generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def lm():
    model = _gpt().eval()
    base_params = {k: v.detach().clone()
                   for k, v in model.named_parameters()}
    apply_lora(model, LCFG)
    return model, base_params


def _random_adapter(model, rng, std=0.04):
    return {k: rng.normal(0, std, tuple(v.shape)).astype(np.float32)
            for k, v in lora_state(model).items()}


@pytest.fixture(scope="module")
def tenants(lm):
    model, _ = lm
    rng = np.random.default_rng(42)
    return {t: _random_adapter(model, rng) for t in ("t0", "t1", "t2")}


@pytest.fixture(scope="module")
def store(lm, tenants):
    model, _ = lm
    st = AdapterStore(model, max_loaded=4)
    for name, tree in tenants.items():
        st.register(name, tree)
    return st


@pytest.fixture(scope="module")
def server(lm, store):
    model, _ = lm
    srv = InferenceServer(model, slots=3, adapter_store=store,
                          max_queue_depth=16, device="cpu", **GEO)
    yield srv
    srv.shutdown(drain=False, timeout=30)


def _prompt(n, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(
        np.int32)


def _row(stack, row):
    return stack[row].detach().clone()


# ------------------------------------------------------------ unit: config
def test_lora_config_validation():
    with pytest.raises(ValueError):
        LoraConfig(rank=0)
    with pytest.raises(ValueError):
        LoraConfig(dropout=1.0)
    cfg = LoraConfig(rank=8, alpha=16.0, target_modules=["q_proj"])
    assert cfg.scaling == 2.0
    assert cfg.target_modules == ("q_proj",)
    assert cfg.to_dict() == jlora.LoraConfig(
        rank=8, alpha=16.0, target_modules=["q_proj"]).to_dict()
    assert is_lora_param("gpt.h.0.attn.qkv_proj.lora_A")
    assert not is_lora_param("gpt.h.0.attn.qkv_proj.weight")


def test_apply_lora_idempotent_and_conflicts(lm):
    model, _ = lm
    assert applied_config(model) == LCFG
    apply_lora(model, LCFG)  # same config: no-op
    with pytest.raises(ValueError, match="refusing to stack"):
        apply_lora(model, LoraConfig(rank=2))

    class Bare(torch.nn.Module):
        pass

    with pytest.raises(ValueError, match="target_modules"):
        apply_lora(Bare(), LoraConfig())
    with pytest.raises(ValueError, match="matched"):
        apply_lora(Bare(), LoraConfig(target_modules=("nope",)))
    # lora_spec: 4 targets a GPT block, 7 a Llama block
    assert len(lora_paths(model)) == 4 * 2
    assert [p.rsplit(".", 1)[-1] for p in lora_paths(model)[:4]] == [
        "qkv_proj", "out_proj", "fc_in", "fc_out"]
    lm2 = apply_lora(LlamaForCausalLM(llama_tiny(), device="cpu"), LCFG)
    assert len(lora_paths(lm2)) == 7 * 2


def test_injection_is_base_identical_until_trained(lm):
    """B = 0 at injection: bitwise no-op; set_adapter changes outputs;
    clear_adapter restores the base bitwise."""
    fresh = _gpt().eval()
    x = torch.as_tensor(_prompt(8, 0)[None])
    with torch.no_grad():
        base = fresh(x)
        apply_lora(fresh, LCFG)
        assert torch.equal(base, fresh(x))
        set_adapter(fresh, _random_adapter(fresh, np.random.default_rng(5),
                                           std=0.05))
        assert not torch.equal(base, fresh(x))
        clear_adapter(fresh)
        assert torch.equal(base, fresh(x))


def test_set_adapter_rejects_mismatch(lm, tenants):
    model, _ = lm
    good = tenants["t0"]
    with pytest.raises(ValueError, match="missing"):
        set_adapter(model, dict(list(good.items())[:-1]))
    k0 = next(iter(good))
    with pytest.raises(ValueError, match="shape"):
        set_adapter(model, {**good, k0: np.zeros((3, 3), np.float32)})
    clear_adapter(model)


def test_batched_rows_equal_solo_per_row(lm, tenants, store):
    """The batched-rows context (the engine's path) gives each row what
    the solo hook gives it with that row's adapter set, row 0 the base."""
    model, _ = lm
    x = torch.as_tensor(np.stack([_prompt(8, i) for i in range(3)]))
    rows = [store.acquire(n) for n in (None, "t1", "t2")]
    try:
        with torch.no_grad(), adapter_rows(store.tensors, rows):
            batched = model(x)
        for i, name in enumerate((None, "t1", "t2")):
            if name is None:
                clear_adapter(model)
            else:
                set_adapter(model, tenants[name])
            with torch.no_grad():
                assert torch.equal(batched[i:i + 1], model(x[i:i + 1]))
    finally:
        for r in rows:
            store.release(r)
        clear_adapter(model)
    with adapter_rows({}, [0]), pytest.raises(KeyError, match="no pages"):
        with torch.no_grad():
            model(x[:1])


# -------------------------------------------------------- training (fit)
def _fit_data(n=3):
    return [(_prompt(10, i).reshape(2, 5),) * 2 for i in range(n)]


def test_fit_trains_only_adapter_pytree():
    trandom.seed(3)
    net = _gpt(seed=3)
    base_before = {k: v.detach().clone() for k, v in net.named_parameters()}
    m = hapi.Model(net)
    m.prepare(optimizer=Adam(learning_rate=1e-2),
              loss=lambda out, labels: net.loss(out, labels))
    data = _fit_data()
    m.fit(data, epochs=2, verbose=0, lora=LoraConfig(rank=2, alpha=4.0))
    step = m._train_step
    # only adapter leaves are optimized...
    assert step.params and all(is_lora_param(k) for k in step.params)
    # ...the frozen base stays bitwise unchanged on the model and rides
    # the step's snapshot...
    named = dict(net.named_parameters())
    snap = step.state_dict()
    for k, v in base_before.items():
        assert torch.equal(v, named[k]), k
        assert torch.equal(v, snap["buffers"][k]), k
        assert not named[k].requires_grad
    # ...the adapter actually moved...
    assert any(bool(v.abs().max() > 0) for k, v in step.params.items()
               if k.endswith("lora_B"))
    # ...and optimizer state is rank-sized, not model-sized
    def floats(tree):
        if isinstance(tree, dict):
            return sum(floats(v) for v in tree.values())
        return tree.numel() if isinstance(tree, torch.Tensor) else 0

    model_floats = sum(v.numel() for v in base_before.values())
    assert 0 < floats(step.opt_state) < model_floats / 10
    # a later PLAIN fit must not silently keep the base frozen
    m.fit(data, epochs=1, verbose=0)
    step2 = m._train_step
    assert step2 is not step and step2._trainable is None
    named = dict(net.named_parameters())
    assert any(not torch.equal(base_before[k], named[k])
               for k in step2.params if k in base_before)


def test_o2_adapter_fit_keeps_float32_leaves_and_rank_sized_state():
    """Under bf16 O2 (decorate, then inject, as fit(lora=...) does) the
    adapter leaves are float32, as the reference's are; only they get
    optimizer state (a float32 leaf is its own master), and the bf16 base
    stays bitwise unchanged. The fingerprint carries the dtypes, so a
    float32 model of the same architecture refuses the adapter."""
    pt.seed(3)
    jm = JaxGPT(jax_gpt_tiny(hidden_size=64, num_layers=2, num_heads=2,
                             vocab_size=256, max_position_embeddings=64))
    jdecorate(jm, level="O2", dtype="bfloat16")
    jlora.apply_lora(jm, jlora.LoraConfig(rank=2, alpha=4.0))
    jdtypes = {str(v.dtype) for k, v in jm.named_parameters()
               if jlora.is_lora_param(k)}
    trandom.seed(3)
    net = _gpt(seed=3).train()
    net, opt = amp.decorate(net, AdamW(learning_rate=1e-2), level="O2",
                            dtype="bfloat16")
    base_before = {k: v.detach().clone() for k, v in net.named_parameters()}
    m = hapi.Model(net, labels=[])
    m.prepare(opt)
    m.fit(_fit_data(), epochs=1, verbose=0,
          lora=LoraConfig(rank=2, alpha=4.0))
    step = m._train_step
    assert jdtypes == {"float32"}
    assert {str(v.dtype) for v in lora_state(net).values()} \
        == {"torch.float32"}
    named = dict(net.named_parameters())
    for k, v in base_before.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, named[k]), k
    state_keys = {k for slot in step.opt_state.values()
                  if isinstance(slot, dict) for k in slot}
    assert state_keys and all(is_lora_param(k) for k in state_keys)
    # a float32 leaf is its own master: no copy
    for k, w in step.opt_state.get("master_weights", {}).items():
        assert w is named[k], k
    f32 = apply_lora(_gpt(seed=3), LoraConfig(rank=2, alpha=4.0))
    assert base_fingerprint(f32) != base_fingerprint(net)


# -------------------------------------------------- registry: disk format
def test_adapter_save_load_roundtrip(lm, tenants, tmp_path):
    model, _ = lm
    set_adapter(model, tenants["t0"])
    d = str(tmp_path / "t0")
    save_adapter(d, model)
    clear_adapter(model)
    state, meta = load_adapter(d, model)
    assert meta["rank"] == LCFG.rank
    assert meta["base_fingerprint"] == base_fingerprint(model)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), tenants["t0"][k], k)


def test_format_guards_both_directions(lm, tmp_path):
    """An adapter checkpoint refuses to restore a full model; a full
    checkpoint refuses to load as an adapter."""
    model, _ = lm
    adir = str(tmp_path / "adapter")
    save_adapter(adir, model)
    with pytest.raises(ValueError, match="LoRA ADAPTER checkpoint"):
        load_state(adir, template={k: v.detach() for k, v in
                                   model.state_dict().items()})
    fdir = str(tmp_path / "full")
    save_state({k: v.detach() for k, v in model.state_dict().items()}, fdir)
    with pytest.raises(AdapterFormatError, match="not a LoRA adapter"):
        load_adapter(fdir, model)
    with pytest.raises(AdapterFormatError):
        AdapterStore(model, max_loaded=2).load("x", fdir)


def test_fingerprint_mismatch_rejected(lm, tmp_path):
    """An adapter saved against one base hard-fails onto another
    architecture, and onto the right base with another geometry."""
    model, _ = lm
    adir = str(tmp_path / "t")
    save_adapter(adir, model)
    other = apply_lora(_gpt(seed=9, hidden_size=32, num_heads=2), LCFG)
    with pytest.raises(AdapterFormatError, match="fingerprint"):
        load_adapter(adir, other)
    same_arch = apply_lora(_gpt(), LoraConfig(rank=2, alpha=8.0))
    with pytest.raises(AdapterFormatError, match="rank"):
        load_adapter(adir, same_arch)


# --------------------------------------------------- registry: residency
def test_store_lru_eviction_and_reload_determinism(lm, tenants):
    model, _ = lm
    st = AdapterStore(model, max_loaded=2)
    for name, tree in tenants.items():
        st.register(name, tree)

    def pages_of(name):
        row = st.loaded()[name]
        return {p: (_row(a, row), _row(b, row))
                for p, (a, b) in st.tensors.items()}

    s0 = st.acquire("t0"); st.release(s0)
    first_pages = pages_of("t0")
    s1 = st.acquire("t1"); st.release(s1)
    assert set(st.loaded()) == {"t0", "t1"}
    # t2 must evict the LRU resident (t0)
    s2 = st.acquire("t2"); st.release(s2)
    assert set(st.loaded()) == {"t1", "t2"}
    assert st.stats()["evictions"] == 1
    # reload of the evicted adapter is bit-exact and deterministic
    s0b = st.acquire("t0"); st.release(s0b)
    again = pages_of("t0")
    for p in first_pages:
        assert torch.equal(first_pages[p][0], again[p][0])
        assert torch.equal(first_pages[p][1], again[p][1])
    a = st.tensors[st.paths[0]][0][st.loaded()["t0"]]
    np.testing.assert_array_equal(
        a.numpy(), tenants["t0"][f"{st.paths[0]}.lora_A"])
    with pytest.raises(AdapterError, match="unknown adapter"):
        st.acquire("nope")


def test_store_pinned_rows_never_evict(lm, tenants):
    model, _ = lm
    st = AdapterStore(model, max_loaded=2)
    for name, tree in tenants.items():
        st.register(name, tree)
    st.acquire("t0")
    b = st.acquire("t1")
    with pytest.raises(AdapterError, match="pinned"):
        st.acquire("t2")
    st.release(b)
    st.acquire("t2")
    assert set(st.loaded()) == {"t0", "t2"}
    st.release_all()
    assert st.acquire(None) == 0 and st.acquire("base") == 0
    st.release_all()


def test_reregister_bumps_cache_namespace(lm, tenants):
    model, _ = lm
    st = AdapterStore(model, max_loaded=2)
    st.register("t0", tenants["t0"])
    s1 = st.salt("t0")
    assert s1.startswith(b"lora:t0@")
    st.register("t0", tenants["t1"])   # adapter update
    s2 = st.salt("t0")
    assert s1 != s2
    assert st.salt(None) == st.salt("base") == b""


def test_reregister_never_swaps_pages_under_a_pin(lm, tenants):
    """Updating a resident adapter while streams decode against it leaves
    the pinned row alone (orphaned until they finish); new acquires stage
    the new pages into a fresh row. An unpinned resident is refreshed in
    place and published as a new stack dict."""
    model, _ = lm
    st = AdapterStore(model, max_loaded=3)
    st.register("t0", tenants["t0"])
    row = st.acquire("t0")
    before = _row(st.tensors[st.paths[0]][0], row)
    st.register("t0", tenants["t1"])
    assert torch.equal(before, st.tensors[st.paths[0]][0][row])
    assert "t0" not in st.loaded()
    row2 = st.acquire("t0")
    assert row2 != row
    st.register("t2", tenants["t2"])
    assert st.acquire("t2") not in (row, row2)
    st.release_all()
    old = st.tensors
    st.register("t2", tenants["t0"])   # resident, unpinned: refreshed
    assert st.tensors is not old
    r2 = st.loaded()["t2"]
    np.testing.assert_array_equal(
        st.tensors[st.paths[0]][0][r2].numpy(),
        tenants["t0"][f"{st.paths[0]}.lora_A"])
    assert torch.equal(old[st.paths[0]][0][r2], torch.as_tensor(
        tenants["t2"][f"{st.paths[0]}.lora_A"]))


def test_store_register_validation(lm, tenants):
    model, _ = lm
    st = AdapterStore(model, max_loaded=2)
    with pytest.raises(ValueError):
        st.register("base", tenants["t0"])
    bad = dict(tenants["t0"])
    bad.popitem()
    with pytest.raises(AdapterFormatError, match="lacks"):
        st.register("x", bad)
    with pytest.raises(ValueError, match="max_loaded"):
        AdapterStore(model, max_loaded=0)
    with pytest.raises(ValueError, match="one geometry"):
        AdapterStore(model, LoraConfig(rank=2), max_loaded=1)


# ------------------------------------------------- serving: THE acceptance
@pytest.fixture(scope="module")
def mixed_run(lm, tenants, server):
    """A staggered batch mixing 3 adapters + base (greedy and seeded
    sampling), and solo references for every stream."""
    model, _ = lm
    reqs = [("t0", _prompt(7, 1), dict(max_new_tokens=6)),
            (None, _prompt(9, 2), dict(max_new_tokens=5)),
            ("t1", _prompt(5, 3), dict(max_new_tokens=7, do_sample=True,
                                       temperature=0.8, seed=11)),
            ("t2", _prompt(8, 4), dict(max_new_tokens=6, do_sample=True,
                                       temperature=0.7, top_p=0.9,
                                       seed=12)),
            ("t0", _prompt(6, 5), dict(max_new_tokens=4, do_sample=True,
                                       seed=13))]
    solos = []
    for tid, p, kw in reqs:
        if tid is None:
            clear_adapter(model)
        else:
            set_adapter(model, tenants[tid])
        solos.append(model.generate(p[None], **kw, **GEO)[0])
    clear_adapter(model)
    handles = []
    for tid, p, kw in reqs:
        handles.append(server.submit(p, adapter_id=tid, **kw))
        time.sleep(0.05)   # arrive while earlier requests are mid-decode
    results = [h.result(timeout=300) for h in handles]
    return reqs, solos, results


def test_mixed_adapter_batch_matches_solo(mixed_run):
    """Every stream of a batch mixing three adapters plus the base equals
    the solo single-adapter generate with the same seed."""
    reqs, solos, results = mixed_run
    for (tid, _, _), solo, got in zip(reqs, solos, results):
        np.testing.assert_array_equal(got, solo, err_msg=f"adapter={tid}")
    assert len({tuple(s) for s in solos}) == len(solos)


def test_compile_budget_holds_with_adapters(lm, store, server, mixed_run):
    """The port compiles nothing (the counters say 0 compiles); LRU
    churn with adapters serves every request, one prefill each, and
    every pin is released when the streams end."""
    cc = server.engine.cache_stats()
    assert cc["prefill"]["compiles"] == 0 == cc["decode"]["compiles"]
    loads = store.stats()["loads"]
    hs = [server.submit(_prompt(4 + i, 20 + i),
                        adapter_id=("t0", "t1", "t2", None)[i % 4],
                        max_new_tokens=3, do_sample=bool(i % 2), seed=i)
          for i in range(6)]
    for h in hs:
        assert h.result(timeout=300).shape[0] == 3
    cc2 = server.engine.cache_stats()
    assert cc2["prefill"]["calls"] == cc["prefill"]["calls"] + 6
    assert cc2["decode"]["compiles"] == 0
    assert store.stats()["loads"] >= loads
    deadline = time.time() + 30
    while store.stats()["pinned_rows"] and time.time() < deadline:
        time.sleep(0.01)
    assert store.stats()["pinned_rows"] == 0


def test_adapter_submit_validation(lm, server):
    model, _ = lm
    with pytest.raises(ValueError, match="unknown adapter"):
        server.submit(_prompt(5, 0), adapter_id="nobody")
    bare = InferenceServer(model, slots=1, device="cpu", **GEO)
    with pytest.raises(ValueError, match="no adapter_store"):
        bare.submit(_prompt(5, 0), adapter_id="t0")


def test_store_is_owned_by_one_engine(lm, store, server):
    """Pins are engine-lifecycle state: one store per replica."""
    model, _ = lm
    with pytest.raises(ValueError, match="one store per replica"):
        InferenceServer(model, slots=1, adapter_store=store, device="cpu",
                        **GEO)
    other = apply_lora(_gpt(), LCFG)
    with pytest.raises(ValueError, match="different model"):
        InferenceServer(model, slots=1, device="cpu",
                        adapter_store=AdapterStore(other, max_loaded=1),
                        **GEO)


def test_acquire_with_salt_is_atomic(lm, tenants):
    model, _ = lm
    st = AdapterStore(model, max_loaded=2)
    st.register("t0", tenants["t0"])
    row, salt = st.acquire("t0", with_salt=True)
    assert salt == st.salt("t0")
    st.register("t0", tenants["t1"])    # version bump mid-flight
    assert st.salt("t0") != salt
    assert st.acquire(None, with_salt=True) == (0, b"")
    st.release_all()


def test_base_alias_is_one_namespace(server, mixed_run):
    p = _prompt(6, 77)
    a = server.submit(p, max_new_tokens=4).result(timeout=300)
    b = server.submit(p, adapter_id="base",
                      max_new_tokens=4).result(timeout=300)
    np.testing.assert_array_equal(a, b)
    per = server.snapshot()["per_adapter"]
    assert "base" in per and None not in per


def test_snapshot_surfaces_per_adapter(server, mixed_run):
    snap = server.snapshot()
    per = snap["per_adapter"]
    assert {"base", "t0", "t1", "t2"} <= set(per)
    for e in per.values():
        assert e["requests"] >= 1 and e["tokens"] >= 1
        assert "ttft_p50_ms" in e
    assert snap["adapter_store"]["resident"] >= 1
    assert snap["adapter_store"]["rank"] == LCFG.rank


def test_adapter_error_at_admit_fails_only_that_request(lm, tenants):
    """Every row pinned: the next tenant's admission fails with
    AdapterError on the host; the engine is not reset and the other
    requests finish."""
    model, _ = lm
    st = AdapterStore(model, max_loaded=1)
    for name, tree in tenants.items():
        st.register(name, tree)
    srv = InferenceServer(model, slots=2, adapter_store=st, device="cpu",
                          **GEO)
    try:
        h0 = srv.submit(_prompt(6, 1), adapter_id="t0", max_new_tokens=30)
        while not h0.tokens().size:
            time.sleep(0.01)
        h1 = srv.submit(_prompt(6, 2), adapter_id="t1", max_new_tokens=3)
        with pytest.raises(AdapterError, match="pinned"):
            h1.result(timeout=120)
        assert h0.result(timeout=120).shape == (30,)
        snap = srv.snapshot()
    finally:
        srv.shutdown(drain=False, timeout=30)
    assert snap["requests_failed"] == 1 and snap["requests_requeued"] == 0
    assert snap["per_adapter"]["t1"]["failures"] == 1


def test_pool_salts_keep_tenants_apart(lm, tenants):
    """With a prefix pool, two tenants with the same prompt never share a
    block: the hit tokens come from the salt. A tenant's second request
    hits its own blocks, and every stream equals solo generate."""
    model, _ = lm
    st = AdapterStore(model, max_loaded=2)
    for name in ("t0", "t1"):
        st.register(name, tenants[name])
    srv = InferenceServer(model, slots=2, adapter_store=st, device="cpu",
                          prefix_cache=dict(block_tokens=4,
                                            max_bytes=1 << 20), **GEO)
    p = _prompt(11, 9)
    order = ("t0", "t1", None, "t0")
    try:
        hs = []
        for tid in order:
            hs.append(srv.submit(p, adapter_id=tid, max_new_tokens=4))
            hs[-1].result(timeout=120)
    finally:
        srv.shutdown(drain=False, timeout=30)
    assert [h.cache_hit_tokens for h in hs] == [0, 0, 0, 8]
    for tid, h in zip(order, hs):
        if tid is None:
            clear_adapter(model)
        else:
            set_adapter(model, tenants[tid])
        solo = model.generate(p[None], max_new_tokens=4, **GEO)[0]
        np.testing.assert_array_equal(h.result(), solo, err_msg=str(tid))
    clear_adapter(model)


# ------------------------------------------------- device-free satellites
def test_metrics_per_adapter_block():
    m = ServingMetrics(slots=2)
    m.adapter_request("a")
    m.adapter_tokens("a", 5)
    m.observe_adapter_ttft("a", 0.1)
    m.adapter_request(None)
    m.adapter_tokens(None, 2)
    snap = m.snapshot()
    assert snap["per_adapter"]["a"] == {
        "requests": 1, "tokens": 5, "ttft_p50_ms": 100.0,
        "failures": 0, "ttft_count": 1, "ttft_sum_ms": 100.0}
    assert snap["per_adapter"]["base"]["tokens"] == 2
    m.reset()
    assert "per_adapter" not in m.snapshot()


def test_prefix_digest_salt_isolates_tenants():
    toks = np.arange(33, dtype=np.int32)
    base = chain_digests(toks, 8)
    t0 = chain_digests(toks, 8, salt=b"lora:t0")
    t1 = chain_digests(toks, 8, salt=b"lora:t1")
    assert len(base) == len(t0) == 4
    assert all(a != b for a, b in zip(base, t0))
    assert all(a != b for a, b in zip(t0, t1))
    assert t0 == chain_digests(toks, 8, salt=b"lora:t0")


def test_tenant_key_and_serve_through_the_model(lm, tenants):
    """The scheduler's fairness key falls back to the adapter id (the
    reference's key), and Model.serve passes adapter_store= through."""
    from paddle_tpu_torch.serving import BASE_TENANT, FifoScheduler, Request

    assert FifoScheduler.tenant_of(Request(prompt=[1], adapter_id="a")) == "a"
    assert FifoScheduler.tenant_of(
        Request(prompt=[1], adapter_id="a", tenant="t")) == "t"
    assert FifoScheduler.tenant_of(Request(prompt=[1])) == BASE_TENANT
    model, _ = lm
    st = AdapterStore(model, max_loaded=1)
    st.register("t2", tenants["t2"])
    srv = hapi.Model(model).serve(slots=1, adapter_store=st, device="cpu",
                                  **GEO)
    try:
        got = srv.submit(_prompt(6, 8), adapter_id="t2",
                         max_new_tokens=3).result(timeout=120)
    finally:
        srv.shutdown(timeout=30)
    set_adapter(model, tenants["t2"])
    np.testing.assert_array_equal(
        got, model.generate(_prompt(6, 8)[None], max_new_tokens=3, **GEO)[0])
    clear_adapter(model)


def test_adapter_dropout_in_training_only():
    """LoraConfig.dropout drops the adapter branch's input in training
    only, from the step's random streams (replayed from the same seeds);
    eval is deterministic and equals the undropped delta."""
    from paddle_tpu_torch.nn.layer import rng_context

    model = apply_lora(_gpt(), LoraConfig(rank=4, alpha=8.0, dropout=0.5))
    set_adapter(model, _random_adapter(model, np.random.default_rng(1)))
    x = torch.as_tensor(_prompt(8, 3)[None])
    with torch.no_grad():
        model.eval()
        e1, e2 = model(x), model(x)
        model.train()
        with rng_context({"dropout": 5}):
            t1 = model(x)
        with rng_context({"dropout": 5}):
            t2 = model(x)
        with rng_context({"dropout": 6}):
            t3 = model(x)
    assert torch.equal(e1, e2) and torch.equal(t1, t2)
    assert not torch.equal(t1, e1) and not torch.equal(t1, t3)


# ======================================================== cross-package
FAMILIES = ("gpt", "llama")


def _family_cfgs(family):
    kw = dict(max_position_embeddings=64, use_flash_attention=False)
    if family == "gpt":
        kw.update(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
        return jax_gpt_tiny(**kw), gpt_tiny(**kw)
    return jax_llama_tiny(**kw), llama_tiny(**kw)


def _jax_model(family, seed=5):
    pt.seed(seed)
    jcfg, _ = _family_cfgs(family)
    jm = (JaxGPT if family == "gpt" else JaxLlama)(jcfg)
    jm.eval()
    return jm


def _port_from(family, jm, lora=None):
    _, tcfg = _family_cfgs(family)
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    conv = gpt_from_jax if family == "gpt" else llama_from_jax
    return conv(state, tcfg, device="cpu", lora=lora)


JLCFG = jlora.LoraConfig(rank=4, alpha=8.0)


@pytest.fixture(scope="module", params=FAMILIES)
def cross(request):
    """A seeded JAX model injected with LoRA, its port twin converted by
    name (adapter leaves included), and three tenants."""
    family = request.param
    jm = _jax_model(family)
    jlora.apply_lora(jm, JLCFG)
    tm = _port_from(family, jm, lora=LCFG)
    rng = np.random.default_rng(17)
    zero = jlora.lora_state(jm)
    tenants = {t: {k: rng.normal(0, 0.04, tuple(v.shape)).astype(np.float32)
                   for k, v in zero.items()} for t in ("t0", "t1", "t2")}
    return family, jm, tm, tenants


def test_cross_fingerprint_and_leaves(cross):
    family, jm, tm, _ = cross
    assert base_fingerprint(tm) == jlora.base_fingerprint(jm)
    assert lora_paths(tm) == jlora.lora_paths(jm)
    jstate = jlora.lora_state(jm)
    tstate = lora_state(tm)
    assert list(tstate) == list(jstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(tstate[k].detach().numpy(),
                                      np.asarray(v), k)
    # an un-injected pair fingerprints alike too: the digest skips the
    # adapter leaves
    fresh = _jax_model(family)
    assert base_fingerprint(_port_from(family, fresh)) \
        == jlora.base_fingerprint(fresh)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_adapter_checkpoints(cross, writer, tmp_path):
    """The same adapter saved by both packages gives byte-equal files, and
    each package loads what the other wrote (fingerprint checked)."""
    _, jm, tm, tenants = cross
    jlora.set_adapter(jm, tenants["t1"])
    set_adapter(tm, tenants["t1"])
    jlora.save_adapter(str(tmp_path / "ref"), jm)
    save_adapter(str(tmp_path / "port"), tm)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert (tmp_path / "ref" / name).read_bytes() \
            == (tmp_path / "port" / name).read_bytes(), name
    jlora.clear_adapter(jm)
    clear_adapter(tm)
    d = str(tmp_path / ("ref" if writer == "reference" else "port"))
    if writer == "reference":
        state, meta = load_adapter(d, tm)
        got = {k: v.numpy() for k, v in state.items()}
    else:
        state, meta = jlora.load_adapter(d, jm)
        got = {k: np.asarray(v) for k, v in state.items()}
    assert meta["base_fingerprint"] == base_fingerprint(tm)
    assert set(got) == set(tenants["t1"])
    for k, v in tenants["t1"].items():
        np.testing.assert_array_equal(got[k], v, k)


def test_cross_injected_forward(cross):
    family, jm, tm, tenants = cross
    ids = np.random.default_rng(3).integers(0, 1024, (2, 16))
    for name in ("t0", "t2"):
        jlora.set_adapter(jm, tenants[name])
        set_adapter(tm, tenants[name])
        ref = np.asarray(jm(ids))
        with torch.no_grad():
            got = tm(torch.as_tensor(ids)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0,
                                   err_msg=f"{family} {name}")
    jlora.clear_adapter(jm)
    clear_adapter(tm)


def test_cross_salt_and_digests(cross):
    _, jm, tm, tenants = cross
    jst = jlora.AdapterStore(jm, max_loaded=2)
    tst = AdapterStore(tm, max_loaded=2)
    assert tst.page_bytes == jst.page_bytes
    toks = np.arange(40, dtype=np.int32)
    for versions in (1, 2):
        for name in ("t0", "tenant-ä"):
            jst.register(name, tenants["t0"])
            tst.register(name, tenants["t0"])
        for name in ("t0", "tenant-ä", None, "base"):
            assert tst.salt(name) == jst.salt(name)
            assert chain_digests(toks, 8, salt=tst.salt(name)) \
                == jax_chain_digests(toks, 8, salt=jst.salt(name))
    row, salt = tst.acquire("t0", with_salt=True)
    assert salt == jst.acquire("t0", with_salt=True)[1] == b"lora:t0@2"


def test_cross_mixed_batch(cross):
    """Three tenants plus the base in one live batch, greedy and seeded:
    every stream equals the port's solo generate; the greedy streams
    equal the JAX server's too."""
    family, jm, tm, tenants = cross
    reqs = [("t0", _prompt(7, 1, 1024), dict(max_new_tokens=6)),
            (None, _prompt(9, 2, 1024), dict(max_new_tokens=5)),
            ("t1", _prompt(5, 3, 1024), dict(max_new_tokens=7,
                                             do_sample=True,
                                             temperature=0.8, seed=11)),
            ("t2", _prompt(8, 4, 1024), dict(max_new_tokens=6)),
            ("t1", _prompt(10, 5, 1024), dict(max_new_tokens=4))]
    solos = []
    for tid, p, kw in reqs:
        if tid is None:
            clear_adapter(tm)
        else:
            set_adapter(tm, tenants[tid])
        solos.append(tm.generate(p[None], **kw, **GEO)[0])
    clear_adapter(tm)
    tst = AdapterStore(tm, max_loaded=2)   # 3 tenants, 2 rows: churn
    jst = jlora.AdapterStore(jm, max_loaded=2)
    for name, tree in tenants.items():
        tst.register(name, tree)
        jst.register(name, tree)
    tsrv = InferenceServer(tm, slots=3, adapter_store=tst, device="cpu",
                           **GEO)
    jsrv = JaxServer(jm, slots=3, adapter_store=jst, **GEO)
    try:
        th, jh = [], []
        for tid, p, kw in reqs:
            th.append(tsrv.submit(p, adapter_id=tid, **kw))
            if not kw.get("do_sample"):
                jh.append(jsrv.submit(p, adapter_id=tid, **kw))
            time.sleep(0.02)
        got = [h.result(timeout=300) for h in th]
        jgot = [h.result(timeout=300) for h in jh]
    finally:
        tsrv.shutdown(drain=False, timeout=60)
        jsrv.shutdown(drain=False, timeout=60)
    for (tid, _, _), solo, g in zip(reqs, solos, got):
        np.testing.assert_array_equal(g, solo, err_msg=f"{family} {tid}")
    greedy = [g for (_, _, kw), g in zip(reqs, got)
              if not kw.get("do_sample")]
    for a, b in zip(greedy, jgot):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=family)
    assert tst.stats()["evictions"] >= 1


def test_cross_fit_lora(cross):
    """fit(lora=...) in both packages from the same weights and the same
    initial adapter: per-batch losses within 1e-5 relative, the trained
    adapter leaves within 1e-4 absolute, the base untouched in both."""
    family, _, _, _ = cross
    jm = _jax_model(family, seed=8)
    tm = _port_from(family, jm)
    jcfg = jlora.LoraConfig(rank=2, alpha=4.0)
    tcfg = LoraConfig(rank=2, alpha=4.0)
    jlora.apply_lora(jm, jcfg)
    apply_lora(tm, tcfg)
    set_adapter(tm, {k: np.asarray(v)
                     for k, v in jlora.lora_state(jm).items()})
    jm.train()
    tm.train()
    base = {k: v.detach().clone() for k, v in tm.named_parameters()
            if not is_lora_param(k)}
    rng = np.random.default_rng(4)
    data = [(ids, ids) for ids in
            (rng.integers(0, 1024, (2, 12)) for _ in range(3))]

    def recorder(cls):
        class Rec(cls):
            losses = []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(float(logs["loss"]))
        return Rec()

    jrec, trec = recorder(jhapi.Callback), recorder(hapi.Callback)
    jmodel = jhapi.Model(jm)
    jmodel.prepare(optimizer=JAdam(learning_rate=1e-3, parameters=[]),
                   loss=lambda out, labels: jm.loss(out, labels))
    jmodel.fit(data, epochs=2, verbose=0, lora=jcfg, callbacks=[jrec])
    tmodel = hapi.Model(tm)
    tmodel.prepare(optimizer=Adam(learning_rate=1e-3),
                   loss=lambda out, labels: tm.loss(out, labels))
    tmodel.fit(data, epochs=2, verbose=0, lora=tcfg, callbacks=[trec])
    assert len(trec.losses) == 6
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=RTOL)
    jleaves = jmodel._train_step.params
    tleaves = lora_state(tm)
    assert set(jleaves) == set(tleaves)
    for k, v in jleaves.items():
        np.testing.assert_allclose(tleaves[k].detach().numpy(),
                                   np.asarray(v), atol=1e-4, rtol=0,
                                   err_msg=k)
    assert any(bool(v.abs().max() > 0) for k, v in tleaves.items()
               if k.endswith("lora_B"))
    for k, v in tm.named_parameters():
        if k in base:
            assert torch.equal(v, base[k]), k


# ------------------------------------------------ the LoRA lifecycle soak
SOAK_STEPS, SOAK_SAVE_EVERY, SOAK_KILL_AT = 12, 4, 6


class _KillAt(hapi.Callback):
    """Deliver a real SIGTERM to ourselves after the N-th batch."""

    def __init__(self, at):
        super().__init__()
        self.at, self.seen, self.fired = at, 0, False

    def on_train_batch_end(self, step, logs=None):
        self.seen += 1
        if not self.fired and self.seen == self.at:
            self.fired = True
            os.kill(os.getpid(), signal.SIGTERM)


def _soak_base(family):
    """tools/lora_soak.py's tiny base (hidden 64, vocab 256, 64 positions),
    GPT or Llama (4 heads, 2 KV heads), from one seed."""
    gen = torch.Generator().manual_seed(1234)
    if family == "gpt":
        return GPTForCausalLM(_tiny_cfg(), device="cpu", generator=gen)
    return LlamaForCausalLM(llama_tiny(
        hidden_size=64, vocab_size=256, max_position_embeddings=64,
        use_flash_attention=False), device="cpu", generator=gen)


def _soak_fit(family, ckpt_dir, callbacks=()):
    """tools/lora_soak.py's fit on the port: an adapter-only fit of
    SOAK_STEPS batches with the supervisor checkpointing every
    SOAK_SAVE_EVERY steps. Returns the model."""
    trandom.seed(1234)
    net = _soak_base(family).train()
    m = hapi.Model(net, labels=[])
    m.prepare(AdamW(learning_rate=1e-2, weight_decay=0.01))
    ids = np.random.default_rng(1).integers(0, 256, (2 * SOAK_STEPS, 12))
    from paddle_tpu_torch.io import TensorDataset

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        m.fit(TensorDataset([ids, ids]), batch_size=2, epochs=1,
              shuffle=False, verbose=0, callbacks=list(callbacks),
              lora=LoraConfig(rank=4, alpha=8.0),
              recovery=RecoveryPolicy(
                  checkpoint_dir=ckpt_dir,
                  save_interval_steps=SOAK_SAVE_EVERY, check_interval=1,
                  async_save=False, grace_seconds=10.0))
    return m


@pytest.mark.parametrize("family", FAMILIES)
def test_lora_soak_preempt_resume_then_serve(family, tmp_path):
    """Train, preempt (SIGTERM) mid-fit, resume bit-identically, publish
    the adapter, load it into a store on a rebuilt base and serve mixed
    base + tenant traffic token-equal to solo generate."""
    ref = _soak_fit(family, str(tmp_path / "ref"))
    ref_leaves = {k: v.detach().clone()
                  for k, v in lora_state(ref.network).items()}
    with pytest.raises(TrainingPreempted) as info:
        _soak_fit(family, str(tmp_path / "run"),
                  callbacks=[_KillAt(SOAK_KILL_AT)])
    assert info.value.saved
    resumed = _soak_fit(family, str(tmp_path / "run"))
    got = lora_state(resumed.network)
    assert set(got) == set(ref_leaves)
    for k, v in ref_leaves.items():
        assert torch.equal(v.view(torch.int32), got[k].view(torch.int32)), k
    base = _soak_base(family)
    for k, v in resumed.network.named_parameters():
        if not is_lora_param(k):
            assert torch.equal(v, dict(base.named_parameters())[k]), k
    adir = str(tmp_path / "adapter")
    save_adapter(adir, resumed.network)
    # serve: a rebuilt base, the adapter loaded through the store
    served = apply_lora(_soak_base(family).eval(),
                        LoraConfig(rank=4, alpha=8.0))
    st = AdapterStore(served, max_loaded=2)
    st.load("tenant", adir)
    probes = [("tenant", _prompt(9, 40), dict(max_new_tokens=6)),
              (None, _prompt(7, 41), dict(max_new_tokens=6)),
              ("tenant", _prompt(5, 42), dict(max_new_tokens=6,
                                              do_sample=True, seed=3))]
    with InferenceServer(served, slots=2, adapter_store=st, device="cpu",
                         **GEO) as srv:
        hs = [srv.submit(p, adapter_id=t, **kw) for t, p, kw in probes]
        outs = [h.result(timeout=120) for h in hs]
        snap = srv.snapshot()
    assert snap["requests_completed"] == 3 and snap["requests_failed"] == 0
    state, _ = load_adapter(adir, served)
    for (tid, p, kw), out in zip(probes, outs):
        if tid is None:
            clear_adapter(served)
        else:
            set_adapter(served, state)
        np.testing.assert_array_equal(
            out, served.generate(p[None], **kw, **GEO)[0], err_msg=str(tid))

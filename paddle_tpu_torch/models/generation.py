"""KV-cache generation (port of ``paddle_tpu/models/generation.py:96-594``).

Shape discipline as in the reference: the cache is PREALLOCATED
``[B, max_length, n_kv_heads, head_dim]`` per layer and never changes
shape; **prefill** runs the prompt right-padded to the smallest length
bucket through the block-local attention path (the flash kernel on the
card) and writes the prompt's K/V into the cache; **decode** is a
one-token step of cached attention against the full cache under a
position mask. PyTorch runs eagerly, so there is no compile count to
keep; the buckets bound the set of prefill shapes the kernels see.

Sampling uses explicit ``torch.Generator``s. ``torch`` and ``jax.random``
give different numbers from one seed, so sampled tokens cannot equal the
JAX package's; greedy tokens do. What the port keeps by itself is the
reference's placement invariant (``per_row_keys``): the generator of row
``r`` at decode position ``p`` depends only on ``(seed, p, r)``, so a
served request's sampled stream equals a solo batch-1 :func:`generate`
with the same seed, whatever its slot or its batch companions.
"""
from __future__ import annotations

import random
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..framework.tree import tree_map
from ..io.batching import bucket_for

__all__ = ["DEFAULT_PREFILL_BUCKETS", "GenerationEngine", "generate",
           "normalize_kv_dtype", "cache_entries", "init_cache",
           "cache_nbytes", "slice_cache_rows", "scatter_cache_rows",
           "gather_cache_blocks", "scatter_cache_blocks", "filter_logits",
           "sample_logits", "sample_logits_rows", "per_row_generators",
           "fresh_seed", "torch_dtype"]

# prompt lengths round up to the smallest of these (clipped to the
# model's max_length)
DEFAULT_PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` (the reference's config spelling) -> ``torch.bfloat16``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


# ----------------------------------------------------------------- cache
def normalize_kv_dtype(kv_dtype):
    """Canonicalize a ``kv_dtype`` knob: ``None``/``"none"`` -> None (the
    full-precision cache), ``"int8"`` -> ``"int8"``. Anything else is an
    error at construction time, not a quiet full-precision fallback."""
    if kv_dtype is None or kv_dtype in ("none", "fp", "full"):
        return None
    if str(kv_dtype) == "int8":
        return "int8"
    raise ValueError(f"unsupported kv_dtype {kv_dtype!r}; expected None "
                     f"or 'int8'")


def cache_entries(spec: dict, rows: int, length: int, dtype=None,
                  kv_dtype=None, device=None):
    """Zeroed cache-shaped storage for ``spec`` (a ``cache_spec()``): per
    layer a ``(k, v)`` pair of ``[rows, length, n_kv_heads, head_dim]``
    entries in ``dtype`` (``spec["dtype"]`` by default), or of int8
    ``(values, float32 scales [rows, length, n_kv_heads, 1])`` pairs under
    ``kv_dtype="int8"``. The KV cache (rows = batch) and the prefix pool
    (rows = blocks, length = block tokens) share this layout."""
    dtype = torch_dtype(dtype or spec["dtype"])
    shape = (rows, length, spec["num_kv_heads"], spec["head_dim"])

    def entry():
        if normalize_kv_dtype(kv_dtype) == "int8":
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                device=device))
        return torch.zeros(shape, dtype=dtype, device=device)

    return tuple((entry(), entry()) for _ in range(spec["num_layers"]))


def init_cache(model, batch: int, max_length: Optional[int] = None,
               dtype=None, device=None, kv_dtype=None):
    """Preallocate the KV cache for ``model``: a tuple (one entry per
    layer) of ``(k, v)`` pairs, each ``[batch, max_length, n_kv_heads,
    head_dim]`` zeros in the cache dtype (``cfg.dtype`` by default), on
    the model's device by default.

    ``kv_dtype="int8"`` allocates the quantized layout instead: each
    ``k``/``v`` entry is an ``(int8 values, float32 scales [batch,
    max_length, n_kv_heads, 1])`` pair (see
    :mod:`paddle_tpu_torch.quantization`), about half the bytes of a bf16
    cache at head_dim 64 and up."""
    spec = model.cache_spec()
    max_length = int(max_length or spec["max_length"])
    device = model.device if device is None else device
    return cache_entries(spec, batch, max_length, dtype, kv_dtype, device)


def cache_nbytes(cache) -> int:
    """Total bytes of a cache (quantized scale leaves included)."""
    total = [0]

    def add(x):
        total[0] += x.numel() * x.element_size()
        return x

    tree_map(add, cache)
    return total[0]


def slice_cache_rows(cache, index: int, rows: int = 1):
    """Views of ``rows`` batch rows starting at ``index`` of every cache
    leaf: ``[B, S, Hkv, D]`` -> ``[rows, S, Hkv, D]``."""
    return tree_map(lambda x: x[index:index + rows], cache)


def scatter_cache_rows(cache, row_cache, index: int):
    """Write ``row_cache`` (``[r, S, Hkv, D]`` leaves) into ``cache``
    (``[B, S, Hkv, D]`` leaves) at batch row ``index``, in place — the
    slot scatter of continuous batching. Returns ``cache``."""
    def put(dst, src):
        n = src.shape[0]
        if not 0 <= index <= dst.shape[0] - n:
            raise IndexError(f"rows {index}:{index + n} outside a cache "
                             f"of batch {dst.shape[0]}")
        dst[index:index + n].copy_(src)
        return dst

    return tree_map(put, cache, row_cache)


def _block_index(block_indices, device):
    return torch.as_tensor(np.asarray(block_indices, np.int64),
                           device=device)


def gather_cache_blocks(pool, block_indices, length: int):
    """Assemble one cache row from a paged block pool: gather the pool's
    ``[N, bs, Hkv, D]`` leaves at ``block_indices`` ``[n]`` and lay the
    blocks out contiguously as ``[1, length, Hkv, D]`` (zero past
    ``n * bs``).

    The prefix-cache read: matched prompt blocks land in a slot's cache
    rows, so a hit never re-prefills the shared prefix. Indices past the
    matched chain point at the pool's dump block (row 0); those positions
    hold garbage, which is safe under the invariant of slot reuse: the
    position mask never lets a query see beyond its request's frontier,
    and every position is rewritten before it first becomes visible."""
    def assemble(leaf):
        idx = _block_index(block_indices, leaf.device)
        n, bs = idx.shape[0], leaf.shape[1]
        flat = leaf.index_select(0, idx).reshape(1, n * bs, *leaf.shape[2:])
        if n * bs < length:
            flat = torch.cat([flat, flat.new_zeros(
                (1, length - n * bs) + tuple(leaf.shape[2:]))], dim=1)
        return flat[:, :length]

    return tree_map(assemble, pool)


def scatter_cache_blocks(pool, row_cache, block_indices):
    """Write a cache row back into a paged block pool, in place: split
    ``row_cache`` leaves ``[1, S, Hkv, D]`` into ``n`` blocks of the
    pool's block size and write them at ``block_indices`` ``[n]``
    (inverse of :func:`gather_cache_blocks`). Returns ``pool``.

    Blocks the host chose not to store point at the dump row 0, so that
    index repeats. ``index_copy_`` with a repeated index is
    nondeterministic on CUDA (which duplicate lands is unspecified);
    that is harmless only because row 0 is never read as valid: the
    pool never allocates it, and a read that reaches it lies past the
    reader's frontier. Keep that invariant."""
    def store(leaf, row):
        idx = _block_index(block_indices, leaf.device)
        n, bs = idx.shape[0], leaf.shape[1]
        blocks = row[0, :n * bs].reshape(n, bs, *leaf.shape[2:])
        leaf.index_copy_(0, idx, blocks.to(leaf.dtype))
        return leaf

    return tree_map(store, pool, row_cache)


# -------------------------------------------------------------- sampling
_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _row_seed(seed: int, row: int, position: Optional[int] = None) -> int:
    """The generator seed of batch row ``row`` at decode ``position``
    (``None`` at prefill): fold the position into the request seed first,
    then the row index, as ``per_row_keys`` does with PRNG keys."""
    h = _splitmix64(int(seed) & _MASK64)
    if position is not None:
        h = _splitmix64(h ^ _splitmix64(int(position) + 1))
    h = _splitmix64(h ^ _splitmix64((int(row) + 1) << 32))
    return h & ((1 << 63) - 1)


def per_row_generators(seed: int, batch: int, position: Optional[int] = None,
                       device=None) -> List[torch.Generator]:
    """One ``torch.Generator`` per batch row, on ``device`` (the port of
    ``per_row_keys``, ``generation.py:281``): every (step, row) pair draws
    from its own stream, and row 0 at batch 1 is the derivation the
    serving engine replays per slot."""
    gens = []
    for r in range(batch):
        g = torch.Generator(device=device)
        g.manual_seed(_row_seed(seed, r, position))
        gens.append(g)
    return gens


def fresh_seed() -> int:
    """A seed for an unseeded sampled request: fresh randomness per
    request, so two unseeded requests do not sample the same stream."""
    return random.SystemRandom().getrandbits(63)


def filter_logits(logits, temperature=1.0, top_k: int = 0, top_p=1.0):
    """The temperature / top-k / top-p transform that sampling draws from,
    as float32 logits ``[..., V]`` with ``-inf`` on filtered entries.
    ``temperature`` and ``top_p`` are Python floats. ``top_p >= 1.0`` is
    an exact no-op."""
    l = logits.float() / max(float(temperature), 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(l, min(int(top_k), l.shape[-1]), dim=-1).values[..., -1:]
        l = l.masked_fill(l < kth, float("-inf"))
    if float(top_p) < 1.0:
        # nucleus: keep the smallest prefix of the sorted distribution
        # whose EXCLUSIVE cumulative mass is < top_p (top-1 always stays)
        sorted_l = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < float(top_p)
        cutoff = torch.where(keep, sorted_l, torch.full_like(sorted_l, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        l = l.masked_fill(l < cutoff, float("-inf"))
    return l


def _gumbel_argmax(l_row, generator: torch.Generator):
    """A categorical draw from logits ``l_row`` ``[V]``: argmax of the
    logits plus Gumbel noise from ``generator``."""
    u = torch.rand(l_row.shape[-1], generator=generator, device=l_row.device,
                   dtype=torch.float32)
    return torch.argmax(l_row - torch.log(-torch.log(u.clamp_min(1e-20))))


def _per_row(value, batch: int) -> List[float]:
    if np.ndim(value) == 0:
        return [float(value)] * batch
    return [float(x) for x in value]


def sample_logits_rows(logits, generators: Sequence[Optional[torch.Generator]],
                       temperature=1.0, top_k: int = 0, top_p=1.0,
                       greedy_mask=None):
    """Next token for each row of ``logits`` ``[B, V]`` with one generator
    PER ROW. ``temperature``/``top_p`` are scalars or per-row host
    sequences; ``greedy_mask`` (host ``[B]`` bools) picks argmax per row.
    A row whose generator is ``None`` takes argmax too (the engine passes
    ``None`` for free and finished slots). Each sampled row is filtered
    and drawn on its own, so its token does not depend on the other rows.
    Returns int64 ``[B]`` on the logits' device."""
    B = logits.shape[0]
    temp, tp = _per_row(temperature, B), _per_row(top_p, B)
    greedy = [False] * B if greedy_mask is None else [bool(g) for g in greedy_mask]
    out = torch.argmax(logits, dim=-1)
    for i in range(B):
        if greedy[i] or generators[i] is None:
            continue
        l = filter_logits(logits[i:i + 1], temp[i], top_k, tp[i])[0]
        out[i] = _gumbel_argmax(l, generators[i])
    return out


def sample_logits(logits, generators=None, temperature=1.0, top_k: int = 0,
                  top_p=1.0, greedy: bool = False):
    """Batched next-token selection on ``logits`` [B, V]: argmax under
    ``greedy``, else a categorical draw over :func:`filter_logits` with
    ``generators[r]`` for row r."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    return sample_logits_rows(logits, generators, temperature, top_k, top_p)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- engine
class GenerationEngine:
    """Bucketed prefill + one-token decode loop for one model and cache
    geometry (port of ``GenerationEngine``, ``generation.py:325``).
    ``kv_dtype="int8"`` runs it on the quantized cache."""

    def __init__(self, model, max_length: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 kv_dtype=None):
        self.model = model
        spec = model.cache_spec()
        self.kv_dtype = normalize_kv_dtype(kv_dtype)
        self._calls = {"prefill": 0, "decode": 0}
        self.max_length = int(max_length or spec["max_length"])
        if self.max_length > spec["max_length"]:
            raise ValueError(
                f"max_length {self.max_length} exceeds the model's position "
                f"table ({spec['max_length']} positions)")
        buckets = tuple(sorted(int(b) for b in
                               (prefill_buckets or DEFAULT_PREFILL_BUCKETS)
                               if int(b) <= self.max_length))
        self.prefill_buckets = buckets or (self.max_length,)

    def cache_stats(self) -> dict:
        """``{"prefill": {...}, "decode": {...}}`` with the reference's
        ``compiles`` and ``calls`` keys. The port traces and compiles
        nothing (PyTorch runs eagerly), so ``compiles`` is always 0;
        ``calls`` counts the forwards of each kind."""
        return {kind: {"compiles": 0, "calls": n}
                for kind, n in self._calls.items()}

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 seed: Optional[int] = None,
                 return_stats: bool = False,
                 done_check_interval: int = 4):
        """Autoregressively extend ``input_ids`` [B, prompt_len]; returns
        the GENERATED ids as an int32 numpy array ``[B, n]``
        (``n <= max_new_tokens``: the loop stops once every row emitted
        ``eos_token_id``, finished rows are filled with eos). The all-done
        flag is read on the host every ``done_check_interval`` steps and
        the overshoot trimmed, so the output equals a per-step check."""
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        B, prompt_len = ids.shape
        if prompt_len < 1:
            raise ValueError("generate needs a non-empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "step always emits the first token)")
        if prompt_len + max_new_tokens > self.max_length:
            raise ValueError(
                f"prompt_len {prompt_len} + max_new_tokens {max_new_tokens} "
                f"exceeds the cache's max_length {self.max_length}; build "
                f"the engine with a larger max_length")
        device = self.model.device
        bucket = min(bucket_for(prompt_len, self.prefill_buckets),
                     self.max_length)
        ids_p = np.zeros((B, bucket), np.int64)
        ids_p[:, :prompt_len] = ids
        greedy = not do_sample
        if do_sample and seed is None:
            seed = fresh_seed()
        eos_id = -1 if eos_token_id is None else int(eos_token_id)

        def pick(logits, position):
            gens = (None if greedy else
                    per_row_generators(seed, B, position, device))
            return sample_logits(logits, gens, temperature, top_k, top_p,
                                 greedy=greedy)

        # generation runs the eval graph (dropout off) whatever the mode
        was_training = self.model.training
        self.model.eval()
        try:
            cache = init_cache(self.model, B, self.max_length,
                               kv_dtype=self.kv_dtype)
            t0 = time.perf_counter()
            self._calls["prefill"] += 1
            logits, cache = self.model(
                torch.as_tensor(ids_p, device=device), cache=cache,
                position_offset=0, gather_last=prompt_len - 1)
            tok = pick(logits[:, 0, :], None)
            done = tok == eos_id
            tokens, dones = [tok], [done]
            _sync(device)  # honest TTFT: the first token is READY
            ttft = time.perf_counter() - t0
            pos = prompt_len
            check_done = eos_token_id is not None
            interval = max(1, int(done_check_interval))
            fill = max(eos_id, 0)
            for i in range(max_new_tokens - 1):
                if check_done and i % interval == 0 and bool(done.all()):
                    break
                self._calls["decode"] += 1
                logits, cache = self.model(tok[:, None], cache=cache,
                                           position_offset=pos)
                nxt = pick(logits[:, -1, :], pos)
                # finished rows keep emitting eos (or 0)
                tok = torch.where(done, torch.full_like(nxt, fill), nxt)
                done = done | (tok == eos_id)
                tokens.append(tok)
                dones.append(done)
                pos += 1
            out = torch.stack(tokens, dim=1).cpu().numpy().astype(np.int32)
            if check_done and out.shape[1] > 1:
                col_done = torch.stack(dones, dim=1).all(dim=0).cpu().numpy()
                if col_done.any():
                    out = out[:, :int(col_done.argmax()) + 1]
            total = time.perf_counter() - t0
        finally:
            if was_training:
                self.model.train()
        if not return_stats:
            return out
        n = out.shape[1]
        return out, {
            "ttft_s": ttft,
            "total_s": total,
            "new_tokens": n,
            "tokens_per_sec": B * n / max(total, 1e-9),
            "decode_tokens_per_sec": (B * (n - 1) / max(total - ttft, 1e-9)
                                      if n > 1 else 0.0),
            "prefill_bucket": bucket,
        }


def _engine_for(model, max_length, prefill_buckets,
                kv_dtype=None) -> GenerationEngine:
    """One engine per (max_length, buckets, kv_dtype) geometry, kept on
    the model."""
    engines = model.__dict__.setdefault("_generation_engines", {})
    key = (max_length, tuple(prefill_buckets) if prefill_buckets else None,
           normalize_kv_dtype(kv_dtype))
    if key not in engines:
        engines[key] = GenerationEngine(model, max_length=max_length,
                                        prefill_buckets=prefill_buckets,
                                        kv_dtype=kv_dtype)
    return engines[key]


def generate(model, input_ids, max_new_tokens: int = 32, *,
             max_length: Optional[int] = None,
             prefill_buckets: Optional[Sequence[int]] = None,
             kv_dtype=None, **sampling_kwargs):
    """Module-level entry point surfaced as ``model.generate(...)``. See
    :meth:`GenerationEngine.generate` for the sampling knobs;
    ``kv_dtype="int8"`` decodes on the quantized cache."""
    engine = _engine_for(model, max_length, prefill_buckets, kv_dtype)
    return engine.generate(input_ids, max_new_tokens, **sampling_kwargs)

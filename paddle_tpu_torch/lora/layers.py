"""LoRA injection: frozen-base low-rank adapters on existing layers (port
of ``paddle_tpu/lora/layers.py``).

Low-Rank Adaptation (arXiv:2106.09685) fine-tunes a frozen base model by
learning a rank-``r`` update per target projection: the layer computes
``W x + (alpha/r) * B (A x)`` with ``A [in, r]``, ``B [r, out]`` and only
``A``/``B`` trainable.

:func:`apply_lora` registers ``lora_A``/``lora_B`` as ordinary parameters
on each target layer and adds the delta in a forward hook
(``register_forward_hook``), so

- base parameter paths are unchanged: base checkpoints load before or
  after injection, and :func:`base_fingerprint` covers exactly the paths
  a model without LoRA has;
- every path that calls the target module picks the delta up: eager
  training, recompute (``torch.utils.checkpoint`` and the port's
  recompute re-run the module, hooks included), ``generate()`` and the
  serving engine's prefill and decode;
- ``B`` starts at zeros, so an injected model is bit-identical to the
  base until training moves the adapter.

Two modes:

- **solo** (default): the hook reads the layer's own ``lora_A``/
  ``lora_B``, broadcast to the batch: training and solo ``generate``;
- **batched rows** (:func:`adapter_rows`): the serving engine enters a
  per-batch-row adapter context on its worker thread; each target layer
  gets gathered ``[B, in, r]`` / ``[B, r, out]`` pages and applies a
  per-row product, so one decode step serves a batch that mixes tenants
  (row 0 of the page stack is the zero adapter, the base model).

Both modes go through :func:`_delta_rows`, the same two batched products,
so a tenant's served stream is token-identical to its solo generate.

Adapter leaves are float32 whatever the base's dtype, as the reference's
``create_parameter`` makes them after ``amp.decorate`` (which casts the
existing parameters, not the layer's default dtype); the delta computes
in the input's dtype.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn import functional as F
from ..nn.initializer import Constant, Normal, create_parameter

__all__ = ["LoraConfig", "apply_lora", "applied_config", "lora_paths",
           "lora_state", "set_adapter", "clear_adapter", "is_lora_param",
           "base_fingerprint", "adapter_rows"]

_LORA_LEAVES = ("lora_A", "lora_B")


@dataclass(frozen=True)
class LoraConfig:
    """Adapter geometry shared by training, the registry and serving.

    - ``rank``: the low-rank bottleneck ``r`` (optimizer state and
      adapter checkpoints scale with it, not with the model);
    - ``alpha``: the delta is scaled by ``alpha / rank``;
    - ``target_modules``: leaf module names to inject (e.g.
      ``("qkv_proj", "fc_in")``); ``None`` asks the model's
      ``lora_spec()`` (the GPT and Llama families have one);
    - ``dropout``: input dropout on the adapter branch, training only.
    """

    rank: int = 8
    alpha: float = 16.0
    target_modules: Optional[Tuple[str, ...]] = None
    dropout: float = 0.0

    def __post_init__(self):
        if int(self.rank) < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if not 0.0 <= float(self.dropout) < 1.0:
            raise ValueError(
                f"dropout must be in [0, 1), got {self.dropout}")
        if self.target_modules is not None:
            object.__setattr__(self, "target_modules",
                               tuple(self.target_modules))

    @property
    def scaling(self) -> float:
        return float(self.alpha) / float(self.rank)

    def to_dict(self) -> dict:
        return {"rank": int(self.rank), "alpha": float(self.alpha),
                "target_modules": (None if self.target_modules is None
                                   else list(self.target_modules)),
                "dropout": float(self.dropout)}


# ------------------------------------------------- batched adapter context
# The serving engine pushes a {layer_path: (A_rows, B_rows)} dict around
# its forward so that every hook reached under it applies the per-row
# pages instead of the layer's own adapter. Thread-local: the server's
# worker thread runs the engine.
_CTX = threading.local()


def _ctx_stack() -> list:
    stack = getattr(_CTX, "stack", None)
    if stack is None:
        stack = _CTX.stack = []
    return stack


def _current_rows() -> Optional[dict]:
    stack = _ctx_stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def adapter_rows(pages, rows):
    """Activate per-row adapter pages for every LoRA hook reached in this
    block (on this thread).

    ``pages`` maps layer path -> ``(A_stack [S, in, r], B_stack [S, r,
    out])``, the store's device-resident stacks; ``rows`` (an int, a
    sequence, an array or a tensor ``[B]``) names one stack row per batch
    row (0 = the zero adapter = the base model). Each target's rows are
    gathered once here, with ``index_select``, not per hook call."""
    idx = None
    ctx = {}
    for path, (a, b) in pages.items():
        if idx is None:
            idx = torch.as_tensor(rows, dtype=torch.long).to(a.device)
            if idx.ndim == 0:
                idx = idx[None]
        ctx[path] = (a.index_select(0, idx), b.index_select(0, idx))
    _ctx_stack().append(ctx)
    try:
        yield
    finally:
        _ctx_stack().pop()


@functools.lru_cache(maxsize=None)
def _scale_in(scaling: float, dtype: torch.dtype) -> float:
    # the reference multiplies by ``jnp.asarray(scaling, x.dtype)``: the
    # factor rounded to the input's dtype first
    return float(torch.tensor(scaling, dtype=dtype))


def _delta_rows(x, a_rows, b_rows, scaling):
    """The one adapter product both modes share: ``x [B, ..., in]``
    against per-row ``a_rows [B, in, r]`` and ``b_rows [B, r, out]``, in
    ``x``'s dtype, scaled by ``alpha/rank`` rounded to that dtype. One
    formulation (the same two batched products) is what makes a tenant's
    served stream equal its solo generate."""
    a_rows = a_rows.to(x.dtype)
    b_rows = b_rows.to(x.dtype)
    B = x.shape[0]
    t = torch.bmm(x.reshape(B, -1, x.shape[-1]), a_rows)
    d = torch.bmm(t, b_rows)
    return d.reshape(*x.shape[:-1], d.shape[-1]) * _scale_in(scaling,
                                                             x.dtype)


class _LoraHook:
    """Forward hook carrying one target layer's adapter math."""

    __slots__ = ("path", "config")

    def __init__(self, path: str, config: LoraConfig):
        self.path = path
        self.config = config

    def __call__(self, layer, inputs, output):
        x = inputs[0]
        if self.config.dropout and layer.training:
            x = F.dropout(x, p=self.config.dropout, training=True)
        ctx = _current_rows()
        if ctx is not None:
            try:
                a_rows, b_rows = ctx[self.path]
            except KeyError:
                raise KeyError(
                    f"adapter_rows context active but holds no pages for "
                    f"layer {self.path!r} — the AdapterStore was built "
                    f"for a different injection (target_modules "
                    f"mismatch?)") from None
        else:
            a, b = layer.lora_A, layer.lora_B
            batch = x.shape[0]
            a_rows = a.expand(batch, *a.shape)
            b_rows = b.expand(batch, *b.shape)
        return output + _delta_rows(x, a_rows, b_rows, self.config.scaling)


@dataclass
class _LoraApplied:
    """What :func:`apply_lora` records on the model instance."""

    config: LoraConfig
    paths: List[str]
    shapes: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]
    hooks: dict


def _resolve_targets(model, config: LoraConfig) -> Tuple[str, ...]:
    if config.target_modules is not None:
        return tuple(config.target_modules)
    spec = getattr(model, "lora_spec", None)
    if spec is None:
        raise ValueError(
            f"{type(model).__name__} has no lora_spec() and the "
            f"LoraConfig names no target_modules; pass target_modules= "
            f"explicitly (leaf layer names, e.g. ('qkv_proj', 'fc_in'))")
    return tuple(spec()["target_modules"])


def applied_config(model) -> Optional[LoraConfig]:
    """The :class:`LoraConfig` a model was injected with (None = base)."""
    st = model.__dict__.get("_lora_applied")
    return st.config if st is not None else None


def lora_paths(model) -> List[str]:
    """Paths of the injected target layers, in traversal order."""
    st = model.__dict__.get("_lora_applied")
    if st is None:
        raise ValueError(f"{type(model).__name__} has no LoRA injection; "
                         f"call apply_lora(model, config) first")
    return list(st.paths)


def apply_lora(model, config: LoraConfig):
    """Inject LoRA branches into ``model``'s target projections, in place.

    Each matched leaf module (by name, among modules with
    ``in_features``/``out_features``) gains float32 parameters ``lora_A``
    ``[in, rank]`` (Normal(0, 0.02), drawn from a generator seeded from
    the port's global seed, as ``create_parameter`` draws) and ``lora_B``
    ``[rank, out]`` (zeros: injection changes no output until training),
    and the delta hook.

    Idempotent under the same config; a second call with a different
    config raises (rebuild the model to change the geometry)."""
    existing = model.__dict__.get("_lora_applied")
    if existing is not None:
        if existing.config == config:
            return model
        raise ValueError(
            f"model already carries a LoRA injection with "
            f"{existing.config}; refusing to stack {config} on top — "
            f"rebuild the model to change adapter geometry")
    targets = _resolve_targets(model, config)
    paths: List[str] = []
    shapes: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {}
    hooks = {}
    for path, layer in model.named_modules():
        name = path.rsplit(".", 1)[-1]
        if not path or name not in targets:
            continue
        in_f = getattr(layer, "in_features", None)
        out_f = getattr(layer, "out_features", None)
        if in_f is None or out_f is None:
            raise ValueError(
                f"LoRA target {path!r} has no in_features/out_features — "
                f"only linear-style projections can carry an adapter "
                f"(got {type(layer).__name__})")
        device = layer.weight.device
        layer.register_parameter("lora_A", create_parameter(
            (in_f, config.rank), default_initializer=Normal(0.0, 0.02),
            device=device))
        layer.register_parameter("lora_B", create_parameter(
            (config.rank, out_f), default_initializer=Constant(0.0),
            device=device))
        hooks[path] = layer.register_forward_hook(_LoraHook(path, config))
        paths.append(path)
        shapes[path] = ((in_f, config.rank), (config.rank, out_f))
    if not paths:
        raise ValueError(
            f"no layer of {type(model).__name__} matched LoRA "
            f"target_modules {targets!r}")
    model.__dict__["_lora_applied"] = _LoraApplied(
        config=config, paths=paths, shapes=shapes, hooks=hooks)
    return model


# --------------------------------------------------------- adapter leaves
def is_lora_param(path: str) -> bool:
    """True for adapter leaves (``...lora_A`` / ``...lora_B``): the
    trainable-set predicate ``Model.fit(lora=...)`` hands the step."""
    return path.rsplit(".", 1)[-1] in _LORA_LEAVES


def lora_state(model) -> Dict[str, torch.Tensor]:
    """The adapter leaves: flat ``{param_path: parameter}`` over the
    injected ``lora_A``/``lora_B`` only, what :class:`~paddle_tpu_torch.
    lora.store.AdapterStore` saves, loads and stacks."""
    lora_paths(model)  # raises when not injected
    return {k: v for k, v in model.named_parameters() if is_lora_param(k)}


def set_adapter(model, state: Dict):
    """Write adapter leaves (from :func:`lora_state` or an adapter
    checkpoint; tensors or arrays) into the model's injected leaves, in
    place. Missing or unexpected keys, or a wrong shape, are an error: a
    truncated adapter silently serving the base model is the bug this
    refuses."""
    current = lora_state(model)
    want, got = set(current), set(state)
    if want != got:
        missing = sorted(want - got)[:3]
        extra = sorted(got - want)[:3]
        raise ValueError(
            f"adapter state does not match this model's injection: "
            f"{len(want - got)} missing (e.g. {missing}), "
            f"{len(got - want)} unexpected (e.g. {extra})")
    with torch.no_grad():
        for k, v in state.items():
            cur = current[k]
            arr = v.detach() if isinstance(v, torch.Tensor) \
                else torch.tensor(np.asarray(v))
            if tuple(cur.shape) != tuple(arr.shape):
                raise ValueError(
                    f"adapter leaf {k!r} has shape {tuple(arr.shape)}, "
                    f"model expects {tuple(cur.shape)} (rank mismatch?)")
            cur.copy_(arr.to(device=cur.device, dtype=cur.dtype))
    return model


def clear_adapter(model):
    """Zero the injected leaves: back to the base model exactly."""
    with torch.no_grad():
        for v in lora_state(model).values():
            v.zero_()
    return model


def _dtype_name(dtype: torch.dtype) -> str:
    # the reference's spelling (str of a jnp dtype): "float32", "bfloat16"
    return str(dtype).replace("torch.", "")


def base_fingerprint(model) -> str:
    """Structural fingerprint of the base model an adapter belongs to: a
    digest over the model's class name and every non-LoRA parameter's
    ``(path, shape, dtype)``, byte-equal to the reference's for the same
    architecture, so adapter checkpoints cross packages. It identifies
    the architecture, not the weight values."""
    rows = sorted(
        (k, tuple(int(d) for d in v.shape), _dtype_name(v.dtype))
        for k, v in model.named_parameters() if not is_lora_param(k))
    raw = json.dumps([type(model).__name__, rows]).encode()
    return hashlib.blake2b(raw, digest_size=16).hexdigest()

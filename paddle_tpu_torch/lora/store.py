"""Adapter registry: small checkpoints on disk, stacked pages on the
device (port of ``paddle_tpu/lora/store.py``).

- **disk**: :func:`save_adapter` writes the adapter leaves through the
  crash-safe checkpoint writer (:func:`~paddle_tpu_torch.distributed.
  checkpoint.save_state`) with a ``format: "lora_adapter"`` metadata
  record carrying rank, alpha, targets, dropout and the base-model
  fingerprint; the files are the reference's, byte for byte.
  :func:`load_adapter` checks both: a full checkpoint is refused as an
  adapter, an adapter is refused onto the wrong base;
- **device**: :class:`AdapterStore` keeps up to ``max_loaded`` adapters
  resident in one stack per target layer, ``(A_stack [S, in, r],
  B_stack [S, r, out])`` on the model's device, with ``S = max_loaded +
  1`` and row 0 the zero adapter (the base model). The serving engine
  gathers each slot's rows (:func:`~paddle_tpu_torch.lora.layers.
  adapter_rows`);
- **residency**: LRU over unpinned rows. The engine pins a row for the
  life of every request decoding against it, so eviction never swaps an
  adapter out from under a live stream.

Staging a row copies the stacks and writes the row into the copy, then
publishes the new stack dict with one assignment under ``_lock``, as the
reference publishes its ``.at[slot].set`` result: a reader sees all old
or all new pages, never a half-written row, and a concurrent
``acquire(with_salt=True)`` never pairs a new salt with old pages. The
writes run on the current stream, so every later forward that reads the
published stacks is ordered after them. On the card the registered
pages wait in pinned host memory and the row writes are asynchronous
copies: admitting a tenant does not sync the host with the device.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .layers import (LoraConfig, applied_config, base_fingerprint,
                     is_lora_param, lora_paths, lora_state)

__all__ = ["ADAPTER_FORMAT", "AdapterError", "AdapterFormatError",
           "AdapterStore", "save_adapter", "load_adapter",
           "adapter_metadata", "normalize_adapter_id"]

ADAPTER_FORMAT = "lora_adapter"

BASE_ADAPTER = "base"   # reserved name for stack row 0 (the zero adapter)


def normalize_adapter_id(adapter_id):
    """Collapse the reserved ``"base"`` alias onto ``None`` (the zero
    adapter). Every boundary that accepts an adapter id (server submit,
    engine admit) normalizes through this helper, so one tenant key never
    splits into two cache namespaces or metrics rows."""
    return None if adapter_id == BASE_ADAPTER else adapter_id


class AdapterError(RuntimeError):
    """A registry operation failed on the host before any device work
    (unknown adapter, every row pinned): the serving loop fails just the
    offending request, never the engine."""


class AdapterFormatError(ValueError):
    """A checkpoint is not what the caller pointed at: a full model
    checkpoint fed to the adapter loader, or an adapter whose base
    fingerprint or LoRA geometry does not match the serving model."""


# -------------------------------------------------------------- disk side
def save_adapter(directory: str, model, *, async_: bool = False):
    """Save ``model``'s adapter leaves as a (tiny) crash-safe checkpoint
    whose metadata records ``format: "lora_adapter"``, the LoRA geometry
    and the base-model fingerprint. Returns the async save handle when
    ``async_`` (see ``checkpoint.save_state``)."""
    from ..distributed.checkpoint import save_state

    config = applied_config(model)
    if config is None:
        raise ValueError(
            f"{type(model).__name__} has no LoRA injection to save; "
            f"apply_lora(model, config) / Model.fit(lora=...) first")
    extra = {"format": ADAPTER_FORMAT,
             "lora": {**config.to_dict(),
                      "base_fingerprint": base_fingerprint(model),
                      "base_model": type(model).__name__}}
    state = {k: v.detach() for k, v in lora_state(model).items()}
    return save_state(state, directory, async_=async_, extra_meta=extra)


def adapter_metadata(directory: str) -> dict:
    """The ``lora`` metadata record of an adapter checkpoint (raises
    :class:`AdapterFormatError` for other directories)."""
    try:
        with open(os.path.join(directory, "metadata.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise AdapterFormatError(
            f"{directory}: not a readable checkpoint directory: {e}"
        ) from e
    if meta.get("format") != ADAPTER_FORMAT:
        raise AdapterFormatError(
            f"{directory} is not a LoRA adapter checkpoint (format="
            f"{meta.get('format')!r}); full model checkpoints load via "
            f"checkpoint.load_state / Model.load, not the adapter "
            f"registry")
    return dict(meta.get("lora") or {})


def load_adapter(directory: str, model=None) -> Tuple[Dict, dict]:
    """Load an adapter checkpoint: ``(adapter_state, lora_meta)``, the
    state as CPU tensors.

    With ``model`` (an injected network), the recorded base fingerprint
    and LoRA geometry are checked against it; a mismatch is a hard
    :class:`AdapterFormatError`, since an adapter trained against another
    base would load cleanly and serve garbage."""
    from ..distributed.checkpoint import load_state

    meta = adapter_metadata(directory)
    if model is not None:
        _check_compatible(directory, meta, model)
    state = load_state(directory)
    bad = sorted(k for k in state if not is_lora_param(k))
    if bad:
        raise AdapterFormatError(
            f"{directory}: adapter checkpoint contains non-adapter "
            f"leaves (e.g. {bad[:3]}) — corrupt metadata?")
    return state, meta


def _check_compatible(directory: str, meta: dict, model) -> None:
    config = applied_config(model)
    if config is None:
        raise AdapterFormatError(
            f"cannot load adapter {directory} into a model without a "
            f"LoRA injection; apply_lora(model, config) first")
    want_fp = base_fingerprint(model)
    got_fp = meta.get("base_fingerprint")
    if got_fp is not None and got_fp != want_fp:
        raise AdapterFormatError(
            f"{directory}: adapter was trained against base model "
            f"{meta.get('base_model')!r} (fingerprint {got_fp}); this "
            f"model's fingerprint is {want_fp} — refusing to serve an "
            f"adapter on the wrong base")
    for field in ("rank", "alpha", "dropout"):
        got = meta.get(field)
        want = getattr(config, field)
        if got is not None and float(got) != float(want):
            raise AdapterFormatError(
                f"{directory}: adapter {field}={got} does not match the "
                f"model's injection {field}={want}; adapters in one "
                f"registry must share the stacked-page geometry")


# ------------------------------------------------------------ device side
class AdapterStore:
    """Device-resident multi-adapter registry for one injected model.

    ``register``/``load`` put adapters in the host registry; the first
    request for a tenant stages its pages into a stack row
    (:meth:`acquire`), evicting the least recently used unpinned row when
    the stacks are full.

    Thread-safe: the serving worker acquires and releases; other threads
    may read :meth:`resident`, :meth:`known`, :meth:`salt` and
    :meth:`stats`.
    """

    def __init__(self, model, config: Optional[LoraConfig] = None,
                 max_loaded: int = 8):
        from .layers import apply_lora

        applied = applied_config(model)
        if applied is None:
            if config is None:
                raise ValueError(
                    "AdapterStore needs a LoRA-applied model or a "
                    "LoraConfig to apply (pass config=)")
            apply_lora(model, config)
            applied = config
        elif config is not None and config != applied:
            raise ValueError(
                f"model is injected with {applied}, store asked for "
                f"{config}; one geometry per model")
        if int(max_loaded) < 1:
            raise ValueError(f"max_loaded must be >= 1, got {max_loaded}")
        self.model = model
        self.config = applied
        self.fingerprint = base_fingerprint(model)
        self.paths = lora_paths(model)
        self.max_loaded = int(max_loaded)
        self.slots = self.max_loaded + 1      # +1: the zero row 0
        st = model.__dict__["_lora_applied"]
        # two locks, one order: `_lock` guards the host metadata and is
        # held only for dict and int work (the serving loop's release and
        # other threads' probes contend it); `_write_lock` serializes page
        # staging and is taken only by writers (acquire's miss path,
        # register's refresh), always BEFORE `_lock`
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._tick = 0
        # _names[s] is the adapter resident in row s
        self._names: List[Optional[str]] = [BASE_ADAPTER] + \
            [None] * self.max_loaded
        self._by_name: Dict[str, int] = {}
        self._pins = [0] * self.slots
        self._last_use = [0] * self.slots
        self._host: Dict[str, Dict[str, Tuple[torch.Tensor,
                                              torch.Tensor]]] = {}
        # bumped on every register() of a name: the prefix-cache digest
        # salt embeds it, so a new adapter version orphans the K/V blocks
        # the old weights computed (they age out of the pool by LRU)
        self._versions: Dict[str, int] = {}
        self.loads = 0
        self.evictions = 0
        self.tensors = {}
        for path in self.paths:
            (a_shape, b_shape) = st.shapes[path]
            a_ref = model.get_parameter(f"{path}.lora_A")
            self.tensors[path] = (
                torch.zeros((self.slots,) + tuple(a_shape),
                            dtype=a_ref.dtype, device=a_ref.device),
                torch.zeros((self.slots,) + tuple(b_shape),
                            dtype=a_ref.dtype, device=a_ref.device))
        self.dtype = next(iter(self.tensors.values()))[0].dtype
        self.device = next(iter(self.tensors.values()))[0].device
        self.page_bytes = int(sum(
            a.numel() * a.element_size() + b.numel() * b.element_size()
            for a, b in self.tensors.values()) // self.slots)

    # ------------------------------------------------------------- intake
    def _host_page(self, value) -> torch.Tensor:
        """One leaf as a CPU tensor in the stacks' dtype, pinned when the
        stacks live on the card (so that staging it is an asynchronous
        copy)."""
        t = value.detach() if isinstance(value, torch.Tensor) \
            else torch.tensor(np.asarray(value))
        t = t.to(device="cpu", dtype=self.dtype, copy=True)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _as_pages(self, state: Dict) -> Dict[str, Tuple[torch.Tensor,
                                                        torch.Tensor]]:
        """Check an adapter's leaves against this store's geometry and
        regroup them per layer path, as host pages."""
        st = self.model.__dict__["_lora_applied"]
        pages = {}
        seen = set()
        for path in self.paths:
            a_key, b_key = f"{path}.lora_A", f"{path}.lora_B"
            if a_key not in state or b_key not in state:
                raise AdapterFormatError(
                    f"adapter state lacks {a_key!r}/{b_key!r}; it was "
                    f"saved from a different injection "
                    f"(target_modules/model mismatch)")
            a, b = state[a_key], state[b_key]
            want_a, want_b = st.shapes[path]
            if tuple(a.shape) != tuple(want_a) \
                    or tuple(b.shape) != tuple(want_b):
                raise AdapterFormatError(
                    f"adapter leaf shapes {tuple(a.shape)}/"
                    f"{tuple(b.shape)} at {path!r} do not match the store "
                    f"geometry {want_a}/{want_b} (rank mismatch?)")
            pages[path] = (self._host_page(a), self._host_page(b))
            seen.update((a_key, b_key))
        extra = sorted(set(state) - seen)
        if extra:
            raise AdapterFormatError(
                f"adapter state carries unexpected leaves (e.g. "
                f"{extra[:3]}) — saved from a wider injection?")
        return pages

    def register(self, name: str, state: Dict) -> None:
        """Host-register an adapter's leaves under ``name``. Registering a
        name again replaces it (and refreshes its device pages if it is
        resident and unpinned: the adapter-update path)."""
        if not name or name == BASE_ADAPTER:
            raise ValueError(
                f"adapter name must be a non-empty string != "
                f"{BASE_ADAPTER!r}, got {name!r}")
        pages = self._as_pages(state)
        with self._write_lock:
            with self._lock:
                slot = self._by_name.get(name)
                if slot is not None and self._pins[slot] > 0:
                    slot = None     # live streams: never rewrite in place
            staged = self._stage_pages(slot, pages) \
                if slot is not None else None
            with self._lock:
                self._host[name] = pages
                self._versions[name] = self._versions.get(name, 0) + 1
                cur = self._by_name.get(name)
                if cur is not None and self._pins[cur] > 0:
                    # live streams decode against the OLD pages (a pin may
                    # have landed while we staged): orphan the row instead
                    # of publishing mixed-version weights. The pinned
                    # streams keep it until they finish; the next acquire
                    # stages the new pages into a fresh row
                    del self._by_name[name]
                    self._names[cur] = None
                elif staged is not None and cur == slot:
                    # pages and version bump publish under one hold, so a
                    # concurrent acquire(with_salt=True) never pairs the
                    # new salt with the old pages or the reverse
                    self.tensors = staged
                    self.loads += 1
                elif cur is not None:
                    del self._by_name[name]
                    self._names[cur] = None

    def load(self, name: str, directory: str) -> None:
        """Load an adapter checkpoint from ``directory`` and register it
        as ``name``; fingerprint and geometry mismatches are errors."""
        state, _ = load_adapter(directory, self.model)
        self.register(name, state)

    # ---------------------------------------------------------- residency
    def _stage_pages(self, slot: int, pages: Dict) -> Dict:
        """The whole new stack dict: each stack copied, row ``slot``
        overwritten in the copy. The caller publishes it under ``_lock``
        (one assignment: readers see all old or all new). Only
        ``_write_lock`` is held here."""
        non_blocking = self.device.type == "cuda"
        staged = {}
        with torch.no_grad():
            for path, (a_stack, b_stack) in self.tensors.items():
                a, b = a_stack.clone(), b_stack.clone()
                a[slot].copy_(pages[path][0], non_blocking=non_blocking)
                b[slot].copy_(pages[path][1], non_blocking=non_blocking)
                staged[path] = (a, b)
        return staged

    def acquire(self, name: Optional[str], *, with_salt: bool = False):
        """Resolve ``name`` to a resident stack row and pin it (one pin
        per live request). ``None``/``"base"`` is row 0. Raises
        :class:`AdapterError` (on the host, before any device work) for
        an unknown adapter or when every row is pinned by live requests.

        ``with_salt`` returns ``(row, digest_salt)`` taken under one lock
        hold: the admit needs the salt of exactly the version whose pages
        it pinned."""
        if name is None or name == BASE_ADAPTER:
            with self._lock:
                self._pins[0] += 1
            return (0, b"") if with_salt else 0
        with self._lock:
            # resident: pin, touch and salt under one hold, no staging
            self._tick += 1
            slot = self._by_name.get(name)
            if slot is not None:
                self._pins[slot] += 1
                self._touch_locked(slot)
                if not with_salt:
                    return slot
                return slot, self._salt_locked(name)
        # miss: stage the pages with the metadata lock released
        with self._write_lock:
            with self._lock:
                slot = self._by_name.get(name)
                if slot is not None:        # a register() raced us in
                    self._pins[slot] += 1
                    self._touch_locked(slot)
                    if not with_salt:
                        return slot
                    return slot, self._salt_locked(name)
                pages = self._host.get(name)
                if pages is None:
                    raise AdapterError(
                        f"unknown adapter {name!r}; register() or load() "
                        f"it into the store first")
                slot = self._free_slot_locked()
                if slot is None:
                    raise AdapterError(
                        f"all {self.max_loaded} adapter rows are pinned "
                        f"by live requests; raise max_loaded (>= engine "
                        f"slots is always safe) or shed load")
                # reserve: a PINNED nameless row, which _free_slot_locked
                # skips, so no other writer takes it while we stage
                self._pins[slot] += 1
                self._touch_locked(slot)
            try:
                staged = self._stage_pages(slot, pages)
            except BaseException:
                with self._lock:
                    # guarded like release(): a release_all() may have
                    # zeroed the pins while we staged
                    if self._pins[slot] > 0:
                        self._pins[slot] -= 1
                raise
            with self._lock:
                self.tensors = staged
                self.loads += 1
                self._names[slot] = name
                self._by_name[name] = slot
                if not with_salt:
                    return slot
                return slot, self._salt_locked(name)

    def _touch_locked(self, slot: int) -> None:
        self._last_use[slot] = self._tick

    def _free_slot_locked(self) -> Optional[int]:
        for s in range(1, self.slots):
            # a nameless row may still be PINNED (orphaned by a
            # re-register while streams decode against it): not free
            if self._names[s] is None and self._pins[s] == 0:
                return s
        victim = None
        for s in range(1, self.slots):
            if self._pins[s] > 0:
                continue
            if victim is None or self._last_use[s] < self._last_use[victim]:
                victim = s
        if victim is None:
            return None
        old = self._names[victim]
        if old is not None:
            del self._by_name[old]
            self.evictions += 1
        self._names[victim] = None
        return victim

    def release(self, slot: int) -> None:
        """Drop one pin on ``slot`` (the engine calls this when the
        request leaves its engine slot)."""
        with self._lock:
            if 0 <= slot < self.slots and self._pins[slot] > 0:
                self._pins[slot] -= 1

    def release_all(self) -> None:
        """Crash-recovery sweep: the engine reset requeues every live
        request, so every pin it held is void."""
        with self._lock:
            self._pins = [0] * self.slots

    # ------------------------------------------------------------- lookup
    def salt(self, name: Optional[str]) -> bytes:
        """The prefix-cache digest-chain namespace for ``name``, with the
        registration version in it: a re-registered adapter gets a fresh
        namespace, so blocks its old weights computed never serve the
        new ones. Byte-equal to the reference's."""
        if name is None or name == BASE_ADAPTER:
            return b""
        with self._lock:
            return self._salt_locked(name)

    def _salt_locked(self, name: str) -> bytes:
        return b"lora:%s@%d" % (str(name).encode(),
                                self._versions.get(name, 0))

    def known(self, name: Optional[str]) -> bool:
        """Registered on the host: submit-time validation."""
        if name is None or name == BASE_ADAPTER:
            return True
        with self._lock:
            return name in self._host

    def resident(self, name: Optional[str]) -> bool:
        """Holding a device row now."""
        if name is None or name == BASE_ADAPTER:
            return True
        with self._lock:
            return name in self._by_name

    def loaded(self) -> Dict[str, int]:
        """``{adapter_name: stack_row}`` of resident adapters."""
        with self._lock:
            return dict(self._by_name)

    def stats(self) -> dict:
        with self._lock:
            return {
                "max_loaded": self.max_loaded,
                "registered": len(self._host),
                "resident": len(self._by_name),
                "pinned_rows": sum(1 for s in range(1, self.slots)
                                   if self._pins[s] > 0),
                "loads": self.loads,
                "evictions": self.evictions,
                "page_bytes": self.page_bytes,
                "rank": self.config.rank,
            }

    def __repr__(self):
        s = self.stats()
        return (f"AdapterStore(resident={s['resident']}/{s['max_loaded']},"
                f" registered={s['registered']}, rank={s['rank']})")

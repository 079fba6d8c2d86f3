"""paddle_tpu_torch.lora: multi-tenant low-rank adaptation (port of
``paddle_tpu/lora``).

Per-tenant fine-tuned models without per-tenant replicas: adapters train
against a frozen base (``Model.fit(lora=LoraConfig(...))``: optimizer
state scales with the rank, not the model), persist as small crash-safe
checkpoints (``save_adapter``/``load_adapter``, with a ``lora_adapter``
metadata record pinning the base-model fingerprint), stack into device
pages (:class:`AdapterStore`, LRU rows) and serve batched: every slot of
the continuous-batching engine gathers its own ``(A, B)`` rows, so one
decode step serves every tenant plus the base model (row 0 = the zero
adapter).

    from paddle_tpu_torch.lora import LoraConfig, AdapterStore, apply_lora

    apply_lora(lm, LoraConfig(rank=8))
    Model(lm).fit(train_data, lora=LoraConfig(rank=8))   # adapter-only fit
    save_adapter("adapters/tenant-a", lm)

    store = AdapterStore(lm, max_loaded=32)
    store.load("tenant-a", "adapters/tenant-a")
    srv = InferenceServer(lm, slots=8, adapter_store=store).start()
    srv.submit(prompt, adapter_id="tenant-a")
"""
from .layers import (LoraConfig, adapter_rows, applied_config,  # noqa: F401
                     apply_lora, base_fingerprint, clear_adapter,
                     is_lora_param, lora_paths, lora_state, set_adapter)
from .store import (ADAPTER_FORMAT, AdapterError,  # noqa: F401
                    AdapterFormatError, AdapterStore, adapter_metadata,
                    load_adapter, normalize_adapter_id, save_adapter)

__all__ = [
    "LoraConfig", "apply_lora", "applied_config", "lora_paths",
    "lora_state", "set_adapter", "clear_adapter", "is_lora_param",
    "base_fingerprint", "adapter_rows", "AdapterStore", "AdapterError",
    "AdapterFormatError", "ADAPTER_FORMAT", "save_adapter", "load_adapter",
    "adapter_metadata", "normalize_adapter_id",
]

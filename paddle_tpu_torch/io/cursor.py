"""Input-pipeline cursor: where a training run is in its data stream (port
of ``paddle_tpu/io/cursor.py``; framework-free, so copied and adapted).

Checkpoints produced by the self-healing layer
(:mod:`paddle_tpu_torch.framework.supervisor`) record a :class:`DataCursor`
alongside the model/optimizer state, so a restart (crash, preemption,
rollback) can resume the SAME data trajectory instead of replaying the
epoch from the top: the loader is fast-forwarded to ``batch_index`` of
``epoch`` and the worker-seed stream (``epoch_seed``) is realigned.

Determinism caveat: replay is exact only when the loader's batch order is
itself deterministic — ``shuffle=False``, or a custom seeded sampler. The
stock ``RandomSampler`` draws from a fresh OS-seeded RNG each epoch, so a
resumed shuffled epoch sees a *different* permutation; the restored weights
are still exact, only the remaining batch order differs.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class DataCursor:
    """Position in the input pipeline: the NEXT batch to be consumed."""

    epoch: int = 0
    batch_index: int = 0
    epoch_seed: int = 0     # DataLoader._epoch_seed (worker RNG stream)
    global_step: int = 0    # compiled-step count at this position

    def as_state(self) -> dict:
        """Plain-int dict for embedding in a checkpoint state tree."""
        return {"epoch": int(self.epoch),
                "batch_index": int(self.batch_index),
                "epoch_seed": int(self.epoch_seed),
                "global_step": int(self.global_step)}

    @classmethod
    def from_state(cls, state: Optional[dict]) -> Optional["DataCursor"]:
        """Rebuild from checkpoint leaves; ``None`` (old checkpoint without
        a cursor) stays ``None`` — the caller restarts the epoch."""
        if state is None:
            return None
        return cls(epoch=int(state.get("epoch", 0)),
                   batch_index=int(state.get("batch_index", 0)),
                   epoch_seed=int(state.get("epoch_seed", 0)),
                   global_step=int(state.get("global_step", 0)))

    def rescale(self, old_global_batch: int,
                new_global_batch: int) -> "DataCursor":
        """Re-express this cursor under a CHANGED global batch size.

        The elastic default keeps the global batch constant across a
        shrink/grow (``distributed.elastic_mesh.rescale_batch``), in which
        case the cursor is already valid. When a resize deliberately
        changes the global batch, the invariant to preserve is the number
        of SAMPLES consumed: ``batch_index * old_global_batch``. The new
        index rounds DOWN to a batch boundary, so a partial batch's worth
        of samples is replayed rather than skipped — replaying a few
        samples perturbs nothing, skipping them silently drops data.
        """
        if old_global_batch <= 0 or new_global_batch <= 0:
            raise ValueError("batch sizes must be positive")
        if old_global_batch == new_global_batch:
            return DataCursor(**self.as_state())
        consumed = self.batch_index * old_global_batch
        return DataCursor(epoch=self.epoch,
                          batch_index=consumed // new_global_batch,
                          epoch_seed=self.epoch_seed,
                          global_step=self.global_step)


def resume_batches(loader, start_batch: int) -> Iterator:
    """One epoch of ``loader`` starting at ``start_batch``.

    Fast-forward is cheap where the loader's structure allows it: a
    single-process map-style loader skips the leading batches at the
    *sampler* level (no dataset access, no collation). Everything else
    (iterable datasets, worker pools, bare iterables) is advanced by
    draining — the data work is repaid but no device steps run.
    """
    start_batch = int(start_batch)
    if start_batch <= 0:
        yield from loader
        return
    batch_sampler = getattr(loader, "batch_sampler", None)
    if (batch_sampler is not None
            and getattr(loader, "num_workers", 1) == 0
            and not getattr(loader, "_iterable_mode", False)):
        dataset, collate = loader.dataset, loader.collate_fn
        for indices in itertools.islice(iter(batch_sampler), start_batch,
                                        None):
            yield collate([dataset[i] for i in indices])
        return
    it = iter(loader)
    try:
        for _ in range(start_batch):
            next(it)
    except StopIteration:
        return
    yield from it

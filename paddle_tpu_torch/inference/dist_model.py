"""Multi-rank serving: the FleetExecutor / DistModel analogue (port of
``paddle_tpu/inference/dist_model.py``).

Reference parity: ``paddle/fluid/distributed/fleet_executor/`` — the
``Carrier`` actor runtime hosting ``Interceptor``s per rank
(``carrier.h:49``, ``interceptor.h:46``), micro-batch amplification
(``amplifier_interceptor.cc``), and the multi-rank inference entry
``DistModel``/``DistModelConfig`` (``dist_model.cc``).

Each rank loads ONE pipeline stage as a saved program (the artifact
:func:`save_dist_model` writes, one ``jit.save`` per stage) on its device
— the card unless ``DistModelConfig.device`` says ``"cpu"`` — and serves
it over the port's named RPC layer (:mod:`paddle_tpu_torch.distributed.
rpc`, the MessageBus analogue). A request travels the stage chain as a
relay: rank 0 runs stage 0 and forwards the activation to rank 1, whose
service thread runs stage 1 and forwards onward; the final stage's output
returns back up the chain. Micro-batch amplification pipelines the chain:
rank 0 posts all micro-batches asynchronously, so stage *i* computes
micro-batch *m* while stage *i+1* computes *m-1* — the
ComputeInterceptor's credit loop with threads in place of actor
mailboxes. Activations cross ranks as numpy arrays.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["DistModelConfig", "DistModel", "save_dist_model"]


def _stage_prefix(prefix: str, rank: int) -> str:
    return f"{prefix}.stage{rank}"


def save_dist_model(stages: Sequence, prefix: str,
                    input_spec: Sequence) -> None:
    """Export a stage-split model for multi-rank serving.

    ``stages``: the pipeline split — a list of Layers whose composition is
    the full model (stage *i*'s output feeds stage *i+1*). Each stage is
    saved as its own program (``<prefix>.stage<i>``, ``jit.save``) plus a
    ``<prefix>.distmeta.json`` manifest; rank *i* of :class:`DistModel`
    loads only its stage, the reference's per-rank program slice
    (``dist_model.cc`` loads one rank's program of a distributed save).

    ``input_spec``: InputSpec list for stage 0 (the model's real inputs).
    Leading dims of ``None`` are captured with a dynamic size; the specs
    for later stages are derived from each stage's captured outputs (a
    dim that varies stays None).
    """
    from ..jit import _output_specs, save as jit_save

    stages = list(stages)
    if not stages:
        raise ValueError("need at least one stage")
    spec: List = list(input_spec)
    for i, stage in enumerate(stages):
        program = jit_save(stage, _stage_prefix(prefix, i), input_spec=spec)
        # the next stage's input spec is this stage's outputs
        spec = _output_specs(program)
    meta = {"nranks": len(stages), "format": "paddle_tpu.dist_model.v1"}
    with open(prefix + ".distmeta.json", "w") as f:
        json.dump(meta, f)


@dataclass
class DistModelConfig:
    """``DistModelConfig`` analogue (``dist_model.h``): where the sharded
    artifact lives and which rank of the serving job this process is."""

    model_prefix: str
    rank: Optional[int] = None
    nranks: Optional[int] = None
    master_endpoint: Optional[str] = None
    # micro-batch amplification factor for run() (AmplifierInterceptor):
    # batches are split along dim 0 into this many pipelined micro-batches
    num_micro: int = 1
    # per-hop RPC timeout; must outlast the whole downstream chain's
    # compute, the first request's kernel build included
    rpc_timeout: float = 600.0
    # where this rank's stage runs: None is the card, "cpu" the CPU
    device: Optional[str] = None


# process-global active DistModel — RPC-served stage functions must be
# module-level (picklable by reference), so they find their stage here,
# the Carrier's interceptor registry restated
_ACTIVE: Optional["DistModel"] = None


def _serve_stage(micro: int, payload):
    """Run this rank's stage on ``payload`` and relay to the next stage;
    the final stage's result returns back up the relay chain. Executed on
    an RPC service thread (one per in-flight micro-batch), which is what
    overlaps stage *i* of micro *m* with stage *i+1* of micro *m-1*."""
    dm = _ACTIVE
    if dm is None:
        raise RuntimeError("DistModel not initialized on this rank")
    out = dm._run_local(payload)
    if dm.rank + 1 < dm.nranks:
        from ..distributed import rpc

        return rpc.rpc_sync(dm._peer(dm.rank + 1), _serve_stage,
                            (micro, out), timeout=dm.config.rpc_timeout)
    return out


class DistModel:
    """Multi-rank pipelined inference (reference ``DistModel``,
    ``dist_model.cc``): every rank constructs one, non-zero ranks then call
    :meth:`serve` (block until the job shuts down), rank 0 calls
    :meth:`run`.

    Uses the named-RPC layer for transport; ``init_rpc`` is called here
    with rank/world from the config (or the launch env)."""

    def __init__(self, config: DistModelConfig):
        global _ACTIVE
        from ..distributed import rpc
        from ..jit import load as jit_load

        with open(config.model_prefix + ".distmeta.json") as f:
            meta = json.load(f)
        self.config = config
        self.nranks = config.nranks or int(meta["nranks"])
        if int(meta["nranks"]) != self.nranks:
            raise ValueError(
                f"artifact has {meta['nranks']} stages but config.nranks="
                f"{self.nranks}")
        self.rank = (int(os.environ.get("PADDLE_TRAINER_ID", 0))
                     if config.rank is None else config.rank)
        self._layer = jit_load(_stage_prefix(config.model_prefix, self.rank),
                               device=config.device)
        self._rpc = rpc
        # _ACTIVE must be visible BEFORE the RPC accept loop starts: a fast
        # peer's relayed request may be served the instant init_rpc returns
        _ACTIVE = self
        try:
            rpc.init_rpc(name=self._peer(self.rank), rank=self.rank,
                         world_size=self.nranks,
                         master_endpoint=config.master_endpoint)
        except Exception:
            _ACTIVE = None
            raise

    @staticmethod
    def _peer(rank: int) -> str:
        return f"dist_model_rank{rank}"

    def _run_local(self, payload):
        """One stage forward: numpy in, numpy out (RPC payloads stay
        host-side; the stage moves them to its device)."""
        from . import _host

        out = self._layer(*payload)
        return [_host(t) for t in torch.utils._pytree.tree_leaves(out)]

    def run(self, inputs: Sequence[np.ndarray],
            num_micro: Optional[int] = None) -> List[np.ndarray]:
        """Feed a batch through the stage chain (rank 0 only). With
        ``num_micro > 1`` the batch is split along dim 0 and the
        micro-batches are pipelined through the chain concurrently."""
        if self.rank != 0:
            raise RuntimeError("run() is the rank-0 entry; other ranks "
                               "serve() until shutdown")
        inputs = [np.asarray(a) for a in inputs]
        m = num_micro or self.config.num_micro
        # zero-row micro-batches would violate the capture's batch >= 1
        # range
        m = max(1, min(m, min(a.shape[0] for a in inputs) if inputs else 1))
        if m <= 1:
            return _serve_stage(0, inputs)
        splits = [np.array_split(a, m, axis=0) for a in inputs]
        futures = []
        for i in range(m):
            payload = [s[i] for s in splits]
            if self.nranks == 1:
                futures.append(_serve_stage(i, payload))
            else:
                # post the local stage-0 compute onto the pool too so all
                # micro-batches pipeline; rpc_async returns a Future
                futures.append(self._rpc.rpc_async(
                    self._peer(0), _serve_stage, (i, payload),
                    timeout=self.config.rpc_timeout))
        outs = [f if isinstance(f, list) else f.result() for f in futures]
        return [np.concatenate([o[k] for o in outs], axis=0)
                for k in range(len(outs[0]))]

    def serve(self, timeout: Optional[float] = None) -> None:
        """Block serving RPCs until the job's collective shutdown
        (reference: the Carrier's message loop); ``timeout`` bounds the
        wait (the rpc layer's default otherwise)."""
        self._rpc.shutdown(**({} if timeout is None else
                              {"timeout": timeout}))

    def shutdown(self, timeout: Optional[float] = None) -> None:
        global _ACTIVE
        self._rpc.shutdown(**({} if timeout is None else
                              {"timeout": timeout}))
        _ACTIVE = None

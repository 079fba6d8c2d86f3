"""LocalSGD: per-replica local steps with periodic parameter averaging
(port of ``paddle_tpu/distributed/parallel/localsgd.py``).

Reference parity: ``fleet/meta_optimizers/localsgd_optimizer.py`` (skip the
per-step gradient all-reduce; every ``k_steps`` average the weights) — the
communication-efficient data-parallel mode for slow interconnects.

The reference stacks the replicas on a leading axis sharded over the
mesh's data axis and steps them in one SPMD program. In the port each rank
of the axis holds one replica: it takes its slice of the global batch,
steps its own parameters with its own optimizer state and no gradient
reduction, and every ``k_steps``-th step all-reduces the parameters to
their mean over the axis — one collective per parameter every k steps
instead of a gradient reduction every step. The loss is averaged over the
axis every step.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ...framework import random as framework_random
from ...framework.jit import (DEFAULT_RNG_STREAMS, _to_device,
                              resolve_inputs_fn)
from ...framework.tree import tree_map
from ...nn.layer import rng_context
from .. import collective as C
from ..mesh import require_mesh

__all__ = ["LocalSGDStep"]


class LocalSGDStep:
    """The step of the localsgd strategy (``DistributedStrategy.localsgd``
    with ``localsgd_configs={"k_steps": k}``; ``fleet.distributed_model``
    builds it): ``loss = step(batch)`` on every rank with the same global
    batch, split over ``axis``.

    Each step updates this rank's replica from its own slice; every
    ``k_steps``-th call then averages the parameters over the axis. The
    optimizer state (moments, step count) stays per replica, as in the
    reference. Under mixed precision (float32 masters of half-precision
    parameters, ``amp.decorate(level="O2")``) the float32 masters are what
    is averaged and the parameters are cast from the average, so that
    the next update starts from the consensus. Buffers are constants:
    a forward that would update them (a training-mode BatchNorm) is
    refused."""

    def __init__(self, model: nn.Module, optimizer, loss_fn: Callable = None,
                 mesh=None, k_steps: int = 4, axis: str = "dp",
                 inputs_fn: Optional[Callable] = None):
        from ...nn.layers.norm import _BatchNormBase

        self.mesh = mesh or require_mesh()
        if axis not in self.mesh.shape:
            raise ValueError(f"mesh has no {axis!r} axis")
        if not self.mesh.member:
            raise RuntimeError(f"LocalSGDStep: this rank is not on the mesh "
                               f"{self.mesh}")
        if any(isinstance(m, _BatchNormBase) and m.training
               for m in model.modules()):
            raise NotImplementedError(
                "LocalSGDStep keeps buffers constant: a training-mode "
                "BatchNorm would update its running statistics")
        self.axis = axis
        self.dp = self.mesh.shape[axis]
        self.k_steps = int(k_steps)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.inputs_fn = resolve_inputs_fn(inputs_fn, loss_fn)
        self.params: Dict[str, nn.Parameter] = dict(model.named_parameters())
        self.opt_state = optimizer.init(self.params)
        seed = torch.tensor([framework_random.next_seed()],
                            dtype=torch.int64, device=self.device)
        self._base_seed = int(C.broadcast(seed, 0, self.mesh.axis_names,
                                          self.mesh)[0])
        self._t = 0

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def _local_batch(self, batch):
        n, i = self.dp, self.mesh.axis_index(self.axis)

        def leaf(x):
            if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1:
                if x.shape[0] % n:
                    raise ValueError(f"batch dimension {x.shape[0]} does not "
                                     f"split over {n} replicas")
                b = x.shape[0] // n
                return x[i * b:(i + 1) * b]
            return x

        return _to_device(tree_map(leaf, batch), self.device)

    def __call__(self, batch):
        """One local step on this replica's slice of the global batch;
        every ``k_steps``-th call also averages the replicas. Returns the
        loss averaged over the axis."""
        sync = (self._t + 1) % self.k_steps == 0
        seed = framework_random.fold_in(
            framework_random.fold_in(self._base_seed, self._t),
            self.mesh.axis_index(self.axis))
        self._t += 1
        batch = self._local_batch(batch)
        names = list(self.params)
        with rng_context(framework_random.split_streams(
                seed, DEFAULT_RNG_STREAMS)):
            inputs = self.inputs_fn(batch)
            if not isinstance(inputs, (tuple, list)):
                inputs = (inputs,)
            out = self.model(*inputs)
            loss = out if self.loss_fn is None else self.loss_fn(out, batch)
            loss = loss.float()
            grads = torch.autograd.grad(
                loss, [self.params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        self.optimizer.update(grads, self.opt_state, self.params)
        if sync:
            self._average()
        return C.all_reduce(loss.detach(), C.ReduceOp.AVG, self.axis,
                            self.mesh)

    def _average(self) -> None:
        """Replace every parameter (its float32 master where it has one)
        by its mean over the axis."""
        masters = self.opt_state.get("master_weights", {})
        with torch.no_grad():
            for k, p in self.params.items():
                w = masters.get(k, p)
                avg = C.all_reduce(w, C.ReduceOp.AVG, self.axis, self.mesh)
                w.copy_(avg)
                if w is not p:
                    p.copy_(avg.to(p.dtype))

    # ------------------------------------------------------------------
    def replica_params(self) -> Dict[str, torch.Tensor]:
        """This rank's replica: ``{name: a copy of the parameter}`` (one
        replica per rank, where the reference returns the replicas
        stacked on a leading axis). The replicas differ between syncs and
        are equal right after one."""
        return {k: p.detach().clone() for k, p in self.params.items()}

    def averaged_params(self) -> Dict[str, torch.Tensor]:
        """The consensus parameters, the mean over the replicas (a
        collective over the axis) — what you save."""
        return {k: C.all_reduce(p.detach(), C.ReduceOp.AVG, self.axis,
                                self.mesh)
                for k, p in self.params.items()}

    def sync_to_model(self):
        """Write :meth:`averaged_params` into the model (a collective)."""
        with torch.no_grad():
            for k, v in self.averaged_params().items():
                self.params[k].copy_(v)
        return self.model

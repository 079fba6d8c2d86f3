"""Parameter specs and the hybrid-parallel train step (port of
``paddle_tpu/distributed/shard.py``).

The reference declares a ``PartitionSpec`` per parameter and lets one
GSPMD program place every collective. The port keeps the specs and the
step's options and does the parallel work by hand, on each rank's local
tensors:

- **data parallel** over ``batch_axes``: each rank takes its slice of the
  global batch; gradients are summed over the batch axes and divided by
  their size;
- **tensor parallel** through the specs the layers declare
  (``parallel/mp_layers.py``): ``shard_model`` slices each mp layer's
  parameters and the layers issue their own collectives;
- **ZeRO** over "sdp" (``sharding_stage``): 1 — the optimizer state (and
  the update) of each parameter lives on one "sdp" shard of it, on the
  dimension ``overlap.shard_first_free_dim`` picks, after an all-reduce of
  the gradients; 2 — the gradients are reduce-scattered onto those shards
  instead; 3 — the parameters too are stored as shards and gathered on
  use: each element of an ``nn.ModuleList`` (a decoder block) is a unit,
  gathered when its forward starts and freed when it ends, gathered again
  when the gradient reaches its output and freed once each of its
  parameters has its gradient; the parameters of no unit (embeddings, a
  tied head, the final norm) stay gathered from the step's start to the
  end of its backward. After each ZeRO 1/2 update the updated shards are
  all-gathered back into the model;
- **overlap** (``overlap_grad_reduce``): the reduction is issued bucket
  by bucket from gradient hooks, in reverse-backward order, while the
  backward still runs (``overlap.BucketedReduce``); without it every
  gradient is reduced after the backward, one collective each.

Specs are :class:`~paddle_tpu_torch.distributed.mesh.PartitionSpec`s over
the FULL parameter shapes, as the reference's; ``convert.shard_state`` /
``gather_state`` move between full and local tensors.
"""
from __future__ import annotations

import logging
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..framework import flags
from ..framework import random as framework_random
from ..framework.jit import (DEFAULT_RNG_STREAMS, _grad_dtype, _to_device,
                             finite_guard, raise_if_bad_step,
                             resolve_inputs_fn, scaler_guard)
from ..framework.tree import tree_leaves, tree_map
from ..amp.grad_scaler import scale_loss, unscale_and_check
from ..nn.layer import rng_context
from ..nn.layers.norm import _BatchNormBase
from . import collective as C
from .mesh import Mesh, PartitionSpec, require_mesh
from .overlap import (BucketedReduce, GradBucket, bucketed_reduce,
                      build_buckets, shard_first_free_dim,
                      weight_update_specs)
from .parallel.mp_layers import MPModule

__all__ = ["param_specs", "opt_state_specs", "shard_params", "shard_model",
           "DistributedTrainStep"]

P = PartitionSpec
SDP = "sdp"


def _filter_spec(spec, mesh: Mesh) -> PartitionSpec:
    """Drop axes absent from the mesh (so tp-annotated models run on a
    dp-only mesh etc.)."""
    out = []
    for s in spec:
        if s is None:
            out.append(None)
        elif isinstance(s, (tuple, list)):
            kept = [a for a in s if a in mesh.shape]
            out.append(tuple(kept) if kept else None)
        else:
            out.append(s if s in mesh.shape else None)
    return PartitionSpec(*out, blocks=getattr(spec, "blocks", 1))


def _drop_axis(spec, axis: str) -> PartitionSpec:
    out = []
    for s in spec:
        if isinstance(s, (tuple, list)):
            kept = tuple(a for a in s if a != axis)
            out.append(kept or None)
        else:
            out.append(None if s == axis else s)
    return PartitionSpec(*out, blocks=getattr(spec, "blocks", 1))


def _axis_dim(spec, axis: str) -> Optional[int]:
    for d, s in enumerate(spec):
        if s == axis or (isinstance(s, (tuple, list)) and axis in s):
            return d
    return None


def declared_specs(model: nn.Module) -> Dict[str, PartitionSpec]:
    """``{parameter path: spec}`` the model's mp layers declare."""
    out = {}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, MPModule):
            for p, spec in mod.param_shard_specs().items():
                out[f"{mod_name}.{p}" if mod_name else p] = spec
    return out


def param_specs(model: nn.Module, mesh: Optional[Mesh] = None,
                zero3_axis: Optional[str] = None,
                min_zero3_size: int = 2 ** 16) -> Dict[str, PartitionSpec]:
    """PartitionSpec per parameter path: layer-declared (TP) specs first,
    then optional ZeRO-3 sharding of remaining large params over
    ``zero3_axis`` (largest dim divisible by the axis size).

    Unlike the reference, a large layer-declared parameter is split over
    ``zero3_axis`` as well, on the first dim its spec leaves free (the
    rule of ``overlap.shard_first_free_dim``, which its update and
    moments follow too): GPT and Llama are built of the mp layers, and
    the reference's rule would leave every matrix of theirs whole under
    ZeRO-3 (GPT's position table is the one parameter it splits)."""
    mesh = mesh or require_mesh()
    declared = declared_specs(model)
    specs: Dict[str, PartitionSpec] = {}
    for name, p in model.named_parameters():
        if name in declared:
            spec = _filter_spec(declared[name], mesh)
            if zero3_axis and zero3_axis in mesh.shape \
                    and p.numel() >= min_zero3_size:
                spec, _ = shard_first_free_dim(spec, tuple(p.shape),
                                               zero3_axis, mesh)
            specs[name] = spec
            continue
        spec = [None] * p.ndim
        if zero3_axis and zero3_axis in mesh.shape \
                and p.numel() >= min_zero3_size:
            ax_size = mesh.shape[zero3_axis]
            # pick the largest divisible dim
            for i in sorted(range(p.ndim), key=lambda i: -p.shape[i]):
                if p.shape[i] % ax_size == 0:
                    spec[i] = zero3_axis
                    break
        specs[name] = PartitionSpec(*spec)
    return specs


def opt_state_specs(opt_state, params_specs: Dict[str, PartitionSpec],
                    shard_axis: Optional[str] = None, mesh=None,
                    on_fallback: Optional[Callable[[str], None]] = None,
                    shapes: Optional[Dict[str, tuple]] = None):
    """Specs of the optimizer state: each slot inherits its parameter's
    spec; with ``shard_axis`` (ZeRO-1/2) unsharded dims of the slots are
    additionally split over that axis by the SAME dim rule as
    ``overlap.weight_update_specs``. ``shapes`` are the full parameter
    shapes (default: the slots' own). A slot with no divisible dim stays
    at its base spec and is reported once through ``on_fallback``."""
    mesh = mesh or require_mesh()
    shapes = shapes or {}

    def spec_for(key, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
            return PartitionSpec()
        base = params_specs.get(key)
        if base is None:
            return PartitionSpec()
        shape = shapes.get(key, tuple(leaf.shape))
        if shard_axis and shard_axis in mesh.shape:
            spec, ok = shard_first_free_dim(base, shape, shard_axis, mesh)
            if not ok and on_fallback is not None:
                on_fallback(key)
            return spec
        return PartitionSpec(*(list(base) + [None] * (leaf.ndim - len(base))),
                             blocks=base.blocks)

    out = {}
    for slot, val in opt_state.items():
        if isinstance(val, dict) and slot != "step":
            out[slot] = {k: spec_for(k, v) for k, v in val.items()}
        elif isinstance(val, torch.Tensor):
            out[slot] = PartitionSpec()
        else:
            out[slot] = None
    return out


def shard_params(params: Dict[str, torch.Tensor],
                 specs: Dict[str, PartitionSpec], mesh: Optional[Mesh] = None):
    """This rank's local copy of each (full) parameter under its spec."""
    from ..convert import shard_state

    return shard_state(params, specs, mesh or require_mesh())


def shard_model(model: nn.Module, specs: Dict[str, PartitionSpec],
                mesh: Mesh) -> nn.Module:
    """Split the model's parameters in place: each becomes this rank's
    block under ``specs`` (a new ``nn.Parameter``; tied parameters stay
    tied), and every mp layer learns its mesh (``_mp_mesh``, also set on
    each mp-split parameter for ``parallel_matmul``)."""
    n_mp = mesh.axis_size("mp")
    for path, mod in model.named_modules():
        unit = getattr(mod, "mp_head_dim", None)
        if unit and n_mp > 1:
            heads = mod.out_features // mod.fused_blocks // unit
            if heads % n_mp:
                raise ValueError(
                    f"{path}: {heads} heads do not split over mp={n_mp}; "
                    f"tensor parallelism gives each rank whole heads, so "
                    f"num_heads (and Llama's num_kv_heads) must be a "
                    f"multiple of the mp degree")
    done = {}
    with torch.no_grad():
        for mod in model.modules():
            for pname, p in list(mod._parameters.items()):
                if p is None:
                    continue
                if id(p) not in done:
                    path = next(k for k, v in model.named_parameters()
                                if v is p)
                    spec = specs.get(path, PartitionSpec())
                    from ..convert import shard_tensor

                    local = shard_tensor(p.detach(), spec, mesh).clone()
                    new = nn.Parameter(local.contiguous(),
                                       requires_grad=p.requires_grad)
                    if "mp" in spec.axes():
                        new._mp_mesh = mesh
                    done[id(p)] = new
                mod._parameters[pname] = done[id(p)]
            if isinstance(mod, MPModule):
                mod._mp_mesh = mesh
    return model


class _Zero3Unit:
    """The stored parameters of one ZeRO-3 unit, and those of them whose
    gradient the running backward has still to produce."""

    def __init__(self, names):
        self.names = tuple(names)
        self.waiting: set = set()


def _zero3_units(model: nn.Module, stored) -> list:
    """Each child of an outermost ``nn.ModuleList`` whose stored
    parameters are used by it alone (a parameter tied to one outside
    stays with the step's whole-step set): ``[(module, _Zero3Unit)]``."""
    paths: Dict[int, list] = {}
    for path, p in model.named_parameters(remove_duplicate=False):
        paths.setdefault(id(p), []).append(path)
    canon = dict(model.named_parameters())
    units, taken = [], []
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.ModuleList) or any(
                name.startswith(t + ".") for t in taken):
            continue
        for cname, child in mod.named_children():
            prefix = f"{name}.{cname}." if name else f"{cname}."
            names = [k for k in stored if k.startswith(prefix) and all(
                q.startswith(prefix) for q in paths[id(canon[k])])]
            taken.append(prefix[:-1])
            if names:
                units.append((child, _Zero3Unit(names)))
    return units


# the newest DistributedTrainStep of each optimizer (``step_of``)
_STEPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def step_of(optimizer) -> Optional["DistributedTrainStep"]:
    """The live ``DistributedTrainStep`` that ``optimizer`` was last given
    to, or None."""
    ref = _STEPS.get(optimizer)
    return ref() if ref is not None else None


class _SplitParts:
    """``Optimizer._split`` for a step: the axes that split each update
    tensor, and the sum and gather over them."""

    def __init__(self, mesh: Mesh, axes: Dict[str, tuple]):
        self.mesh = mesh
        self._axes = {k: a for k, a in axes.items() if a}

    def axes(self, name):
        return self._axes.get(name)

    def sum(self, name, t: torch.Tensor) -> torch.Tensor:
        return C.all_reduce(t, C.ReduceOp.SUM, self._axes[name], self.mesh)

    def gather(self, name, t: torch.Tensor) -> torch.Tensor:
        return C.all_gather(t, self._axes[name], axis=0, mesh=self.mesh)


class _Reduced:
    """The handle of one bucket's collectives (see ``_issue``)."""

    def __init__(self, finish):
        self._finish = finish

    def wait(self):
        return self._finish()


class DistributedTrainStep:
    """Hybrid-parallel train step: ``loss = step(batch)`` on every rank,
    with the same global batch (each rank takes its slice).

    Composition by configuration (the ``DistributedStrategy`` analogue):
      - data parallel: batch split over ``batch_axes`` (("dp", "sdp"))
      - tensor parallel: layer-declared "mp" specs
      - ZeRO: ``sharding_stage`` 1/2 -> opt-state (+grad) sharded over
        "sdp"; 3 -> params too
      - overlap: ``overlap_grad_reduce=True`` -> bucketed gradient
        reduction from hooks, in reverse-backward order
        (``bucket_size_mb``, ``bucket_count``)
      - ``grad_accum_steps``, ``scaler`` and the guarded step, as
        ``TrainStep``'s: the finiteness and overflow flags are reduced
        over the whole mesh before the commit, so every shard takes the
        same branch, and a global-norm clip sums each gradient shard's
        squares once.

    The loss returned is the global batch's (the mean of the ranks'
    means). ``state_dict()`` gathers the full state onto every rank (a
    collective) and ``set_state_dict`` takes a full state."""

    _return_out = False

    def __init__(self, model: nn.Module, optimizer, loss_fn=None,
                 inputs_fn=None, mesh: Optional[Mesh] = None,
                 batch_axes=("dp", "sdp"), sharding_stage: int = 0,
                 grad_transform=None, donate: bool = True,
                 grad_accum_steps: int = 1, grad_accum_avg: bool = True,
                 scaler=None, overlap_grad_reduce: bool = False,
                 bucket_size_mb: Optional[float] = None,
                 bucket_count: Optional[int] = None):
        del donate
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.inputs_fn = resolve_inputs_fn(inputs_fn, loss_fn)
        self.grad_transform = grad_transform
        self.mesh = mesh or require_mesh()
        m = self.mesh
        if not m.member:
            raise RuntimeError("DistributedTrainStep: this rank is not on "
                               f"the mesh {m}")
        self.batch_axes = tuple(a for a in m.axis_names
                                if a in batch_axes and m.shape[a] > 1)
        self._n_batch = m.axis_size(self.batch_axes)
        # the public ZeRO entry may tag the optimizer with the user's stage
        sharding_stage = max(sharding_stage,
                             getattr(optimizer, "_group_sharded_stage", 0))
        self.sharding_stage = int(sharding_stage)
        if (self._n_batch > 1 or self.sharding_stage >= 1) and any(
                isinstance(mod, _BatchNormBase) and mod.training
                for mod in model.modules()):
            # the reference's statistics cover the global batch (GSPMD);
            # each rank here would take its own shard's
            raise NotImplementedError(
                "DistributedTrainStep: a training-mode BatchNorm under data "
                "parallelism or ZeRO needs batch statistics over the global "
                "batch (SyncBatchNorm), not ported yet (ROADMAP A8)")
        zero3 = SDP if sharding_stage >= 3 else None
        shard_axis = SDP if sharding_stage >= 1 else None
        self.specs = param_specs(model, m, zero3_axis=zero3)
        full = dict(model.named_parameters())
        self.full_shapes = {k: tuple(p.shape) for k, p in full.items()}
        self.zero_fallback_params: list = []

        def _note_fallback(name):
            if name not in self.zero_fallback_params:
                self.zero_fallback_params.append(name)

        self.update_specs = weight_update_specs(
            self.specs, self.full_shapes, shard_axis, m,
            on_fallback=_note_fallback)
        # the model keeps each parameter's tensor-parallel block (whole
        # over "sdp"); ZeRO-3 parameters are stored as their "sdp" shards
        self._compute_specs = {k: _drop_axis(s, SDP)
                               for k, s in self.specs.items()}
        from ..convert import shard_tensor

        with torch.no_grad():
            self._stored = {k: shard_tensor(full[k].detach(), s, m).clone()
                            for k, s in self.specs.items()
                            if SDP in s.axes() and m.axis_size(SDP) > 1}
        shard_model(model, self._compute_specs, m)
        self.compute_params: Dict[str, nn.Parameter] = dict(
            model.named_parameters())
        self._sdp_dim: Dict[str, Optional[int]] = {}
        for k in self.compute_params:
            d = _axis_dim(self.update_specs[k], SDP)
            self._sdp_dim[k] = (d if d is not None and m.axis_size(SDP) > 1
                                and shard_axis else None)
        self._units = _zero3_units(model, self._stored)
        self._whole_step = [k for k in self._stored if not any(
            k in u.names for _, u in self._units)]
        self._phase: Optional[str] = None   # "forward"/"backward" in a step
        for mod, unit in self._units:
            mod.register_forward_pre_hook(self._unit_pre(unit))
            mod.register_forward_hook(self._unit_post(unit))
            for k in unit.names:
                if self.compute_params[k].requires_grad:
                    self.compute_params[k].register_hook(
                        self._unit_grad(unit, k))
        self._free_gathered()
        # the tensors the optimizer updates: a ZeRO-3 shard, a view of the
        # parameter's "sdp" slice (ZeRO 1/2), or the parameter itself
        self.params = {k: self._stored.get(k, p)
                       for k, p in self.compute_params.items()}
        self._update_params = {k: self._update_view(k)
                               for k in self.compute_params}
        self.opt_state = optimizer.init(self._update_params)
        # per-parameter norms (Lamb, LARS) and DGC's quantile read the
        # whole parameter: reduced over the axes that split its update
        # (the optimizer holds this only while ``_update`` runs)
        self._split_parts = _SplitParts(m, {
            k: self._split_axes(k) for k in self.compute_params})
        _STEPS[optimizer] = weakref.ref(self)
        self.opt_specs = opt_state_specs(self.opt_state, self.specs,
                                         shard_axis, m,
                                         shapes=self.full_shapes)
        self.overlap_grad_reduce = bool(overlap_grad_reduce)
        if bucket_size_mb is None:
            # ported DataParallel scripts carry their comm_buffer_size
            # (MB): honor it as the bucket size hint
            bucket_size_mb = getattr(model, "_comm_buffer_mb", None) or 25.0
        self.bucket_size_mb = float(bucket_size_mb)
        self._buckets = None
        if self.overlap_grad_reduce:
            sizes = {k: p.numel() * p.element_size()
                     for k, p in self.compute_params.items()}
            self._buckets = build_buckets(
                sizes, int(self.bucket_size_mb * 2 ** 20), bucket_count)
        if self.zero_fallback_params and shard_axis:
            from ..observability.registry import default_registry

            reg = default_registry()
            reg.inc("distributed.zero_fallback_params_total",
                    len(self.zero_fallback_params))
            reg.set_gauge("distributed.zero_fallback_params",
                          len(self.zero_fallback_params),
                          step=type(model).__name__,
                          stage=str(sharding_stage))
            logging.getLogger(__name__).warning(
                "ZeRO stage %d: %d param(s) have no sdp-divisible dim; "
                "their update stays REPLICATED: %s", sharding_stage,
                len(self.zero_fallback_params),
                ", ".join(self.zero_fallback_params[:8])
                + ("..." if len(self.zero_fallback_params) > 8 else ""))
        # every group the step uses is made now, by every rank together
        for axes in (self.batch_axes, tuple(a for a in self.batch_axes
                                            if a != SDP), m.axis_names):
            m.group(axes)
        seed = torch.tensor([framework_random.next_seed()], dtype=torch.int64,
                            device=self.device)
        self._base_seed = int(C.broadcast(seed, 0, m.axis_names, m)[0])
        self._count = 0
        self._calls = 0
        self.grad_accum_steps = int(grad_accum_steps)
        self.grad_accum_avg = grad_accum_avg
        self._grad_accum = None
        if self.grad_accum_steps > 1:
            self._grad_accum = {
                k: torch.zeros(self._compute_shape(k), device=p.device,
                               dtype=_grad_dtype(p.dtype))
                for k, p in self.compute_params.items()}
        self.scaler = scaler if (scaler is not None
                                 and getattr(scaler, "enable", True)) else None
        if self.scaler is not None and self.grad_accum_steps > 1:
            raise ValueError(
                "GradScaler with grad_accum_steps > 1 is not supported: the "
                "scale could change mid-accumulation window")
        self.scaler_state = None
        if self.scaler is not None:
            self.scaler_state = {
                k: v.to(self.device) if isinstance(v, torch.Tensor) else v
                for k, v in self.scaler.state.items()}
        self._pending_poison = 1.0
        self._reducer = None
        #: buckets the last overlapped step issued from gradient hooks,
        #: before its backward returned (the rest wait for ``finish``)
        self.buckets_issued_in_backward = 0
        if self.overlap_grad_reduce:
            for k, p in self.compute_params.items():
                p.register_hook(self._hook(k))

    # ------------------------------------------------------------ layout
    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def _compute_shape(self, name):
        spec, shape = self._compute_specs[name], self.full_shapes[name]
        return tuple(n // self.mesh.axis_size(s) if s is not None else n
                     for n, s in zip(shape, list(spec) + [None] * len(shape)))

    def _update_view(self, name):
        if name in self._stored:
            return self._stored[name]
        p = self.compute_params[name]
        d = self._sdp_dim[name]
        if d is None:
            return p
        n = p.shape[d] // self.mesh.axis_size(SDP)
        return p.detach().narrow(d, self.mesh.axis_index(SDP) * n, n)

    def _gather(self, names) -> None:
        """ZeRO-3: all-gather the stored shards of ``names`` that are not
        in the model into their parameters (every rank gathers the same
        names at the same point of the step)."""
        with torch.no_grad():
            items = []
            for k in names:
                p = self.compute_params[k]
                if p.numel():
                    continue
                p.data = torch.empty(self._compute_shape(k), dtype=p.dtype,
                                     device=p.device)
                items.append((self._stored[k], p.data, self._sdp_dim[k]))
            self._all_gather_into(items)

    def _free(self, names) -> None:
        for k in names:
            p = self.compute_params[k]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def _unit_pre(self, unit: _Zero3Unit):
        def hook(module, args):
            if self._phase is not None:
                self._gather(unit.names)

        return hook

    def _unit_post(self, unit: _Zero3Unit):
        def again(grad):
            self._gather(unit.names)

        def hook(module, args, output):
            if self._phase is None:
                return
            if self._phase == "forward":   # not a recompute in the backward
                self._free(unit.names)
            for t in tree_leaves(output):
                if isinstance(t, torch.Tensor) and t.requires_grad:
                    t.register_hook(again)

        return hook

    def _unit_grad(self, unit: _Zero3Unit, name: str):
        def hook(grad):
            if self._phase == "backward" and name in unit.waiting:
                unit.waiting.discard(name)
                if not unit.waiting:
                    self._free(unit.names)
            return None

        return hook

    def _all_gather_into(self, items) -> None:
        """All-gather over "sdp" of many slices at once: ``items`` are
        ``(this rank's slice, the whole tensor, the split dim)``; one
        collective a dtype carries every slice laid end to end, and rank
        j's copy of each lands in its block of the whole tensor."""
        n = self.mesh.axis_size(SDP)
        by_dtype: Dict[torch.dtype, list] = {}
        for item in items:
            by_dtype.setdefault(item[0].dtype, []).append(item)
        for group in by_dtype.values():
            flat = torch.cat([src.reshape(-1) for src, _, _ in group])
            out = torch.empty(n * flat.numel(), dtype=flat.dtype,
                              device=flat.device)
            work = C.all_gather_async(out, flat, SDP, self.mesh)
            if work is not None:
                work.wait()
            off = 0
            for j in range(n):
                for src, whole, d in group:
                    w = src.shape[d]
                    whole.narrow(d, j * w, w).copy_(
                        out[off:off + src.numel()].view(src.shape))
                    off += src.numel()

    def _free_gathered(self) -> None:
        self._free(self._stored)

    # ------------------------------------------------------- reduction
    def _issue(self, names, grads):
        """Start the reduction of one bucket: gradients of parameters
        whose update is sdp-sharded under ZeRO 2/3 are reduce-scattered
        over "sdp" (then all-reduced over the other batch axes), the rest
        all-reduced over the batch axes; one flat buffer per kind and
        dtype. Returns a handle whose ``wait()`` gives ``{name: gradient
        of the update's tensor}``, divided by the batch size."""
        m, n = self.mesh, self._n_batch
        rs_ok = self.sharding_stage >= 2 and SDP in self.batch_axes
        groups: Dict[tuple, list] = {}
        for k in names:
            kind = "rs" if rs_ok and self._sdp_dim[k] is not None else "ar"
            groups.setdefault((kind, grads[k].dtype), []).append(k)
        finishers = []
        for (kind, _), ks in groups.items():
            if kind == "rs":
                finishers.append(self._issue_rs(ks, grads))
            else:
                finishers.append(self._issue_ar(ks, grads))

        def finish():
            out = {}
            for f in finishers:
                out.update(f())
            if n > 1:
                for v in out.values():
                    v.div_(n)
            return out

        return _Reduced(finish)

    def _issue_ar(self, ks, grads):
        flat = torch.cat([grads[k].reshape(-1) for k in ks])
        work = C.all_reduce_async(flat, C.ReduceOp.SUM, self.batch_axes,
                                  self.mesh)

        def finish():
            if work is not None:
                work.wait()
            out, off = {}, 0
            for k in ks:
                g = grads[k]
                v = flat[off:off + g.numel()].view(g.shape)
                off += g.numel()
                d = self._sdp_dim[k]
                if d is not None:
                    w = g.shape[d] // self.mesh.axis_size(SDP)
                    v = v.narrow(d, self.mesh.axis_index(SDP) * w, w)
                out[k] = v.contiguous()
            return out

        return finish

    def _issue_rs(self, ks, grads):
        m = self.mesh
        n_sdp = m.axis_size(SDP)
        parts = []
        for j in range(n_sdp):
            for k in ks:
                g, d = grads[k], self._sdp_dim[k]
                w = g.shape[d] // n_sdp
                parts.append(g.narrow(d, j * w, w).reshape(-1))
        flat = torch.cat(parts)
        out = torch.empty(flat.numel() // n_sdp, dtype=flat.dtype,
                          device=flat.device)
        work = C.reduce_scatter_async(out, flat, SDP, m)
        rest = tuple(a for a in self.batch_axes if a != SDP)

        def finish():
            if work is not None:
                work.wait()
            w2 = C.all_reduce_async(out, C.ReduceOp.SUM, rest, m)
            if w2 is not None:
                w2.wait()
            res, off = {}, 0
            for k in ks:
                shape = list(grads[k].shape)
                shape[self._sdp_dim[k]] //= n_sdp
                size = int(np.prod(shape))
                res[k] = out[off:off + size].view(shape)
                off += size
            return res

        return finish

    def _hook(self, name):
        def hook(grad):
            red = self._reducer
            if red is not None:
                red.arrive(name, self._merge_one(name, grad))
            return None

        return hook

    def _merge_one(self, name, g):
        """Gradient merge of one parameter on the update call."""
        if self._grad_accum is None:
            return g
        a = self._grad_accum[name]
        a.add_(g.to(a.dtype))
        merged = (a / float(self.grad_accum_steps) if self.grad_accum_avg
                  else a.clone()).to(g.dtype)
        a.zero_()
        return merged

    def _zeros(self, name):
        p = self.compute_params[name]
        return torch.zeros(self._compute_shape(name), dtype=p.dtype,
                           device=p.device)

    # ----------------------------------------------------------- the step
    def inject_anomaly(self):
        """Poison the next step's loss with NaN (the fault seam)."""
        self._pending_poison = float("nan")

    def _take_poison(self) -> float:
        p, self._pending_poison = self._pending_poison, 1.0
        return p

    def _next_count(self):
        count = self._count
        self._count += 1
        self._calls += 1
        do_update = (self.grad_accum_steps <= 1
                     or self._count % self.grad_accum_steps == 0)
        return count, do_update

    def _local_batch(self, batch):
        n, i = self._n_batch, self.mesh.axis_index(self.batch_axes)

        def leaf(x):
            if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1:
                if x.shape[0] % n:
                    raise ValueError(
                        f"batch dimension {x.shape[0]} does not split over "
                        f"{n} batch ranks")
                b = x.shape[0] // n
                return x[i * b:(i + 1) * b]
            return x

        return _to_device(tree_map(leaf, batch), self.device)

    def _world_all(self, flag: torch.Tensor) -> torch.Tensor:
        """True on every rank iff ``flag`` is True on every rank."""
        v = C.all_reduce(flag.reshape(1).to(torch.int32), C.ReduceOp.MIN,
                         self.mesh.axis_names, self.mesh)
        return v[0] > 0

    def _step(self, batch, checked: bool):
        count, do_update = self._next_count()
        poison = self._take_poison()
        batch = self._local_batch(batch)
        seed = framework_random.fold_in(self._base_seed, count)
        if self._n_batch > 1:   # dp ranks draw their own masks
            seed = framework_random.fold_in(
                seed, self.mesh.axis_index(self.batch_axes))
        seeds = framework_random.split_streams(seed, DEFAULT_RNG_STREAMS)
        names = list(self.compute_params)
        if self._stored:
            self._free_gathered()
            self._gather(self._whole_step)
            for _, unit in self._units:
                unit.waiting = {k for k in unit.names
                                if self.compute_params[k].requires_grad}
        hooked = self.overlap_grad_reduce and do_update
        if hooked:
            self._reducer = BucketedReduce(self._buckets, self._issue,
                                           self._zeros)
        try:
            with rng_context(seeds):
                self._phase = "forward"
                inputs = self.inputs_fn(batch)
                if not isinstance(inputs, (tuple, list)):
                    inputs = (inputs,)
                out = self.model(*inputs)
                raw = out if self.loss_fn is None else self.loss_fn(out,
                                                                    batch)
                loss = raw.float() * poison
                scaled = (loss if self.scaler_state is None
                          else scale_loss(loss, self.scaler_state))
                self._phase = "backward"
                grads = torch.autograd.grad(
                    scaled, [self.compute_params[k] for k in names],
                    allow_unused=True)
            if hooked:
                # how much of the reduction the backward overlapped
                self.buckets_issued_in_backward = self._reducer.issued
                reduced = self._reducer.finish()
        finally:
            self._reducer = None
            self._phase = None
            if self._stored:
                self._free_gathered()
        loss = C.all_reduce(loss.detach(), C.ReduceOp.AVG, self.batch_axes,
                            self.mesh)
        if not hooked:
            grads = {k: self._zeros(k) if g is None else g
                     for k, g in zip(names, grads)}
            if self._grad_accum is not None and not do_update:
                for k, g in grads.items():
                    self._grad_accum[k].add_(g.to(self._grad_accum[k].dtype))
                return loss, None, None
            grads = {k: self._merge_one(k, g) for k, g in grads.items()}
            # the serial schedule: one collective a parameter, in
            # declaration order, all issued before the first wait
            reduced = bucketed_reduce(
                grads, [GradBucket(i, (k,)) for i, k in enumerate(names)],
                self._issue)
        del grads
        if self.grad_transform is not None:
            reduced = self.grad_transform(reduced)
        return (loss,) + self._update(reduced, loss, checked)

    def _clip(self, grads):
        """The optimizer's clip over sharded gradients: a global (or
        per-tensor) norm sums the squares of each shard once over the
        ranks that hold it."""
        from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm

        clip, m = self.optimizer.grad_clip, self.mesh
        if not isinstance(clip, (ClipGradByGlobalNorm, ClipGradByNorm)):
            return grads, clip
        if isinstance(clip, ClipGradByGlobalNorm):
            sq = torch.zeros((), dtype=torch.float32, device=self.device)
            for k, g in grads.items():
                if self._owner(k):
                    sq = sq + torch.sum(torch.square(g.float()))
            gnorm = torch.sqrt(C.all_reduce(sq, group=m.axis_names, mesh=m))
            scale = clip.clip_norm / torch.clamp(gnorm, min=clip.clip_norm)
            return {k: (g.float() * scale).to(g.dtype)
                    for k, g in grads.items()}, None
        out = {}
        for k, g in grads.items():
            axes = self.update_specs[k].axes()
            sq = C.all_reduce(torch.sum(torch.square(g.float())), group=axes,
                              mesh=m)
            scale = torch.clamp(clip.clip_norm
                                / torch.clamp(torch.sqrt(sq), min=1e-12),
                                max=1.0)
            out[k] = (g.float() * scale).to(g.dtype)
        return out, None

    def _split_axes(self, name) -> tuple:
        """The mesh axes (of size > 1) that split ``name``'s update
        tensor."""
        used = set(self.update_specs[name].axes())
        if self._sdp_dim[name] is None:
            used.discard(SDP)
        return tuple(a for a in self.mesh.axis_names
                     if a in used and self.mesh.shape[a] > 1)

    def _owner(self, name) -> bool:
        """True on the one rank of each replica set of ``name``'s update
        tensor (coordinate 0 on every axis it is not split over)."""
        used = set(self._split_axes(name))
        return all(self.mesh.coordinate[a] == 0
                   for a in self.mesh.axis_names if a not in used)

    def _update(self, grads, loss, checked):
        grads, clip = self._clip(grads)
        saved_clip = self.optimizer.grad_clip
        self.optimizer.grad_clip = clip
        self.optimizer._split = self._split_parts
        try:
            if self.scaler_state is None and not checked:
                self.optimizer.update(grads, self.opt_state,
                                      self._update_params)
                self._after_update()
                return None, None
            flags_out = {}
            if self.scaler_state is not None:
                grads, found = unscale_and_check(grads, self.scaler_state)
                found = ~self._world_all(~found)

                def guard(params_finite):
                    skip, flags_out["scaler"], flags_out["ok"], \
                        flags_out["found"] = scaler_guard(
                            loss, found, self.scaler_state,
                            self._world_all(params_finite))
                    return skip
            else:
                def guard(params_finite):
                    ok = finite_guard(grads, params_finite,
                                      extra_ok=torch.isfinite(loss))
                    flags_out["ok"] = self._world_all(ok)
                    flags_out["found"] = torch.zeros_like(flags_out["ok"])
                    return ~flags_out["ok"]

            self.optimizer.update(grads, self.opt_state, self._update_params,
                                  guard=guard)
        finally:
            self.optimizer.grad_clip = saved_clip
            self.optimizer._split = None
        self._after_update()
        if self.scaler_state is not None:
            self.scaler_state = flags_out["scaler"]
            self.scaler._note_step(flags_out["found"])
            self.scaler.state = dict(self.scaler_state)
        return flags_out["ok"], flags_out["found"]

    def _after_update(self) -> None:
        """ZeRO 1/2: all-gather each updated "sdp" slice back into its
        parameter (ZeRO-3 shards are gathered at the next step)."""
        with torch.no_grad():
            self._all_gather_into([
                (self._update_params[k], p, self._sdp_dim[k])
                for k, p in self.compute_params.items()
                if self._sdp_dim[k] is not None and k not in self._stored])

    def __call__(self, batch):
        check = flags.flag("FLAGS_check_nan_inf")
        loss, ok, _ = self._step(batch, checked=check)
        if check and ok is not None:
            raise_if_bad_step(ok, loss)
        return loss

    def watchdog_call(self, batch):
        """One step through the guarded update: ``(loss, ok, found_inf)``,
        the flags lazy device bools, None on accumulate-only calls."""
        return self._step(batch, checked=True)

    # ---------------------------------------------------- introspection
    def enable_integrity(self, vote_axis="dp"):
        raise NotImplementedError(
            "DistributedTrainStep.enable_integrity: the cross-replica "
            "fingerprint vote (distributed/integrity.py) is not ported yet "
            "(ROADMAP A8, integrity)")

    def cache_stats(self) -> dict:
        """The reference's compile/call counters: the port compiles
        nothing, so every call counts as a cache hit."""
        return {"compiles": 0, "calls": self._calls,
                "cache_hits": self._calls, "signatures": {},
                "last_trace_signature": None}

    def collective_schedule(self) -> list:
        """The bucketed reduction schedule as plain dicts (``[]`` on the
        serial path)."""
        return [b.to_dict() for b in (self._buckets or [])]

    def statusz(self) -> dict:
        """The sharding/overlap configuration. A nonzero
        ``zero_fallback_params`` under ``sharding_stage >= 1`` means that
        many updates run replicated (no sdp-divisible dim)."""
        from . import env

        return {
            "sharding_stage": self.sharding_stage,
            "overlap_grad_reduce": self.overlap_grad_reduce,
            "bucket_size_mb": self.bucket_size_mb,
            "buckets": self.collective_schedule(),
            "params": len(self.params),
            "zero_fallback_params": list(self.zero_fallback_params),
            "grad_accum_steps": self.grad_accum_steps,
            "buckets_issued_in_backward": self.buckets_issued_in_backward,
            "mesh": dict(self.mesh.shape),
            "backend": env.backend(),
            "collectives": C.stats(),
        }

    # ---------------------------------------------------------- state
    def full_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter, gathered whole (a collective)."""
        from ..convert import gather_tensor

        return {k: gather_tensor(self._stored[k] if k in self._stored
                                 else p.detach(),
                                 self.specs[k] if k in self._stored
                                 else self._compute_specs[k],
                                 self.mesh).to("cpu", copy=True)
                for k, p in self.compute_params.items()}

    def sync_to_model(self):
        """ZeRO-3: leave the gathered parameters in the model (until the
        next step); otherwise the model already holds them."""
        self._gather(self._stored)
        return self.model

    def state_dict(self) -> dict:
        """The full state, gathered onto every rank (a collective):
        parameters, optimizer state, the step count, the base seed, the
        merged gradient accumulator and the scaler state."""
        from ..convert import gather_tensor

        m = self.mesh
        sd = {"params": self.full_params(), "buffers": {},
              "count": self._count, "base_seed": self._base_seed}
        opt = {}
        for slot, val in self.opt_state.items():
            if isinstance(val, dict):
                opt[slot] = {k: gather_tensor(v.detach(),
                                              self.update_specs[k], m)
                             .to("cpu", copy=True) for k, v in val.items()}
            elif isinstance(val, torch.Tensor):
                opt[slot] = val.detach().cpu().clone()
            else:
                opt[slot] = val
        sd["opt_state"] = opt
        if self._grad_accum is not None:
            sd["grad_accum"] = {
                k: gather_tensor(C.all_reduce(a, C.ReduceOp.AVG,
                                              self.batch_axes, m),
                                 self._compute_specs[k], m)
                .to("cpu", copy=True) for k, a in self._grad_accum.items()}
        if self.scaler_state is not None:
            sd["scaler_state"] = {k: v.detach().cpu().clone()
                                  if isinstance(v, torch.Tensor) else v
                                  for k, v in self.scaler_state.items()}
        return sd

    def set_state_dict(self, sd: dict) -> None:
        """Restore a full state (tensors or numpy arrays): each rank copies
        in its own blocks."""
        from ..convert import shard_state

        m, dev = self.mesh, self.device

        def load(live: dict, saved: dict, specs: dict):
            local = shard_state({k: saved[k] for k in live}, specs, m,
                                device=dev)
            for k, t in live.items():
                t.copy_(local[k].to(t.dtype))

        with torch.no_grad():
            compute = {k: p for k, p in self.compute_params.items()
                       if k not in self._stored}
            load(compute, sd["params"], self._compute_specs)
            load(self._stored, sd["params"], self.specs)
            for slot, val in self.opt_state.items():
                saved = sd["opt_state"][slot]
                if isinstance(val, dict):
                    seen = {}
                    for k, t in val.items():
                        if id(t) in {id(p) for p in compute.values()}:
                            continue   # a float32 master is the parameter
                        seen[k] = t
                    load(seen, saved, self.update_specs)
                elif isinstance(val, torch.Tensor):
                    val.copy_(torch.as_tensor(saved, device=val.device))
            if self._grad_accum is not None and "grad_accum" in sd:
                load(self._grad_accum, sd["grad_accum"], self._compute_specs)
            if self.scaler_state is not None and "scaler_state" in sd:
                for k, v in sd["scaler_state"].items():
                    if isinstance(self.scaler_state.get(k), torch.Tensor):
                        self.scaler_state[k].copy_(torch.as_tensor(v))
                    else:
                        self.scaler_state[k] = v
                self.scaler.state = dict(self.scaler_state)
        self._count = int(sd.get("count", 0))
        if sd.get("base_seed") is not None:
            self._base_seed = int(sd["base_seed"])

    # --------------------------------------------------- sharded state
    def _local_leaves(self):
        """``{flat checkpoint key: (live local tensor, spec)}`` of the
        parameters and the optimizer state (keys as ``state_dict()``'s
        tree flattens them)."""
        out = {}
        for k, p in self.compute_params.items():
            if k in self._stored:
                out[f"params/{k}"] = (self._stored[k], self.specs[k])
            else:
                out[f"params/{k}"] = (p.detach(), self._compute_specs[k])
        for slot, val in self.opt_state.items():
            if isinstance(val, dict):
                for k, t in val.items():
                    out[f"opt_state/{slot}/{k}"] = (t, self.update_specs[k])
            elif isinstance(val, torch.Tensor):
                out[f"opt_state/{slot}"] = (val, PartitionSpec())
        return out

    def sharded_state_dict(self):
        """``(state, shardings)``: the step's state as each rank holds it
        (its own slices, no collective) and, per flat key, the
        ``checkpoint.Sharding`` of each slice — what
        ``checkpoint.save_state(state, dir, shardings=shardings)`` writes
        from every rank as one checkpoint, and what
        ``load_state(dir, shardings=...)`` of a step on ANY mesh reads
        back for :meth:`set_sharded_state_dict`. The gradient
        accumulator (this rank's unreduced sum) is left out; the scaler
        state is whole on every rank."""
        from .checkpoint import Sharding

        tree = {"count": self._count, "base_seed": self._base_seed}
        shardings = {}
        for key, (t, spec) in self._local_leaves().items():
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = t.detach()
            shardings[key] = Sharding(self.mesh, spec)
        if self.scaler_state is not None:
            tree["scaler_state"] = {k: v.detach() if isinstance(
                v, torch.Tensor) else v for k, v in self.scaler_state.items()}
        return tree, shardings

    def set_sharded_state_dict(self, flat: dict) -> None:
        """Restore from ``load_state(dir, shardings=...)``'s flat result
        (``shardings`` from this step's :meth:`sharded_state_dict`): each
        live tensor takes its slice, bit for bit."""
        with torch.no_grad():
            for key, (t, _) in self._local_leaves().items():
                if key in flat:
                    t.copy_(torch.as_tensor(flat[key]).to(t.device, t.dtype))
            if self.scaler_state is not None:
                for k, v in self.scaler_state.items():
                    got = flat.get(f"scaler_state/{k}")
                    if got is None:
                        continue
                    if isinstance(v, torch.Tensor):
                        v.copy_(torch.as_tensor(got).to(v.device, v.dtype))
                    else:
                        self.scaler_state[k] = got
                self.scaler.state = dict(self.scaler_state)
        self._count = int(flat.get("count", self._count))
        if flat.get("base_seed") is not None:
            self._base_seed = int(flat["base_seed"])
        if self._stored:
            self._free_gathered()

"""Tensor (model) parallel layers, Megatron style (port of
``paddle_tpu/distributed/parallel/mp_layers.py:51-151``).

The reference declares shardings over the "mp" mesh axis and lets GSPMD
derive the collectives. The port holds explicit local shards and issues
the collectives itself, through ``autograd.Function``s whose backward is
the conjugate of their forward (``torch.distributed.nn``'s all-reduce
all-reduces again in its backward, which would multiply gradients by mp):

- :class:`ColumnParallelLinear` — weight ``[in, out/mp]`` on each rank;
  its input is the identity going forward and an all-reduce going back
  (``_CopyToMP``); ``gather_output`` all-gathers the output features;
- :class:`RowParallelLinear` — weight ``[in/mp, out]``; its output is an
  all-reduce going forward and the identity going back (``_ReduceFromMP``);
- :class:`VocabParallelEmbedding` — table ``[vocab/mp, h]``: a masked
  lookup of the ids this rank owns, then an all-reduce;
- :class:`ParallelCrossEntropy` — softmax cross entropy over
  vocab-sharded logits: all-reduces of the max and of the sum of
  exponentials, and the label's logit taken on the rank that owns it;
- :func:`parallel_matmul` — the tied head; the logits stay vocab-sharded
  when ``tensor_parallel_output``.

A layer is sharded by ``shard.shard_model`` (which slices its parameters
by :meth:`param_shard_specs` and sets ``_mp_mesh``). Until then, or on a
mesh without an "mp" axis, each layer is exactly the single-card layer
(``Linear``, ``Embedding``, ``cross_entropy``, the plain product): one
implementation. Attention runs on the rank's own heads, so the flash
kernels see plain local tensors.

Randomness: mp ranks share the step's streams, so they draw the same
masks on the replicated activations; attention on a rank's own heads
draws from that stream folded with the rank's "mp" index
(:func:`own_heads_rng`), so its masks differ from the other ranks'.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn

from ...framework import random as framework_random
from ...nn import functional as F
from ...nn.layer import rng_context, take_rng_key
from ...nn.layers.common import Embedding, Linear
from .. import collective as C
from ..mesh import Mesh, PartitionSpec

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "parallel_matmul", "MPModule", "mp_mesh_of", "own_heads_rng"]

MP = "mp"


def mp_mesh_of(obj) -> Optional[Mesh]:
    """The mesh a sharded layer (or sharded parameter) lives on, when its
    "mp" axis has more than one rank; else None (the single-card path)."""
    mesh = getattr(obj, "_mp_mesh", None)
    if mesh is None or mesh.axis_size(MP) == 1:
        return None
    return mesh


@contextlib.contextmanager
def own_heads_rng(layer, active: bool):
    """Dropout on this rank's own heads: inside the block the "dropout"
    stream is one draw of the enclosing stream folded with the rank's
    "mp" index, so mp ranks draw different masks for their heads while
    the enclosing stream (the replicated activations' masks) advances
    alike on every rank. A no-op when ``active`` is False or ``layer`` is
    not split over "mp"."""
    mesh = mp_mesh_of(layer)
    if not active or mesh is None:
        yield
        return
    seed = framework_random.fold_in(take_rng_key("dropout"),
                                    mesh.axis_index(MP))
    with rng_context({"dropout": seed}):
        yield


class _CopyToMP(torch.autograd.Function):
    """Identity forward, all-reduce over "mp" backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce(g, group=MP, mesh=ctx.mesh), None


class _ReduceFromMP(torch.autograd.Function):
    """All-reduce over "mp" forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return C.all_reduce(x, group=MP, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMP(torch.autograd.Function):
    """All-gather the last dim over "mp" forward; the rank's own slice
    backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.width = x.shape[-1]
        return C.all_gather(x, group=MP, axis=x.ndim - 1, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.axis_index(MP)
        return g.narrow(-1, r * ctx.width, ctx.width).contiguous(), None


def copy_to_mp(x, mesh):
    return _CopyToMP.apply(x, mesh)


def reduce_from_mp(x, mesh):
    return _ReduceFromMP.apply(x, mesh)


class MPModule:
    """Mixin of the mp-aware layers: ``_mp_mesh`` (None until sharded) and
    the specs of their parameters (``{name: PartitionSpec}``)."""

    _mp_mesh: Optional[Mesh] = None

    def param_shard_specs(self) -> Dict[str, PartitionSpec]:
        return {}


class ColumnParallelLinear(MPModule, Linear):
    """``Linear`` with out_features split over "mp" (weight ``[in,
    out/mp]`` per rank). ``gather_output=False`` keeps the output
    feature-sharded for a following :class:`RowParallelLinear`.
    ``fused_blocks`` (port-only) marks an output made of that many equal
    parts, each split over "mp" (GPT's fused qkv: 3)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, bias_attr=None,
                 std: Optional[float] = None, fused_blocks: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        del fuse_matmul_bias, mp_group
        super().__init__(in_features, out_features, weight_attr, bias_attr,
                         name, std=std, has_bias=has_bias, device=device,
                         generator=generator)
        self.gather_output = gather_output
        self.fused_blocks = int(fused_blocks)
        #: attention projections set this: their output features are
        #: heads of this many features, and a rank takes whole heads
        self.mp_head_dim: Optional[int] = None

    def param_shard_specs(self):
        specs = {"weight": PartitionSpec(None, MP, blocks=self.fused_blocks)}
        if self.bias is not None:
            specs["bias"] = PartitionSpec(MP, blocks=self.fused_blocks)
        return specs

    def forward(self, x):
        mesh = mp_mesh_of(self)
        if mesh is None:
            return F.linear(x, self.weight, self.bias)
        out = F.linear(copy_to_mp(x, mesh), self.weight, self.bias)
        if self.gather_output:
            if self.fused_blocks > 1:
                raise NotImplementedError(
                    "gather_output with fused_blocks > 1: the gathered "
                    "features would interleave the blocks")
            out = _GatherFromMP.apply(out, mesh)
        return out


class RowParallelLinear(MPModule, Linear):
    """``Linear`` with in_features split over "mp" (weight ``[in/mp,
    out]`` per rank): the partial products are all-reduced, then the
    (replicated) bias is added. ``input_is_parallel=False`` takes a whole
    input and uses this rank's slice of its features."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 bias_attr=None, std: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        del fuse_matmul_bias, mp_group
        super().__init__(in_features, out_features, weight_attr, bias_attr,
                         name, std=std, has_bias=has_bias, device=device,
                         generator=generator)
        self.input_is_parallel = input_is_parallel

    def param_shard_specs(self):
        return {"weight": PartitionSpec(MP, None)}

    def forward(self, x):
        mesh = mp_mesh_of(self)
        if mesh is None:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            width = self.weight.shape[0]
            x = copy_to_mp(x, mesh).narrow(
                -1, mesh.axis_index(MP) * width, width)
        out = reduce_from_mp(torch.matmul(x, self.weight), mesh)
        return out if self.bias is None else out + self.bias


class VocabParallelEmbedding(MPModule, Embedding):
    """``Embedding`` with the vocab split over "mp" (table ``[vocab/mp,
    h]`` per rank): each rank looks up the ids it owns (zeros elsewhere)
    and the rows are all-reduced."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, std: Optional[float] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        del mp_group
        super().__init__(num_embeddings, embedding_dim, weight_attr=weight_attr,
                         name=name, std=std, device=device,
                         generator=generator)

    def param_shard_specs(self):
        return {"weight": PartitionSpec(MP, None)}

    def forward(self, ids):
        mesh = mp_mesh_of(self)
        if mesh is None:
            return super().forward(ids)
        rows = self.weight.shape[0]
        start = mesh.axis_index(MP) * rows
        local = ids - start
        outside = (local < 0) | (local >= rows)
        out = self.weight[local.masked_fill(outside, 0)]
        out = out.masked_fill(outside[..., None], 0.0)
        return reduce_from_mp(out, mesh)


class ParallelCrossEntropy(MPModule, nn.Module):
    """Per-token softmax cross entropy (``mp_layers.py:129``). On one card
    (or an unsharded model) it is ``cross_entropy(reduction="none")``.
    Over vocab-sharded logits it is the vocab-parallel softmax, in
    float32: the max and the sum of exponentials are all-reduced over
    "mp", the label's logit is taken on the rank that owns the label and
    all-reduced, and ``ignore_index`` labels give 0. The result is in the
    logits' dtype, as ``cross_entropy`` gives it."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        del mp_group, name
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        mesh = mp_mesh_of(self)
        if mesh is None:
            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)
        label = torch.as_tensor(label, device=input.device).long()
        z = input.float()
        with torch.no_grad():
            zmax = C.all_reduce(z.max(dim=-1).values, op=C.ReduceOp.MAX,
                                group=MP, mesh=mesh)
        z = z - zmax[..., None]
        sumexp = reduce_from_mp(z.exp().sum(dim=-1), mesh)
        width = z.shape[-1]
        local = label - mesh.axis_index(MP) * width
        owned = (local >= 0) & (local < width)
        picked = torch.gather(z, -1, local.clamp(0, width - 1)[..., None])
        picked = reduce_from_mp(picked.squeeze(-1) * owned, mesh)
        loss = torch.log(sumexp) - picked
        loss = torch.where(label == self.ignore_index,
                           torch.zeros_like(loss), loss)
        return loss.to(input.dtype)


def parallel_matmul(x, weight, transpose_y: bool = False,
                    tensor_parallel_output: bool = True):
    """The logit projection with a (tied, vocab-sharded) embedding weight
    (``mp_layers.py:145``): ``x @ weight`` or ``x @ weight^T``. A sharded
    weight (one that carries its ``_mp_mesh``) gives this rank's vocab
    slice of the logits, all-gathered unless ``tensor_parallel_output``."""
    mesh = mp_mesh_of(weight)
    if mesh is None:
        return torch.matmul(x, weight.t() if transpose_y else weight)
    out = torch.matmul(copy_to_mp(x, mesh),
                       weight.t() if transpose_y else weight)
    if not tensor_parallel_output:
        out = _GatherFromMP.apply(out, mesh)
    return out

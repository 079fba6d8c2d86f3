"""Load the JAX package's weights into the port: GPT, Llama, BERT,
ERNIE, ResNet, the vision zoo (LeNet, VGG, MobileNet, AlexNet,
SqueezeNet, ShuffleNetV2, DenseNet, GoogLeNet, InceptionV3), PP-YOLOE,
YOLOv3, CRNN, or any ported layer tree (``nn.Transformer``, ...).

The JAX ``Layer.state_dict()`` names map one to one onto the port's
parameters and persistable buffers (BatchNorm's ``_mean`` and
``_variance``), with the same layouts (linear weights ``[in, out]``,
embeddings ``[vocab, hidden]``, conv kernels ``[out, in / groups, *k]``),
so conversion is a copy by name. The caller passes the state
as numpy arrays (``{k: np.asarray(v) for k, v in jax_model.state_dict().
items()}``); this module imports nothing of JAX. Arrays in bfloat16
(``ml_dtypes``, the state of a model after ``amp.decorate(level="O2")``)
load into bfloat16 parameters, float32 arrays into float32 ones. The
config's training fields (recompute, ``loss_chunk``, dropout) carry over
with ``cfg``. A reference model injected with LoRA (``paddle_tpu.lora.
apply_lora``) converts with ``lora=`` its ``LoraConfig``'s port twin: the
port model is injected the same way first, and its ``lora_A``/``lora_B``
leaves load by name with the base weights.

Sharded models: :func:`shard_state` gives one rank of a mesh its shards
of a full state (``{name: array}``) under the port's parameter specs
(``distributed.shard.param_specs``), and :func:`gather_state` is its
inverse, gathering every rank's shards back into the full state (a
collective: every rank of the mesh calls it). Both follow each spec's
dimension rule, the fused "mp" blocks of GPT's ``qkv_proj`` included.
"""
from __future__ import annotations

from typing import Dict, Optional, Type

import numpy as np
import torch
from torch import nn

from .models.bert import BertConfig, BertForSequenceClassification
from .models.ernie import ErnieConfig, ErnieForSequenceClassification
from .models.gpt import GPTConfig, GPTForCausalLM
from .models.llama import LlamaConfig, LlamaForCausalLM
from .models import ppyoloe as _ppyoloe
from .models import resnet as _resnet
from .models.ocr import CRNN
from .models.yolo import YOLOv3
from .vision import models as _zoo
from .lora import LoraConfig, apply_lora

__all__ = ["gpt_from_jax", "llama_from_jax", "bert_from_jax",
           "ernie_from_jax", "resnet_from_jax", "zoo_from_jax",
           "ppyoloe_from_jax", "yolov3_from_jax", "crnn_from_jax",
           "layer_from_jax",
           "shard_tensor",
           "gather_tensor", "shard_state", "gather_state"]


def _load_state(model: nn.Module, state: Dict[str, np.ndarray],
                family: str) -> nn.Module:
    """Copy ``state`` into ``model``'s parameters and persistent buffers
    by name and put the model in eval mode. A parameter takes the array's
    type (bfloat16 or float32); a buffer keeps its own (BatchNorm's
    running statistics stay float32)."""
    params = dict(model.named_parameters())
    buffers = dict(model.state_dict(keep_vars=True))
    buffers = {k: v for k, v in buffers.items() if k not in params}
    missing = sorted((set(params) | set(buffers)) - set(state))
    extra = sorted(set(state) - set(params) - set(buffers))
    if missing or extra:
        raise KeyError(f"state does not match the port's {family}: missing "
                       f"{missing}, unexpected {extra}")
    with torch.no_grad():
        for name, t in {**params, **buffers}.items():
            value = np.asarray(state[name])
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)}, the "
                                 f"port expects {tuple(t.shape)}")
            if name in buffers:
                t.copy_(torch.from_numpy(np.array(
                    value, dtype=np.float32 if value.dtype.name == "bfloat16"
                    else value.dtype)))
                continue
            dtype = (torch.bfloat16 if value.dtype.name == "bfloat16"
                     else torch.float32)
            value = np.array(value, dtype=np.float32)  # a copy
            t.data = torch.from_numpy(value).to(device=t.device, dtype=dtype)
    model.eval()
    return model


def _injected(model: nn.Module, lora: Optional[LoraConfig]) -> nn.Module:
    return model if lora is None else apply_lora(model, lora)


def gpt_from_jax(state: Dict[str, np.ndarray], cfg: GPTConfig,
                 device=None, lora: Optional[LoraConfig] = None
                 ) -> GPTForCausalLM:
    """A port ``GPTForCausalLM`` for ``cfg`` on ``device`` carrying the
    weights in ``state``, in eval mode (call ``.train()`` to train it);
    with ``lora``, injected with it and carrying the state's adapter
    leaves too. Raises ``KeyError`` on a missing or an extra name and
    ``ValueError`` on a wrong shape."""
    return _load_state(_injected(GPTForCausalLM(cfg, device=device), lora),
                       state, "GPT")


def llama_from_jax(state: Dict[str, np.ndarray], cfg: LlamaConfig,
                   device=None, lora: Optional[LoraConfig] = None
                   ) -> LlamaForCausalLM:
    """A port ``LlamaForCausalLM`` for ``cfg`` on ``device`` carrying the
    weights in ``state``, in eval mode (call ``.train()`` to train it);
    with ``lora``, injected with it and carrying the state's adapter
    leaves too. Raises ``KeyError`` on a missing or an extra name and
    ``ValueError`` on a wrong shape."""
    return _load_state(_injected(LlamaForCausalLM(cfg, device=device), lora),
                       state, "Llama")


def bert_from_jax(state: Dict[str, np.ndarray], cfg: BertConfig,
                  device=None, model_cls: Type[nn.Module] =
                  BertForSequenceClassification, **kwargs) -> nn.Module:
    """A port ``model_cls`` (``BertModel``, ``BertForSequenceClassification``
    with ``num_classes=`` in ``kwargs``, or ``BertForPretraining``) for
    ``cfg`` on ``device`` carrying the weights in ``state``, in eval mode.
    Raises ``KeyError`` on a missing or an extra name and ``ValueError``
    on a wrong shape."""
    return _load_state(model_cls(cfg, device=device, **kwargs), state,
                       model_cls.__name__)


def ernie_from_jax(state: Dict[str, np.ndarray], cfg: ErnieConfig,
                   device=None, model_cls: Type[nn.Module] =
                   ErnieForSequenceClassification, **kwargs) -> nn.Module:
    """:func:`bert_from_jax` for the ERNIE classes (``ErnieModel``,
    ``ErnieForSequenceClassification``, ``ErnieForPretraining``)."""
    return _load_state(model_cls(cfg, device=device, **kwargs), state,
                       model_cls.__name__)


def resnet_from_jax(state: Dict[str, np.ndarray], depth_or_ctor="resnet50",
                    device=None, **kwargs) -> nn.Module:
    """A port ResNet carrying a reference ResNet's ``state_dict()``
    (parameters and BatchNorm statistics), in eval mode.
    ``depth_or_ctor`` is a constructor of
    :mod:`paddle_tpu_torch.models.resnet` (or its name, e.g.
    ``"resnext50_32x4d"``), or a depth (18, 34, 50, 101, 152) for the
    plain ResNet; ``kwargs`` (``num_classes``, ``with_pool``, ...) go to
    it as they went to the reference's. Raises ``KeyError`` on a missing
    or an extra name and ``ValueError`` on a wrong shape."""
    ctor = depth_or_ctor
    if isinstance(ctor, int):
        ctor = f"resnet{ctor}"
    if isinstance(ctor, str):
        ctor = getattr(_resnet, ctor)
    return _load_state(ctor(device=device, **kwargs), state, "ResNet")


def zoo_from_jax(state: Dict[str, np.ndarray], ctor, device=None,
                 **kwargs) -> nn.Module:
    """A port vision model carrying a reference zoo model's
    ``state_dict()`` (parameters and BatchNorm statistics), in eval mode.
    ``ctor`` is any constructor or class of
    :mod:`paddle_tpu_torch.vision.models` (or its name, e.g.
    ``"mobilenet_v3_large"``, ``"shufflenet_v2_x1_0"``, ``"vgg16"``), and
    ``kwargs`` (``num_classes``, ``scale``, ``batch_norm``, ``with_pool``,
    ...) go to it as they went to the reference's. Raises ``KeyError`` on
    a missing or an extra name and ``ValueError`` on a wrong shape."""
    if isinstance(ctor, str):
        ctor = getattr(_zoo, ctor)
    model = ctor(device=device, **kwargs)
    return _load_state(model, state, type(model).__name__)


def ppyoloe_from_jax(state: Dict[str, np.ndarray], ctor="ppyoloe_s",
                     device=None, fused: bool = False,
                     **kwargs) -> nn.Module:
    """A port PP-YOLOE carrying a reference PP-YOLOE's ``state_dict()``
    (parameters and BatchNorm statistics), in eval mode. ``ctor`` is a
    constructor of :mod:`paddle_tpu_torch.models.ppyoloe` (or its name:
    ``"ppyoloe_s"``, ``"ppyoloe_tiny"``, ``"PPYOLOE"``) and ``kwargs`` go
    to it as they went to the reference's. ``fused=True`` loads the state
    of a reference model after its ``fuse_rep()`` (each RepConv's
    ``_fused`` conv beside its branches) into a fused port model. Raises
    ``KeyError`` on a missing or an extra name and ``ValueError`` on a
    wrong shape."""
    if isinstance(ctor, str):
        ctor = getattr(_ppyoloe, ctor)
    model = ctor(device=device, **kwargs)
    if fused:
        model.eval().fuse_rep()
    return _load_state(model, state, "PPYOLOE")


def yolov3_from_jax(state: Dict[str, np.ndarray], device=None,
                    **kwargs) -> nn.Module:
    """A port ``YOLOv3(**kwargs)`` carrying a reference YOLOv3's
    ``state_dict()``, in eval mode. Raises ``KeyError`` on a missing or an
    extra name and ``ValueError`` on a wrong shape."""
    return _load_state(YOLOv3(device=device, **kwargs), state, "YOLOv3")


def crnn_from_jax(state: Dict[str, np.ndarray], num_classes: int,
                  device=None, **kwargs) -> nn.Module:
    """A port ``CRNN(num_classes, **kwargs)`` carrying a reference CRNN's
    ``state_dict()`` (its LSTM's ``rnn.rnns.0.rnn_fw.cell.weight_ih``, ...),
    in eval mode. Raises ``KeyError`` on a missing or an extra name and
    ``ValueError`` on a wrong shape."""
    return _load_state(CRNN(num_classes, device=device, **kwargs), state,
                       "CRNN")


def layer_from_jax(module: nn.Module,
                   state: Dict[str, np.ndarray]) -> nn.Module:
    """Load ``state`` into an already built port layer tree (e.g. an
    ``nn.Transformer`` built with the reference's arguments) by name, in
    place; returns ``module`` in eval mode."""
    return _load_state(module, state, type(module).__name__)


# ------------------------------------------------------------ sharding
def _dim_axes(entry):
    return (() if entry is None else
            (entry,) if isinstance(entry, str) else tuple(entry))


def shard_tensor(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a
    ``distributed.mesh.PartitionSpec``): each dimension split over its
    axes, a fused dimension (``spec.blocks``) block by block. A view where
    possible; the caller copies."""
    out = full
    for d, entry in enumerate(spec):
        axes = _dim_axes(entry)
        n = mesh.axis_size(axes)
        if n == 1:
            continue
        i = mesh.axis_index(axes)
        blocks = spec.blocks if "mp" in axes else 1
        size = out.shape[d]
        if size % (n * blocks):
            raise ValueError(f"dimension {d} of {tuple(full.shape)} does not "
                             f"split into {n} x {blocks} blocks")
        part = size // blocks // n
        out = out.unflatten(d, (blocks, size // blocks)).narrow(
            d + 1, i * part, part).flatten(d, d + 1)
    return out


def gather_tensor(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full tensor from every rank's :func:`shard_tensor` block (a
    collective over the spec's axes)."""
    from .distributed import collective as C

    out = local.detach()
    for d, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if mesh.axis_size(axes) == 1:
            continue
        blocks = spec.blocks if "mp" in axes else 1
        out = C.all_gather(out.unflatten(d, (blocks, out.shape[d] // blocks)),
                           group=axes, axis=d + 1, mesh=mesh).flatten(d, d + 1)
    return out


def shard_state(state: Dict[str, np.ndarray], specs, mesh,
                device=None) -> Dict[str, torch.Tensor]:
    """One rank's shards of a full state (numpy arrays, bfloat16 as
    ``ml_dtypes``, or tensors): ``{name: tensor}`` on ``device``, each
    ``shard_tensor(state[name], specs[name])`` (a name without a spec is
    whole)."""
    out = {}
    for name, value in state.items():
        if isinstance(value, torch.Tensor):
            full = value.detach()
        else:
            value = np.asarray(value)
            dtype = (torch.bfloat16 if value.dtype.name == "bfloat16"
                     else None)
            full = torch.from_numpy(np.array(
                value, dtype=np.float32 if dtype is not None else None))
            if dtype is not None:
                full = full.to(dtype)
        spec = specs.get(name)
        local = full if spec is None else shard_tensor(full, spec, mesh)
        out[name] = local.to(device=device or local.device,
                             copy=True).contiguous()
    return out


def gather_state(state: Dict[str, torch.Tensor], specs,
                 mesh) -> Dict[str, torch.Tensor]:
    """The full state from every rank's shards (every rank of the mesh
    calls it, in the same order, and gets the whole state): ``{name: CPU
    tensor}``."""
    return {name: (v.detach() if specs.get(name) is None
                   else gather_tensor(v, specs[name], mesh)).cpu().clone()
            for name, v in state.items()}

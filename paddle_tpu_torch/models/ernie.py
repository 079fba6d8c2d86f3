"""ERNIE family (port of ``paddle_tpu/models/ernie.py``): the BERT
encoder with a task-type embedding in the input sum. Everything but that
addend is shared with :mod:`.bert` through its hooks (``embeddings_cls``,
``_make_encoder``, ``_encode``, ``_classify``, ``_mlm_nsp_loss``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..nn.layers.common import Embedding
from .bert import (BertConfig, BertEmbeddings, BertForPretraining,
                   BertForSequenceClassification, BertModel, _init)

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieModel",
           "ErnieForSequenceClassification", "ErnieForPretraining",
           "ernie_tiny", "ernie_3_base"]


@dataclass
class ErnieConfig(BertConfig):
    task_type_vocab_size: int = 3
    use_task_id: bool = True


def ernie_tiny(**kw) -> ErnieConfig:
    return ErnieConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                       num_heads=4, max_position_embeddings=128, **kw)


def ernie_3_base(**kw) -> ErnieConfig:
    """ERNIE-3.0 base: 40000 word pieces, hidden 768, 12 layers of 12
    heads, 2048 positions, 4 token types (the reference's values)."""
    kw.setdefault("max_position_embeddings", 2048)
    kw.setdefault("type_vocab_size", 4)
    return ErnieConfig(vocab_size=40000, hidden_size=768, num_layers=12,
                       num_heads=12, **kw)


class ErnieEmbeddings(BertEmbeddings):
    """BERT's input sum plus a task-type embedding (the ERNIE delta)."""

    def __init__(self, cfg: ErnieConfig, *, device=None, generator=None):
        super().__init__(cfg, device=device, generator=generator)
        self.use_task_id = cfg.use_task_id
        if cfg.use_task_id:
            self.task_type_embeddings = Embedding(
                cfg.task_type_vocab_size, cfg.hidden_size,
                weight_attr=_init(cfg), device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None):
        h = self._embed_sum(input_ids, token_type_ids)
        if self.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            h = h + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(h))


class ErnieModel(BertModel):
    """Task-aware embeddings over the shared BERT encoder stack."""

    embeddings_cls = ErnieEmbeddings

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        if attention_mask is None:
            attention_mask = self._default_mask(input_ids)
        h = self.embeddings(input_ids, token_type_ids, task_type_ids)
        return self._encode(h, attention_mask)


class ErnieForSequenceClassification(BertForSequenceClassification):
    def _make_encoder(self, cfg, device, generator):
        return ErnieModel(cfg, device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None, labels=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              task_type_ids)
        return self._classify(pooled, labels)


class ErnieForPretraining(BertForPretraining):
    """The masked-LM pretrain head over the task-aware encoder (whole-
    entity spans arrive as ``mlm_positions``: a data property, not a model
    one)."""

    def _make_encoder(self, cfg, device, generator):
        return ErnieModel(cfg, device=device, generator=generator)

    def forward(self, input_ids, mlm_positions, mlm_labels, nsp_labels=None,
                token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                                task_type_ids)
        return self._mlm_nsp_loss(seq, pooled, mlm_positions, mlm_labels,
                                  nsp_labels)

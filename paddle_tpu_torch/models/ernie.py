"""ERNIE model family (ERNIE 2.0 / 3.0-style encoder), on the port's paddle
API.

Counterpart of ``paddle_tpu/models/ernie.py``, layer for layer and name
for name (so state dicts carry over): BASELINE config 2's ERNIE-3.0
pretraining.  ERNIE is the BERT encoder of ``models/bert.py`` plus

* task-type embeddings (``use_task_id``) added beside the word, position
  and segment embeddings;
* a pad-aware default attention mask: with no mask given, keys holding
  ``pad_token_id`` get -1e4 through a [B, 1, 1, S] additive mask.  On the
  card the flash kernels take it as their score bias, read in place
  through its strides (stride 0 over heads and queries).

``ErniePretrainingCriterion`` is BERT's (the MLM + sentence-pair
objective over whatever masking the data applied).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .. import nn
from .. import tensor_api as T
from .bert import (
    BertConfig, BertForPretraining, BertModel, BertPretrainingCriterion,
)


@dataclasses.dataclass
class ErnieConfig(BertConfig):
    """ERNIE-3.0-base defaults (vocab 40000, 12 x 768; PaddleNLP
    ``ernie-3.0-base-zh`` geometry)."""

    vocab_size: int = 40000
    task_type_vocab_size: int = 3
    use_task_id: bool = True
    pad_token_id: int = 0


def ernie_3_0_base(**kw):
    return ErnieConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def ernie_3_0_medium(**kw):
    return ErnieConfig(hidden_size=768, num_layers=6, num_heads=12, **kw)


def ernie_3_0_micro(**kw):
    return ErnieConfig(hidden_size=384, num_layers=4, num_heads=12, **kw)


class ErnieModel(BertModel):
    """BERT encoder + task-type embeddings + pad-aware default mask."""

    def __init__(self, cfg: ErnieConfig):
        super().__init__(cfg)
        if cfg.use_task_id:
            init = nn.initializer.Normal(0.0, cfg.initializer_range)
            self.task_type_embeddings = nn.Embedding(
                cfg.task_type_vocab_size, cfg.hidden_size,
                weight_attr=nn.ParamAttr(initializer=init))

    def _pad_mask(self, ids):
        """Additive mask hiding pad positions (PaddleNLP ErnieModel's
        behaviour when attention_mask is None): [b, 1, 1, s], -1e4 on
        pads."""
        pad = T.full_like(ids, self.cfg.pad_token_id)
        is_pad = T.cast(T.equal(ids, pad), "float32")
        return T.unsqueeze(is_pad * -1e4, [1, 2])

    def forward(self, ids, token_type_ids=None, task_type_ids=None,
                attn_mask=None):
        if token_type_ids is None:
            token_type_ids = T.zeros_like(ids)
        x = self._embed(ids, token_type_ids)
        if self.cfg.use_task_id:
            if task_type_ids is None:
                task_type_ids = T.zeros_like(ids)
            x = x + self.task_type_embeddings(task_type_ids)
        if attn_mask is None:
            attn_mask = self._pad_mask(ids)
        return self._encode(x, attn_mask)


class ErnieForPretraining(BertForPretraining):
    """MLM head (tied decoder) + sentence-order classifier: BERT's head
    algebra (``_heads``) over the ERNIE encoder and its task-type
    input."""

    def __init__(self, model_or_cfg):
        enc = (model_or_cfg if isinstance(model_or_cfg, ErnieModel)
               else ErnieModel(model_or_cfg))
        super().__init__(enc)

    @property
    def ernie(self):  # PaddleNLP attribute name
        return self.bert

    @property
    def sop(self):  # the sentence-pair classifier (sentence order)
        return self.nsp

    def forward(self, ids, token_type_ids=None, task_type_ids=None,
                attn_mask=None, masked_positions=None):
        seq, pooled = self.bert(ids, token_type_ids, task_type_ids,
                                attn_mask)
        return self._heads(seq, pooled, masked_positions)


# the MLM + sentence-pair objective algebra is BERT's
ErniePretrainingCriterion = BertPretrainingCriterion


class ErnieForSequenceClassification(nn.Layer):
    """Pooled-output classifier (PaddleNLP fine-tuning surface)."""

    def __init__(self, model_or_cfg, num_classes: int = 2,
                 dropout: Optional[float] = None):
        super().__init__()
        self.ernie = (model_or_cfg if isinstance(model_or_cfg, ErnieModel)
                      else ErnieModel(model_or_cfg))
        cfg = self.ernie.cfg
        self.dropout = nn.Dropout(
            cfg.dropout if dropout is None else dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)

    def forward(self, ids, token_type_ids=None, task_type_ids=None,
                attn_mask=None):
        _, pooled = self.ernie(ids, token_type_ids, task_type_ids,
                               attn_mask)
        return self.classifier(self.dropout(pooled))


class ErnieForTokenClassification(nn.Layer):
    """Per-token classifier (NER-style fine-tuning surface)."""

    def __init__(self, model_or_cfg, num_classes: int = 2,
                 dropout: Optional[float] = None):
        super().__init__()
        self.ernie = (model_or_cfg if isinstance(model_or_cfg, ErnieModel)
                      else ErnieModel(model_or_cfg))
        cfg = self.ernie.cfg
        self.dropout = nn.Dropout(
            cfg.dropout if dropout is None else dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)

    def forward(self, ids, token_type_ids=None, task_type_ids=None,
                attn_mask=None):
        seq, _ = self.ernie(ids, token_type_ids, task_type_ids, attn_mask)
        return self.classifier(self.dropout(seq))

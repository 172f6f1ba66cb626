"""BERT-style encoder pretraining (BertForPretraining and its
criterion), on the port's paddle API.

Counterpart of ``paddle_tpu/models/bert.py``, layer for layer and name
for name (so state dicts carry over): PaddleNLP BERT-base pretraining,
BASELINE config 2.  Attention is ``F.scaled_dot_product_attention`` in
the bnsd layout, bidirectional: on the card the flash kernels, forward
and backward.  The MLM head is tied to the word embedding and computed
by ``matmul_v2`` (``torch.matmul``), as the reference computes it
outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .. import nn
from ..nn import functional as F
from .. import tensor_api as T


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: Optional[int] = None
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.0
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    def __post_init__(self):
        if self.ffn_hidden is None:
            self.ffn_hidden = 4 * self.hidden_size


class BertSelfAttention(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.dropout = cfg.dropout

    def forward(self, x, attn_mask=None):
        b, s, h = x.shape
        qkv = T.reshape(self.qkv(x), [b, s, 3, self.num_heads, self.head_dim])
        qkv = T.transpose(qkv, [2, 0, 3, 1, 4])
        q, k, v = qkv[0], qkv[1], qkv[2]
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = T.reshape(T.transpose(out, [0, 2, 1, 3]), [b, s, h])
        return self.proj(out)


class BertLayer(nn.Layer):
    """Post-LN encoder block (BERT convention)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attn = BertSelfAttention(cfg)
        self.ln1 = nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.ffn_hidden)
        self.fc2 = nn.Linear(cfg.ffn_hidden, cfg.hidden_size)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x, attn_mask=None):
        x = self.ln1(x + self.drop(self.attn(x, attn_mask)))
        x = self.ln2(x + self.drop(self.fc2(F.gelu(self.fc1(x)))))
        return x


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        init = nn.initializer.Normal(0.0, cfg.initializer_range)
        wa = nn.ParamAttr(initializer=init)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, weight_attr=wa)
        self.position_embeddings = nn.Embedding(cfg.max_seq_len, cfg.hidden_size, weight_attr=wa)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size, weight_attr=wa)
        self.ln = nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.drop = nn.Dropout(cfg.dropout)
        self.layers = nn.LayerList([BertLayer(cfg) for _ in range(cfg.num_layers)])
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def _embed(self, ids, token_type_ids=None):
        b, s = ids.shape
        pos = T.arange(0, s, 1, dtype="int64")
        x = self.word_embeddings(ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return x

    def _encode(self, x, attn_mask=None):
        x = self.drop(self.ln(x))
        for l in self.layers:
            x = l(x, attn_mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled

    def forward(self, ids, token_type_ids=None, attn_mask=None):
        return self._encode(self._embed(ids, token_type_ids), attn_mask)


class BertForPretraining(nn.Layer):
    """MLM + NSP heads (BERT pretraining objective).

    Parity: PaddleNLP ``BertForPretraining`` (BertPretrainingHeads: the
    transform + LN + decoder tied to the word embedding, and the NSP
    classifier over the pooled output).  ``masked_positions`` gathers the
    masked token states BEFORE the LM head — only |masked| rows hit the
    (h, vocab) matmul, the same compute saving the reference gets from
    ``paddle.gather`` in BertPretrainingHeads.forward.
    """

    def __init__(self, model_or_cfg):
        super().__init__()
        self.bert = model_or_cfg if isinstance(model_or_cfg, BertModel) else BertModel(model_or_cfg)
        cfg = self.bert.cfg
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.ln = nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.nsp = nn.Linear(cfg.hidden_size, 2)

    def _heads(self, seq, pooled, masked_positions=None):
        if masked_positions is not None:
            b, s, h = seq.shape
            flat = T.reshape(seq, [b * s, h])
            seq = T.gather(flat, T.reshape(masked_positions, [-1]))
        h_out = self.ln(F.gelu(self.transform(seq)))
        w = self.bert.word_embeddings.weight
        mlm_logits = T.matmul(h_out, w, transpose_y=True)
        return mlm_logits, self.nsp(pooled)

    def forward(self, ids, token_type_ids=None, attn_mask=None,
                masked_positions=None):
        seq, pooled = self.bert(ids, token_type_ids, attn_mask)
        return self._heads(seq, pooled, masked_positions)


class BertPretrainingCriterion(nn.Layer):
    """MLM CE (ignore_index=-1 outside masked tokens) + NSP CE.

    Parity: PaddleNLP ``BertPretrainingCriterion.forward`` — masked-LM
    cross entropy scaled by ``masked_lm_scale`` plus next-sentence loss.
    """

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels,
                masked_lm_scale=1.0):
        """Reference semantics: ``sum(per-token CE over labels >= 0) /
        masked_lm_scale + mean(NSP CE)`` — callers pass the masked-token
        count as ``masked_lm_scale`` to get a mean (PaddleNLP pretraining
        recipe); the default 1.0 yields the raw sum like the reference."""
        labels = masked_lm_labels
        if len(labels.shape) == 1:
            labels = T.unsqueeze(labels, [-1])
        elif labels.shape[-1] != 1:
            labels = T.reshape(labels, [-1, 1])
            prediction_scores = T.reshape(
                prediction_scores, [-1, prediction_scores.shape[-1]])
        valid = T.cast(T.greater_equal(
            labels, T.full_like(labels, 0)), "float32")
        safe_labels = T.multiply(labels, T.cast(valid, labels.dtype))
        per_tok = F.softmax_with_cross_entropy(prediction_scores, safe_labels)
        masked_lm_sum = T.sum(T.multiply(per_tok, valid))
        masked_lm_loss = T.divide(
            masked_lm_sum, T.full_like(masked_lm_sum, float(masked_lm_scale)))
        nsp_labels = next_sentence_labels
        if len(nsp_labels.shape) == 1:
            nsp_labels = T.unsqueeze(nsp_labels, [-1])
        nsp_loss = T.mean(F.softmax_with_cross_entropy(
            seq_relationship_score, nsp_labels))
        return T.add(masked_lm_loss, nsp_loss)

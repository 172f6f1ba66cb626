"""Recommendation models: DeepFM and wide&deep, BASELINE config 4.

Counterpart of ``paddle_tpu/models/rec.py`` (``RecConfig``,
``FusedSparseEmbedding``, ``DeepFM``, ``WideDeep``,
``synthetic_click_batch``), layer for layer and name for name, so that
state dicts carry over (:func:`paddle_tpu_torch.weights.
load_paddle_state_dict`).

As in the reference, every categorical field shares one ``[total_vocab,
dim]`` table that lives on the card: each field's ids are offset by
``RecConfig.offsets()`` into global rows, so a ``[batch, fields]`` id
matrix is one gather.  Gradients are dense (the table's whole gradient,
and the optimizer's update of every row, each step), as the reference's
are: a lazy or sparse update would be another result.  The FM second
order is the O(b f d) sum-square identity.

``shard_axis`` names the mesh axis that splits the table's rows.  Without
a mesh, or where that axis has one rank, the table is whole.  Over more
ranks, rank r holds rows ``[r V/n, (r+1) V/n)`` as the port's
vocab-parallel embedding splits them
(:func:`~paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers.
vocab_parallel_embedding`): ids outside its rows look up zeros and an
all-reduce over the axis sums the ranks' rows.  The parameter is drawn
whole from the seed chain and the rank keeps its slice, so the split
model equals the whole one; it carries ``is_distributed`` and
``tp_split`` as the tensor-parallel layers' parameters do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .. import nn
from .. import tensor_api as T
from ..dygraph import tracer
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer_base import EagerParameter


@dataclasses.dataclass
class RecConfig:
    """Shared config of the sparse models.

    ``field_vocab_sizes[i]`` is the vocabulary of categorical field ``i``
    (ids fed in ``[0, field_vocab_sizes[i])``); ``dense_dim`` is the
    number of continuous features.
    """

    field_vocab_sizes: Sequence[int] = (1000,) * 26
    dense_dim: int = 13
    embedding_dim: int = 16
    hidden_sizes: Sequence[int] = (400, 400, 400)
    shard_axis: Optional[str] = "mp"  # mesh axis of the table's rows

    @property
    def num_fields(self) -> int:
        return len(self.field_vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.field_vocab_sizes))

    def offsets(self) -> np.ndarray:
        return np.cumsum([0] + list(self.field_vocab_sizes)[:-1]).astype(
            "int32")


def _row_split(axis):
    """(group, ranks, rank) of mesh axis ``axis`` when it splits the
    rows over more than one rank, else None."""
    from ..distributed import mesh as mesh_mod

    mesh = mesh_mod.get_mesh()
    if axis is None or mesh is None or mesh.shape.get(axis, 1) <= 1:
        return None
    return mesh.group(axis), mesh.shape[axis], mesh.coord[axis]


class FusedSparseEmbedding(nn.Layer):
    """All fields' embeddings in one table, one gather; its rows split
    over ``cfg.shard_axis`` where that axis has more than one rank."""

    def __init__(self, cfg: RecConfig, dim: Optional[int] = None,
                 init_std: float = 0.01):
        super().__init__()
        self._cfg = cfg
        dim = cfg.embedding_dim if dim is None else dim
        self.weight = self.create_parameter(
            shape=[cfg.total_vocab, dim],
            default_initializer=Normal(0.0, init_std))
        self._split = _row_split(cfg.shard_axis)
        if self._split is not None:
            _, n, r = self._split
            if cfg.total_vocab % n:
                raise ValueError(f"{cfg.total_vocab} rows do not split over "
                                 f"{cfg.shard_axis}={n}")
            per = cfg.total_vocab // n
            full = self.weight
            self.weight = EagerParameter(
                full._t[r * per:(r + 1) * per].clone(), name=full.name,
                is_distributed=True)
            self.weight.tp_split = (0, np.arange(r * per, (r + 1) * per),
                                    cfg.total_vocab)
            del full
        # the fields' row offsets, added to the ids every forward
        self._offsets = T.to_tensor(cfg.offsets())

    def forward(self, sparse_ids):
        # [b, f] local ids -> [b, f] global rows -> [b, f, dim]
        rows = sparse_ids + self._offsets
        if self._split is None:
            return F.embedding(rows, self.weight)
        from ..distributed.fleet.meta_parallel.mp_layers import (
            vocab_parallel_embedding)

        group = self._split[0]
        return tracer.trace_fn(
            lambda ids, w: vocab_parallel_embedding(ids, w, group),
            [rows, self.weight])


class _MLP(nn.Layer):
    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int = 1):
        super().__init__()
        layers: List[nn.Layer] = []
        d = in_dim
        for h in hidden:
            layers += [nn.Linear(d, h), nn.ReLU()]
            d = h
        layers.append(nn.Linear(d, out_dim))
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(x)


class DeepFM(nn.Layer):
    """DeepFM (Guo et al. 2017): FM first and second order plus a deep
    tower.  Returns logits ``[batch, 1]``; train with
    ``F.binary_cross_entropy_with_logits``."""

    def __init__(self, cfg: RecConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = FusedSparseEmbedding(cfg)
        # first-order weights: a dim-1 embedding over the same fused vocab
        self.fo_weight = FusedSparseEmbedding(cfg, dim=1)
        self.dense_fo = nn.Linear(cfg.dense_dim, 1)
        # the dense features join the FM pairwise term through a
        # projection into the embedding space
        self.dense_emb = nn.Linear(cfg.dense_dim, cfg.embedding_dim)
        self.deep = _MLP(cfg.num_fields * cfg.embedding_dim + cfg.dense_dim,
                         cfg.hidden_sizes)

    def forward(self, sparse_ids, dense_feats):
        b = sparse_ids.shape[0]
        emb = self.embedding(sparse_ids)                      # [b, f, d]
        # first order
        first = T.sum(self.fo_weight(sparse_ids), axis=[1, 2], keepdim=False)
        first = T.reshape(first, [b, 1]) + self.dense_fo(dense_feats)
        # second order over the fields and the projected dense features:
        # 0.5 ((sum e)^2 - sum e^2)
        dvec = T.reshape(self.dense_emb(dense_feats), [b, 1, -1])
        allv = T.concat([emb, dvec], axis=1)                  # [b, f+1, d]
        s = T.sum(allv, axis=1)                               # [b, d]
        s2 = T.sum(allv * allv, axis=1)                       # [b, d]
        second = 0.5 * T.sum(s * s - s2, axis=1, keepdim=True)
        # deep tower
        deep_in = T.concat([T.reshape(emb, [b, -1]), dense_feats], axis=1)
        return first + second + self.deep(deep_in)


class WideDeep(nn.Layer):
    """wide&deep (Cheng et al. 2016): a linear wide part plus an MLP."""

    def __init__(self, cfg: RecConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = FusedSparseEmbedding(cfg)
        self.wide = FusedSparseEmbedding(cfg, dim=1)          # sparse linear
        self.wide_dense = nn.Linear(cfg.dense_dim, 1)
        self.deep = _MLP(cfg.num_fields * cfg.embedding_dim + cfg.dense_dim,
                         cfg.hidden_sizes)

    def forward(self, sparse_ids, dense_feats):
        b = sparse_ids.shape[0]
        wide = T.reshape(
            T.sum(self.wide(sparse_ids), axis=[1, 2], keepdim=False), [b, 1]
        ) + self.wide_dense(dense_feats)
        emb = self.embedding(sparse_ids)
        deep_in = T.concat([T.reshape(emb, [b, -1]), dense_feats], axis=1)
        return wide + self.deep(deep_in)


def synthetic_click_batch(cfg: RecConfig, batch: int, seed: int = 0):
    """A synthetic Criteo-like batch ``(ids, dense, label)`` as numpy with a
    learnable signal: the label follows a hidden per-row logit of the
    sampled ids plus the dense features, so loss and AUC improve within a
    few steps.  The reference's draws, array for array."""
    rs = np.random.RandomState(seed)
    ids = np.stack(
        [rs.randint(0, v, size=batch) for v in cfg.field_vocab_sizes],
        axis=1).astype("int32")
    dense = rs.rand(batch, cfg.dense_dim).astype("float32")
    # the hidden ground truth: each vocabulary row carries a logit
    hidden = np.random.RandomState(1234)
    row_logit = hidden.randn(cfg.total_vocab).astype("float32") * 0.5
    glob = ids + cfg.offsets()[None, :]
    logit = row_logit[glob].sum(axis=1) + dense.sum(axis=1) - cfg.dense_dim / 2
    label = (1 / (1 + np.exp(-logit)) > rs.rand(batch)).astype("float32")
    return ids, dense, label[:, None]

"""GPT as paddle ``nn.Layer``s: the model a Paddle user trains through the
eager API and ``fleet`` (counterpart of the layer classes of
``paddle_tpu/models/gpt.py``: ``w8a8_linear``, ``GPTAttention``,
``GPTMLP``, ``GPTBlock``, ``GPTEmbeddings``, ``GPTModel``,
``GPTForPretraining``, ``GPTPretrainingCriterion``, ``_embed_head_fwd``
and ``GPTForPretrainingPipe``), layer for layer and name for name, so the
reference's ``state_dict()`` loads here
(:func:`paddle_tpu_torch.weights.load_paddle_state_dict`).

Which is which: this module keeps the reference's names for its paddle
layers, and :mod:`paddle_tpu_torch.models.gpt` and ``models/__init__.py``
export ``GPTForPretraining``, ``GPTModel``, ``GPTPretrainingCriterion``
and ``GPTForPretrainingPipe`` from here, as the reference's do.
:mod:`~paddle_tpu_torch.models.gpt`'s ``GPTParams`` (with ``GPTBlock``
and ``GPTParamsCriterion``) is the torch parameter holder that serving,
generation and the functional train step read; each of them also takes
this module's ``GPTForPretraining`` (:func:`paddle_tpu_torch.weights.
gpt_params`).  Both take the same :class:`GPTConfig`.

Attention goes through ``F.scaled_dot_product_attention`` (the registered
op: on the card the flash kernels, forward and backward), causal, in
bnsd, or in sbnd under ``seq_major`` (the [S, B, H] activations from the
embedding to the logits), with GQA and ``attn_window``.  Under ``int8``
the four projections of a block run W8A8 (:func:`w8a8_linear`: the
``w8a8_gemm`` kernel, straight-through gradients), and with
``int8_lm_head`` the tied head too.

Under ``use_parallel`` the projections, the word embedding and the head
are the tensor-parallel layers of :mod:`~paddle_tpu_torch.distributed.
fleet.meta_parallel` over the installed mesh's mp axis.  A rank holds the
slices :func:`paddle_tpu_torch.weights.tp_index` names: the fused QKV's
columns by head (its query heads, then the K/V heads they read), fc1's
columns, proj's and fc2's rows, the vocabulary rows of the tied
embedding.  The head's logits are then this rank's vocabulary slice and
the criterion takes the vocabulary-parallel cross-entropy.  mp must
divide the query and the K/V heads.
"""

from __future__ import annotations

from typing import Optional

from .. import nn
from .. import tensor_api as T
from ..dygraph import tracer
from ..nn import functional as F
from ..ops.quant_ops import w8a8_matmul
from .gpt import GPTConfig

__all__ = ["GPTConfig", "w8a8_linear", "GPTAttention", "GPTMLP", "GPTBlock",
           "GPTEmbeddings", "GPTModel", "GPTForPretraining",
           "GPTPretrainingCriterion", "GPTForPretrainingPipe"]


def _mpp():
    from ..distributed.fleet import meta_parallel as mpp

    return mpp


def _mp_rank():
    """(the mesh's mp degree, this rank's mp index)."""
    from ..distributed import mesh as mesh_mod

    return mesh_mod.axis_size("mp"), mesh_mod.axis_rank("mp")


def w8a8_linear(x, layer):
    """A Linear layer's weights through the W8A8 product
    (:func:`~paddle_tpu_torch.ops.w8a8_matmul`: per-output-channel weight
    quantization and dynamic per-token activation quantization of the live
    float weight, the int8 GEMM, straight-through gradients), then its
    bias.  The float parameters stay the layer's, so the int8 and float
    models share structure, state-dict keys and seed-chain draws."""
    out = tracer.trace_fn(lambda a, w: w8a8_matmul(a, w), [x, layer.weight])
    if getattr(layer, "bias", None) is not None:
        out = T.add(out, layer.bias)
    return out


class GPTAttention(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.window = cfg.attn_window
        self.dropout = cfg.dropout
        self.seq_major = cfg.seq_major
        self.int8 = cfg.int8
        init = nn.initializer.Normal(0.0, cfg.initializer_range)
        wa = nn.ParamAttr(initializer=init)
        qkv_width = (cfg.num_heads + 2 * cfg.num_kv_heads) * self.head_dim
        if cfg.use_parallel:
            from ..weights import tp_index

            mp, rank = _mp_rank()
            if cfg.num_heads % mp or cfg.num_kv_heads % mp:
                raise ValueError(
                    f"use_parallel: mp={mp} must divide num_heads "
                    f"({cfg.num_heads}) and num_kv_heads "
                    f"({cfg.num_kv_heads})")
            cols = tp_index(cfg, "qkv_w", mp, rank)[1] if mp > 1 else None
            mpp = _mpp()
            self.qkv = mpp.ColumnParallelLinear(
                cfg.hidden_size, qkv_width, weight_attr=wa,
                gather_output=False, int8=cfg.int8, columns=cols)
            self.proj = mpp.RowParallelLinear(
                cfg.hidden_size, cfg.hidden_size, weight_attr=wa,
                input_is_parallel=True, int8=cfg.int8)
        else:
            self.qkv = nn.Linear(cfg.hidden_size, qkv_width, weight_attr=wa)
            self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                  weight_attr=wa)
        # the tensor-parallel layers run W8A8 themselves
        self._w8a8 = cfg.int8 and not cfg.use_parallel

    def _run_qkv(self, x):
        return w8a8_linear(x, self.qkv) if self._w8a8 else self.qkv(x)

    def _run_proj(self, x):
        return w8a8_linear(x, self.proj) if self._w8a8 else self.proj(x)

    def _heads(self, w):
        """(query heads, K/V heads) of a QKV output ``w`` wide (this rank's
        share under tensor parallelism)."""
        hd = self.head_dim
        nkv = self.num_kv_heads * w // (
            (self.num_heads + 2 * self.num_kv_heads) * hd)
        return (w - 2 * nkv * hd) // hd, nkv

    def forward(self, x):
        hd = self.head_dim
        qkv = self._run_qkv(x)
        nh, nkv = self._heads(qkv.shape[-1])
        q, k, v = T.split(qkv, [nh * hd, nkv * hd, nkv * hd], axis=-1)
        if self.seq_major:
            # [S, B, H] in and out: reshapes only, the sbnd kernel entry
            # reads the layout in place
            s, b, _ = x.shape
            out = F.scaled_dot_product_attention(
                T.reshape(q, [s, b, nh, hd]), T.reshape(k, [s, b, nkv, hd]),
                T.reshape(v, [s, b, nkv, hd]), is_causal=True,
                dropout_p=self.dropout, training=self.training,
                layout="sbnd", window=self.window)
            return self._run_proj(T.reshape(out, [s, b, nh * hd]))
        b, s, _ = x.shape
        q = T.transpose(T.reshape(q, [b, s, nh, hd]), [0, 2, 1, 3])
        k = T.transpose(T.reshape(k, [b, s, nkv, hd]), [0, 2, 1, 3])
        v = T.transpose(T.reshape(v, [b, s, nkv, hd]), [0, 2, 1, 3])
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.dropout,
            training=self.training, window=self.window)
        out = T.reshape(T.transpose(out, [0, 2, 1, 3]), [b, s, nh * hd])
        return self._run_proj(out)


class GPTMLP(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        init = nn.initializer.Normal(0.0, cfg.initializer_range)
        wa = nn.ParamAttr(initializer=init)
        if cfg.use_parallel:
            mpp = _mpp()
            self.fc1 = mpp.ColumnParallelLinear(
                cfg.hidden_size, cfg.ffn_hidden, weight_attr=wa,
                gather_output=False, int8=cfg.int8)
            self.fc2 = mpp.RowParallelLinear(
                cfg.ffn_hidden, cfg.hidden_size, weight_attr=wa,
                input_is_parallel=True, int8=cfg.int8)
        else:
            self.fc1 = nn.Linear(cfg.hidden_size, cfg.ffn_hidden,
                                 weight_attr=wa)
            self.fc2 = nn.Linear(cfg.ffn_hidden, cfg.hidden_size,
                                 weight_attr=wa)
        self._w8a8 = cfg.int8 and not cfg.use_parallel

    def forward(self, x):
        if self._w8a8:
            return w8a8_linear(F.gelu(w8a8_linear(x, self.fc1)), self.fc2)
        return self.fc2(F.gelu(self.fc1(x)))


class GPTBlock(nn.Layer):
    """Pre-LN decoder block; homogeneous, so the pipeline engine puts
    runs of them on its stages."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.mlp = GPTMLP(cfg)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        x = x + self.mlp(self.ln2(x))
        return x


class GPTEmbeddings(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        init = nn.initializer.Normal(0.0, cfg.initializer_range)
        if cfg.use_parallel:
            self.word_embeddings = _mpp().VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size,
                weight_attr=nn.ParamAttr(initializer=init))
        else:
            self.word_embeddings = nn.Embedding(
                cfg.vocab_size, cfg.hidden_size,
                weight_attr=nn.ParamAttr(initializer=init))
        self.position_embeddings = nn.Embedding(
            cfg.max_seq_len, cfg.hidden_size,
            weight_attr=nn.ParamAttr(initializer=init))
        self.dropout = nn.Dropout(cfg.dropout)
        self.seq_major = cfg.seq_major

    def forward(self, ids):
        b, s = ids.shape
        pos = T.arange(0, s, 1, dtype="int64")
        pe = self.position_embeddings(pos)
        if self.seq_major:
            # the [B, S] ids transposed once; [S, B, H] from here on
            x = self.word_embeddings(T.transpose(ids, [1, 0])) \
                + T.unsqueeze(pe, [1])
        else:
            x = self.word_embeddings(ids) + pe
        return self.dropout(x)


class GPTModel(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = GPTEmbeddings(cfg)
        self.blocks = nn.LayerList([GPTBlock(cfg)
                                    for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)

    def forward(self, ids):
        x = self.embeddings(ids)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)


def _tied_head(x, word_embeddings, w8a8=False):
    """Logits of ``x`` against the word embedding: ``x @ W^T`` (W8A8 with
    ``w8a8``).  A vocabulary-parallel embedding gives this rank's
    vocabulary slice of the logits, marked ``vocab_parallel`` for the
    criterion; ``x`` enters through ``_c_identity`` so its gradient sums
    the ranks' slices."""
    w = word_embeddings.weight
    vocab_parallel = getattr(w, "tp_split", None) is not None
    if vocab_parallel:
        from ..distributed.collective import _c_identity

        group = word_embeddings.group
        x = tracer.trace_fn(lambda a: _c_identity(a, group), [x])
    if w8a8:
        out = tracer.trace_fn(lambda a, b: w8a8_matmul(a, b, True), [x, w])
    else:
        out = T.matmul(x, w, transpose_y=True)
    out.vocab_parallel = vocab_parallel
    return out


class GPTForPretraining(nn.Layer):
    """LM head tied to the word embedding (PaddleNLP GPTForPretraining)."""

    def __init__(self, model_or_cfg):
        super().__init__()
        self.gpt = (model_or_cfg if isinstance(model_or_cfg, GPTModel)
                    else GPTModel(model_or_cfg))
        self.cfg = self.gpt.cfg

    def forward(self, ids):
        x = self.gpt(ids)
        return _tied_head(x, self.gpt.embeddings.word_embeddings,
                          self.cfg.int8 and self.cfg.int8_lm_head)


class GPTPretrainingCriterion(nn.Layer):
    """Next-token cross-entropy (vocabulary-parallel for logits the tied
    head marked so).  ``seq_major``: logits arrive [S, B, V] and the
    labels stay [B, S]; the labels are transposed here, never the
    logits."""

    def __init__(self, seq_major: bool = False):
        super().__init__()
        self.seq_major = seq_major

    def forward(self, logits, labels, loss_mask=None):
        if self.seq_major:
            labels = T.transpose(labels, [1, 0])
            if loss_mask is not None:
                loss_mask = T.transpose(loss_mask, [1, 0])
        if getattr(logits, "vocab_parallel", False):
            loss = _mpp().ParallelCrossEntropy()(logits,
                                                 T.unsqueeze(labels, [-1]))
        else:
            loss = F.softmax_with_cross_entropy(logits,
                                                T.unsqueeze(labels, [-1]))
        loss = T.squeeze(loss, [-1])
        if loss_mask is not None:
            return T.divide(T.sum(T.multiply(loss, loss_mask)),
                            T.maximum(T.sum(loss_mask),
                                      T.full_like(T.sum(loss_mask), 1.0)))
        return T.mean(loss)


def _embed_head_fwd(layer, x):
    """The tied LM head on the shared embedding layer (the
    ``SharedLayerDesc`` forward_func of PaddleNLP's pipelined GPT)."""
    return _tied_head(x, layer.word_embeddings)


def GPTForPretrainingPipe(cfg: GPTConfig, num_stages: Optional[int] = None,
                          **kw):
    """GPT as a ``PipelineLayer``: the embedding (shared with the tied
    head), the blocks, the final LayerNorm and the head, with the
    criterion as its loss.  The pipeline engine runs the blocks on their
    stages and the embedding and the head, stored 1/S per stage, on the
    first and the last (:class:`~paddle_tpu_torch.distributed.fleet.
    meta_parallel.PipelineEngine`)."""
    from ..distributed.fleet.meta_parallel import (LayerDesc, PipelineLayer,
                                                   SharedLayerDesc)

    descs = [
        SharedLayerDesc("embed", GPTEmbeddings, None, "weight", cfg),
        *[LayerDesc(GPTBlock, cfg) for _ in range(cfg.num_layers)],
        LayerDesc(nn.LayerNorm, cfg.hidden_size, epsilon=cfg.layer_norm_eps),
        SharedLayerDesc("embed", GPTEmbeddings, _embed_head_fwd, "weight",
                        cfg),
    ]
    return PipelineLayer(
        layers=descs, num_stages=num_stages,
        loss_fn=GPTPretrainingCriterion(seq_major=cfg.seq_major),
        seq_major=cfg.seq_major, **kw)

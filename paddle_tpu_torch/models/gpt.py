"""GPT: configuration, parameters, the training forward and the functional
train step (counterpart of ``paddle_tpu/models/gpt.py``).

:class:`GPTParams` holds the decoder's parameters as a torch module: word and
position embeddings, the pre-LN blocks, the final LayerNorm, and the LM
head tied to the word embedding.  Projection weights keep the reference's
``[in, out]`` layout (``x @ W``), so parameter names and shapes match the
JAX parameter tree that ``models/generation._decoder_setup`` builds there,
one to one, and the JAX model's ``named_parameters()`` in the same order
(see :mod:`paddle_tpu_torch.weights`).

Inference reads the parameters through
:func:`paddle_tpu_torch.models.generation._decoder_setup`.  The
full-sequence forward (:meth:`GPTParams.forward`) and
:func:`build_functional_train_step` (forward, backward, chunked
cross-entropy and AdamW with fp32 masters) run attention through
:func:`~paddle_tpu_torch.kernels.sdpa`: the flash kernels on the card, the
dense plain attention on the CPU.  With ``int8`` the four projections of
each block go through :func:`~paddle_tpu_torch.ops.w8a8_matmul` (the
``w8a8_gemm`` kernel, straight-through gradients), and with
``int8_lm_head`` too the eager forward's tied head.

Dropout (``cfg.dropout > 0``, in training mode) follows the reference: on
the embedding sum (:func:`~paddle_tpu_torch.ops.dropout`) and on each
block's attention probabilities (:func:`~paddle_tpu_torch.kernels.
attention.sdpa_dropout`, the reference's non-kernel attention: dropout
never reaches the flash kernels, there or here).  Each mask is drawn from
its own key: the eager forward takes one key per site from the seed chain
(:mod:`paddle_tpu_torch.framework.random`) in the reference's order, the
embedding's and then each block's; the train step folds its step counter
into a base key drawn when it is built and splits the step's keys off
that, as the reference's ``fold_in(_base_key, t)`` does.  A block gets its
key as an argument and seeds its generator inside, so a block recomputed
by ``torch.utils.checkpoint`` draws the mask its forward drew.  On one
device the reference runs its blocks as an unrolled loop (its
``lax.scan`` over stacked blocks only runs with a pipeline axis), so
every block draws its own mask, here as there.

Distributed training runs over the hybrid mesh of
:mod:`paddle_tpu_torch.distributed.mesh` (``dp x pp x sharding x mp``,
one process per rank): see :func:`build_functional_train_step`.  A model
built with ``use_parallel`` under a mesh whose mp degree is above 1 holds
its rank's tensor-parallel slices (:func:`paddle_tpu_torch.weights.
tp_index`: heads of the fused QKV, columns of fc1, rows of proj and fc2,
vocabulary rows of the tied embedding) of the weights the one-device
model of the same seed holds.  Either step's state saves to the sharded
checkpoint and loads into any layout (:func:`train_state_dict`,
:func:`save_train_state`, :func:`load_train_state`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DeviceLike, resolve_device, resolve_dtype
from ..distributed import mesh as mesh_mod
from ..distributed.checkpoint import Shard
from ..distributed.collective import (_all_gather_flat, _c_concat,
                                      _c_identity, _coalesced, _Flat,
                                      _gather, _RecvAct, _reduce_scatter_flat,
                                      _SendAct)
from ..distributed.fleet.meta_parallel.mp_layers import (
    column_parallel_linear, parallel_cross_entropy, row_parallel_linear,
    vocab_parallel_embedding)
from ..framework import random as _random
from ..kernels.attention import sdpa
from ..ops.nn_ops import dropout as _dropout
from ..ops.quant_ops import w8a8_matmul
from ..weights import _tp_length, attn_split, gpt_params, tp_index, tp_shard
from .generation import _ln


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_hidden: Optional[int] = None
    max_seq_len: int = 1024
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    # num_kv_heads < num_heads is grouped-query attention: the fused QKV
    # projection emits num_kv_heads K/V heads, and attention groups the
    # query heads over the shared K/V head.  None means num_heads (MHA).
    num_kv_heads: Optional[int] = None
    # sliding-window causal attention: position p attends
    # [p - attn_window + 1, p].  None is full causal attention.
    attn_window: Optional[int] = None
    # int8: decoding and serving run the QKV/output/MLP projections W8A8
    # (per-output-channel int8 weights quantized once at setup, dynamic
    # per-token int8 activations, int32 sums) and keep an int8 KV cache
    # unless kv_bits says otherwise.  The parameters stay float.
    int8: bool = False
    # int8_lm_head: with int8, the eager forward's tied LM head runs W8A8
    # too (per-vocab-row weight scales, per-token activation scales); the
    # train step's chunked cross-entropy head stays float, as the
    # reference's does
    int8_lm_head: bool = False
    # kv_bits: decode-time KV cache precision.  None stores the model
    # dtype, 8 int8 values with one fp32 scale per position (also implied
    # by int8), 4 two nibbles per byte with the same scales.
    kv_bits: Optional[int] = None
    # seq_major: the training forward keeps [S, B, H] activations from the
    # embedding to the logits; attention reads them in place ("sbnd").
    seq_major: bool = False
    # use_parallel: tensor-parallel layers over the installed mesh's mp
    # axis (a model built under mp > 1 holds its rank's slices)
    use_parallel: bool = False

    def __post_init__(self):
        if self.ffn_hidden is None:
            self.ffn_hidden = 4 * self.hidden_size
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError(
                f"num_heads ({self.num_heads}) must be a multiple of "
                f"num_kv_heads ({self.num_kv_heads})")
        if self.attn_window is not None and self.attn_window < 1:
            raise ValueError(f"attn_window must be >= 1, got {self.attn_window}")
        if self.kv_bits not in (None, 4, 8):
            raise ValueError(f"kv_bits must be None, 8 or 4, got {self.kv_bits}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
                     max_seq_len=256, **kw)


def gpt_small(**kw):
    return GPTConfig(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt_medium(**kw):
    return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def gpt_1p3b(**kw):
    return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                     max_seq_len=2048, **kw)


def gpt_13b(**kw):
    return GPTConfig(hidden_size=5120, num_layers=40, num_heads=40,
                     max_seq_len=2048, **kw)


class GPTBlock(nn.Module):
    """One pre-LN decoder block's parameters, named as in the reference's
    block parameter dict (``ln1_g`` … ``fc2_b``)."""

    def __init__(self, cfg: GPTConfig, *, device: torch.device,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_hidden
        qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        kw = dict(device=device, dtype=dtype)

        def normal(*shape):
            w = torch.empty(*shape, **kw)
            w.normal_(0.0, cfg.initializer_range, generator=generator)
            return nn.Parameter(w)

        def const(n, value):
            return nn.Parameter(torch.full((n,), value, **kw))

        self.ln1_g, self.ln1_b = const(h, 1.0), const(h, 0.0)
        self.qkv_w, self.qkv_b = normal(h, qkv), const(qkv, 0.0)
        self.proj_w, self.proj_b = normal(h, h), const(h, 0.0)
        self.ln2_g, self.ln2_b = const(h, 1.0), const(h, 0.0)
        self.fc1_w, self.fc1_b = normal(h, f), const(f, 0.0)
        self.fc2_w, self.fc2_b = normal(f, h), const(h, 0.0)


class GPTParams(nn.Module):
    """GPT decoder parameters with the LM head tied to ``wte``: the torch
    holder that generation, serving and the functional train step read
    (the reference's paddle ``GPTForPretraining`` is
    :class:`~paddle_tpu_torch.models.gpt_layers.GPTForPretraining`, which
    they also take, through :func:`~paddle_tpu_torch.weights.gpt_params`).

    Weights are drawn N(0, ``initializer_range``) from a generator seeded
    with ``seed`` on ``device`` (the CUDA card unless the caller passes
    one; see :mod:`paddle_tpu_torch.device`); biases start at 0 and
    LayerNorm gains at 1.  ``dtype`` defaults to fp32 on the CPU and bf16
    on the card.
    """

    def __init__(self, cfg: GPTConfig, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        h = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        wte = torch.empty(cfg.vocab_size, h, **kw)
        wpe = torch.empty(cfg.max_seq_len, h, **kw)
        self.wte = nn.Parameter(
            wte.normal_(0.0, cfg.initializer_range, generator=gen))
        self.wpe = nn.Parameter(
            wpe.normal_(0.0, cfg.initializer_range, generator=gen))
        self.blocks = nn.ModuleList(
            GPTBlock(cfg, device=device, dtype=dtype, generator=gen)
            for _ in range(cfg.num_layers))
        self.lnf_g = nn.Parameter(torch.ones(h, **kw))
        self.lnf_b = nn.Parameter(torch.zeros(h, **kw))
        # tensor parallelism: the global weights of this seed, sliced
        self.tp = None
        mesh = mesh_mod.get_mesh() if cfg.use_parallel else None
        if mesh is not None and mesh.shape["mp"] > 1:
            self.tp = TensorParallel(cfg, mesh)
            with torch.no_grad():
                for name, p in self.named_parameters():
                    p.data = tp_shard(cfg, name, p.data, self.tp.n,
                                      self.tp.rank).contiguous()

    @property
    def device(self) -> torch.device:
        return self.wte.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wte.dtype

    def leaves(self):
        """The parameters in the reference model's ``parameters()`` order
        (wte, wpe, each block's twelve, lnf_g, lnf_b), the order of the
        train step's flat leaves.  (``self.parameters()`` yields lnf_g and
        lnf_b before the blocks.)"""
        blocks = [p for blk in self.blocks for p in blk.parameters()]
        return [self.wte, self.wpe, *blocks, self.lnf_g, self.lnf_b]

    def forward(self, ids):
        """Logits of ``ids`` (B, S): (B, S, V), or (S, B, V) with
        ``cfg.seq_major``, in the model's dtype; the LM head is tied to
        ``wte`` (W8A8 under ``cfg.int8`` and ``cfg.int8_lm_head``).  In
        training mode ``cfg.dropout`` drops on the embedding and on the
        attention probabilities, with one key per site from the seed
        chain."""
        cfg = self.cfg
        ids = torch.as_tensor(ids, device=self.device).long()
        # one key per dropout site, embedding first, as the reference's
        # eager ops draw them (whether or not they drop)
        keys = [_random.next_rng_key() for _ in range(1 + cfg.num_layers)]
        drop = cfg.dropout if self.training else 0.0
        tp = self.tp
        x = _hidden(cfg, _tree(self.leaves(), cfg), ids, keys=keys,
                    dropout=drop, tp=tp)
        if tp is not None:
            x = _c_identity(x, tp.group)
        if cfg.int8 and cfg.int8_lm_head:
            logits = w8a8_matmul(x, self.wte, transpose_y=True)
        else:
            logits = x @ self.wte.t()
        return logits if tp is None else tp.concat(logits)


class GPTParamsCriterion(nn.Module):
    """:class:`GPTParams`' criterion, on torch tensors (the paddle
    ``GPTPretrainingCriterion`` is :mod:`~.gpt_layers`'): next-token
    cross-entropy over logits, mean over tokens (or over the
    ``loss_mask``'s weight).  ``seq_major`` logits arrive [S, B, V] while
    labels stay [B, S]; the labels are transposed here.  Labels equal to
    -100 are ignored, as the reference's ``softmax_with_cross_entropy``
    ignores them; the per-token loss is in the logits' dtype."""

    def __init__(self, seq_major: bool = False):
        super().__init__()
        self.seq_major = seq_major

    def forward(self, logits, labels, loss_mask=None):
        if self.seq_major:
            labels = labels.t()
            if loss_mask is not None:
                loss_mask = loss_mask.t()
        lf = logits.float()
        log_softmax = lf - torch.logsumexp(lf, dim=-1, keepdim=True)
        valid = labels != -100
        safe = torch.where(valid, labels, 0).long().clamp(0, lf.shape[-1] - 1)
        picked = log_softmax.gather(-1, safe[..., None])[..., 0]
        loss = torch.where(valid, -picked, 0.0).to(logits.dtype)
        if loss_mask is not None:
            total = (loss * loss_mask).sum()
            return total / torch.clamp_min(loss_mask.sum(), 1.0)
        return loss.mean()


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


class _SharedKV(torch.autograd.Function):
    """Identity on a rank's QKV columns (or bias) in the forward; in the
    backward the gradient of its K/V columns is summed over the ranks that
    hold copies of the same K/V head, so the copies stay equal: each
    rank scatters its K/V gradient into its heads' slots of a buffer over
    all K/V heads, one all-reduce over mp sums the copies, and each rank
    reads its slots back."""

    @staticmethod
    def forward(ctx, w, tp):
        ctx.tp = tp
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        nq, kv0, nkv = tp.split[1], tp.split[2], tp.split[3]
        hd = tp.head_dim
        lead = g.shape[:-1]
        kv = g[..., nq * hd:].reshape(*lead, 2, nkv, hd)
        buf = g.new_zeros(*lead, 2, tp.kv_heads, hd)
        buf[..., kv0:kv0 + nkv, :] = kv
        dist.all_reduce(buf, group=tp.group)
        out = g.clone()
        out[..., nq * hd:] = buf[..., kv0:kv0 + nkv, :].reshape(
            *lead, 2 * nkv * hd)
        return out, None


class TensorParallel:
    """The mesh's mp axis as the GPT's layers use it: rank ``rank`` of
    ``n`` in ``group``, holding ``heads`` = (query heads, KV heads) of its
    own.  The layers are the Megatron ones of :mod:`paddle_tpu_torch.
    distributed.fleet.meta_parallel.mp_layers`: QKV and fc1
    column-parallel, proj and fc2 row-parallel, the tied embedding and
    head vocabulary-parallel (the cross-entropy never gathers the
    logits).  The vocabulary and the MLP's hidden units must split
    evenly.  Attention splits by head as :func:`~paddle_tpu_torch.
    weights.attn_split` decides: with fewer K/V heads than ranks each
    rank holds the K/V head its query heads read, and the gradient of
    such a copy is summed over the ranks sharing it (:class:`_SharedKV`);
    where mp does not divide the query heads attention is whole on every
    rank (``split`` None), with QKV and proj replicated.  Their gradients
    are then equal on every rank without a collective: the residual
    stream's gradient reaching them is whole on every rank (the split
    MLP's and the head's partial input gradients are all-reduced where
    they enter), so each rank computes the same update."""

    def __init__(self, cfg: GPTConfig, mesh):
        self.group = mesh.group("mp")
        self.n, self.rank = mesh.shape["mp"], mesh.coord["mp"]
        for what, size in (("vocab_size", cfg.vocab_size),
                           ("ffn_hidden", cfg.ffn_hidden)):
            if size % self.n:
                raise ValueError(f"tensor parallelism over mp={self.n} needs "
                                 f"{what} ({size}) to be a multiple of it")
        self.split = attn_split(cfg, self.n, self.rank)
        self.head_dim, self.kv_heads = cfg.head_dim, cfg.num_kv_heads
        self.heads = ((cfg.num_heads, cfg.num_kv_heads) if self.split is None
                      else (self.split[1], self.split[3]))
        self.shared_kv = self.split is not None and cfg.num_kv_heads < self.n
        self.vocab = cfg.vocab_size

    def embed(self, wte, ids):
        return vocab_parallel_embedding(ids, wte, self.group)

    def col(self, x, w, b, int8):
        return column_parallel_linear(x, w, b, self.group, int8=int8)

    def row(self, x, w, b, int8):
        return row_parallel_linear(x, w, b, self.group, int8=int8)

    def qkv(self, x, w, b, int8):
        """The fused QKV projection: column-parallel over this rank's
        heads (K/V copies summed in the backward), or whole."""
        if self.split is None:
            return _linear(x, w, b, int8)
        if self.shared_kv:
            w, b = _SharedKV.apply(w, self), _SharedKV.apply(b, self)
        return self.col(x, w, b, int8)

    def proj(self, x, w, b, int8):
        """The attention's output projection: row-parallel, or whole."""
        if self.split is None:
            return _linear(x, w, b, int8)
        return self.row(x, w, b, int8)

    def concat(self, logits):
        """Vocabulary-split logits gathered whole (differentiable)."""
        return _c_concat(logits, self.group)

    def gather(self, logits):
        """Vocabulary-split logits gathered whole (no gradient)."""
        return _gather(logits, self.group, -1)


# ---------------------------------------------------------------------------
# the training forward: functions of a parameter tree
# ---------------------------------------------------------------------------

_BLOCK_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
               "ln2_g", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def _tree(leaves, cfg):
    """Flat parameters in :meth:`GPTParams.leaves` order as
    ``{"wte", "wpe", "lnf_g", "lnf_b", "blocks": [list of 12, ...]}``."""
    n = len(_BLOCK_KEYS)
    blocks = [leaves[2 + i * n:2 + (i + 1) * n]
              for i in range(cfg.num_layers)]
    return {"wte": leaves[0], "wpe": leaves[1], "lnf_g": leaves[-2],
            "lnf_b": leaves[-1], "blocks": blocks}


def _ln32(x, g, b, eps):
    """LayerNorm computed in fp32 and cast back to x's dtype, as the
    reference's ``layer_norm`` kernel does."""
    return _ln(x.float(), g.float(), b.float(), eps).to(x.dtype)


def _linear(x, w, b, int8):
    """``x @ W + b``: W8A8 with straight-through gradients under int8."""
    return (w8a8_matmul(x, w) if int8 else x @ w) + b


def _attention(cfg, p, x, key=None, dropout=0.0, tp=None):
    """The block's attention half over ``x`` [B, S, H] (or [S, B, H] with
    ``seq_major``): Q, K and V are head views of the fused projection
    (a reshape, no transposes), read in place by the flash kernels (bsnd
    or sbnd).  Batch-major GQA uses bsnd here where the reference
    transposes to bnsd and, having no bnsd GQA kernel, runs its jnp
    attention.  ``dropout`` > 0 drops attention probabilities with the
    mask of ``key`` (:func:`~paddle_tpu_torch.kernels.attention.
    sdpa_dropout`).  Under ``tp`` the QKV projection is column-parallel
    (this rank's heads) and proj row-parallel, or both whole where
    attention does not split (:class:`TensorParallel`)."""
    hd = cfg.head_dim
    nh, nkv = (cfg.num_heads, cfg.num_kv_heads) if tp is None else tp.heads
    col = _linear if tp is None else tp.qkv
    row = _linear if tp is None else tp.proj
    d0, d1, _ = x.shape
    qkv = col(x, p["qkv_w"], p["qkv_b"], cfg.int8)
    q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    out = sdpa(q.reshape(d0, d1, nh, hd), k.reshape(d0, d1, nkv, hd),
               v.reshape(d0, d1, nkv, hd), is_causal=True,
               layout="sbnd" if cfg.seq_major else "bsnd",
               window=cfg.attn_window, dropout_p=dropout, key=key)
    return row(out.reshape(d0, d1, nh * hd), p["proj_w"], p["proj_b"],
               cfg.int8)


def _block(cfg, x, key, dropout, tp, *leaves):
    """One pre-LN block over ``x``; ``leaves`` in ``_BLOCK_KEYS`` order,
    ``key`` the mask key of its attention dropout, ``tp`` the tensor
    parallelism (None on one rank)."""
    p = dict(zip(_BLOCK_KEYS, leaves))
    eps = cfg.layer_norm_eps
    x = x + _attention(cfg, p, _ln32(x, p["ln1_g"], p["ln1_b"], eps),
                       key=key, dropout=dropout, tp=tp)
    h = _ln32(x, p["ln2_g"], p["ln2_b"], eps)
    col = _linear if tp is None else tp.col
    row = _linear if tp is None else tp.row
    h = F.gelu(col(h, p["fc1_w"], p["fc1_b"], cfg.int8), approximate="none")
    return x + row(h, p["fc2_w"], p["fc2_b"], cfg.int8)


def _embed(cfg, wte, wpe, ids, tp=None):
    """Word plus position embeddings; with ``seq_major`` only the ids are
    transposed, and the activations are [S, B, H] from here on.  Under
    ``tp`` the word embedding is vocabulary-parallel."""
    pe = wpe[:ids.shape[1]]
    if tp is None:
        if cfg.seq_major:
            return wte[ids.t()] + pe[:, None]
        return wte[ids] + pe
    if cfg.seq_major:
        return tp.embed(wte, ids.t()) + pe[:, None]
    return tp.embed(wte, ids) + pe


_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective checkpointing: keep the outputs of matrix products with
    no batch dims (the projections), recompute the rest; the counterpart
    of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat):
    """``fn`` checkpointed per ``remat``: True recomputes the whole
    function in the backward, "dots" only what is not a matrix product,
    False nothing."""
    if remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_matmuls)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    if remat:
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return fn


def _run_blocks(cfg, x, blocks, keys, dropout, remat, cast, tp=None,
                uses=None):
    """``x`` through ``blocks`` (lists of 12 leaves), block ``i`` with
    dropout key ``keys[i]``.  ``uses`` (ZeRO stage 3: one function per
    leaf of a block, gathering its shard whole) and ``cast`` apply at
    each leaf's use, inside the checkpointed region, so a recomputed
    block gathers and casts again."""
    uses = uses or [lambda a: a] * len(_BLOCK_KEYS)
    block = _remat(lambda h, key, *ls: _block(
        cfg, h, key, dropout, tp, *[cast(u(a)) for u, a in zip(uses, ls)]),
        remat)
    for key, leaves in zip(keys, blocks):
        x = block(x, key, *leaves)
    return x


def _hidden(cfg, tree, ids, remat=False, cast=None, keys=None,
            dropout=0.0, tp=None):
    """Final-LayerNorm hidden states of ``ids`` (B, S): [B, S, H], or
    [S, B, H] with ``seq_major``.  ``cast`` (default identity) applies to
    each parameter at its use, inside the checkpointed region.
    ``dropout`` > 0 drops on the embedding with ``keys[0]`` and in block
    ``i``'s attention with ``keys[1 + i]``; the key goes into the
    checkpointed block, where its generator is seeded, so a recomputed
    block draws its forward's mask."""
    cast = cast or (lambda a: a)
    keys = keys or [None] * (1 + cfg.num_layers)
    x = _embed(cfg, cast(tree["wte"]), cast(tree["wpe"]), ids, tp)
    x = _dropout(x, dropout, keys[0])
    x = _run_blocks(cfg, x, tree["blocks"], keys[1:], dropout, remat, cast,
                    tp)
    return _ln32(x, cast(tree["lnf_g"]), cast(tree["lnf_b"]),
                 cfg.layer_norm_eps)


def _xent_chunk(xc, w32, lc):
    """Summed cross-entropy of one chunk of rows: fp32 logits (the products
    of the hidden states' values with the fp32 head), logsumexp minus the
    label's logit, labels clipped to the vocabulary."""
    logits = xc.float() @ w32.t()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, lc[:, None])[:, 0]
    return (lse - picked).sum()


def _parallel_xent_chunk(xc, w32, lc, group):
    """:func:`_xent_chunk` over a vocabulary-parallel head: this rank's
    logits, the cross-entropy by all-reduces (never gathered)."""
    return parallel_cross_entropy(xc.float() @ w32.t(), lc, group).sum()


def _chunked_softmax_xent(x2, w, labels1, chunk_rows=1024, tp=None):
    """Mean cross-entropy of ``x2`` (N, H) against the tied head ``w``
    (V, H) without a (N, V) tensor: chunks of ``chunk_rows`` rows (halved
    until they divide N), each under ``torch.utils.checkpoint`` so its
    (chunk, V) fp32 logits are recomputed in the backward, not kept.
    Under ``tp`` ``w`` is this rank's vocabulary rows."""
    n = x2.shape[0]
    c = min(chunk_rows, n)
    while n % c:
        c //= 2
    w32 = w.float()
    vocab = w.shape[0] if tp is None else tp.vocab
    labels1 = labels1.clamp(0, vocab - 1)
    if tp is not None:
        x2 = _c_identity(x2, tp.group)
    tot = torch.zeros((), dtype=torch.float32, device=x2.device)
    for i in range(0, n, c):
        if tp is None:
            part = checkpoint(_xent_chunk, x2[i:i + c], w32,
                              labels1[i:i + c], use_reentrant=False)
        else:
            part = checkpoint(_parallel_xent_chunk, x2[i:i + c], w32,
                              labels1[i:i + c], tp.group,
                              use_reentrant=False)
        tot = tot + part
    return tot / n


def _loss(cfg, x, w, labels, ce_chunk_rows, tp=None):
    """Mean cross-entropy of final hidden states ``x`` against ``labels``
    (B, S) through the tied head ``w``: chunked (``ce_chunk_rows`` > 0) or
    over dense logits."""
    if cfg.seq_major:
        labels = labels.t()          # the logits' [S, B] order
    d0, d1, h = x.shape
    if ce_chunk_rows:
        return _chunked_softmax_xent(x.reshape(d0 * d1, h), w,
                                     labels.reshape(d0 * d1),
                                     chunk_rows=ce_chunk_rows, tp=tp)
    if tp is not None:
        x = _c_identity(x, tp.group)
        logits = (x @ w.t()).float()
        lab = labels.clamp(0, tp.vocab - 1)
        return parallel_cross_entropy(logits, lab, tp.group).mean()
    logits = (x @ w.t()).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp(0, w.shape[0] - 1)[..., None])
    return (lse - picked[..., 0]).mean()


def _dtype(name):
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def _adamw(w32, grads, m, v, t, lr, beta1, beta2, eps, wd):
    """The reference's AdamW on ``_foreach`` lists, in its order: the
    moments ``m`` and ``v`` updated in place, the bias corrections in
    fp32 as its traced counter, ``upd = m_hat / (sqrt(v_hat) + eps) + wd
    * w32``; returns the new fp32 weights ``w32 - lr * upd``."""
    b1t = float(np.float32(1.0) - np.float32(beta1) ** np.float32(t))
    b2t = float(np.float32(1.0) - np.float32(beta2) ** np.float32(t))
    torch._foreach_mul_(m, beta1)
    torch._foreach_add_(m, torch._foreach_mul(grads, 1 - beta1))
    torch._foreach_mul_(v, beta2)
    torch._foreach_add_(v, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - beta2))
    den = torch._foreach_sqrt(torch._foreach_div(v, b2t))
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(torch._foreach_div(m, b1t), den)
    torch._foreach_add_(upd, torch._foreach_mul(w32, wd))
    return torch._foreach_sub(w32, torch._foreach_mul(upd, lr))


def _sharding_stage(sharding_stage, shd):
    """The ZeRO stage the reference takes: the caller's, else the fleet
    strategy's ``sharding_configs["stage"]``, else 2 when the sharding
    axis is above 1; 0 whenever it is not."""
    if sharding_stage is None:
        from ..distributed import fleet

        strat = fleet._fleet_state.get("strategy")
        if strat is not None and shd > 1:
            sharding_stage = int(strat.sharding_configs.get("stage", 2))
        else:
            sharding_stage = 2 if shd > 1 else 0
    if shd <= 1:
        return 0
    if sharding_stage not in (0, 1, 2, 3):
        raise ValueError(f"sharding_stage must be 0-3, got {sharding_stage}")
    return sharding_stage


def build_functional_train_step(model, lr: float = 1e-4,
                                beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1,
                                remat=True, ce_chunk_rows: int = 1024,
                                compute_dtype=None, *, dp_axis=None,
                                sharding_stage=None, mesh=None):
    """Forward, backward and AdamW as one step on the model's device.

    Returns ``(step, params, opt_state)`` with ``step(params, opt_state,
    ids, labels) -> (params, opt_state, loss)``.  ``params`` are the
    model's own parameters (detached, in :meth:`GPTParams.leaves`
    order, the reference's) and are updated IN PLACE, as is ``opt_state``
    ({"m", "v", "t"} and, when any parameter is not fp32, fp32 "master"
    copies); the reference donates both to its jitted step.
    ``ids``/``labels`` are (B, S) integer arrays or tensors.

    ``remat``: True checkpoints each block, "dots" checkpoints it keeping
    the matrix products' outputs, False keeps every activation; anything
    else raises ValueError.  ``ce_chunk_rows`` > 0 takes the chunked
    cross-entropy, 0 the dense logits.  ``compute_dtype`` (e.g.
    "bfloat16"): parameters stay in their storage dtype (fp32) and are
    cast at use.  AdamW runs the reference's formula in its order:
    bias-corrected moments, ``upd = m_hat / (sqrt(v_hat) + eps) + wd *
    w32``, ``w32 - lr * upd``, in fp32 on ``_foreach`` tensor lists.

    With ``cfg.dropout`` > 0 and the model in training mode, each step
    drops on the embedding and the attention probabilities with fresh
    masks: the step's key is the base key (drawn from the live seed chain
    when the step is built) folded with ``opt_state["t"]``, and the
    sites' keys split off it in the reference's order.

    **Distributed.**  With a hybrid mesh (``mesh``, else the one
    installed by ``fleet.init`` / ``build_hybrid_mesh``) the step is one
    rank's part of the step over ``dp x pp x sharding x mp``, and
    computes the function of the one-device step on the global batch:
    see :func:`_distributed_step`.  ``dp_axis`` (None means "dp", the
    reference's default; no other axis is taken) and ``sharding_stage``
    (None: the reference's choice, :func:`_sharding_stage`) apply there.
    Asking for a mesh, ``dp_axis``, a ZeRO stage or a ``use_parallel``
    model without an initialised process group raises RuntimeError: the
    step never runs them quietly on one device.

    ``model``: a :class:`GPTParams`, or a paddle ``GPTForPretraining``,
    whose weights the step copies into a holder
    (:func:`~paddle_tpu_torch.weights.gpt_params`) and leaves as they
    are, as the reference's step reads a paddle model's parameters."""
    model = gpt_params(model)
    cfg = model.cfg
    if remat != "dots" and not isinstance(remat, bool):
        raise ValueError(f"remat must be True, False, or 'dots'; got "
                         f"{remat!r}")
    asked = [name for name, on in (("mesh", mesh is not None),
                                   ("dp_axis", dp_axis is not None),
                                   ("sharding_stage", bool(sharding_stage)),
                                   ("use_parallel", cfg.use_parallel)) if on]
    if asked and not dist.is_initialized():
        raise RuntimeError(
            f"{', '.join(asked)}: the distributed train step needs an "
            "initialised process group (init_parallel_env / fleet.init); "
            "it does not run distributed options on one device")
    if dp_axis not in (None, "dp"):
        raise ValueError(f"dp_axis must be 'dp' (the batch splits over the "
                         f"mesh's dp and sharding axes), got {dp_axis!r}")
    if mesh is None:
        mesh = mesh_mod.get_mesh()
        if mesh is None and asked:
            mesh = mesh_mod.ensure_default_mesh()
    cd = _dtype(compute_dtype)

    def cast(a):
        return a.to(cd) if cd is not None and a.dtype != cd else a

    opts = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, wd=wd)
    if mesh is not None:
        stage = _sharding_stage(sharding_stage, mesh.shape["sharding"])
        return _distributed_step(model, mesh, stage, remat, ce_chunk_rows,
                                 cast, opts)

    params = [p.detach() for p in model.leaves()]
    opt_state = {"m": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params],
                 "v": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params],
                 "t": 0}
    if any(p.dtype != torch.float32 for p in params):
        opt_state["master"] = [p.float().clone() for p in params]
    device = model.device
    # drawn from the LIVE seed chain, so seed() decides the step's masks
    base_key = _random.next_rng_key()

    def step(params, opt_state, ids, labels):
        ids = torch.as_tensor(ids, device=device).long()
        labels = torch.as_tensor(labels, device=device).long()
        leaves = [p.detach().requires_grad_() for p in params]
        # fresh masks every step: the step counter folded into the base
        # key, the sites' keys split off it (embedding, then each block)
        with _random.trace_rng_scope(
                _random.fold_in(base_key, opt_state["t"])):
            keys = [_random.next_rng_key()
                    for _ in range(1 + cfg.num_layers)]
        drop = cfg.dropout if model.training else 0.0
        x = _hidden(cfg, _tree(leaves, cfg), ids, remat=remat, cast=cast,
                    keys=keys, dropout=drop)
        loss = _loss(cfg, x, cast(leaves[0]), labels, ce_chunk_rows)
        grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
        t = opt_state["t"] + 1
        w32 = opt_state.get("master", params)
        new = _adamw(w32, grads, opt_state["m"], opt_state["v"], t, **opts)
        if "master" in opt_state:
            opt_state["master"] = new
        torch._foreach_copy_(params, new)
        opt_state["t"] = t
        return params, opt_state, loss.detach()

    step.names = _leaf_names(cfg)
    step.shard_of = lambda kind, i, t: t
    return step, params, opt_state


def _leaf_names(cfg):
    """Port names of :meth:`GPTParams.leaves`, in its order."""
    return ["wte", "wpe", *[f"blocks.{b}.{k}" for b in range(cfg.num_layers)
                            for k in _BLOCK_KEYS], "lnf_g", "lnf_b"]


def train_state_dict(step, params, opt_state):
    """A train step's state as the sharded checkpoint's state dict
    (:mod:`paddle_tpu_torch.distributed.checkpoint`): ``param/<name>``,
    ``m/<name>``, ``v/<name>`` and ``master/<name>`` by port name, each
    this rank's tensor or, where the step partitions it (tensor-parallel
    slices, ZeRO chunks), its :class:`~paddle_tpu_torch.distributed.
    checkpoint.Shard`; ``t`` the step count.  Any layout loads into any
    other: one device's state from a distributed run's checkpoint, and
    the reverse."""
    sd = {}
    for kind, tensors in (("param", params), ("m", opt_state["m"]),
                          ("v", opt_state["v"]),
                          ("master", opt_state.get("master"))):
        if tensors is None:
            continue
        for i, name in enumerate(step.names):
            sd[f"{kind}/{name}"] = step.shard_of(kind, i, tensors[i])
    sd["t"] = torch.tensor(opt_state["t"], dtype=torch.int64)
    return sd


def save_train_state(step, params, opt_state, path) -> None:
    """Write the step's state to ``path`` (every rank calls it)."""
    from ..distributed.checkpoint import save_state_dict

    save_state_dict(train_state_dict(step, params, opt_state), path)


def load_train_state(step, params, opt_state, path) -> None:
    """Fill the step's ``params`` and ``opt_state`` in place from the
    checkpoint at ``path``, whatever layout wrote it."""
    from ..distributed.checkpoint import load_state_dict

    sd = train_state_dict(step, params, opt_state)
    load_state_dict(sd, path)
    opt_state["t"] = int(sd["t"])


# ---------------------------------------------------------------------------
# the distributed step: dp x pp x sharding x mp
# ---------------------------------------------------------------------------


class _GatherShard(torch.autograd.Function):
    """ZeRO stage 3: a leaf's chunk gathered whole at its use; the
    gradient of the whole leaf is summed over the sharding ranks and
    each keeps its chunk."""

    @staticmethod
    def forward(ctx, shard, flat, group):
        ctx.flat, ctx.group = flat, group
        out = shard.new_empty(flat.n * flat.chunk)
        dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
        return flat.whole(out.view(flat.n, flat.chunk)).clone()

    @staticmethod
    def backward(ctx, g):
        f = ctx.flat
        out = g.new_empty(f.chunk)
        dist.reduce_scatter_tensor(out, f.padded(g.contiguous()),
                                   group=ctx.group)
        return out, None, None


def _step_keys(cfg, base_key, t, homogeneous):
    """The step's dropout keys: the embedding's, then one per block; under
    a pipeline axis every block shares one key, as the reference's
    scanned block body draws one for all layers."""
    with _random.trace_rng_scope(_random.fold_in(base_key, t)):
        if homogeneous:
            emb, blk = _random.next_rng_key(), _random.next_rng_key()
            return [emb] + [blk] * cfg.num_layers
        return [_random.next_rng_key() for _ in range(1 + cfg.num_layers)]


def _distributed_step(model, mesh, stage, remat, ce_chunk_rows, cast, opts):
    """One rank's train step over the hybrid mesh (ZeRO stage ``stage``).

    * mp: a ``use_parallel`` model holds this rank's tensor-parallel
      slices (:class:`TensorParallel`); mp = 1 runs the one-device layers.
    * dp x sharding: ``ids`` / ``labels`` are this rank's rows of the
      global batch (:func:`~paddle_tpu_torch.distributed.mesh.
      shard_batch`); gradients are averaged over that group and the
      returned loss is the global batch's mean on every rank.
    * ZeRO (over the sharding axis, each leaf split by :class:`_Flat`):
      stage 1 holds ``m``, ``v`` and the fp32 masters 1/N, updates its
      chunk of every leaf and all-gathers the new weights; stage 2 also
      reduce-scatters the gradients instead of all-reducing them; stage 3
      holds the parameters 1/N too and gathers each whole at its use
      (:class:`_GatherShard`, again inside a checkpointed block's
      recompute).
    * pp: this rank holds its stage's blocks (``num_layers / pp`` of
      them) and the other leaves (embeddings, final LayerNorm), which stay
      whole on every stage and whose gradients are summed over pp; the
      activation goes forward and its gradient comes back by send / recv
      inside autograd Functions, and the last stage's loss is broadcast.
      One dropout key serves every block of a step, as in the reference's
      scan over stacked blocks.

    ``params`` are this rank's leaves: wte, wpe, its stage's blocks,
    lnf_g, lnf_b (the model's own tensors, updated in place; their ZeRO
    chunks under stage 3).  ``step.names`` names them (port names);
    ``step.unshard(params)`` (every rank calls it) gives them whole."""
    cfg = model.cfg
    tp = model.tp
    mp = mesh.shape["mp"]
    if mp > 1 and (tp is None or tp.n != mp):
        raise ValueError(f"the mesh has mp={mp}: the model must be built "
                         "with use_parallel=True under that mesh")
    if mp == 1 and tp is not None:
        raise ValueError("a tensor-parallel model needs the mesh it was "
                         "built under")
    pp, pstage = mesh.shape["pp"], mesh.coord["pp"]
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers {cfg.num_layers} does not split over "
                         f"pp={pp} stages")
    per = cfg.num_layers // pp
    first = pstage * per
    homogeneous = pp > 1 and cfg.num_layers > 1
    tree = _tree(model.leaves(), cfg)
    held = [tree["wte"], tree["wpe"],
            *[p for blk in tree["blocks"][first:first + per] for p in blk],
            tree["lnf_g"], tree["lnf_b"]]
    names = ["wte", "wpe", *[f"blocks.{first + i}.{k}" for i in range(per)
                             for k in _BLOCK_KEYS], "lnf_g", "lnf_b"]
    held = [p.detach() for p in held]
    nonblock = [0, 1, len(held) - 2, len(held) - 1]
    device = model.device
    data = mesh.group(("dp", "sharding"))
    n_data = mesh.degree(("dp", "sharding"))
    sgroup, sd = mesh.group("sharding"), mesh.shape["sharding"]
    flats = [_Flat(p.shape, sd, mesh.coord["sharding"]) for p in held]
    nkey = len(_BLOCK_KEYS)

    if stage >= 3:
        params = [f.shard(p) for f, p in zip(flats, held)]
    else:
        params = held

    def zeros():
        """fp32 moments: a chunk of each leaf from stage 1, else whole."""
        if stage >= 1:
            return [torch.zeros(f.chunk, device=device) for f in flats]
        return [torch.zeros_like(p, dtype=torch.float32) for p in params]

    opt_state = {"m": zeros(), "v": zeros(), "t": 0}
    if any(p.dtype != torch.float32 for p in params):
        opt_state["master"] = [f.shard(p.float()) if stage in (1, 2)
                               else p.float().clone()
                               for f, p in zip(flats, params)]
    base_key = _random.next_rng_key()
    pgroup = mesh.group("pp")
    prev = mesh.rank_of(**{**mesh.coord, "pp": pstage - 1})
    nxt = mesh.rank_of(**{**mesh.coord, "pp": pstage + 1})
    last = mesh.rank_of(**{**mesh.coord, "pp": pp - 1})
    bdim = 1 if cfg.seq_major else 0
    batch_part = (mesh.index(("dp", "sharding")), n_data)

    def sharded(key, heads):
        """The site's key as this rank's part of the global mask."""
        parts = {}
        if n_data > 1:
            parts[bdim if not heads else 0] = batch_part
        if heads and mp > 1 and tp.split is not None:
            parts[1] = (tp.rank, mp)
        return _random.ShardedKey(key, parts) if parts else key

    def use(i):
        """Leaf ``i`` whole at its use (ZeRO stage 3 gathers it)."""
        if stage < 3:
            return lambda a: a
        return lambda a, f=flats[i]: _GatherShard.apply(a, f, sgroup)

    block_uses = [use(2 + j) for j in range(nkey)]

    def forward(leaves, ids, labels, keys, drop):
        """This stage's part: (the scalar to differentiate, the loss or
        None, the anchor of a received activation or None)."""
        wte, wpe, lnf_g, lnf_b = (use(i)(leaves[i]) for i in nonblock)
        blocks = [leaves[2 + b * nkey:2 + (b + 1) * nkey]
                  for b in range(per)]
        anchor = None
        if pstage == 0:
            x = _embed(cfg, cast(wte), cast(wpe), ids, tp)
            x = _dropout(x, drop, sharded(keys[0], False))
        else:
            b, s = ids.shape
            shape = ((s, b) if cfg.seq_major else (b, s)) + (
                cfg.hidden_size,)
            anchor = torch.zeros((), device=device, requires_grad=True)
            x = _RecvAct.apply(anchor, shape, cast(wte).dtype, prev, pgroup)
        bkeys = [sharded(k, True) for k in keys[1 + first:1 + first + per]]
        x = _run_blocks(cfg, x, blocks, bkeys, drop, remat, cast, tp,
                        block_uses)
        if pstage < pp - 1:
            return _SendAct.apply(x, nxt, pgroup), None, anchor
        x = _ln32(x, cast(lnf_g), cast(lnf_b), cfg.layer_norm_eps)
        loss = _loss(cfg, x, cast(wte), labels, ce_chunk_rows, tp)
        return loss, loss, anchor

    def step(params, opt_state, ids, labels):
        ids = torch.as_tensor(ids, device=device).long()
        labels = torch.as_tensor(labels, device=device).long()
        leaves = [p.detach().requires_grad_() for p in params]
        keys = _step_keys(cfg, base_key, opt_state["t"], homogeneous)
        drop = cfg.dropout if model.training else 0.0
        out, loss, anchor = forward(leaves, ids, labels, keys, drop)
        inputs = leaves + ([anchor] if anchor is not None else [])
        grads = torch.autograd.grad(out, inputs, allow_unused=True)
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None
                 else g.float() for g, p in zip(grads, leaves)]
        if pp > 1:
            _coalesced([grads[i] for i in nonblock],
                       lambda b: dist.all_reduce(b, group=pgroup))
        if stage == 2:
            grads = _reduce_scatter_flat(grads, flats, sgroup)
        reduce_over = data if stage < 2 else mesh.group("dp")
        _coalesced(grads, lambda b: dist.all_reduce(b, group=reduce_over))
        torch._foreach_div_(grads, float(n_data))
        if stage == 1:
            grads = [f.shard(g) for f, g in zip(flats, grads)]

        t = opt_state["t"] + 1
        if stage in (1, 2):
            w32 = opt_state.get("master") or [f.shard(p)
                                              for f, p in zip(flats, params)]
        else:
            w32 = opt_state.get("master", params)
        new = _adamw(w32, grads, opt_state["m"], opt_state["v"], t, **opts)
        if "master" in opt_state:
            opt_state["master"] = new
        if stage in (1, 2):
            new = _all_gather_flat(new, flats, sgroup, params[0].dtype)
        torch._foreach_copy_(params, new)
        opt_state["t"] = t

        # the global batch's mean loss, on every rank
        if loss is None:
            loss = torch.zeros((), device=device)
        else:
            loss = loss.detach().float().clone()
            dist.all_reduce(loss, group=data)
            loss = loss / n_data
        if pp > 1:
            dist.broadcast(loss, src=last, group=pgroup)
        return params, opt_state, loss

    def unshard(params):
        """This rank's leaves whole (every rank of the group calls it)."""
        if stage < 3:
            return list(params)
        return _all_gather_flat(params, flats, sgroup, params[0].dtype)

    # the checkpoint's view of each leaf: its tensor-parallel index (the
    # global leaf's rows or columns this rank holds) and, where ZeRO
    # partitions it, the flat chunk's offset
    where = [tp_index(cfg, n, mp, tp.rank) if tp is not None else None
             for n in names]
    shapes = []
    for p, n, w in zip(held, names, where):
        shape = list(p.shape)
        if w is not None:
            shape[w[0]] = _tp_length(cfg, n.rsplit(".", 1)[-1])
        shapes.append(shape)

    def shard_of(kind, i, t):
        flat = stage >= (3 if kind == "param" else 1)
        if not flat and where[i] is None:
            return t
        dim, idx = where[i] if where[i] is not None else (None, None)
        return Shard(t, shapes[i], dim, idx,
                     flat=flats[i].r * flats[i].chunk if flat else None)

    step.names = names
    step.unshard = unshard
    step.stage = stage
    step.shard_of = shard_of
    return step, params, opt_state


# The reference's paddle classes under its names (``paddle_tpu/models/
# gpt.py``): the model and the criterion are paddle ``nn.Layer``s, which a
# paddle optimizer trains; GPTParams and GPTParamsCriterion are the torch
# holder the functional paths read.  Imported last: gpt_layers reads
# GPTConfig from this module.
from .gpt_layers import (  # noqa: E402,F401
    GPTForPretraining, GPTForPretrainingPipe, GPTModel,
    GPTPretrainingCriterion)

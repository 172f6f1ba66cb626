"""GPT: configuration, parameters, the training forward and the functional
train step (counterpart of ``paddle_tpu/models/gpt.py``).

:class:`GPTForPretraining` holds the decoder's parameters: word and
position embeddings, the pre-LN blocks, the final LayerNorm, and the LM
head tied to the word embedding.  Projection weights keep the reference's
``[in, out]`` layout (``x @ W``), so parameter names and shapes match the
JAX parameter tree that ``models/generation._decoder_setup`` builds there,
one to one, and the JAX model's ``named_parameters()`` in the same order
(see :mod:`paddle_tpu_torch.weights`).

Inference reads the parameters through
:func:`paddle_tpu_torch.models.generation._decoder_setup`.  The
full-sequence forward (:meth:`GPTForPretraining.forward`) and
:func:`build_functional_train_step` (forward, backward, chunked
cross-entropy and AdamW with fp32 masters) run attention through
:func:`~paddle_tpu_torch.kernels.sdpa`: the flash kernels on the card, the
dense plain attention on the CPU.  With ``int8`` the four projections of
each block go through :func:`~paddle_tpu_torch.ops.w8a8_matmul` (the
``w8a8_gemm`` kernel, straight-through gradients).

The reference's distributed options (a mesh, pipeline stacking, ZeRO
``sharding_stage``, ``dp_axis``, ``use_parallel``) and dropout in training
are not ported: asking for them raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DeviceLike, resolve_device, resolve_dtype
from ..kernels.attention import sdpa
from ..ops.quant_ops import w8a8_matmul
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
    # kv_bits: decode-time KV cache precision.  None stores the model
    # dtype, 8 int8 values with one fp32 scale per position (also implied
    # by int8), 4 two nibbles per byte with the same scales.
    kv_bits: Optional[int] = None
    # seq_major: the training forward keeps [S, B, H] activations from the
    # embedding to the logits; attention reads them in place ("sbnd").
    seq_major: bool = False
    # tensor-parallel layers over a mesh: not ported (the train step
    # raises NotImplementedError)
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


class GPTForPretraining(nn.Module):
    """GPT decoder parameters with the LM head tied to ``wte``.

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
        ``wte``.  Dropout is not ported: a model with ``cfg.dropout > 0``
        raises in training mode."""
        if self.training and self.cfg.dropout > 0:
            raise NotImplementedError("dropout in the training forward is "
                                      "not ported")
        ids = torch.as_tensor(ids, device=self.device).long()
        x = _hidden(self.cfg, _tree(self.leaves(), self.cfg), ids)
        return x @ self.wte.t()


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross-entropy over logits, mean over tokens (or over the
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
# the training forward: functions of a parameter tree
# ---------------------------------------------------------------------------

_BLOCK_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
               "ln2_g", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def _tree(leaves, cfg):
    """Flat parameters in :meth:`GPTForPretraining.leaves` order as
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


def _attention(cfg, p, x):
    """The block's attention half over ``x`` [B, S, H] (or [S, B, H] with
    ``seq_major``): Q, K and V are head views of the fused projection
    (a reshape, no transposes), read in place by the flash kernels (bsnd
    or sbnd).  Batch-major GQA uses bsnd here where the reference
    transposes to bnsd and, having no bnsd GQA kernel, runs its jnp
    attention."""
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    d0, d1, _ = x.shape
    qkv = _linear(x, p["qkv_w"], p["qkv_b"], cfg.int8)
    q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    out = sdpa(q.reshape(d0, d1, nh, hd), k.reshape(d0, d1, nkv, hd),
               v.reshape(d0, d1, nkv, hd), is_causal=True,
               layout="sbnd" if cfg.seq_major else "bsnd",
               window=cfg.attn_window)
    return _linear(out.reshape(d0, d1, nh * hd), p["proj_w"], p["proj_b"],
                   cfg.int8)


def _block(cfg, x, *leaves):
    """One pre-LN block over ``x``; ``leaves`` in ``_BLOCK_KEYS`` order."""
    p = dict(zip(_BLOCK_KEYS, leaves))
    eps = cfg.layer_norm_eps
    x = x + _attention(cfg, p, _ln32(x, p["ln1_g"], p["ln1_b"], eps))
    h = _ln32(x, p["ln2_g"], p["ln2_b"], eps)
    h = F.gelu(_linear(h, p["fc1_w"], p["fc1_b"], cfg.int8),
               approximate="none")
    return x + _linear(h, p["fc2_w"], p["fc2_b"], cfg.int8)


def _embed(cfg, wte, wpe, ids):
    """Word plus position embeddings; with ``seq_major`` only the ids are
    transposed, and the activations are [S, B, H] from here on."""
    pe = wpe[:ids.shape[1]]
    if cfg.seq_major:
        return wte[ids.t()] + pe[:, None]
    return wte[ids] + pe


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


def _hidden(cfg, tree, ids, remat=False, cast=None):
    """Final-LayerNorm hidden states of ``ids`` (B, S): [B, S, H], or
    [S, B, H] with ``seq_major``.  ``cast`` (default identity) applies to
    each parameter at its use, inside the checkpointed region."""
    cast = cast or (lambda a: a)
    x = _embed(cfg, cast(tree["wte"]), cast(tree["wpe"]), ids)
    block = _remat(lambda h, *ls: _block(cfg, h, *map(cast, ls)), remat)
    for leaves in tree["blocks"]:
        x = block(x, *leaves)
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


def _chunked_softmax_xent(x2, w, labels1, chunk_rows=1024):
    """Mean cross-entropy of ``x2`` (N, H) against the tied head ``w``
    (V, H) without a (N, V) tensor: chunks of ``chunk_rows`` rows (halved
    until they divide N), each under ``torch.utils.checkpoint`` so its
    (chunk, V) fp32 logits are recomputed in the backward, not kept."""
    n = x2.shape[0]
    c = min(chunk_rows, n)
    while n % c:
        c //= 2
    w32 = w.float()
    labels1 = labels1.clamp(0, w.shape[0] - 1)
    tot = torch.zeros((), dtype=torch.float32, device=x2.device)
    for i in range(0, n, c):
        tot = tot + checkpoint(_xent_chunk, x2[i:i + c], w32,
                               labels1[i:i + c], use_reentrant=False)
    return tot / n


def _dtype(name):
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def build_functional_train_step(model: GPTForPretraining, lr: float = 1e-4,
                                beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1,
                                remat=True, ce_chunk_rows: int = 1024,
                                compute_dtype=None, *, dp_axis=None,
                                sharding_stage=None, mesh=None):
    """Forward, backward and AdamW as one step on the model's device.

    Returns ``(step, params, opt_state)`` with ``step(params, opt_state,
    ids, labels) -> (params, opt_state, loss)``.  ``params`` are the
    model's own parameters (detached, in :meth:`GPTForPretraining.leaves`
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

    ``mesh``, ``dp_axis``, ``sharding_stage`` > 0, ``cfg.use_parallel`` and
    ``cfg.dropout`` > 0 raise NotImplementedError."""
    cfg = model.cfg
    if mesh is not None or dp_axis is not None or sharding_stage:
        raise NotImplementedError("the distributed options of the train "
                                  "step (mesh, dp_axis, sharding_stage) are "
                                  "not ported")
    if cfg.use_parallel:
        raise NotImplementedError("tensor-parallel GPT (use_parallel) is "
                                  "not ported")
    if cfg.dropout > 0:
        raise NotImplementedError("dropout in the training forward is not "
                                  "ported")
    if remat != "dots" and not isinstance(remat, bool):
        raise ValueError(f"remat must be True, False, or 'dots'; got "
                         f"{remat!r}")
    cd = _dtype(compute_dtype)

    def cast(a):
        return a.to(cd) if cd is not None and a.dtype != cd else a

    params = [p.detach() for p in model.leaves()]
    opt_state = {"m": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params],
                 "v": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params],
                 "t": 0}
    if any(p.dtype != torch.float32 for p in params):
        opt_state["master"] = [p.float().clone() for p in params]
    device = model.device

    def loss_fn(leaves, ids, labels):
        x = _hidden(cfg, _tree(leaves, cfg), ids, remat=remat, cast=cast)
        w = cast(leaves[0])
        if cfg.seq_major:
            labels = labels.t()          # the logits' [S, B] order
        d0, d1, h = x.shape
        if ce_chunk_rows:
            return _chunked_softmax_xent(x.reshape(d0 * d1, h), w,
                                         labels.reshape(d0 * d1),
                                         chunk_rows=ce_chunk_rows)
        logits = (x @ w.t()).float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, labels.clamp(0, w.shape[0] - 1)[..., None])
        return (lse - picked[..., 0]).mean()

    def step(params, opt_state, ids, labels):
        ids = torch.as_tensor(ids, device=device).long()
        labels = torch.as_tensor(labels, device=device).long()
        leaves = [p.detach().requires_grad_() for p in params]
        loss = loss_fn(leaves, ids, labels)
        grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
        t = opt_state["t"] + 1
        # the bias corrections in fp32, as the reference's traced counter
        b1t = float(np.float32(1.0) - np.float32(beta1) ** np.float32(t))
        b2t = float(np.float32(1.0) - np.float32(beta2) ** np.float32(t))
        m, v = opt_state["m"], opt_state["v"]
        w32 = opt_state.get("master", params)
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1 - beta1))
        torch._foreach_mul_(v, beta2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - beta2))
        den = torch._foreach_sqrt(torch._foreach_div(v, b2t))
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(torch._foreach_div(m, b1t), den)
        torch._foreach_add_(upd, torch._foreach_mul(w32, wd))
        new = torch._foreach_sub(w32, torch._foreach_mul(upd, lr))
        if "master" in opt_state:
            opt_state["master"] = new
        torch._foreach_copy_(params, new)
        opt_state["t"] = t
        return params, opt_state, loss.detach()

    return step, params, opt_state

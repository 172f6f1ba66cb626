"""GPT configuration and parameters (counterpart of ``paddle_tpu/models/gpt.py``).

:class:`GPTForPretraining` holds the decoder's parameters: word and
position embeddings, the pre-LN blocks, the final LayerNorm, and the LM
head tied to the word embedding.  Projection weights keep the reference's
``[in, out]`` layout (``x @ W``), so parameter names and shapes match the
JAX parameter tree that ``models/generation._decoder_setup`` builds there,
one to one (see :mod:`paddle_tpu_torch.weights`).

Inference reads the parameters through
:func:`paddle_tpu_torch.models.generation._decoder_setup`.  The
full-sequence training forward goes through the flash-attention kernels
and is ported with them, so this module defines no ``forward``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device, resolve_dtype


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
        # the port serves only so far; the training slice turns gradients on
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wte.dtype

"""Transformer layers: MultiHeadAttention (with its incremental and static
caches), the encoder and decoder layers and stacks, and Transformer.

Counterpart of ``paddle_tpu/nn/layer/transformer.py``, layer for layer
and name for name, so that state dicts carry over.  Attention goes
through the registered ``scaled_dot_product_attention`` op in the bnsd
layout, as the reference's does: on the card the flash kernels, forward
and backward, with ``attn_mask`` (``src_mask``, ``tgt_mask``,
``memory_mask``) as their additive score bias; on the CPU the plain
attention.  The card's kernels need q and k of one length, so
cross-attention over a memory of another length and decoding against a
growing ``Cache`` raise there (ROADMAP A.15), as the dispatcher says.
"""

from __future__ import annotations

import collections
import copy

import numpy as np

from ..layer_base import Layer, LayerList
from .common import Dropout, Linear
from .norm import LayerNorm
from .. import functional as F
from ... import tensor_api as T


def _convert_param_attr_to_list(param_attr, n):
    if isinstance(param_attr, (list, tuple)):
        if len(param_attr) != n:
            raise ValueError(f"expected {n} parameter attributes, got "
                             f"{len(param_attr)}")
        return list(param_attr)
    return [param_attr] * n


class MultiHeadAttention(Layer):
    """q / k / v / out projections over ``scaled_dot_product_attention``,
    with a ``Cache`` (incremental K/V: the step's keys are appended) and a
    ``StaticCache`` (K/V of a fixed memory, projected once)."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")

        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _reshape_qkv(self, x):
        s = x.shape
        return T.transpose(
            T.reshape(x, [s[0], s[1], self.num_heads, self.head_dim]),
            [0, 2, 1, 3])

    def gen_cache(self, key, value=None, type=None):
        if type == MultiHeadAttention.StaticCache:
            k = self._reshape_qkv(self.k_proj(key))
            v = self._reshape_qkv(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        if value is None:
            value = key
        k = self._reshape_qkv(self.k_proj(key))
        v = self._reshape_qkv(self.v_proj(value))
        return self.Cache(k, v)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._reshape_qkv(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._reshape_qkv(self.k_proj(key))
            v = self._reshape_qkv(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = T.concat([cache.k, k], axis=2)
                v = T.concat([cache.v, v], axis=2)
                cache = self.Cache(k, v)

        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        # [B, H, S, D] -> [B, S, E]
        out = T.transpose(out, [0, 2, 1, 3])
        s = out.shape
        out = T.reshape(out, [s[0], s[1], self.embed_dim])
        out = self.out_proj(out)
        if cache is not None and isinstance(cache, self.Cache):
            return out, cache
        return out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        wa = _convert_param_attr_to_list(weight_attr, 2)
        ba = _convert_param_attr_to_list(bias_attr, 2)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=wa[0],
                                            bias_attr=ba[0])
        self.linear1 = Linear(d_model, dim_feedforward, wa[1], ba[1])
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, wa[1], ba[1])
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation

    def _act(self, x):
        return getattr(F, self.activation)(x)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self._act(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """``num_layers`` deep copies of ``encoder_layer`` (the first is the
    layer itself), then ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        wa = _convert_param_attr_to_list(weight_attr, 3)
        ba = _convert_param_attr_to_list(bias_attr, 3)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=wa[0],
                                            bias_attr=ba[0])
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=wa[1],
                                             bias_attr=ba[1])
        self.linear1 = Linear(d_model, dim_feedforward, wa[2], ba[2])
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, wa[2], ba[2])
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                                  cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(
            getattr(F, self.activation)(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr, cache[1]))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    """``num_layers`` deep copies of ``decoder_layer``, then ``norm``."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask,
                                  cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """[length, length] fp32: 0 on and below the diagonal, -inf above
        it (an additive mask)."""
        from ...dygraph.tensor import Tensor

        m = np.triu(np.full((length, length), -np.inf, "float32"), k=1)
        return Tensor(m)

"""Vision Transformer (ViT): ``PatchEmbed``, ``ViTBlock``,
``VisionTransformer`` and the ``vit_*`` constructors.

Counterpart of ``paddle_tpu/vision/models/vit.py``, layer for layer and
name for name (so state dicts carry over); BASELINE config 1's second
backbone.  The patch embedding is one strided ``Conv2D`` (cuDNN on the
card), and each pre-LN block's attention is
``F.scaled_dot_product_attention`` over bnsd head views of its fused QKV
projection: on the card the flash kernels, forward and backward, at the
model's token count (197 at 224 px with 16 px patches, which no tile of
the kernels divides: they mask the ragged last tile).
"""

from __future__ import annotations

from ... import nn
from ...nn import functional as F
from ... import tensor_api as T


class PatchEmbed(nn.Layer):
    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 embed_dim=768):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2D(in_chans, embed_dim, kernel_size=patch_size,
                              stride=patch_size)

    def forward(self, x):
        x = self.proj(x)                     # (B, D, H/P, W/P)
        b, d, h, w = x.shape
        x = T.reshape(x, [b, d, h * w])
        return T.transpose(x, [0, 2, 1])     # (B, N, D)


class ViTBlock(nn.Layer):
    """Pre-LN transformer encoder block."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, dropout=0.0,
                 epsilon=1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.ln1 = nn.LayerNorm(dim, epsilon=epsilon)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, epsilon=epsilon)
        hidden = int(dim * mlp_ratio)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.dropout = dropout

    def forward(self, x):
        b, n, d = x.shape
        h = self.ln1(x)
        qkv = T.reshape(self.qkv(h), [b, n, 3, self.num_heads,
                                      self.head_dim])
        qkv = T.transpose(qkv, [2, 0, 3, 1, 4])
        q, k, v = qkv[0], qkv[1], qkv[2]
        att = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.dropout, training=self.training)
        att = T.reshape(T.transpose(att, [0, 2, 1, 3]), [b, n, d])
        x = x + self.proj(att)
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class VisionTransformer(nn.Layer):
    """ViT encoder + classification head (class-token pooling)."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0,
                 num_classes=1000, dropout=0.0, epsilon=1e-6):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim)
        n = self.patch_embed.num_patches
        zeros = nn.initializer.Constant(0.0)
        trunc = nn.initializer.TruncatedNormal(std=0.02)
        self.cls_token = self.create_parameter(
            [1, 1, embed_dim], attr=nn.ParamAttr(initializer=zeros))
        self.pos_embed = self.create_parameter(
            [1, n + 1, embed_dim], attr=nn.ParamAttr(initializer=trunc))
        self.pos_drop = nn.Dropout(dropout)
        self.blocks = nn.LayerList([
            ViTBlock(embed_dim, num_heads, mlp_ratio, dropout, epsilon)
            for _ in range(depth)
        ])
        self.norm = nn.LayerNorm(embed_dim, epsilon=epsilon)
        self.head = (nn.Linear(embed_dim, num_classes)
                     if num_classes > 0 else None)

    def forward_features(self, x):
        x = self.patch_embed(x)
        b = x.shape[0]
        cls = T.expand(self.cls_token, [b, 1, self.embed_dim])
        x = T.concat([cls, x], axis=1) + self.pos_embed
        x = self.pos_drop(x)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)

    def forward(self, x):
        x = self.forward_features(x)[:, 0]
        return self.head(x) if self.head is not None else x


def _vit(**kw):
    return VisionTransformer(**kw)


def vit_b_16(**kw):
    return _vit(patch_size=16, embed_dim=768, depth=12, num_heads=12, **kw)


def vit_b_32(**kw):
    return _vit(patch_size=32, embed_dim=768, depth=12, num_heads=12, **kw)


def vit_l_16(**kw):
    return _vit(patch_size=16, embed_dim=1024, depth=24, num_heads=16, **kw)


def vit_s_16(**kw):
    return _vit(patch_size=16, embed_dim=384, depth=12, num_heads=6, **kw)


def vit_tiny(**kw):
    """Test-sized ViT: 32 px, 8 px patches (17 tokens), width 64, 2
    blocks of 2 heads, 10 classes."""
    kw.setdefault("img_size", 32)
    kw.setdefault("patch_size", 8)
    kw.setdefault("num_classes", 10)
    return _vit(embed_dim=64, depth=2, num_heads=2, **kw)

"""Common layers: Linear, Embedding, Dropout, Flatten, padding, the
upsampling layers, Identity, Bilinear, CosineSimilarity.

Counterpart of ``paddle_tpu/nn/layer/common.py``.  ``Linear`` keeps
paddle's ``[in_features, out_features]`` weight (``y = x @ W + b``), so
state dicts carry over unchanged.  The upsampling layers (``Upsample``,
``UpsamplingBilinear2D``, ``UpsamplingNearest2D``) run the interpolation
ops through ``F.interpolate``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...framework import program as fw
from ..layer_base import Layer, ParamAttr
from .. import functional as F
from ... import tensor_api as T
from ..initializer import Constant, Normal, XavierUniform


class Linear(Layer):
    """y = x @ W + b, W: [in_features, out_features] (reference layout)."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform(),
        )
        self.bias = self.create_parameter(
            shape=[out_features], attr=bias_attr, is_bias=True,
        )

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0),
        )
        if padding_idx is not None and fw.in_dygraph_mode():
            with torch.no_grad():
                self.weight._t[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training, data_format=self.data_format)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return T.flatten(x, self.start_axis, self.stop_axis)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding if isinstance(padding, (list, tuple)) else [padding] * 4
        self.mode = mode
        self.value = value

    def forward(self, x):
        return F.pad(x, list(self.padding), mode=self.mode, value=self.value)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            shape=[out_features, in1_features, in2_features], attr=weight_attr,
        )
        self.bias = self.create_parameter(shape=[1, out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        out = F.bilinear(x1, x2, self.weight)
        if self.bias is not None:
            out = T.add(out, self.bias)
        return out


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)

"""``paddle.fluid.dygraph``: the v2.1-era imperative API (``guard``,
``to_variable``, ``Layer``, the ``dygraph.nn`` layer classes with their
``act=`` argument, ``no_grad``), and ``paddle.jit``'s ``declarative``
(``to_static``), ``TracedLayer`` and ``ProgramTranslator``."""

from __future__ import annotations

import contextlib

import numpy as np

from ...dygraph.tensor import Tensor
from ...framework import program as fw
from ...nn import functional as _F
from ...nn.layer_base import Layer, Sequential  # noqa: F401
from ... import nn as _nn

__all__ = [
    "guard", "to_variable", "no_grad", "grad", "enabled", "Layer",
    "Sequential", "Linear", "Conv2D", "Conv2DTranspose", "Pool2D",
    "BatchNorm", "Embedding", "LayerNorm", "GroupNorm", "SpectralNorm",
    "Dropout", "LayerList", "ParameterList", "PRelu", "NCE", "BilinearTensorProduct",
    "TracedLayer", "ProgramTranslator", "declarative", "jit",
]


@contextlib.contextmanager
def guard(place=None):
    """``with fluid.dygraph.guard(): ...``: dygraph mode inside."""
    was_static = not fw.in_dygraph_mode()
    fw.disable_static()
    try:
        yield
    finally:
        if was_static:
            fw.enable_static()


def enabled() -> bool:
    return fw.in_dygraph_mode()


def to_variable(value, name=None, zero_copy=None, dtype=None):
    arr = np.asarray(value)
    if dtype is not None:
        arr = arr.astype(dtype)
    return Tensor(arr, stop_gradient=True)


from ...dygraph import no_grad  # noqa: F401,E402
from ...dygraph.base import grad  # noqa: F401,E402


def _act_wrap(out, act):
    return getattr(_F, act)(out) if act else out


class Linear(Layer):
    """``fluid.dygraph.Linear(input_dim, output_dim, param_attr,
    bias_attr, act, dtype)``: 2.x ``nn.Linear`` and the ``act``."""

    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        self._linear = _nn.Linear(input_dim, output_dim,
                                  weight_attr=param_attr, bias_attr=bias_attr)
        self._act = act

    @property
    def weight(self):
        return self._linear.weight

    @property
    def bias(self):
        return self._linear.bias

    def forward(self, x):
        return _act_wrap(self._linear(x), self._act)


class Conv2D(Layer):
    """fluid.dygraph.Conv2D(num_channels, num_filters, filter_size, ...)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype="float32"):
        super().__init__()
        self._conv = _nn.Conv2D(num_channels, num_filters, filter_size,
                                stride=stride, padding=padding,
                                dilation=dilation, groups=groups,
                                weight_attr=param_attr, bias_attr=bias_attr)
        self._act = act

    @property
    def weight(self):
        return self._conv.weight

    def forward(self, x):
        return _act_wrap(self._conv(x), self._act)


class Conv2DTranspose(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype="float32",
                 output_size=None):
        super().__init__()
        self._conv = _nn.Conv2DTranspose(
            num_channels, num_filters, filter_size, stride=stride,
            padding=padding, dilation=dilation, groups=groups,
            weight_attr=param_attr, bias_attr=bias_attr)
        self._act = act

    def forward(self, x):
        return _act_wrap(self._conv(x), self._act)


class Pool2D(Layer):
    """fluid.dygraph.Pool2D(pool_size, pool_type, pool_stride, ...)."""

    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True, data_format="NCHW"):
        super().__init__()
        self._kw = dict(pool_size=pool_size, pool_type=pool_type,
                        pool_stride=pool_stride, pool_padding=pool_padding,
                        global_pooling=global_pooling, ceil_mode=ceil_mode,
                        exclusive=exclusive, data_format=data_format)

    def forward(self, x):
        from ..layers import pool2d

        return pool2d(x, **self._kw)


class BatchNorm(Layer):
    """fluid.dygraph.BatchNorm(num_channels, act=..., ...)."""

    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype="float32", data_layout="NCHW", in_place=False,
                 moving_mean_name=None, moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__()
        self._bn = _nn.BatchNorm2D(
            num_channels, momentum=momentum, epsilon=epsilon,
            weight_attr=param_attr, bias_attr=bias_attr,
            data_format=data_layout, use_global_stats=use_global_stats)
        self._act = act

    def forward(self, x):
        return _act_wrap(self._bn(x), self._act)


class Embedding(Layer):
    """fluid.dygraph.Embedding(size=[vocab, dim], ...)."""

    def __init__(self, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__()
        self._emb = _nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                                  sparse=is_sparse, weight_attr=param_attr)

    @property
    def weight(self):
        return self._emb.weight

    def forward(self, x):
        return self._emb(x)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True,
                 epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__()
        self._ln = _nn.LayerNorm(normalized_shape, epsilon=epsilon,
                                 weight_attr=param_attr if scale else False,
                                 bias_attr=bias_attr if shift else False)
        self._act = act

    def forward(self, x):
        return _act_wrap(self._ln(x), self._act)


class GroupNorm(Layer):
    def __init__(self, channels, groups, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, data_layout="NCHW"):
        super().__init__()
        self._gn = _nn.GroupNorm(groups, channels, epsilon=epsilon,
                                 weight_attr=param_attr, bias_attr=bias_attr)
        self._act = act

    def forward(self, x):
        return _act_wrap(self._gn(x), self._act)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        raise NotImplementedError(
            "fluid.dygraph.SpectralNorm: use paddle.nn.utils.spectral_norm "
            "on the owning layer instead")


class Dropout(Layer):
    def __init__(self, p=0.5, seed=None, dropout_implementation=
                 "downgrade_in_infer", is_test=False):
        super().__init__()
        self._p = p
        self._mode = dropout_implementation

    def forward(self, x):
        return _F.dropout(x, p=self._p, training=self.training,
                          mode=self._mode)


class PRelu(Layer):
    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32"):
        super().__init__()
        num = 1 if mode == "all" else (channel if mode == "channel" else
                                       int(np.prod(input_shape)))
        self._prelu = _nn.PReLU(num_parameters=num, weight_attr=param_attr)

    def forward(self, x):
        return self._prelu(x)


LayerList = _nn.LayerList
ParameterList = _nn.ParameterList


class NCE(Layer):
    def __init__(self, *a, **k):
        super().__init__()
        raise NotImplementedError(
            "fluid.dygraph.NCE is a parameter-server-era sampled-softmax "
            "layer; compute "
            "sampled softmax with paddle ops or full softmax_with_cross_entropy")


class BilinearTensorProduct(Layer):
    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None, dtype="float32"):
        super().__init__()
        self._b = _nn.Bilinear(input1_dim, input2_dim, output_dim,
                               weight_attr=param_attr, bias_attr=bias_attr)
        self._act = act

    def forward(self, x, y):
        return _act_wrap(self._b(x, y), self._act)


# -- the jit bridge -----------------------------------------------------------
from ... import jit  # noqa: E402
from ...jit import ProgramTranslator, TracedLayer, declarative  # noqa: E402,F401

"""``paddle.fluid.nets``: the composite helpers of the v2.1 tutorials
(simple_img_conv_pool, img_conv_group, sequence_conv_pool, glu,
scaled_dot_product_attention)."""

from __future__ import annotations

from . import layers
from .. import tensor_api as T
from ..nn import functional as F
from ..static import nn as snn


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = snn.conv2d(
        input, num_filters, filter_size, stride=conv_stride,
        padding=conv_padding, dilation=conv_dilation, groups=conv_groups,
        param_attr=param_attr, bias_attr=bias_attr, act=act)
    return layers.pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    tmp = input
    n = len(conv_num_filter)

    def _expand(v):
        return v if isinstance(v, (list, tuple)) else [v] * n

    padding, fsize = _expand(conv_padding), _expand(conv_filter_size)
    attrs, with_bn = _expand(param_attr), _expand(conv_with_batchnorm)
    drop = _expand(conv_batchnorm_drop_rate)
    for i in range(n):
        act = conv_act if not with_bn[i] else None
        tmp = snn.conv2d(tmp, conv_num_filter[i], fsize[i],
                         padding=padding[i], param_attr=attrs[i], act=act)
        if with_bn[i]:
            tmp = snn.batch_norm(tmp, act=conv_act)
            if drop[i]:
                tmp = layers.dropout(tmp, dropout_prob=drop[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    conv_out = snn.sequence_conv(input, num_filters, filter_size,
                                 param_attr=param_attr, bias_attr=bias_attr,
                                 act=act)
    return snn.sequence_pool(conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    a, b = T.split(input, 2, axis=dim)
    return T.multiply(a, F.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head attention over [B, S, D] inputs through the registered
    ``scaled_dot_product_attention`` op: the flash kernels on the
    card."""
    b = T.shape(queries)[0]

    def _split(x):
        s = x.shape
        return T.transpose(
            T.reshape(x, [0, 0, num_heads, s[-1] // num_heads]),
            [0, 2, 1, 3])

    q, k, v = _split(queries), _split(keys), _split(values)
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=dropout_rate)
    out = T.transpose(out, [0, 2, 1, 3])
    s = out.shape
    return T.reshape(out, [0, 0, s[-2] * s[-1]])

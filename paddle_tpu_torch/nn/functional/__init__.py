"""``paddle.nn.functional``: the functions over the ported ops.

Counterpart of ``paddle_tpu/nn/functional/__init__.py``, function for
function: activations, ``linear``, the 1-D, 2-D and 3-D convs and pools,
``interpolate`` / ``upsample``, dropout (``alpha_dropout``,
``dropout3d``), the norms, ``embedding`` / ``one_hot``, the losses (with
``ctc_loss`` and ``hsigmoid_loss``), ``pad``, ``unfold``,
``pixel_shuffle``, ``affine_grid`` / ``grid_sample``,
``temporal_shift``, ``gather_tree``, ``sequence_mask``,
``scaled_dot_product_attention`` (the registered op, which on the card
launches the flash kernels) and ``ring_attention`` (over
:mod:`paddle_tpu_torch.kernels.ring`).  The functions the reference
writes as one-off JAX functions are one-off torch functions here
(``tracer.trace_fn``), the same formulas, so they run where their
input lies.
"""

from __future__ import annotations

import torch

import numpy as np

from ...framework import random as _random
from ...framework.dtype import convert_dtype  # noqa: F401
from ...ops.dispatch import dispatch, single
from ... import tensor_api as T

__all__ = [
    "linear", "conv2d", "conv2d_transpose", "max_pool2d", "avg_pool2d",
    "adaptive_avg_pool2d", "adaptive_max_pool2d", "conv1d",
    "conv1d_transpose", "max_pool1d", "avg_pool1d", "adaptive_avg_pool1d",
    "adaptive_max_pool1d", "relu", "relu6", "gelu", "sigmoid", "tanh", "softmax",
    "log_softmax", "leaky_relu", "elu", "selu", "silu", "swish", "mish",
    "hardswish", "hardsigmoid", "hardtanh", "hardshrink", "softshrink",
    "softplus", "softsign", "tanhshrink", "thresholded_relu", "prelu",
    "log_sigmoid", "maxout", "dropout", "dropout2d", "batch_norm",
    "layer_norm", "group_norm", "instance_norm", "embedding", "one_hot",
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss", "nll_loss",
    "kl_div", "smooth_l1_loss", "margin_ranking_loss", "pad", "flatten",
    "label_smooth", "normalize", "cosine_similarity",
    "scaled_dot_product_attention", "sequence_mask", "square_error_cost",
    "accuracy", "conv3d", "conv3d_transpose", "max_pool3d", "avg_pool3d",
    "adaptive_avg_pool3d", "adaptive_max_pool3d", "interpolate", "upsample",
    "unfold", "pixel_shuffle", "diag_embed", "alpha_dropout", "dropout3d",
    "temporal_shift", "affine_grid", "grid_sample", "gather_tree",
    "ctc_loss", "hsigmoid_loss", "ring_attention",
]


def _d(op_type, ins, attrs=None, slot="Out"):
    return single(dispatch(op_type, ins, attrs or {}), slot)


# -- activations ------------------------------------------------------------


def relu(x, name=None):
    return _d("relu", {"X": [x]})


def relu6(x, name=None):
    return _d("relu6", {"X": [x]})


def gelu(x, approximate=False, name=None):
    return _d("gelu", {"X": [x]}, {"approximate": approximate})


def sigmoid(x, name=None):
    return _d("sigmoid", {"X": [x]})


def tanh(x, name=None):
    return _d("tanh", {"X": [x]})


def softmax(x, axis=-1, dtype=None, name=None):
    out = _d("softmax", {"X": [x]}, {"axis": axis})
    return T.cast(out, dtype) if dtype is not None else out


def log_softmax(x, axis=-1, dtype=None, name=None):
    out = _d("log_softmax", {"X": [x]}, {"axis": axis})
    return T.cast(out, dtype) if dtype is not None else out


def leaky_relu(x, negative_slope=0.01, name=None):
    return _d("leaky_relu", {"X": [x]}, {"alpha": negative_slope})


def elu(x, alpha=1.0, name=None):
    return _d("elu", {"X": [x]}, {"alpha": alpha})


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _d("selu", {"X": [x]}, {"scale": scale, "alpha": alpha})


def silu(x, name=None):
    return _d("silu", {"X": [x]})


def swish(x, name=None):
    return _d("swish", {"X": [x]}, {"beta": 1.0})


def mish(x, name=None):
    return _d("mish", {"X": [x]})


def hardswish(x, name=None):
    return _d("hard_swish", {"X": [x]})


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return _d("hard_sigmoid", {"X": [x]}, {"slope": slope, "offset": offset})


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _d("hard_tanh", {"X": [x]}, {"t_min": min, "t_max": max})


def hardshrink(x, threshold=0.5, name=None):
    return _d("hardshrink", {"X": [x]}, {"threshold": threshold})


def softshrink(x, threshold=0.5, name=None):
    return _d("softshrink", {"X": [x]}, {"lambda": threshold})


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _d("softplus", {"X": [x]}, {"beta": beta, "threshold": threshold})


def softsign(x, name=None):
    return _d("softsign", {"X": [x]})


def tanhshrink(x, name=None):
    return _d("tanhshrink", {"X": [x]})


def thresholded_relu(x, threshold=1.0, name=None):
    return _d("thresholded_relu", {"X": [x]}, {"threshold": threshold})


def log_sigmoid(x, name=None):
    return _d("logsigmoid", {"X": [x]})


def prelu(x, weight, data_format="NCHW", name=None):
    return _d("prelu", {"X": [x], "Alpha": [weight]}, {"data_format": data_format})


def maxout(x, groups, axis=1, name=None):
    def fn(a):
        shape = list(a.shape)
        shape[axis] = shape[axis] // groups
        shape.insert(axis + 1, groups)
        return torch.amax(a.reshape(shape), dim=axis + 1)

    from ...dygraph import tracer

    return tracer.trace_fn(fn, [x], name="maxout")


# -- 2-D conv and pool -------------------------------------------------------


def conv2d(
    x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
    data_format="NCHW", name=None,
):
    stride = [stride] * 2 if isinstance(stride, int) else list(stride)
    dilation = [dilation] * 2 if isinstance(dilation, int) else list(dilation)
    pad_alg = "EXPLICIT"
    if isinstance(padding, str):
        pad_alg, padding = padding.upper(), [0, 0]
    padding = [padding] * 2 if isinstance(padding, int) else list(padding)
    out = _d(
        "conv2d",
        {"Input": [x], "Filter": [weight]},
        {
            "strides": stride, "paddings": padding, "dilations": dilation,
            "groups": groups, "padding_algorithm": pad_alg, "data_format": data_format,
        },
        slot="Output",
    )
    if bias is not None:
        ax = 1 if data_format == "NCHW" else 3
        out = _d("elementwise_add", {"X": [out], "Y": [bias]}, {"axis": ax})
    return out


def conv2d_transpose(
    x, weight, bias=None, stride=1, padding=0, output_padding=0, dilation=1,
    groups=1, output_size=None, data_format="NCHW", name=None,
):
    stride = [stride] * 2 if isinstance(stride, int) else list(stride)
    dilation = [dilation] * 2 if isinstance(dilation, int) else list(dilation)
    padding = [padding] * 2 if isinstance(padding, int) else list(padding)
    output_padding = (
        [output_padding] * 2 if isinstance(output_padding, int) else list(output_padding)
    )
    if output_size is not None:
        # derive output_padding so the result hits the requested size exactly
        os_ = [output_size] * 2 if isinstance(output_size, int) else list(output_size)
        kh, kw = int(weight.shape[-2]), int(weight.shape[-1])
        for i, (k, dim) in enumerate(zip((kh, kw), (2, 3))):
            base = (int(x.shape[dim]) - 1) * stride[i] - 2 * padding[i] + dilation[i] * (k - 1) + 1
            output_padding[i] = int(os_[i]) - base
    out = _d(
        "conv2d_transpose",
        {"Input": [x], "Filter": [weight]},
        {"strides": stride, "paddings": padding, "dilations": dilation,
         "groups": groups, "output_padding": output_padding},
        slot="Output",
    )
    if bias is not None:
        out = _d("elementwise_add", {"X": [out], "Y": [bias]}, {"axis": 1})
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    ks = [kernel_size] * 2 if isinstance(kernel_size, int) else list(kernel_size)
    st = ks if stride is None else ([stride] * 2 if isinstance(stride, int) else list(stride))
    pd = [padding] * 2 if isinstance(padding, int) else list(padding)
    if return_mask:
        if data_format != "NCHW":
            raise ValueError("return_mask=True requires NCHW (the mask indexes "
                             "an NCHW feature map)")
        outs = dispatch("max_pool2d_with_index", {"X": [x]},
                        {"ksize": ks, "strides": st, "paddings": pd,
                         "ceil_mode": ceil_mode})
        return single(outs, "Out"), single(outs, "Mask")
    return _d(
        "pool2d", {"X": [x]},
        {"pooling_type": "max", "ksize": ks, "strides": st, "paddings": pd,
         "ceil_mode": ceil_mode, "data_format": data_format},
    )


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW", name=None):
    ks = [kernel_size] * 2 if isinstance(kernel_size, int) else list(kernel_size)
    st = ks if stride is None else ([stride] * 2 if isinstance(stride, int) else list(stride))
    pd = [padding] * 2 if isinstance(padding, int) else list(padding)
    return _d(
        "pool2d", {"X": [x]},
        {"pooling_type": "avg", "ksize": ks, "strides": st, "paddings": pd,
         "ceil_mode": ceil_mode, "exclusive": exclusive, "data_format": data_format},
    )


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    os = [output_size] * 2 if isinstance(output_size, int) else list(output_size)
    return _d(
        "pool2d", {"X": [x]},
        {"pooling_type": "avg", "ksize": os, "adaptive": True, "data_format": data_format},
    )


def adaptive_max_pool2d(x, output_size, return_mask=False,
                        data_format="NCHW", name=None):
    os = [output_size] * 2 if isinstance(output_size, int) else list(output_size)
    if return_mask:
        if data_format != "NCHW":
            raise ValueError("return_mask=True requires NCHW (the mask indexes "
                             "an NCHW feature map)")
        outs = dispatch("max_pool2d_with_index", {"X": [x]},
                        {"ksize": os, "adaptive": True})
        return single(outs, "Out"), single(outs, "Mask")
    return _d(
        "pool2d", {"X": [x]},
        {"pooling_type": "max", "ksize": os, "adaptive": True, "data_format": data_format},
    )


# -- 1-D conv and pool (the 2-D ops over a singleton height) --------------


def _require_default_layout(data_format, allowed, return_mask=False):
    """The 1-D conv and pool functions take the channels-first layout only:
    reject the others instead of convolving over the wrong axes, and
    reject return_mask (argmax indices) the same way."""
    if data_format not in allowed:
        raise NotImplementedError(
            f"data_format={data_format!r} is not wired for this op "
            f"(supported: {allowed}); transpose to channels-first")
    if return_mask:
        raise NotImplementedError(
            "return_mask=True (pooling argmax indices) is not wired")


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D conv as a 2-D conv over a singleton height (Conv1D layer trick)."""
    _require_default_layout(data_format, ("NCL",))
    x4 = T.unsqueeze(x, [2])
    w4 = T.unsqueeze(weight, [2])
    s = stride if isinstance(stride, int) else stride[0]
    p = padding if isinstance(padding, int) else padding[0]
    d = dilation if isinstance(dilation, int) else dilation[0]
    out = conv2d(x4, w4, bias=bias, stride=[1, s], padding=[0, p],
                 dilation=[1, d], groups=groups)
    return T.squeeze(out, [2])


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCL", name=None):
    _require_default_layout(data_format, ("NCL",))
    x4 = T.unsqueeze(x, [2])
    w4 = T.unsqueeze(weight, [2])
    s = stride if isinstance(stride, int) else stride[0]
    p = padding if isinstance(padding, int) else padding[0]
    d = dilation if isinstance(dilation, int) else dilation[0]
    op = (output_padding if isinstance(output_padding, int)
          else output_padding[0])
    os_ = None if output_size is None else [1, (
        output_size if isinstance(output_size, int) else output_size[0])]
    out = conv2d_transpose(x4, w4, bias=bias, stride=[1, s], padding=[0, p],
                           output_padding=[0, op], dilation=[1, d],
                           groups=groups, output_size=os_)
    return T.squeeze(out, [2])


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    _require_default_layout("NCL", ("NCL",), return_mask)
    x4 = T.unsqueeze(x, [2])
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = k if stride is None else (
        stride if isinstance(stride, int) else stride[0])
    p = padding if isinstance(padding, int) else padding[0]
    out = max_pool2d(x4, [1, k], stride=[1, s], padding=[0, p],
                     ceil_mode=ceil_mode)
    return T.squeeze(out, [2])


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    x4 = T.unsqueeze(x, [2])
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = k if stride is None else (
        stride if isinstance(stride, int) else stride[0])
    p = padding if isinstance(padding, int) else padding[0]
    out = avg_pool2d(x4, [1, k], stride=[1, s], padding=[0, p],
                     ceil_mode=ceil_mode, exclusive=exclusive)
    return T.squeeze(out, [2])


def adaptive_avg_pool1d(x, output_size, name=None):
    x4 = T.unsqueeze(x, [2])
    o = output_size if isinstance(output_size, int) else output_size[0]
    return T.squeeze(adaptive_avg_pool2d(x4, [1, o]), [2])


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _require_default_layout("NCL", ("NCL",), return_mask)
    x4 = T.unsqueeze(x, [2])
    o = output_size if isinstance(output_size, int) else output_size[0]
    return T.squeeze(adaptive_max_pool2d(x4, [1, o]), [2])


# -- 3-D conv and pool (NCDHW) ----------------------------------------------


def _many(v, n):
    """An int as ``n`` copies, a sequence as a list."""
    return [v] * n if isinstance(v, int) else list(v)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    _require_default_layout(data_format, ("NCDHW",))
    out = _d("conv3d", {"Input": [x], "Filter": [weight]},
             {"strides": _many(stride, 3), "paddings": _many(padding, 3),
              "dilations": _many(dilation, 3), "groups": groups},
             slot="Output")
    if bias is not None:
        out = _d("elementwise_add", {"X": [out], "Y": [bias]}, {"axis": 1})
    return out


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCDHW", name=None):
    """The adjoint of conv3d; as the reference's, it reads no
    ``output_size`` (give ``output_padding``)."""
    _require_default_layout(data_format, ("NCDHW",))
    out = _d("conv3d_transpose", {"Input": [x], "Filter": [weight]},
             {"strides": _many(stride, 3), "paddings": _many(padding, 3),
              "dilations": _many(dilation, 3), "groups": groups,
              "output_padding": _many(output_padding, 3)},
             slot="Output")
    if bias is not None:
        out = _d("elementwise_add", {"X": [out], "Y": [bias]}, {"axis": 1})
    return out


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    _require_default_layout(data_format, ("NCDHW",), return_mask)
    ks = _many(kernel_size, 3)
    return _d("pool3d", {"X": [x]},
              {"pooling_type": "max", "ksize": ks,
               "strides": ks if stride is None else _many(stride, 3),
               "paddings": _many(padding, 3), "ceil_mode": ceil_mode})


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    _require_default_layout(data_format, ("NCDHW",))
    ks = _many(kernel_size, 3)
    return _d("pool3d", {"X": [x]},
              {"pooling_type": "avg", "ksize": ks,
               "strides": ks if stride is None else _many(stride, 3),
               "paddings": _many(padding, 3), "ceil_mode": ceil_mode,
               "exclusive": exclusive})


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    _require_default_layout(data_format, ("NCDHW",))
    return _d("pool3d", {"X": [x]},
              {"pooling_type": "avg", "ksize": _many(output_size, 3),
               "adaptive": True})


def adaptive_max_pool3d(x, output_size, return_mask=False,
                        data_format="NCDHW", name=None):
    _require_default_layout(data_format, ("NCDHW",), return_mask)
    return _d("pool3d", {"X": [x]},
              {"pooling_type": "max", "ksize": _many(output_size, 3),
               "adaptive": True})


# -- linear ------------------------------------------------------------------


def linear(x, weight, bias=None, name=None):
    """Parity: nn.functional.common.linear — x @ W + b (W is [in, out])."""
    out = _d("matmul_v2", {"X": [x], "Y": [weight]}, {})
    if bias is not None:
        out = _d("elementwise_add", {"X": [out], "Y": [bias]}, {})
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", name=None):
    attrs = {"dropout_prob": p, "is_test": not training, "dropout_implementation": mode}
    if axis is not None:
        attrs["axis"] = [axis] if isinstance(axis, int) else list(axis)
    return _d("dropout", {"X": [x]}, attrs)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    # spatial dropout: whole channels are dropped (mask over N, C only)
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None, name=None):
    outs = dispatch(
        "batch_norm",
        {"X": [x], "Scale": [weight], "Bias": [bias],
         "Mean": [running_mean], "Variance": [running_var]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": not training,
         "data_layout": data_format,
         "use_global_stats": bool(use_global_stats) if use_global_stats is not None else False},
    )
    # running stats are functional outputs; rebind in place (dygraph) so the
    # caller's running_mean/var follow paddle's mutable semantics
    if training and hasattr(running_mean, "_t"):
        running_mean._t = outs["MeanOut"][0]._t
        running_var._t = outs["VarianceOut"][0]._t
    return outs["Y"][0]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5, name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    bna = len(x.shape) - len(normalized_shape)
    ins = {"X": [x]}
    if weight is not None:
        ins["Scale"] = [weight]
    if bias is not None:
        ins["Bias"] = [bias]
    return single(
        dispatch("layer_norm", ins, {"epsilon": epsilon, "begin_norm_axis": bna}), "Y"
    )


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5, data_format="NCHW", name=None):
    ins = {"X": [x]}
    if weight is not None:
        ins["Scale"] = [weight]
    if bias is not None:
        ins["Bias"] = [bias]
    return single(dispatch("group_norm", ins, {"groups": num_groups, "epsilon": epsilon}), "Y")


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-5, data_format="NCHW", name=None):
    ins = {"X": [x]}
    if weight is not None:
        ins["Scale"] = [weight]
    if bias is not None:
        ins["Bias"] = [bias]
    return single(dispatch("instance_norm", ins, {"epsilon": eps}), "Y")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    norm = T.pow(T.sum(T.pow(T.abs(x), p), axis=axis, keepdim=True), 1.0 / p)
    return T.divide(x, T.maximum(norm, T.full_like(norm, epsilon)))


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = T.sum(T.multiply(x1, x2), axis=axis)
    n1 = T.sqrt(T.sum(T.square(x1), axis=axis))
    n2 = T.sqrt(T.sum(T.square(x2), axis=axis))
    denom = T.maximum(T.multiply(n1, n2), T.full_like(n1, eps))
    return T.divide(dot, denom)


# -- embedding / one-hot -----------------------------------------------------


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    if padding_idx is not None and padding_idx < 0:
        padding_idx = int(weight.shape[0]) + padding_idx
    return _d(
        "lookup_table_v2", {"W": [weight], "Ids": [x]},
        {"padding_idx": -1 if padding_idx is None else padding_idx},
    )


def one_hot(x, num_classes, name=None):
    return _d("one_hot_v2", {"X": [x]}, {"depth": num_classes})


# -- losses ------------------------------------------------------------------


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               return_softmax=False, axis=-1):
    outs = dispatch(
        "softmax_with_cross_entropy",
        {"Logits": [logits], "Label": [label]},
        {"soft_label": soft_label, "ignore_index": ignore_index, "axis": axis},
    )
    if return_softmax:
        return outs["Loss"][0], outs["Softmax"][0]
    return outs["Loss"][0]


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, name=None):
    """Parity: nn.functional.loss.cross_entropy (2.x semantics: input=logits)."""
    if use_softmax:
        loss = softmax_with_cross_entropy(
            input, label, soft_label=soft_label, ignore_index=ignore_index, axis=axis
        )
    else:
        loss = _d("cross_entropy", {"X": [input], "Label": [label]},
                  {"soft_label": soft_label}, slot="Y")
    if weight is not None:
        w = _d("lookup_table_v2", {"W": [T.reshape(weight, [-1, 1])], "Ids": [label]}, {"padding_idx": -1})
        loss = T.multiply(loss, T.reshape(w, loss.shape))
    if reduction == "mean":
        if not soft_label:
            # divide by the number of NON-ignored targets (paddle semantics)
            valid = T.cast(T.not_equal(label, T.full_like(label, ignore_index)), loss.dtype)
            denom = T.maximum(T.sum(valid), T.full_like(T.sum(valid), 1.0))
            if weight is not None:
                denom = T.maximum(T.sum(T.multiply(T.reshape(w, loss.shape),
                                                   T.reshape(valid, loss.shape))),
                                  T.full_like(denom, 1e-8))
            return T.divide(T.sum(loss), denom)
        return T.mean(loss)
    if reduction == "sum":
        return T.sum(loss)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean", name=None):
    loss = _d("bce_loss", {"X": [input], "Label": [label]})
    if weight is not None:
        loss = T.multiply(loss, weight)
    if reduction == "mean":
        return T.mean(loss)
    if reduction == "sum":
        return T.sum(loss)
    return loss


def binary_cross_entropy_with_logits(logit, label, weight=None, reduction="mean",
                                     pos_weight=None, name=None):
    loss = _d("sigmoid_cross_entropy_with_logits", {"X": [logit], "Label": [label]})
    if pos_weight is not None:
        log_w = T.add(T.multiply(T.subtract(pos_weight, T.full_like(pos_weight, 1.0)), label),
                      T.full_like(label, 1.0))
        loss = T.multiply(loss, log_w)
    if weight is not None:
        loss = T.multiply(loss, weight)
    if reduction == "mean":
        return T.mean(loss)
    if reduction == "sum":
        return T.sum(loss)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    loss = T.square(T.subtract(input, label))
    if reduction == "mean":
        return T.mean(loss)
    if reduction == "sum":
        return T.sum(loss)
    return loss


def l1_loss(input, label, reduction="mean", name=None):
    loss = T.abs(T.subtract(input, label))
    if reduction == "mean":
        return T.mean(loss)
    if reduction == "sum":
        return T.sum(loss)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean", name=None):
    # input is log-probabilities
    valid = T.not_equal(label, T.full_like(label, ignore_index))
    safe_label = T.where(valid, label, T.full_like(label, 0))
    picked = T.scale(
        T.take_along_axis(input, T.reshape(safe_label, list(label.shape) + [1]), axis=-1), -1.0
    )
    loss = T.squeeze(picked, axis=[-1])
    validf = T.cast(valid, loss.dtype)
    loss = T.multiply(loss, validf)
    if weight is not None:
        w = T.squeeze(
            _d("lookup_table_v2", {"W": [T.reshape(weight, [-1, 1])], "Ids": [safe_label]},
               {"padding_idx": -1}),
            axis=[-1],
        )
        loss = T.multiply(loss, w)
        denom = T.sum(T.multiply(w, validf))
    else:
        denom = T.sum(validf)
    if reduction == "mean":
        return T.divide(T.sum(loss), T.maximum(denom, T.full_like(denom, 1e-8)))
    if reduction == "sum":
        return T.sum(loss)
    return loss


def kl_div(input, label, reduction="mean", name=None):
    return single(dispatch("kldiv_loss", {"X": [input], "Target": [label]},
                           {"reduction": reduction}), "Loss")


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    outs = dispatch("huber_loss", {"X": [input], "Y": [label]}, {"delta": delta})
    loss = outs["Out"][0]
    if reduction == "mean":
        return T.mean(loss)
    if reduction == "sum":
        return T.sum(loss)
    return loss


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean", name=None):
    out = T.maximum(
        T.add(T.multiply(T.scale(label, -1.0), T.subtract(input, other)),
              T.full_like(input, margin)),
        T.full_like(input, 0.0),
    )
    if reduction == "mean":
        return T.mean(out)
    if reduction == "sum":
        return T.sum(out)
    return out


def square_error_cost(input, label):
    return _d("square_error_cost", {"X": [input], "Y": [label]})


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    topk_out, topk_idx = T.topk(input, k)
    outs = dispatch(
        "accuracy",
        {"Out": [topk_out], "Indices": [topk_idx], "Label": [label]},
        {},
    )
    return outs["Accuracy"][0]


# -- misc --------------------------------------------------------------------


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    if len(pad) == len(x.shape) * 2 and mode == "constant":
        return _d("pad", {"X": [x]}, {"paddings": list(pad), "pad_value": value})
    p = list(pad)
    if len(p) == 4 and len(x.shape) == 4:
        # [l, r, t, b] on NCHW spatial dims: lift to 5-D for pad3d, squeeze back
        x5 = T.unsqueeze(x, axis=[2])
        out = _d("pad3d", {"X": [x5]},
                 {"paddings": p + [0, 0], "mode": mode, "value": value})
        return T.squeeze(out, axis=[2])
    if len(p) == 6 and len(x.shape) == 5:
        return _d("pad3d", {"X": [x]}, {"paddings": p, "mode": mode, "value": value})
    raise ValueError(
        f"unsupported pad spec {pad} for input rank {len(x.shape)} (mode={mode})"
    )


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return T.flatten(x, start_axis, stop_axis)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    return _d("label_smooth", {"X": [label]}, {"epsilon": epsilon})


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    from ...dygraph import tracer
    from ...framework.dtype import to_torch_dtype

    def fn(lens):
        m = maxlen if maxlen is not None else int(lens.max())
        return (torch.arange(m, device=lens.device)[None, :]
                < lens[:, None]).to(to_torch_dtype(dtype))

    return tracer.trace_fn(fn, [lengths], name="sequence_mask")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, layout="bnsd",
                                 window=None):
    """Attention through the registered ``scaled_dot_product_attention``
    op (:func:`paddle_tpu_torch.kernels.attention.sdpa`): on the card the
    flash kernels, forward and backward, or a NotImplementedError naming
    what they cannot take; ``layout`` "bsnd" / "sbnd" read seq-major
    inputs in place, K/V with fewer heads select GQA, ``window`` the
    sliding causal window."""
    ins = {"Q": [query], "K": [key], "V": [value]}
    if attn_mask is not None:
        ins["Mask"] = [attn_mask]
    return _d("scaled_dot_product_attention", ins,
              {"dropout_p": dropout_p, "is_causal": is_causal,
               "is_test": not training, "layout": layout, "window": window})


def glu(x, axis=-1, name=None):
    """Parity: F.glu — a * sigmoid(b) over a split of ``axis``."""
    a, b = T.split(x, 2, axis=axis)
    return T.multiply(a, sigmoid(b))


def log_loss(input, label, epsilon=1e-4, name=None):
    """Parity: log_loss_op.cc — negative log likelihood of probabilities."""
    eps = float(epsilon)
    return T.subtract(
        T.multiply(T.scale(label, -1.0), T.log(T.scale(input, 1.0, eps))),
        T.multiply(T.scale(label, -1.0, 1.0),
                   T.log(T.scale(input, -1.0, 1.0 + eps))))


def dice_loss(input, label, epsilon=1e-5, name=None):
    """Parity: F.dice_loss — 1 - 2|X∩Y| / (|X|+|Y|)."""
    label_f = T.cast(label, input.dtype)
    if len(label_f.shape) == len(input.shape) and label_f.shape[-1] == 1:
        label_oh = one_hot(T.squeeze(T.cast(label, "int64"), [-1]),
                           input.shape[-1])
    else:
        label_oh = label_f
    reduce_dims = list(range(1, len(input.shape)))
    inter = T.sum(T.multiply(input, label_oh), axis=reduce_dims)
    union = T.sum(input, axis=reduce_dims) + T.sum(label_oh,
                                                   axis=reduce_dims)
    dice = T.divide(T.scale(inter, 2.0),
                    T.scale(union, 1.0, float(epsilon)))
    return T.mean(T.scale(dice, -1.0, 1.0))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Parity: F.npair_loss (improved deep metric learning)."""
    reg = T.scale(
        T.add(T.mean(T.sum(T.multiply(anchor, anchor), axis=1)),
              T.mean(T.sum(T.multiply(positive, positive), axis=1))),
        float(l2_reg) * 0.25)
    sim = T.matmul(anchor, positive, transpose_y=True)
    lab = T.reshape(T.cast(labels, "float32"), [-1, 1])
    tgt = T.cast(T.equal(lab, T.transpose(lab, [1, 0])), "float32")
    tgt = T.divide(tgt, T.sum(tgt, axis=1, keepdim=True))
    ce = T.mean(T.sum(
        T.multiply(T.scale(tgt, -1.0), log_softmax(sim, axis=1)), axis=1))
    return T.add(ce, reg)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """Parity: F.sigmoid_focal_loss (RetinaNet focal loss)."""
    p = sigmoid(logit)
    ce = binary_cross_entropy_with_logits(logit, label, reduction="none")
    p_t = T.add(T.multiply(p, label),
                T.multiply(T.scale(p, -1.0, 1.0), T.scale(label, -1.0, 1.0)))
    loss = T.multiply(ce, T.pow(T.scale(p_t, -1.0, 1.0), gamma))
    if alpha >= 0:
        a_t = T.add(T.scale(label, alpha),
                    T.scale(T.scale(label, -1.0, 1.0), 1.0 - alpha))
        loss = T.multiply(a_t, loss)
    if normalizer is not None:
        loss = T.divide(loss, normalizer)
    if reduction == "sum":
        return T.sum(loss)
    if reduction == "mean":
        return T.mean(loss)
    return loss


def local_response_norm(x, size=5, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """Cross-channel local response normalization."""
    from ...dygraph import tracer

    def fn(a):
        if data_format != "NCHW":
            a = torch.movedim(a, -1, 1)
        sq = torch.square(a)
        half = size // 2
        pad = [0, 0] * (a.ndim - 2) + [half, size - half - 1]
        sq = torch.nn.functional.pad(sq, pad)
        den = sum(sq[:, i:i + a.shape[1]] for i in range(size))
        out = a / torch.pow(k + alpha * den, beta)
        if data_format != "NCHW":
            out = torch.movedim(out, 1, -1)
        return out.to(a.dtype)

    return tracer.trace_fn(fn, [x], name="local_response_norm")


def bilinear(x1, x2, weight, bias=None, name=None):
    """x1 W_k x2^T for every output k."""
    from ...dygraph import tracer

    ins = [x1, x2, weight] + ([bias] if bias is not None else [])

    def fn(a, b, w, *rest):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out + rest[0] if rest else out

    return tracer.trace_fn(fn, ins, name="bilinear")


# -- resizing, patches and the vision extras ---------------------------------


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize dims 2 and 3 by the ``nearest_interp_v2`` /
    ``bilinear_interp_v2`` ops: to ``size``, else by ``scale_factor``
    (the size truncated).  As the reference's, the ops take no
    ``align_corners``, ``align_mode`` or ``data_format``: the pixels are
    half-pixel centred, and the input is NCHW."""
    attrs = {}
    if size is not None:
        attrs["out_h"], attrs["out_w"] = int(size[0]), int(size[1])
    if scale_factor is not None:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor, scale_factor])
        attrs["scale"] = [float(v) for v in sf]
        attrs.setdefault("out_h", -1)
        attrs.setdefault("out_w", -1)
    op = {"nearest": "nearest_interp_v2",
          "bilinear": "bilinear_interp_v2"}[mode]
    return _d(op, {"X": [x]}, attrs)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, name=None):
    return interpolate(x, size, scale_factor, mode, align_corners)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """[N, C * kh * kw, L] patches of an NCHW input, (c, kh, kw) order."""
    from ...dygraph import tracer

    ks, st = _many(kernel_sizes, 2), _many(strides, 2)
    pd, dl = _many(paddings, 2), _many(dilations, 2)

    def fn(a):
        return torch.nn.functional.unfold(a, ks, dilation=dl,
                                          padding=pd[:2], stride=st)

    return tracer.trace_fn(fn, [x], name="unfold")


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """(B, C * r^2, H, W) -> (B, C, H * r, W * r); NHWC reads the channels
    as (r, r, C), the reference's order."""
    from ...dygraph import tracer

    r = int(upscale_factor)

    def fn(a):
        if data_format == "NCHW":
            b, c, h, w = a.shape
            a = a.reshape(b, c // (r * r), r, r, h, w)
            return a.permute(0, 1, 4, 2, 5, 3).reshape(
                b, c // (r * r), h * r, w * r)
        b, h, w, c = a.shape
        a = a.reshape(b, h, w, r, r, c // (r * r))
        return a.permute(0, 1, 3, 2, 4, 5).reshape(b, h * r, w * r,
                                                   c // (r * r))

    return tracer.trace_fn(fn, [x], name="pixel_shuffle")


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """The last dim as the ``offset`` diagonal of a new plane at (dim1,
    dim2)."""
    from ...dygraph import tracer

    off = int(offset)

    def fn(a):
        n = a.shape[-1] + abs(off)
        base = a.new_zeros(tuple(a.shape[:-1]) + (n, n))
        idx = torch.arange(a.shape[-1], device=a.device)
        base[..., idx + max(-off, 0), idx + max(off, 0)] = a
        nd = base.ndim
        src = {dim1 % nd: nd - 2, dim2 % nd: nd - 1}
        rest = iter(range(nd - 2))
        return base.permute([src[i] if i in src else next(rest)
                             for i in range(nd)])

    return tracer.trace_fn(fn, [input], name="diag_embed")


def _keep(key, shape, device, p):
    return _random.uniform(key, shape, device) < np.float32(1.0 - p)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped values become -alpha * scale, then
    the affine map that keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    from ...dygraph import tracer

    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    key = _random.next_rng_key()

    def fn(arr):
        keep = _keep(key, arr.shape, arr.device, p)
        return (torch.where(keep, arr, torch.tensor(
            alpha_p, dtype=arr.dtype, device=arr.device)) * a + b).to(
                arr.dtype)

    return tracer.trace_fn(fn, [x], name="alpha_dropout")


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Whole channels of a 5-D input dropped, the kept ones scaled by
    1 / (1 - p)."""
    if not training or p == 0.0:
        return x
    from ...dygraph import tracer

    key = _random.next_rng_key()

    def fn(arr):
        shape = ((arr.shape[0], arr.shape[1], 1, 1, 1)
                 if data_format == "NCDHW"
                 else (arr.shape[0], 1, 1, 1, arr.shape[-1]))
        keep = _keep(key, shape, arr.device, p)
        return torch.where(keep, arr / (1.0 - p), torch.zeros(
            (), dtype=arr.dtype, device=arr.device)).to(arr.dtype)

    return tracer.trace_fn(fn, [x], name="dropout3d")


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    """TSM: of the (N * seg_num, C, H, W) frames, the first C * ratio
    channels shift one segment back in time, the next C * ratio one
    forward, zeros filling."""
    from ...dygraph import tracer

    def fn(a):
        nt, c, h, w = a.shape
        a = a.reshape(nt // seg_num, seg_num, c, h, w)
        c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
        fwd = torch.cat([a[:, 1:, :c1], torch.zeros_like(a[:, :1, :c1])],
                        dim=1)
        back = torch.cat([torch.zeros_like(a[:, :1, c1:c2]),
                          a[:, :-1, c1:c2]], dim=1)
        out = torch.cat([fwd, back, a[:, :, c2:]], dim=2)
        return out.reshape(nt, c, h, w)

    return tracer.trace_fn(fn, [x], name="temporal_shift")


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The (N, H, W, 2) sampling grid of 2 x 3 affine ``theta`` (N, 2,
    3) over [-1, 1] coordinates."""
    from ...dygraph import tracer

    oh, ow = int(out_shape[2]), int(out_shape[3])

    def fn(th):
        dev = th.device
        if align_corners:
            ys = torch.linspace(-1.0, 1.0, oh, device=dev)
            xs = torch.linspace(-1.0, 1.0, ow, device=dev)
        else:
            ys = (torch.arange(oh, device=dev) * 2 + 1) / oh - 1.0
            xs = (torch.arange(ow, device=dev) * 2 + 1) / ow - 1.0
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
        return torch.einsum("hwk,bjk->bhwj", base,
                            th.to(torch.float32)).to(th.dtype)

    return tracer.trace_fn(fn, [theta], name="affine_grid")


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """NCHW ``x`` sampled at ``grid`` (N, Hg, Wg, 2) in [-1, 1]
    coordinates, bilinear or nearest (round half to even), as the
    reference computes it: each corner's index clipped into the image, and
    with ``padding_mode="zeros"`` a corner outside it read as 0 (any other
    mode keeps the clipped pixel)."""
    from ...dygraph import tracer

    def fn(a, g):
        n, c, h, w = a.shape
        gx, gy = g[..., 0], g[..., 1]
        if align_corners:
            fx = (gx + 1.0) * (w - 1) / 2.0
            fy = (gy + 1.0) * (h - 1) / 2.0
        else:
            fx = ((gx + 1.0) * w - 1.0) / 2.0
            fy = ((gy + 1.0) * h - 1.0) / 2.0
        rows = torch.arange(n, device=a.device)[:, None, None]
        chw = a.permute(0, 2, 3, 1)

        def gather(yy, xx):
            out = chw[rows, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
            if padding_mode == "zeros":
                inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
                out = torch.where(inside[..., None], out,
                                  torch.zeros((), dtype=out.dtype,
                                              device=out.device))
            return out

        if mode == "nearest":
            out = gather(torch.round(fy).long(), torch.round(fx).long())
            return out.permute(0, 3, 1, 2).to(a.dtype)
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        wx, wy = fx - x0, fy - y0
        out = (gather(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
               + gather(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
               + gather(y0 + 1, x0) * (wy * (1 - wx))[..., None]
               + gather(y0 + 1, x0 + 1) * (wy * wx)[..., None])
        return out.permute(0, 3, 1, 2).to(a.dtype)

    return tracer.trace_fn(fn, [x, grid], name="grid_sample")


def gather_tree(ids, parents):
    """Beam search's backtrack: ``ids`` and ``parents`` (T, B, K); step t
    of the result holds the token of the beam that each final beam came
    through."""
    from ...dygraph import tracer

    def fn(tok, par):
        beams = torch.arange(tok.shape[-1], device=tok.device).expand(
            tok.shape[1:])
        outs = [None] * tok.shape[0]
        for t in range(tok.shape[0] - 1, -1, -1):
            outs[t] = torch.gather(tok[t], -1, beams)
            beams = torch.gather(par[t], -1, beams)
        return torch.stack(outs)

    return tracer.trace_fn(fn, [ids, parents], name="gather_tree")


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) as max + log1p(exp(-|a - b|)), its gradient
    exp(a - out) and exp(b - out) (the reference's): where a value at the
    -1e30 floor absorbs the log 2, both sides get 1 (torch's logaddexp
    gives 1 / (1 + exp(b - a)), 0.5)."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean"):
    """CTC by the reference's log-domain forward recursion over time.

    ``log_probs``: (T, B, C) logits (log-softmax taken here, as warpctc's
    softmax stage); ``labels``: (B, L) padded.  Impossible paths sit at
    the -1e30 floor, so an infeasible alignment gives a loss near 1e30
    (``F.ctc_loss`` gives inf), and a row's last two states are summed
    even where they are one state (a label of length 0), as the
    reference's are.  ``"mean"`` averages the losses over max(label
    length, 1)."""
    from ...dygraph import tracer

    def fn(logits, lab, in_len, lab_len):
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        tmax, b, _ = lp.shape
        s = 2 * lab.shape[1] + 1
        neg = torch.tensor(-1e30, dtype=torch.float32, device=lp.device)
        ext = torch.full((b, s), blank, dtype=lab.dtype, device=lab.device)
        ext[:, 1::2] = lab
        can_skip = torch.zeros((b, s), dtype=torch.bool, device=lab.device)
        can_skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
        alpha = neg.expand(b, s).clone()
        alpha[:, 0] = lp[0, :, blank]
        alpha[:, 1] = torch.gather(lp[0], 1, ext[:, 1:2])[:, 0]
        emit_idx = ext.long()
        for t in range(1, tmax):
            move = torch.cat([neg.expand(b, 1), alpha[:, :-1]], dim=1)
            skip = torch.cat([neg.expand(b, 2), alpha[:, :-2]], dim=1)
            skip = torch.where(can_skip, skip, neg)
            merged = _LogAddExp.apply(_LogAddExp.apply(alpha, move), skip)
            new = merged + torch.gather(lp[t], 1, emit_idx)
            alpha = torch.where((t < in_len)[:, None], new, alpha)
        last = (2 * lab_len).long()
        a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
        a_prev = torch.gather(alpha, 1, torch.clamp_min(last - 1, 0)[:, None])
        loss = -_LogAddExp.apply(a_last, a_prev[:, 0])
        if reduction == "mean":
            return torch.mean(loss / torch.clamp_min(lab_len, 1).to(
                loss.dtype))
        if reduction == "sum":
            return torch.sum(loss)
        return loss

    return tracer.trace_fn(fn, [log_probs, labels, input_lengths,
                                label_lengths], name="ctc_loss")


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree: class
    ``label`` is code ``label + num_classes``; at depth d its node is
    ``(code >> (len - d)) - 1`` and its bit ``(code >> (len - d - 1)) &
    1``; the loss is the sum of the path's logistic losses, (B, 1)."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "custom-tree hsigmoid (path_table / path_code) is not wired; "
            "the default complete binary tree is")
    from ...dygraph import tracer

    max_len = int(np.ceil(np.log2(max(num_classes, 2))))

    def fn(x, lab, w, *rest):
        code = (lab.reshape(-1) + num_classes).to(torch.int32)
        length = torch.floor(torch.log2(code.to(torch.float32))).to(
            torch.int32) + 1
        losses = torch.zeros((x.shape[0],), dtype=torch.float32,
                             device=x.device)
        zero = torch.zeros((), dtype=torch.int32, device=x.device)
        for d in range(max_len):
            valid = d < (length - 1)
            node = torch.where(valid, (code >> torch.clamp_min(
                length - 1 - d, 0)) - 1, zero).long()
            bit = torch.where(valid, (code >> torch.clamp_min(
                length - 2 - d, 0)) & 1, zero).to(x.dtype)
            logit = torch.einsum("bi,bi->b", x, w[node])
            if rest:
                logit = logit + rest[0][node]
            loss = (torch.clamp_min(logit, 0) - logit * bit
                    + torch.log1p(torch.exp(-torch.abs(logit))))
            losses = losses + torch.where(valid, loss, torch.zeros(
                (), dtype=loss.dtype, device=x.device))
        return losses[:, None]

    ins = [input, label, weight] + ([bias] if bias is not None else [])
    return tracer.trace_fn(fn, ins, name="hsigmoid_loss")


def ring_attention(query, key, value, axis="mp", is_causal=False, name=None,
                   layout="bnsd"):
    """Attention with the sequence split over the installed mesh's
    ``axis`` (:func:`paddle_tpu_torch.kernels.ring.ring_attention`): the
    K/V blocks travel the ring; inputs and output are the global (B, H,
    S, D) tensors, or (S, B, H, D) with ``layout="sbnd"``.  Without a mesh
    axis of more than one rank it is the one-device attention."""
    from ...dygraph import tracer
    from ...kernels.ring import ring_attention as _ring

    def fn(q, k, v):
        return _ring(q, k, v, axis=axis, causal=is_causal, layout=layout)

    return tracer.trace_fn(fn, [query, key, value], name="ring_attention")


def relu_(x, name=None):
    return T._inplace_apply(x, lambda a: torch.clamp_min(a, 0), (), "relu_")


def elu_(x, alpha=1.0, name=None):
    return T._inplace_apply(
        x, lambda a: torch.where(a > 0, a, alpha * (torch.exp(a) - 1)),
        (), "elu_")


def softmax_(x, axis=-1, name=None):
    return T._inplace_apply(x, lambda a: torch.softmax(a, dim=axis), (),
                            "softmax_")


def tanh_(x, name=None):
    return T.tanh_(x)

"""``paddle.nn.functional``: the functions over the ported ops.

Counterpart of ``paddle_tpu/nn/functional/__init__.py``, function for
function where the op is ported: activations, ``linear``, the 2-D convs
and pools and the 1-D forms built on them (``conv1d``,
``conv1d_transpose``, ``max_pool1d``, ``avg_pool1d``,
``adaptive_*_pool1d``), dropout, the norms, ``embedding`` / ``one_hot``,
the losses, ``pad``, ``label_smooth``, ``normalize``,
``cosine_similarity``, ``sequence_mask`` and
``scaled_dot_product_attention`` (the registered op, which on the card
launches the flash kernels).  The 3-D convs and pools, interpolate /
upsample, ``unfold``, ``pixel_shuffle``, ``affine_grid``,
``grid_sample``, ``temporal_shift``, ``ring_attention``, ``ctc_loss``,
``hsigmoid_loss``, ``gather_tree``, ``alpha_dropout`` and ``dropout3d``
wait for the 3-D ops, the interpolation ops and the extras layers
(ROADMAP A.7).
"""

from __future__ import annotations

import torch

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
    "accuracy",
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

"""Activation ops.

Counterpart of ``paddle_tpu/ops/activation_ops.py``, op for op, with
``jax.nn``'s definitions: softplus is ``logaddexp(x, 0)`` (no threshold,
and the ``beta`` / ``threshold`` attributes are not read, as the
reference's kernel reads neither), selu takes its fixed constants, gelu
is exact (erf) unless ``approximate``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op


def _unary(fn):
    def kernel(ins, attrs):
        return {"Out": fn(ins["X"])}

    return kernel


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype))


register_op("relu")(_unary(torch.relu))
register_op("relu6")(_unary(lambda x: torch.clamp(x, 0.0, 6.0)))
register_op("tanh")(_unary(torch.tanh))
register_op("sigmoid")(_unary(torch.sigmoid))
register_op("silu")(_unary(F.silu))
register_op("softplus")(_unary(_softplus))
register_op("softsign")(_unary(lambda x: x / (torch.abs(x) + 1)))
register_op("mish")(_unary(lambda x: x * torch.tanh(_softplus(x))))
register_op("logsigmoid")(_unary(lambda x: -_softplus(-x)))


@register_op("gelu")
def gelu_kernel(ins, attrs):
    return {"Out": F.gelu(ins["X"], approximate="tanh" if attrs.get(
        "approximate", False) else "none")}


@register_op("leaky_relu")
def leaky_relu_kernel(ins, attrs):
    x = ins["X"]
    alpha = attrs.get("alpha", 0.02)
    return {"Out": torch.where(x >= 0, x, alpha * x)}


@register_op("elu")
def elu_kernel(ins, attrs):
    x = ins["X"]
    alpha = attrs.get("alpha", 1.0)
    return {"Out": torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))}


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


@register_op("selu")
def selu_kernel(ins, attrs):
    x = ins["X"]
    return {"Out": _SELU_SCALE * torch.where(
        x > 0, x, _SELU_ALPHA * torch.expm1(
            torch.where(x > 0, torch.zeros_like(x), x)))}


@register_op("hard_sigmoid")
def hard_sigmoid_kernel(ins, attrs):
    slope = attrs.get("slope", 0.2)
    offset = attrs.get("offset", 0.5)
    return {"Out": torch.clamp(slope * ins["X"] + offset, 0.0, 1.0)}


@register_op("hard_swish")
def hard_swish_kernel(ins, attrs):
    threshold = attrs.get("threshold", 6.0)
    scale = attrs.get("scale", 6.0)
    offset = attrs.get("offset", 3.0)
    x = ins["X"]
    return {"Out": x * torch.clamp(x + offset, 0.0, threshold) / scale}


@register_op("hard_tanh")
def hard_tanh_kernel(ins, attrs):
    return {"Out": torch.clamp(ins["X"], attrs.get("t_min", -1.0),
                               attrs.get("t_max", 1.0))}


@register_op("swish")
def swish_kernel(ins, attrs):
    x = ins["X"]
    return {"Out": x * torch.sigmoid(attrs.get("beta", 1.0) * x)}


@register_op("softmax")
def softmax_kernel(ins, attrs):
    return {"Out": torch.softmax(ins["X"], dim=attrs.get("axis", -1))}


@register_op("log_softmax")
def log_softmax_kernel(ins, attrs):
    return {"Out": torch.log_softmax(ins["X"], dim=attrs.get("axis", -1))}


@register_op("prelu")
def prelu_kernel(ins, attrs):
    x, alpha = ins["X"], ins["Alpha"]
    if attrs.get("mode", "all") == "channel" and x.ndim == 4:
        alpha = alpha.reshape(1, -1, 1, 1)
    return {"Out": torch.where(x > 0, x, alpha * x)}


@register_op("hardshrink")
def hardshrink_kernel(ins, attrs):
    x = ins["X"]
    t = attrs.get("threshold", 0.5)
    return {"Out": torch.where(torch.abs(x) > t, x, torch.zeros_like(x))}


@register_op("softshrink")
def softshrink_kernel(ins, attrs):
    lam = attrs.get("lambda", 0.5)
    x = ins["X"]
    return {"Out": torch.where(x > lam, x - lam, torch.where(
        x < -lam, x + lam, torch.zeros_like(x)))}


@register_op("tanhshrink")
def tanhshrink_kernel(ins, attrs):
    x = ins["X"]
    return {"Out": x - torch.tanh(x)}


@register_op("thresholded_relu")
def thresholded_relu_kernel(ins, attrs):
    x = ins["X"]
    return {"Out": torch.where(x > attrs.get("threshold", 1.0), x,
                               torch.zeros_like(x))}

"""``paddle.nn.quant``: binary ops as layers, and the quantization
surface.

Counterpart of ``paddle_tpu/nn/quant/__init__.py``: ``FloatFunctionalLayer``
wraps an elementwise op so quantization-aware training can wrap it like
any layer; the QAT and PTQ wrappers come from
:mod:`paddle_tpu_torch.incubate.quant` and the int8 weight helpers from
:mod:`paddle_tpu_torch.ops.quant_ops`.
"""

from ...incubate.quant import (  # noqa: F401
    ImperativePTQ, ImperativeQuantAware, QuantizedConv2D, QuantizedLinear,
)
from ...ops.quant_ops import quantize_per_channel, w8a8_apply  # noqa: F401
from ..layer_base import Layer
from ... import tensor_api as T

__all__ = ["FloatFunctionalLayer", "add", "subtract", "multiply", "divide",
           "ImperativeQuantAware", "ImperativePTQ", "QuantizedLinear",
           "QuantizedConv2D", "quantize_per_channel", "w8a8_apply"]


class FloatFunctionalLayer(Layer):
    """A binary op as a layer."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, x, y):
        return self._fn(x, y)


def add():
    return FloatFunctionalLayer(T.add)


def subtract():
    return FloatFunctionalLayer(T.subtract)


def multiply():
    return FloatFunctionalLayer(T.multiply)


def divide():
    return FloatFunctionalLayer(T.divide)

"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``)."""

from __future__ import annotations

from ..layer_base import Layer
from .. import functional as F


def _act_layer(name, fn, **defaults):
    class _Act(Layer):
        def __init__(self, **kw):
            super().__init__()
            self._kw = {**defaults, **{k: v for k, v in kw.items() if k != "name"}}

        def forward(self, x):
            return fn(x, **self._kw)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
GELU = _act_layer("GELU", F.gelu)
SiLU = _act_layer("SiLU", F.silu)
Swish = _act_layer("Swish", F.swish)
Mish = _act_layer("Mish", F.mish)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
Hardtanh = _act_layer("Hardtanh", F.hardtanh)
Hardshrink = _act_layer("Hardshrink", F.hardshrink)
Softshrink = _act_layer("Softshrink", F.softshrink)
Softplus = _act_layer("Softplus", F.softplus)
Softsign = _act_layer("Softsign", F.softsign)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
ThresholdedReLU = _act_layer("ThresholdedReLU", F.thresholded_relu)
LogSigmoid = _act_layer("LogSigmoid", F.log_sigmoid)
ELU = _act_layer("ELU", F.elu)
SELU = _act_layer("SELU", F.selu)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        from ..initializer import Constant

        self.weight = self.create_parameter(
            shape=[num_parameters], attr=weight_attr,
            default_initializer=Constant(init),
        )

    def forward(self, x):
        return F.prelu(x, self.weight)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)

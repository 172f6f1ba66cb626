"""Conv layers: ``Conv2D``, ``Conv2DTranspose`` and ``Conv1D``.

Counterpart of ``paddle_tpu/nn/layer/conv.py``: the same parameters, named
and initialised as the reference's (``Conv2D``'s weight by
``KaimingUniform`` over its fan-in, the bias by the default bias
initializer unless ``bias_attr=False``).
"""

from __future__ import annotations

from ..layer_base import Layer
from .. import functional as F
from ..initializer import KaimingUniform


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride = _pair(stride)
        self._padding = padding
        self._dilation = _pair(dilation)
        self._groups = groups
        self._data_format = data_format
        filter_shape = [out_channels, in_channels // groups] + self._kernel_size
        fan_in = (in_channels // groups) * self._kernel_size[0] * self._kernel_size[1]
        self.weight = self.create_parameter(
            shape=filter_shape, attr=weight_attr,
            default_initializer=KaimingUniform(fan_in=fan_in),
        )
        self.bias = self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True
        )

    def forward(self, x):
        return F.conv2d(
            x, self.weight, self.bias, stride=self._stride, padding=self._padding,
            dilation=self._dilation, groups=self._groups, data_format=self._data_format,
        )

    def extra_repr(self):
        return (
            f"{self._in_channels}, {self._out_channels}, "
            f"kernel_size={self._kernel_size}, stride={self._stride}"
        )


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        self._stride = _pair(stride)
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = _pair(dilation)
        self._groups = groups
        ks = _pair(kernel_size)
        self.weight = self.create_parameter(
            shape=[in_channels, out_channels // groups] + ks, attr=weight_attr,
        )
        self.bias = self.create_parameter(shape=[out_channels], attr=bias_attr, is_bias=True)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, stride=self._stride, padding=self._padding,
            output_padding=self._output_padding if output_size is None else 0,
            dilation=self._dilation, groups=self._groups, output_size=output_size,
        )


class Conv1D(Layer):
    """1-D conv as a 2-D conv over a singleton height."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__()
        self._stride = stride if isinstance(stride, int) else stride[0]
        self._padding = padding if isinstance(padding, int) else padding[0]
        self._dilation = dilation if isinstance(dilation, int) else dilation[0]
        self._groups = groups
        k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups, 1, k], attr=weight_attr,
        )
        self.bias = self.create_parameter(shape=[out_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        from ... import tensor_api as T

        x4 = T.unsqueeze(x, axis=[2])  # NCL -> NC1L
        out = F.conv2d(
            x4, self.weight, self.bias, stride=[1, self._stride],
            padding=[0, self._padding], dilation=[1, self._dilation], groups=self._groups,
        )
        return T.squeeze(out, axis=[2])

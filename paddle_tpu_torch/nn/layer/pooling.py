"""Pooling layers: ``MaxPool2D``, ``AvgPool2D``, ``AdaptiveAvgPool2D``,
``AdaptiveMaxPool2D``, ``MaxPool1D`` and ``AvgPool1D``.

Counterpart of ``paddle_tpu/nn/layer/pooling.py``, class for class.
"""

from __future__ import annotations

from ..layer_base import Layer
from .. import functional as F


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, return_mask=self.return_mask,
                            data_format=self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            data_format=self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     data_format=self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size,
                                     return_mask=self.return_mask,
                                     data_format=self.data_format)


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride or kernel_size
        self.padding = padding

    def forward(self, x):
        from ... import tensor_api as T

        x4 = T.unsqueeze(x, axis=[2])
        out = F.max_pool2d(x4, [1, self.kernel_size], [1, self.stride], [0, self.padding])
        return T.squeeze(out, axis=[2])


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride or kernel_size
        self.padding = padding

    def forward(self, x):
        from ... import tensor_api as T

        x4 = T.unsqueeze(x, axis=[2])
        out = F.avg_pool2d(x4, [1, self.kernel_size], [1, self.stride], [0, self.padding])
        return T.squeeze(out, axis=[2])

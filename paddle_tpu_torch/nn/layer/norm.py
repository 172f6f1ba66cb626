"""Normalization layers: BatchNorm (1D/2D/3D, SyncBatchNorm), LayerNorm,
GroupNorm, InstanceNorm, LocalResponseNorm.

Counterpart of ``paddle_tpu/nn/layer/norm.py``.  BatchNorm's running
statistics are the op's MeanOut / VarianceOut; a training forward
rebinds the layer's buffers to them (in static mode the op writes them
back to the same persistable Variables).  Under a data-parallel group (the
installed mesh's dp x sharding axes, as ``DataParallel`` and
``fleet.distributed_model`` train) every ``BatchNorm*`` and
``SyncBatchNorm`` normalises by the global batch's statistics, as the
reference's BatchNorm over its sharded global batch does: the op
all-reduces them (``ops/nn_ops.py``).
"""

from __future__ import annotations

import numpy as np

from ...framework import program as fw
from ...ops.dispatch import dispatch
from ..layer_base import Layer
from ..initializer import Constant
from .. import functional as F


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = "NHWC" if data_format in ("NHWC", "NLC", "NDHWC") else "NCHW"
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            shape=[num_features], attr=weight_attr, default_initializer=Constant(1.0)
        )
        self.bias = self.create_parameter(shape=[num_features], attr=bias_attr, is_bias=True)
        if fw.in_dygraph_mode():
            from ...dygraph.tensor import Tensor

            self.register_buffer("_mean", Tensor(np.zeros(num_features,
                                                          "float32")))
            self.register_buffer("_variance", Tensor(np.ones(num_features,
                                                             "float32")))
            return
        blk = fw.default_main_program().global_block()
        self._mean = blk.create_var(
            name=self.full_name() + ".mean", shape=(num_features,),
            dtype="float32", persistable=True, stop_gradient=True)
        self._variance = blk.create_var(
            name=self.full_name() + ".variance", shape=(num_features,),
            dtype="float32", persistable=True, stop_gradient=True)
        sb = fw.default_startup_program().global_block()
        for var, val in ((self._mean, 0.0), (self._variance, 1.0)):
            sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                          persistable=True)
            sb.append_op(type="fill_constant", inputs={},
                         outputs={"Out": [var.name]},
                         attrs={"shape": [num_features], "value": val,
                                "dtype": "float32"})

    def forward(self, x):
        training = self.training and not (self._use_global_stats or False)
        ins = {"X": [x], "Scale": [self.weight], "Bias": [self.bias],
               "Mean": [self._mean], "Variance": [self._variance]}
        attrs = {"momentum": self._momentum, "epsilon": self._epsilon,
                 "is_test": not training, "data_layout": self._data_format,
                 "use_global_stats": bool(self._use_global_stats)
                 if self._use_global_stats is not None else False}
        if fw.in_dygraph_mode():
            outs = dispatch("batch_norm", ins, attrs)
            if training:
                # the running statistics, rebound (a functional update)
                self._buffers["_mean"] = outs["MeanOut"][0].detach()
                self._buffers["_variance"] = outs["VarianceOut"][0].detach()
            return outs["Y"][0]
        # static: MeanOut / VarianceOut write the same persistable vars
        from ...framework import unique_name
        from ...ops.dispatch import dispatch_static

        blk = fw.default_main_program().current_block()
        y = blk.create_var(name=unique_name.generate(self.full_name() + ".out"))
        sm = blk.create_var(name=unique_name.generate(
            self.full_name() + ".saved_mean"), stop_gradient=True)
        sv = blk.create_var(name=unique_name.generate(
            self.full_name() + ".saved_var"), stop_gradient=True)
        outs = dispatch_static(
            "batch_norm", ins, attrs,
            outputs={"Y": [y], "MeanOut": [self._mean],
                     "VarianceOut": [self._variance],
                     "SavedMean": [sm], "SavedVariance": [sv]})
        return outs["Y"][0]

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm (act attr) — kept for reference model parity."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=False, **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr, bias_attr,
                         data_layout, use_global_stats)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            from ...ops.dispatch import dispatch as _dd, single as _s

            out = _s(_dd(self._act, {"X": [out]}, {}))
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm whose statistics span the data-parallel ranks: it
    computes as ``BatchNorm`` does, which under a data-parallel group
    all-reduces its statistics and its backward's sums over the group
    (on one rank, the rank's own)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        # structural conversion: BatchNorm* -> SyncBatchNorm
        for name, sub in list(layer._sub_layers.items()):
            layer._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            new = SyncBatchNorm(layer._num_features, layer._momentum, layer._epsilon)
            new.weight = layer.weight
            new.bias = layer.bias
            new._buffers = layer._buffers
            return new
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=self._normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0),
        )
        self.bias = self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True
        )

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=[num_channels], attr=weight_attr, default_initializer=Constant(1.0)
        )
        self.bias = self.create_parameter(shape=[num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias, self._epsilon)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=[num_features], attr=weight_attr, default_initializer=Constant(1.0)
        )
        self.bias = self.create_parameter(shape=[num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)

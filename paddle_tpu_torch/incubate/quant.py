"""Imperative quantization: quantization-aware training and
post-training quantization.

Counterpart of ``paddle_tpu/incubate/quant.py``.
:class:`ImperativeQuantAware` wraps each Linear / Conv2D in a layer that
fake-quantizes its weight (channel-wise abs-max for Linear, abs-max for
Conv2D) and its input activation (moving-average abs-max, whose scale and
two accumulators are persistable buffers, so the trained scale goes
through ``state_dict``); the fake-quant ops (registered in
:mod:`paddle_tpu_torch.ops.quant_ops`) have straight-through gradients.
:class:`ImperativePTQ` calibrates with forward passes only (an abs-max or
a mean-of-abs-max observer a layer) and then swaps in those wrappers with
the calibrated scale, frozen (eval).  The int8 program rewrite reads the
frozen scales of a saved model.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import nn

__all__ = ["ImperativeQuantAware", "ImperativePTQ", "QuantizedLinear",
           "QuantizedConv2D"]


def _fake_quant(x, kind: str, bits: int, layer, state_name: str,
                moving_rate: float = 0.9):
    from ..dygraph.tensor import Tensor
    from ..framework import program as fw
    from ..ops.dispatch import dispatch

    ndim = len(x.shape)
    if kind == "channel":
        outs = dispatch(
            "fake_channel_wise_quantize_dequantize_abs_max", {"X": [x]},
            {"bit_length": bits, "quant_axis": ndim - 1})
        return outs["Out"][0]
    if kind == "abs_max":
        outs = dispatch(
            "fake_quantize_dequantize_abs_max", {"X": [x]},
            {"bit_length": bits})
        return outs["Out"][0]
    # moving-average activation quant: the scale is a persistable BUFFER so
    # the trained value round-trips through state_dict (a plain attribute
    # would silently drop it on save/load)
    scale = getattr(layer, state_name, None)
    if scale is None:
        if not fw.in_dygraph_mode():
            raise RuntimeError(
                "fake-quant scale buffer missing under a static trace — "
                "calibrate/train the quantized model eagerly before "
                "jit.save / to_static")
        scale = Tensor(np.asarray([float(np.abs(x.numpy()).max() or 1.0)],
                                  "float32"), stop_gradient=True)
        layer.register_buffer(state_name, scale)
        # accumulation states for the reference moving-average recurrence
        # (state_t = rate*state + 1, accum_t = rate*accum + cur,
        # scale = accum/state); starting both at 0 makes the first scale
        # exactly the first batch's abs-max — no warm-up bias
        layer.register_buffer(state_name + "_state", Tensor(
            np.zeros((1,), "float32"), stop_gradient=True))
        layer.register_buffer(state_name + "_accum", Tensor(
            np.zeros((1,), "float32"), stop_gradient=True))
    sc_in = scale
    if not fw.in_dygraph_mode():
        # static trace: address the buffer through its bound program var
        # (jit._bind_params created it and pushed the value to the scope)
        blk = fw.default_main_program().global_block()
        v = blk.vars.get(scale.name)
        if v is None:
            v = blk.create_var(name=scale.name, shape=(1,),
                               dtype="float32", persistable=True)
        sc_in = v
    ins = {"X": [x], "InScale": [sc_in]}
    state = getattr(layer, state_name + "_state", None)
    accum = getattr(layer, state_name + "_accum", None)
    training = layer.training and fw.in_dygraph_mode()
    if training and state is not None and accum is not None:
        # thread the accumulators so the kernel runs the stateful
        # (bias-corrected) recurrence instead of the legacy one-buffer EMA
        ins["InState"] = [state]
        ins["InAccum"] = [accum]
    outs = dispatch(
        "fake_quantize_dequantize_moving_average_abs_max", ins,
        {"bit_length": bits, "moving_rate": moving_rate,
         "is_test": not layer.training})
    if training:
        # new values, not writes into the old ones (which the op's backward
        # keeps)
        scale._t = outs["OutScale"][0]._t.detach()
        if "OutState" in outs:
            state._t = outs["OutState"][0]._t.detach()
            accum._t = outs["OutAccum"][0]._t.detach()
    return outs["Out"][0]


class QuantizedLinear(nn.Layer):
    """Linear with channel-wise weight fake-quant and moving-average
    activation fake-quant."""

    def __init__(self, inner, weight_bits=8, activation_bits=8,
                 moving_rate=0.9):
        super().__init__()
        self.inner = inner
        self._wbits, self._abits = weight_bits, activation_bits
        self._rate = moving_rate

    def forward(self, x):
        from ..nn import functional as F
        from .. import tensor_api as T

        xq = _fake_quant(x, "moving", self._abits, self, "_in_scale",
                         self._rate)
        wq = _fake_quant(self.inner.weight, "channel", self._wbits, self,
                         "_w_scale")
        out = T.matmul(xq, wq)
        if self.inner.bias is not None:
            out = T.add(out, self.inner.bias)
        return out


class QuantizedConv2D(nn.Layer):
    def __init__(self, inner, weight_bits=8, activation_bits=8,
                 moving_rate=0.9):
        super().__init__()
        self.inner = inner
        self._wbits, self._abits = weight_bits, activation_bits
        self._rate = moving_rate

    def forward(self, x):
        from ..ops.dispatch import dispatch

        xq = _fake_quant(x, "moving", self._abits, self, "_in_scale",
                         self._rate)
        wq = _fake_quant(self.inner.weight, "abs_max", self._wbits, self,
                         "_w_scale")
        pad = self.inner._padding
        pad = [pad, pad] if isinstance(pad, int) else list(pad)
        attrs = {"strides": list(self.inner._stride),
                 "paddings": pad,
                 "dilations": list(self.inner._dilation),
                 "groups": self.inner._groups}
        outs = dispatch("conv2d", {"Input": [xq], "Filter": [wq]}, attrs)
        out = outs["Output"][0]
        if self.inner.bias is not None:
            from .. import tensor_api as T

            b = self.inner.bias
            out = T.add(out, T.reshape(b, [1, -1, 1, 1]))
        return out


_WRAPPERS = {"Linear": QuantizedLinear, "Conv2D": QuantizedConv2D}


class ImperativeQuantAware:
    """Quantization-aware training: each quantizable sub-layer replaced by
    its fake-quant wrapper, in place."""

    def __init__(self, quantizable_layer_type: List[str] = ("Linear",
                                                            "Conv2D"),
                 weight_bits: int = 8, activation_bits: int = 8,
                 moving_rate: float = 0.9, **kw):
        self._types = tuple(quantizable_layer_type)
        self._wbits = weight_bits
        self._abits = activation_bits
        self._rate = moving_rate

    def quantize(self, model: nn.Layer) -> nn.Layer:
        """Replace every quantizable sublayer with its fake-quant wrapper
        (in place, like the reference)."""
        for name, sub in list(model._sub_layers.items()):
            cls = type(sub).__name__
            if cls in self._types and cls in _WRAPPERS:
                model._sub_layers[name] = _WRAPPERS[cls](
                    sub, self._wbits, self._abits, self._rate)
            else:
                self.quantize(sub)
        return model


# ---------------------------------------------------------------------------
# Post-training quantization (PTQ)
# ---------------------------------------------------------------------------


class _AbsMaxObserver:
    """Running abs-max over calibration batches."""

    def __init__(self):
        self.scale = 0.0

    def update(self, arr):
        m = float(np.abs(np.asarray(arr)).max()) if arr.size else 0.0
        self.scale = max(self.scale, m)


class _AvgAbsMaxObserver(_AbsMaxObserver):
    """Mean of per-batch abs-max (smoother than the global max when
    calibration data has outliers)."""

    def __init__(self):
        self.scale = 0.0
        self._n = 0

    def update(self, arr):
        m = float(np.abs(np.asarray(arr)).max()) if arr.size else 0.0
        self._n += 1
        self.scale += (m - self.scale) / self._n


_PTQ_OBSERVERS = {"abs_max": _AbsMaxObserver, "avg_abs_max": _AvgAbsMaxObserver}


class _ObservedLayer(nn.Layer):
    """Pass-through wrapper recording input-activation statistics."""

    def __init__(self, inner, observer_cls):
        super().__init__()
        self.inner = inner
        self.observer = observer_cls()

    def forward(self, *args, **kw):
        if args:
            self.observer.update(args[0].numpy())
        return self.inner(*args, **kw)


class ImperativePTQ:
    """Post-training quantization: calibrate with forward passes only, then
    freeze the fake-quant scales (no training).  Flow::

        ptq = ImperativePTQ(algo="avg_abs_max")
        model = ptq.quantize(model)
        for batch in calib_loader: model(batch)     # calibration
        model = ptq.convert(model)                  # frozen fake-quant

    After ``convert`` each Linear/Conv2D runs with the calibrated
    activation scale (moving-average kernel in is_test mode) and
    channel-wise weight fake-quant — the same inference math QAT produces,
    minus the fine-tuning.
    """

    def __init__(self, quantizable_layer_type: List[str] = ("Linear",
                                                            "Conv2D"),
                 algo: str = "avg_abs_max", weight_bits: int = 8,
                 activation_bits: int = 8):
        if algo not in _PTQ_OBSERVERS:
            raise ValueError(
                f"algo must be one of {sorted(_PTQ_OBSERVERS)}, got {algo!r}")
        self._types = tuple(quantizable_layer_type)
        self._observer = _PTQ_OBSERVERS[algo]
        self._wbits = weight_bits
        self._abits = activation_bits

    def quantize(self, model: nn.Layer) -> nn.Layer:
        for name, sub in list(model._sub_layers.items()):
            cls = type(sub).__name__
            if cls in self._types and cls in _WRAPPERS:
                model._sub_layers[name] = _ObservedLayer(sub, self._observer)
            else:
                self.quantize(sub)
        return model

    def convert(self, model: nn.Layer) -> nn.Layer:
        """Swap observers for fake-quant wrappers seeded with the calibrated
        scales; the returned model is inference-ready (call ``.eval()``)."""
        from ..dygraph.tensor import Tensor

        for name, sub in list(model._sub_layers.items()):
            if isinstance(sub, _ObservedLayer):
                wrapped = _WRAPPERS[type(sub.inner).__name__](
                    sub.inner, self._wbits, self._abits)
                scale = sub.observer.scale or 1.0
                wrapped.register_buffer("_in_scale", Tensor(
                    np.asarray([scale], "float32"), stop_gradient=True))
                # frozen calibration: eval mode keeps the moving-average
                # kernel in is_test so a forward pass can never drift the
                # calibrated scale (reference PTQ emits frozen scales)
                wrapped.eval()
                model._sub_layers[name] = wrapped
            else:
                self.convert(sub)
        return model

"""Parameter initializers.

Counterpart of ``paddle_tpu/nn/initializer/__init__.py`` (Constant,
Uniform, Normal, TruncatedNormal, Xavier, Kaiming / MSRA, Assign,
``calculate_gain``, ``set_global_initializer``).  An initializer names
the creation op and attributes it runs (``_op``); in dygraph mode it
runs that op eagerly with the next key of the seed chain (every
initializer takes one, as the reference's do, so the chain advances
alike).  Appending the op to a startup program waits for graph mode
(ROADMAP A.10).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ...framework.dtype import convert_dtype, to_torch_dtype

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "calculate_gain", "set_global_initializer",
]


def calculate_gain(nonlinearity: str, param=None) -> float:
    gains = {
        "sigmoid": 1.0,
        "linear": 1.0,
        "conv1d": 1.0,
        "conv2d": 1.0,
        "conv3d": 1.0,
        "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains.get(nonlinearity, 1.0)


def _fan_in_out(shape: Sequence[int]):
    """Parity: ``_compute_fans`` in the reference's fluid/initializer.py —
    FC weights are [in, out]; conv kernels are [out_c, in_c, kh, kw], so for
    rank>2 fan_in uses shape[1] (input channels) times the receptive field."""
    shape = list(shape)
    if len(shape) < 2:
        fan_in = fan_out = shape[0] if shape else 1
    elif len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    else:
        receptive = 1
        for s in shape[2:]:
            receptive *= s
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    return fan_in, fan_out


class Initializer:
    """Base. Subclasses define ``_op`` returning (op_type, attrs) or override
    the whole __call__."""

    def _op(self, shape, dtype):
        raise NotImplementedError

    def apply_dygraph(self, shape, dtype):
        """The initial value as a torch tensor on the current device."""
        from ...dygraph import tracer

        op_type, attrs = self._op(tuple(shape), convert_dtype(dtype))
        return tracer.run_eager_kernel(op_type, {}, attrs,
                                       rng=_init_rng())["Out"][0]

    def __call__(self, param, block=None):
        """Re-initialize ``param`` (a Tensor) in place."""
        param.set_value(self.apply_dygraph(param.shape, param.dtype))
        return param


def _init_rng():
    from ...framework.random import next_rng_key

    return next_rng_key()


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def _op(self, shape, dtype):
        return "fill_constant", {"shape": list(shape), "value": self.value, "dtype": dtype}


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0, seed: int = 0):
        self.mean, self.std = mean, std

    def _op(self, shape, dtype):
        return "gaussian_random", {
            "shape": list(shape), "mean": self.mean, "std": self.std, "dtype": dtype,
        }


class TruncatedNormal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def _op(self, shape, dtype):
        return "truncated_gaussian_random", {
            "shape": list(shape), "mean": self.mean, "std": self.std, "dtype": dtype,
        }


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def _op(self, shape, dtype):
        return "uniform_random", {
            "shape": list(shape), "min": self.low, "max": self.high, "dtype": dtype,
        }


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _op(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return "uniform_random", {
            "shape": list(shape), "min": -limit, "max": limit, "dtype": dtype,
        }


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _op(self, shape, dtype):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return "gaussian_random", {
            "shape": list(shape), "mean": 0.0, "std": std, "dtype": dtype,
        }


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.gain = calculate_gain(nonlinearity, negative_slope)

    def _op(self, shape, dtype):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        limit = self.gain * math.sqrt(3.0 / fi)
        return "uniform_random", {
            "shape": list(shape), "min": -limit, "max": limit, "dtype": dtype,
        }


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.gain = calculate_gain(nonlinearity, negative_slope)

    def _op(self, shape, dtype):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        std = self.gain / math.sqrt(fi)
        return "gaussian_random", {
            "shape": list(shape), "mean": 0.0, "std": std, "dtype": dtype,
        }


class Assign(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def apply_dygraph(self, shape, dtype):
        import torch

        from ...framework.place import current_device

        return torch.as_tensor(self.value, dtype=to_torch_dtype(dtype),
                               device=current_device()).reshape(shape)


# aliases matching reference naming (initializer.py MSRAInitializer etc.)
MSRA = KaimingNormal


# ---------------------------------------------------------------------------
# global default initializers
# ---------------------------------------------------------------------------

_global_weight_initializer: Optional[Initializer] = None
_global_bias_initializer: Optional[Initializer] = None


def set_global_initializer(weight_init, bias_init=None):
    """Parity: ``paddle.nn.initializer.set_global_initializer``
    (reference ``fluid/initializer.py:set_global_initializer``) — default
    initializers for parameters created AFTER this call whose attr does not
    pin one.  Pass ``None`` to restore the built-in defaults."""
    global _global_weight_initializer, _global_bias_initializer
    _global_weight_initializer = weight_init
    _global_bias_initializer = bias_init


def _global_initializer(is_bias: bool):
    return _global_bias_initializer if is_bias else _global_weight_initializer

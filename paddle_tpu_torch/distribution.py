"""Probability distributions: ``paddle.distribution``.

Counterpart of ``paddle_tpu/distribution.py``, after the reference's
``distribution.py`` (``Distribution``, ``Uniform``, ``Normal``,
``Categorical``).  The densities, entropies and divergences are tensor
functions of :mod:`paddle_tpu_torch.tensor_api`, so they run in dygraph
and in static programs and differentiate through the tape.

Sampling: ``Uniform.sample(shape, seed)`` and ``Normal.sample(shape,
seed)`` draw from a ``torch.Generator`` seeded with ``seed`` on the
parameters' device when ``seed`` is not 0 (two draws of one seed are
equal), and from the port's seed chain (the registered ``uniform_random``
/ ``gaussian_random`` ops) when it is 0, as in a static program.
``Categorical.sample`` draws through the registered ``multinomial`` op,
so ``paddle.seed`` fixes it.  The draws are torch's, not the JAX
package's bits.

The reference's conventions, kept:
  * ``Categorical`` takes unnormalised non-negative weights;
    ``probs`` / ``log_prob`` divide by their plain sum, while ``entropy``
    / ``kl_divergence`` take the softmax of them;
  * ``Uniform.log_prob`` is ``-inf`` outside the open interval
    (``log(0)``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Distribution", "Uniform", "Normal", "Categorical"]


def _is_tensor(v):
    from .dygraph.tensor import Tensor
    from .framework.program import Variable

    return isinstance(v, (Tensor, Variable))


def _seeded(draw, shape, seed, like):
    """``draw`` (``torch.rand`` / ``torch.randn``) of ``shape`` in
    ``like``'s dtype and on its device, from a ``torch.Generator`` seeded
    with ``seed``; None when ``seed`` is 0 or ``like`` is a static
    Variable (the caller then draws from the seed chain)."""
    from .dygraph.tensor import Tensor

    if not seed or not isinstance(like, Tensor):
        return None
    t = like._t
    gen = torch.Generator(device=t.device).manual_seed(int(seed))
    return Tensor._wrap(draw(tuple(shape), generator=gen, dtype=t.dtype,
                             device=t.device))


def _to_tensor_pair(*args):
    """The reference's ``Distribution._to_tensor``: numbers, lists and
    arrays become float32 tensors (``assign``, which in a static program
    records a constant)."""
    from . import tensor_api as T

    arrays = []
    for a in args:
        if _is_tensor(a):
            arrays.append(a)
        else:
            host = np.asarray(a, dtype="float32")
            if host.ndim == 0:
                host = host.reshape(1)
            arrays.append(T.assign(host))
    return arrays


class Distribution:
    """The abstract base."""

    def __init__(self):
        super().__init__()

    def sample(self):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        raise NotImplementedError

    def _validate_args(self, *args):
        """True when every argument is a tensor; tensors mixed with host
        values raise."""
        is_variable = False
        is_number = False
        for arg in args:
            if _is_tensor(arg):
                is_variable = True
            else:
                is_number = True
        if is_variable and is_number:
            raise ValueError(
                "if one argument is Tensor, all arguments should be Tensor")
        return is_variable

    def _check_values_dtype_in_probs(self, param, value):
        """``value`` as a tensor of the parameter's dtype."""
        from . import tensor_api as T

        if not _is_tensor(value):
            value = T.assign(np.asarray(value))
        pd = str(getattr(param, "dtype", "float32"))
        vd = str(value.dtype)
        if pd != vd:
            return T.cast(value, pd)
        return value


class Uniform(Distribution):
    """U(low, high) with broadcastable batch parameters."""

    def __init__(self, low, high, name=None):
        super().__init__()
        self.name = name if name is not None else "Uniform"
        self.all_arg_is_float = False
        if isinstance(low, int):
            low = float(low)
        if isinstance(high, int):
            high = float(high)
        if not self._validate_args(low, high):
            if isinstance(low, float) and isinstance(high, float):
                self.all_arg_is_float = True
            low, high = _to_tensor_pair(low, high)
        self.low, self.high = low, high
        self.dtype = str(self.low.dtype)

    def sample(self, shape, seed=0):
        from . import tensor_api as T

        batch_shape = list((self.low + self.high).shape)
        output_shape = list(shape) + batch_shape
        u = _seeded(torch.rand, output_shape, seed, self.low)
        if u is None:
            u = T.uniform(output_shape, dtype=self.dtype, min=0.0, max=1.0,
                          seed=seed)
        out = self.low + u * (self.high - self.low)
        if self.all_arg_is_float:
            return T.reshape(out, list(shape))
        return out

    def log_prob(self, value):
        from . import tensor_api as T

        value = self._check_values_dtype_in_probs(self.low, value)
        lb = T.cast(self.low < value, str(value.dtype))
        ub = T.cast(value < self.high, str(value.dtype))
        return T.log(lb * ub) - T.log(self.high - self.low)

    def probs(self, value):
        from . import tensor_api as T

        value = self._check_values_dtype_in_probs(self.low, value)
        lb = T.cast(self.low < value, str(value.dtype))
        ub = T.cast(value < self.high, str(value.dtype))
        return (lb * ub) / (self.high - self.low)

    def entropy(self):
        from . import tensor_api as T

        return T.log(self.high - self.low)


class Normal(Distribution):
    """N(loc, scale^2)."""

    def __init__(self, loc, scale, name=None):
        super().__init__()
        self.name = name if name is not None else "Normal"
        self.all_arg_is_float = False
        if isinstance(loc, int):
            loc = float(loc)
        if isinstance(scale, int):
            scale = float(scale)
        if not self._validate_args(loc, scale):
            if isinstance(loc, float) and isinstance(scale, float):
                self.all_arg_is_float = True
            loc, scale = _to_tensor_pair(loc, scale)
        self.loc, self.scale = loc, scale
        self.dtype = str(self.loc.dtype)

    def sample(self, shape, seed=0):
        from . import tensor_api as T

        batch_shape = list((self.loc + self.scale).shape)
        output_shape = list(shape) + batch_shape
        eps = _seeded(torch.randn, output_shape, seed, self.loc)
        if eps is None:
            eps = T.randn(output_shape, dtype=self.dtype)
        out = self.loc + eps * self.scale
        if self.all_arg_is_float:
            return T.reshape(out, list(shape))
        return out

    def entropy(self):
        from . import tensor_api as T

        # 0.5 + 0.5 log(2 pi) + log(scale), broadcast to the batch shape
        zero = (self.loc + self.scale) * 0.0
        return 0.5 + zero + (0.5 * math.log(2.0 * math.pi)
                             + T.log(self.scale + zero * 0.0))

    def log_prob(self, value):
        from . import tensor_api as T

        value = self._check_values_dtype_in_probs(self.loc, value)
        var = self.scale * self.scale
        log_scale = T.log(self.scale)
        return (-1.0 * ((value - self.loc) * (value - self.loc)) / (2.0 * var)
                - log_scale - math.log(math.sqrt(2.0 * math.pi)))

    def probs(self, value):
        from . import tensor_api as T

        value = self._check_values_dtype_in_probs(self.loc, value)
        var = self.scale * self.scale
        return (T.exp(-1.0 * ((value - self.loc) * (value - self.loc))
                      / (2.0 * var))
                / (math.sqrt(2.0 * math.pi) * self.scale))

    def kl_divergence(self, other):
        from . import tensor_api as T

        if not isinstance(other, Normal):
            raise TypeError(
                f"kl_divergence expects Normal, got {type(other).__name__}")
        var_ratio = self.scale / other.scale
        var_ratio = var_ratio * var_ratio
        t1 = (self.loc - other.loc) / other.scale
        t1 = t1 * t1
        return 0.5 * var_ratio + 0.5 * (t1 - 1.0 - T.log(var_ratio))


class Categorical(Distribution):
    """Categorical over unnormalised non-negative weights."""

    def __init__(self, logits, name=None):
        super().__init__()
        self.name = name if name is not None else "Categorical"
        if not self._validate_args(logits):
            (logits,) = _to_tensor_pair(logits)
        self.logits = logits
        self.dtype = str(self.logits.dtype)

    def sample(self, shape):
        """Index draws with replacement; prepends ``shape`` and keeps the
        leading distribution dims of a >=2-D ``logits``."""
        from . import tensor_api as T

        num_samples = int(np.prod(shape)) if len(shape) else 1
        logits_shape = list(self.logits.shape)
        if len(logits_shape) > 1:
            sample_shape = list(shape) + logits_shape[:-1]
            logits = T.reshape(
                self.logits,
                [int(np.prod(logits_shape[:-1])), logits_shape[-1]])
        else:
            sample_shape = list(shape)
            logits = self.logits
        idx = T.multinomial(logits, num_samples, replacement=True)
        if len(logits_shape) > 1:
            # (num_dist, n) -> shape + dist_dims: samples vary fastest
            idx = T.transpose(idx, [1, 0])
        return T.reshape(idx, sample_shape)

    def _softmax_stats(self, logits):
        from . import tensor_api as T

        shifted = logits - T.max(logits, axis=-1, keepdim=True)
        e = T.exp(shifted)
        z = T.sum(e, axis=-1, keepdim=True)
        return shifted, e, z

    def kl_divergence(self, other):
        from . import tensor_api as T

        if not isinstance(other, Categorical):
            raise TypeError(
                f"kl_divergence expects Categorical, got "
                f"{type(other).__name__}")
        logits, e, z = self._softmax_stats(self.logits)
        o_logits, o_e, o_z = other._softmax_stats(other.logits)
        prob = e / z
        return T.sum(prob * (logits - T.log(z) - o_logits + T.log(o_z)),
                     axis=-1, keepdim=True)

    def entropy(self):
        from . import tensor_api as T

        logits, e, z = self._softmax_stats(self.logits)
        prob = e / z
        ent = -1.0 * T.sum(prob * (logits - T.log(z)), axis=-1, keepdim=True)
        return ent

    def probs(self, value):
        """Probability of category index ``value`` under weights/sum
        normalization (the reference's non-softmax convention)."""
        from . import tensor_api as T

        dist_sum = T.sum(self.logits, axis=-1, keepdim=True)
        prob = self.logits / dist_sum
        shape = list(self.logits.shape)
        value_shape = list(value.shape)
        if len(shape) == 1:
            num_value_in_one_dist = int(np.prod(value_shape))
            index_value = T.reshape(value, [num_value_in_one_dist, 1])
            index = index_value
        else:
            num_dist = int(np.prod(shape[:-1]))
            num_value_in_one_dist = value_shape[-1]
            prob = T.reshape(prob, [num_dist, shape[-1]])
            if len(value_shape) == 1:
                value = T.broadcast_to(
                    T.reshape(value, [1, -1]), [num_dist, value_shape[-1]])
                value_shape = [num_dist, value_shape[-1]]
            elif value_shape[:-1] != shape[:-1]:
                raise ValueError(
                    f"shape of value {value_shape[:-1]} must match shape "
                    f"of logits {shape[:-1]}")
            index_value = T.reshape(value, [num_dist, -1, 1])
            prefix = T.reshape(
                T.arange(0, num_dist, dtype=str(value.dtype)),
                [num_dist, 1, 1])
            prefix = T.broadcast_to(prefix,
                                    [num_dist, num_value_in_one_dist, 1])
            index = T.concat([prefix, index_value], axis=-1)
        out = T.gather_nd(prob, T.cast(index, "int64"))
        return T.reshape(out, value_shape)

    def log_prob(self, value):
        from . import tensor_api as T

        return T.log(self.probs(value))

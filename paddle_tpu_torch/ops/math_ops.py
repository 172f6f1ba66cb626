"""Math, elementwise, reduction and matmul ops.

Counterpart of ``paddle_tpu/ops/math_ops.py``, op for op: each kernel
makes the reference's jnp decisions in torch (paddle's ``axis``
broadcasting of Y, ``reduce_all`` / ``dim`` / ``keep_dim``, scalars cast
to x's dtype first, the median's midpoint, ``imag`` of a real tensor as
zeros).  ``matmul_v2`` is ``torch.matmul``: the reference computes it
outside any Pallas kernel, so no hand-written kernel stands behind it.
"""

from __future__ import annotations

import torch

from ..framework import random as _random
from .registry import register_op


def _s(v, like):
    """Python scalar ``v`` as a 0-d tensor of ``like``'s dtype (on the
    CPU, which an operation on the card takes as a scalar argument), as
    ``jnp.asarray(v, x.dtype)`` casts it first."""
    return torch.tensor(v, dtype=like.dtype)


def _align_y(x, y, axis):
    """Paddle's elementwise broadcasting: y's dims aligned to x's from
    ``axis`` (-1: trailing broadcast)."""
    if not isinstance(y, torch.Tensor) or y.ndim == x.ndim or axis == -1 \
            or axis is None:
        return y
    pad_right = x.ndim - axis - y.ndim
    if pad_right < 0:
        return y
    return torch.reshape(y, (1,) * axis + tuple(y.shape) + (1,) * pad_right)


def _binary(fn):
    def kernel(ins, attrs):
        x, y = ins["X"], ins["Y"]
        y = _align_y(x, y, attrs.get("axis", -1))
        return {"Out": fn(x, y)}

    return kernel


def _true_divide(x, y):
    if not (x.is_floating_point() or x.is_complex()) and not (
            y.is_floating_point() or y.is_complex()):
        # integer / integer is float64 in the reference (x64)
        return torch.div(x.double(), y.double())
    return torch.div(x, y)


register_op("elementwise_add")(_binary(torch.add))
register_op("elementwise_sub")(_binary(torch.sub))
register_op("elementwise_mul")(_binary(torch.mul))
register_op("elementwise_div")(_binary(_true_divide))
register_op("elementwise_min")(_binary(torch.minimum))
register_op("elementwise_max")(_binary(torch.maximum))
register_op("elementwise_pow")(_binary(torch.pow))
register_op("elementwise_mod")(_binary(torch.remainder))
def _floor_divide(x, y):
    """floor(x / y): for floats, differentiable (zero gradient) as
    ``jnp.floor_divide``'s is."""
    if x.is_floating_point() or y.is_floating_point():
        return torch.floor(torch.div(x, y))
    return torch.floor_divide(x, y)


register_op("elementwise_floordiv")(_binary(_floor_divide))


@register_op("scale")
def scale_kernel(ins, attrs):
    """out = scale * x + bias, or scale * (x + bias)."""
    x = ins["X"]
    s, b = attrs.get("scale", 1.0), attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        out = x * _s(s, x) + _s(b, x)
    else:
        out = (x + _s(b, x)) * _s(s, x)
    return {"Out": out}


@register_op("pow")
def pow_kernel(ins, attrs):
    x = ins["X"]
    return {"Out": torch.pow(x, _s(attrs.get("factor", 1.0), x))}


@register_op("sum", list_slots=("X",))
def sum_kernel(ins, attrs):
    """Adds N tensors."""
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("matmul_v2")
def matmul_v2_kernel(ins, attrs):
    x, y = ins["X"], ins["Y"]
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    return {"Out": torch.matmul(x, y)}


@register_op("matmul")
def matmul_v1_kernel(ins, attrs):
    """v1: transpose_X / transpose_Y / alpha."""
    x, y = ins["X"], ins["Y"]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * _s(alpha, out)
    return {"Out": out}


def _prod(t):
    p = 1
    for v in t:
        p *= int(v)
    return p


@register_op("mul")
def mul_kernel(ins, attrs):
    """Flatten to 2-D, then matmul (the FC primitive)."""
    x, y = ins["X"], ins["Y"]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    out = torch.matmul(x.reshape(-1, _prod(xs[xnc:])),
                       y.reshape(_prod(ys[:ync]), -1))
    return {"Out": out.reshape(xs[:xnc] + ys[ync:])}


def _axes(x, attrs, key="dim"):
    """The reduced axes: None for all."""
    dims = attrs.get(key, [0])
    if attrs.get("reduce_all", False) or dims is None or (
            isinstance(dims, (list, tuple)) and len(dims) == 0):
        return None
    if isinstance(dims, int):
        dims = [dims]
    return tuple(int(d) % max(x.ndim, 1) for d in dims)


def _over(fn, x, axis, keep):
    """``fn(x, dim, keepdim)`` over several axes one at a time (for the
    reductions that take one axis)."""
    axes = range(x.ndim) if axis is None else axis
    for a in sorted(axes, reverse=True):
        x = fn(x, a, keep)
    return x


def _reduce(name):
    def kernel(ins, attrs):
        x = ins["X"]
        axis = _axes(x, attrs)
        keep = attrs.get("keep_dim", False)
        if x.ndim == 0:
            out = x.clone()
        elif name in ("sum", "mean", "amax", "amin"):
            dim = tuple(range(x.ndim)) if axis is None else axis
            out = getattr(torch, name)(x, dim=dim, keepdim=keep)
        else:
            out = _over(lambda t, a, k: getattr(torch, name)(
                t, dim=a, keepdim=k), x, axis, keep)
        return {"Out": out}

    return kernel


register_op("reduce_sum")(_reduce("sum"))
register_op("reduce_mean")(_reduce("mean"))
register_op("reduce_max")(_reduce("amax"))
register_op("reduce_min")(_reduce("amin"))
register_op("reduce_prod")(_reduce("prod"))
register_op("reduce_any", nondiff_slots=("X",))(_reduce("any"))
register_op("reduce_all", nondiff_slots=("X",))(_reduce("all"))


@register_op("mean")
def mean_kernel(ins, attrs):
    """The mean over ALL elements."""
    return {"Out": torch.mean(ins["X"])}


@register_op("max")
def max_all_kernel(ins, attrs):
    return {"Out": torch.amax(ins["X"]) if ins["X"].ndim else ins["X"]}


def _unary(fn):
    def kernel(ins, attrs):
        return {"Out": fn(ins["X"])}

    return kernel


register_op("sqrt")(_unary(torch.sqrt))
register_op("rsqrt")(_unary(torch.rsqrt))
register_op("square")(_unary(torch.square))
register_op("exp")(_unary(torch.exp))
register_op("log")(_unary(torch.log))
register_op("log2")(_unary(torch.log2))
register_op("log10")(_unary(torch.log10))
register_op("log1p")(_unary(torch.log1p))
register_op("abs")(_unary(torch.abs))
register_op("sign", no_grad=True)(_unary(torch.sign))
register_op("floor", no_grad=True)(_unary(torch.floor))
register_op("ceil", no_grad=True)(_unary(torch.ceil))
register_op("round", no_grad=True)(_unary(torch.round))
register_op("sin")(_unary(torch.sin))
register_op("cos")(_unary(torch.cos))
register_op("tan")(_unary(torch.tan))
register_op("asin")(_unary(torch.asin))
register_op("acos")(_unary(torch.acos))
register_op("atan")(_unary(torch.atan))
register_op("sinh")(_unary(torch.sinh))
register_op("cosh")(_unary(torch.cosh))
register_op("reciprocal")(_unary(torch.reciprocal))
register_op("logical_not", nondiff_slots=("X",), no_grad=True)(
    _unary(torch.logical_not))
register_op("isnan_v2", nondiff_slots=("X",), no_grad=True)(
    _unary(torch.isnan))
register_op("isinf_v2", nondiff_slots=("X",), no_grad=True)(
    _unary(torch.isinf))
register_op("isfinite_v2", nondiff_slots=("X",), no_grad=True)(
    _unary(torch.isfinite))

_F32_MAX = float(torch.finfo(torch.float32).max)


@register_op("clip")
def clip_kernel(ins, attrs):
    x = ins["X"]
    lo = attrs.get("min", -_F32_MAX)
    hi = attrs.get("max", _F32_MAX)
    return {"Out": torch.clamp(x, _s(lo, x), _s(hi, x))}


def _logical(fn):
    def kernel(ins, attrs):
        return {"Out": fn(ins["X"], ins["Y"])}

    return kernel


for _name, _fn in (("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor),
                   ("equal", torch.eq), ("not_equal", torch.ne),
                   ("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt),
                   ("greater_equal", torch.ge)):
    register_op(_name, nondiff_slots=("X", "Y"), no_grad=True)(
        _logical(_fn))


@register_op("maximum")
def maximum_kernel(ins, attrs):
    return {"Out": torch.maximum(ins["X"], ins["Y"])}


@register_op("minimum")
def minimum_kernel(ins, attrs):
    return {"Out": torch.minimum(ins["X"], ins["Y"])}


@register_op("p_norm")
def p_norm_kernel(ins, attrs):
    x = ins["X"]
    porder = attrs.get("porder", 2.0)
    axis = attrs.get("axis", None)
    keepdim = attrs.get("keepdim", False)
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    dim = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    s = torch.sum(torch.abs(x) ** porder, dim=dim, keepdim=keepdim)
    return {"Out": s ** (1.0 / porder)}


@register_op("squared_l2_norm")
def squared_l2_norm_kernel(ins, attrs):
    return {"Out": torch.sum(torch.square(ins["X"])).reshape(1)}


@register_op("cumsum")
def cumsum_kernel(ins, attrs):
    x = ins["X"]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x = x.reshape(-1)
        axis = 0
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
    else:
        out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    return {"Out": out}


@register_op("addmm")
def addmm_kernel(ins, attrs):
    inp, x, y = ins["Input"], ins["X"], ins["Y"]
    return {"Out": attrs.get("Beta", 1.0) * inp
            + attrs.get("Alpha", 1.0) * torch.matmul(x, y)}


@register_op("dot")
def dot_kernel(ins, attrs):
    return {"Out": torch.sum(ins["X"] * ins["Y"], dim=-1)}


@register_op("cholesky")
def cholesky_kernel(ins, attrs):
    out = torch.linalg.cholesky(ins["X"])
    if attrs.get("upper", False):
        out = out.transpose(-1, -2)
    return {"Out": out}


@register_op("inverse")
def inverse_kernel(ins, attrs):
    return {"Output": torch.linalg.inv(ins["Input"])}


register_op("erf")(_unary(torch.erf))
register_op("expm1")(_unary(torch.expm1))
register_op("lgamma")(_unary(torch.lgamma))
register_op("digamma")(_unary(torch.digamma))
register_op("trunc", no_grad=True)(_unary(torch.trunc))
register_op("conj")(_unary(lambda x: torch.conj(x).resolve_conj()))
register_op("real")(_unary(lambda x: torch.real(x) if x.is_complex()
                           else x))
register_op("imag", no_grad=True)(_unary(
    lambda x: torch.imag(x) if x.is_complex() else torch.zeros_like(x)))
register_op("atan2")(_binary(torch.atan2))
register_op("bitwise_and", nondiff_slots=("X", "Y"), no_grad=True)(
    _binary(torch.bitwise_and))
register_op("bitwise_or", nondiff_slots=("X", "Y"), no_grad=True)(
    _binary(torch.bitwise_or))
register_op("bitwise_xor", nondiff_slots=("X", "Y"), no_grad=True)(
    _binary(torch.bitwise_xor))
register_op("bitwise_not", nondiff_slots=("X",), no_grad=True)(
    _unary(torch.bitwise_not))


@register_op("stanh")
def stanh_kernel(ins, attrs):
    """b * tanh(a * x)."""
    a = attrs.get("scale_a", 0.67)
    b = attrs.get("scale_b", 1.7159)
    return {"Out": b * torch.tanh(a * ins["X"])}


def _dims(axis, x):
    if axis is None:
        return tuple(range(x.ndim))
    return tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)


@register_op("logsumexp")
def logsumexp_kernel(ins, attrs):
    x = ins["X"]
    axis = None if attrs.get("reduce_all", False) else attrs.get("axis")
    return {"Out": torch.logsumexp(x, dim=_dims(axis, x),
                                   keepdim=bool(attrs.get("keepdim",
                                                          False)))}


@register_op("trace")
def trace_kernel(ins, attrs):
    d = torch.diagonal(ins["Input"], offset=attrs.get("offset", 0),
                       dim1=attrs.get("axis1", 0), dim2=attrs.get("axis2", 1))
    return {"Out": d.sum(-1)}


@register_op("diagonal")
def diagonal_kernel(ins, attrs):
    return {"Out": torch.diagonal(ins["Input"], offset=attrs.get("offset", 0),
                                  dim1=attrs.get("axis1", 0),
                                  dim2=attrs.get("axis2", 1))}


@register_op("diagflat")
def diagflat_kernel(ins, attrs):
    return {"Out": torch.diagflat(ins["X"], offset=attrs.get("offset", 0))}


def _moment(fn):
    def kernel(ins, attrs):
        x = ins["X"]
        axis = None if attrs.get("reduce_all", False) else attrs.get("dim")
        ddof = 1 if attrs.get("unbiased", True) else 0
        return {"Out": fn(x, dim=_dims(axis, x), correction=ddof,
                          keepdim=bool(attrs.get("keep_dim", False)))}

    return kernel


register_op("reduce_std")(_moment(torch.std))
register_op("reduce_var")(_moment(torch.var))


@register_op("median", no_grad=True)
def median_kernel(ins, attrs):
    """The midpoint of the two middle values for an even count, as
    ``jnp.median``."""
    x = ins["X"]
    axis = attrs.get("axis")
    keepdim = bool(attrs.get("keepdim", False))
    if axis is None:
        out = torch.quantile(x.reshape(-1), 0.5)
        return {"Out": out.reshape((1,) * x.ndim) if keepdim else out}
    return {"Out": torch.quantile(x, 0.5, dim=axis, keepdim=keepdim)}


@register_op("reverse")
def reverse_kernel(ins, attrs):
    ax = attrs.get("axis")
    ax = tuple(ax) if isinstance(ax, (list, tuple)) else (ax,)
    return {"Out": torch.flip(ins["X"], ax)}


@register_op("multinomial", needs_rng=True, nondiff_slots=("X",),
             no_grad=True)
def multinomial_kernel(ins, attrs, rng=None):
    """Categorical draws from the rows of X (probabilities), with or
    without replacement, from the op's key."""
    x = ins["X"]
    n = attrs.get("num_samples", 1)
    gen = _random.generator(rng, x.device)
    flat = x.reshape(-1, x.shape[-1]).float()
    out = torch.multinomial(flat, n, replacement=bool(
        attrs.get("replacement", False)) or n == 1, generator=gen)
    return {"Out": out.reshape(tuple(x.shape[:-1]) + (n,)).long()}


@register_op("index_sample", nondiff_slots=("Index",))
def index_sample_kernel(ins, attrs):
    """out[i, j] = x[i, index[i, j]]."""
    return {"Out": torch.take_along_dim(ins["X"], ins["Index"].long(),
                                        dim=1)}


@register_op("shard_index", nondiff_slots=("X",), no_grad=True)
def shard_index_kernel(ins, attrs):
    """Ids remapped into a shard-local range (others: ``ignore_value``)."""
    x = ins["X"]
    nshards, shard_id = attrs["nshards"], attrs["shard_id"]
    size = (attrs["index_num"] + nshards - 1) // nshards
    ignore = attrs.get("ignore_value", -1)
    return {"Out": torch.where(torch.div(x, size, rounding_mode="floor")
                               == shard_id, x % size,
                               torch.full_like(x, ignore))}


@register_op("crop_tensor")
def crop_tensor_kernel(ins, attrs):
    x = ins["X"]
    offsets = attrs.get("offsets", [0] * x.ndim)
    shape = attrs.get("shape")
    idx = tuple(slice(int(o), int(o) + int(s)) for o, s in zip(offsets,
                                                              shape))
    return {"Out": x[idx]}

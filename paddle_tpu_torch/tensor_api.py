"""The ``paddle.*`` tensor-function surface.

Counterpart of ``paddle_tpu/tensor_api.py``: creation, math,
reductions, manipulation, search and logic functions, each a dispatch of
a registered op (:func:`paddle_tpu_torch.ops.dispatch.dispatch`), and the
Tensor's operators and methods (the ``math_op_patch`` role).  Python
scalars in a binary op take the other operand's dtype, as the
reference's ``_wrap`` makes them, and travel as 0-d CPU tensors, which an
operation on the card reads as a scalar argument.  In static mode the
same functions append ops to the current program: a Python scalar
becomes a ``fill_constant`` op, and a static ``Variable`` takes the
Tensor's operators, methods and indexing (``x[0]``, ``x[:, 0]``).
"""

from __future__ import annotations

import builtins
from typing import Any, List, Optional, Sequence, Union

import numpy as np

import torch

from .dygraph.tensor import Tensor, to_tensor
from .framework import program as fw
from .framework.dtype import convert_dtype, to_torch_dtype
from .ops.dispatch import dispatch, single

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "empty", "empty_like", "arange", "linspace", "eye", "rand",
    "randn", "randint", "randperm", "uniform", "normal", "bernoulli",
    "add", "subtract", "multiply", "divide", "floor_divide", "mod",
    "remainder", "pow", "matmul", "mm", "bmm", "dot", "t", "transpose",
    "sum", "mean", "max", "min", "prod", "abs", "sqrt", "rsqrt", "square",
    "exp", "log", "log2", "log10", "log1p", "sin", "cos", "tan", "asin",
    "acos", "atan", "sinh", "cosh", "tanh", "floor", "ceil", "round",
    "sign", "reciprocal", "clip", "cumsum", "maximum", "minimum", "add_n",
    "scale", "isnan", "isinf", "isfinite", "numel",
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "equal_all", "allclose", "logical_and", "logical_or",
    "logical_xor", "logical_not",
    "reshape", "flatten", "squeeze", "unsqueeze", "concat", "split", "chunk",
    "stack", "unstack", "expand", "expand_as", "tile", "gather", "gather_nd",
    "scatter", "scatter_nd_add", "index_select", "masked_select", "where",
    "nonzero", "roll", "flip", "tril", "triu", "unique", "topk", "argmax",
    "argmin", "argsort", "sort", "cast", "slice", "strided_slice",
    "take_along_axis", "broadcast_to", "meshgrid", "norm", "dist", "kron",
    "flops", "increment", "is_tensor", "shape", "real", "create_parameter",
    "create_array", "array_write", "array_read", "array_length",
    "multiplex", "histogram", "bincount", "cross", "diag", "mv",
    "cholesky", "inverse", "erf", "expm1", "lgamma", "digamma", "trunc",
    "conj", "real", "imag", "atan2", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "stanh", "logsumexp", "trace",
    "diagonal", "diagflat", "std", "var", "median", "reverse",
    "multinomial", "index_sample", "scatter_nd",
    "shard_index", "crop", "crop_tensor", "neg", "all", "any",
    "floor_mod", "is_empty", "rank", "broadcast_shape",
    "broadcast_tensors", "standard_normal", "unbind", "tolist",
    "assign", "addmm", "reshape_", "squeeze_", "unsqueeze_", "tanh_",
    "scatter_",
]


def _attrs_axis(axis):
    if axis is None:
        return {"reduce_all": True, "dim": []}
    if isinstance(axis, int):
        axis = [axis]
    return {"reduce_all": False, "dim": list(axis)}


def _d(op_type, ins, attrs=None, slot="Out"):
    return single(dispatch(op_type, ins, attrs or {}), slot)


def is_tensor(x) -> bool:
    return isinstance(x, (Tensor, fw.Variable))


def _is_scalar(v) -> bool:
    return isinstance(v, (int, float, bool, np.number))


def _wrap(v, like=None):
    """Python scalars and numpy arrays as Tensors for binary ops; a
    scalar beside a Tensor takes its dtype (bools excepted) and stays on
    the CPU as a 0-d tensor."""
    if is_tensor(v):
        return v
    if fw.in_dygraph_mode():
        if like is not None and _is_scalar(v) and not isinstance(v, bool):
            return Tensor._wrap(torch.tensor(v, dtype=to_torch_dtype(
                like.dtype)))
        return Tensor(np.asarray(v))
    # static mode: a fill_constant op
    arr = np.asarray(v)
    dtype = str(arr.dtype) if arr.dtype != np.float64 else "float32"
    if like is not None and _is_scalar(v) and not isinstance(v, bool):
        dtype = like.dtype if isinstance(like.dtype, str) else str(like.dtype)
    return _d("fill_constant", {}, {
        "shape": list(arr.shape),
        "value": float(arr) if arr.ndim == 0 else arr.tolist(),
        "dtype": dtype})


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


def zeros(shape, dtype=None, name=None):
    return full(shape, 0.0, dtype)


def ones(shape, dtype=None, name=None):
    return full(shape, 1.0, dtype)


def full(shape, fill_value, dtype=None, name=None):
    if dtype is None:
        from .framework.dtype import get_default_dtype

        dtype = get_default_dtype()
    if is_tensor(shape):
        shape = [int(s) for s in np.asarray(shape.numpy())]
    shape = [int(s) for s in (shape if isinstance(shape, (list, tuple)) else [shape])]
    if is_tensor(fill_value):
        fill_value = float(fill_value.numpy())
    return _d(
        "fill_constant",
        {},
        {"shape": shape, "value": fill_value, "dtype": convert_dtype(dtype)},
    )


def zeros_like(x, dtype=None, name=None):
    return full_like(x, 0.0, dtype)


def ones_like(x, dtype=None, name=None):
    return full_like(x, 1.0, dtype)


def full_like(x, fill_value, dtype=None, name=None):
    return _d(
        "fill_any_like",
        {"X": [x]},
        {"value": float(fill_value), "dtype": convert_dtype(dtype) if dtype else -1},
    )


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    if dtype is None:
        # NB: builtins.all — paddle.all shadows the builtin in this module
        import builtins

        dtype = (
            "int64"
            if builtins.all(isinstance(v, (int, np.integer))
                            for v in (start, end, step))
            else "float32"
        )
    return _d(
        "range", {}, {"start": start, "end": end, "step": step, "dtype": convert_dtype(dtype)}
    )


def linspace(start, stop, num, dtype="float32", name=None):
    return _d(
        "linspace", {}, {"start": start, "stop": stop, "num": num, "dtype": convert_dtype(dtype)}
    )


def eye(num_rows, num_columns=None, dtype="float32", name=None):
    return _d(
        "eye",
        {},
        {
            "num_rows": num_rows,
            "num_columns": num_columns or num_rows,
            "dtype": convert_dtype(dtype),
        },
    )


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None):
    if dtype is None:
        from .framework.dtype import get_default_dtype

        dtype = get_default_dtype()
    return _d(
        "gaussian_random",
        {},
        {"shape": list(shape), "mean": 0.0, "std": 1.0, "dtype": convert_dtype(dtype)},
    )


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return _d(
        "randint",
        {},
        {"low": low, "high": high, "shape": list(shape), "dtype": convert_dtype(dtype)},
    )


def randperm(n, dtype="int64", name=None):
    return _d("randperm", {}, {"n": n, "dtype": convert_dtype(dtype)})


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    if dtype is None:
        from .framework.dtype import get_default_dtype

        dtype = get_default_dtype()
    return _d(
        "uniform_random",
        {},
        {"shape": list(shape), "min": min, "max": max, "seed": seed, "dtype": convert_dtype(dtype)},
    )


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if shape is None:
        shape = [1]
    return _d(
        "gaussian_random",
        {},
        {"shape": list(shape), "mean": mean, "std": std, "dtype": "float32"},
    )


def bernoulli(x, name=None):
    return _d("bernoulli", {"X": [x]}, {})


# ---------------------------------------------------------------------------
# binary math
# ---------------------------------------------------------------------------


def _binop(op_type):
    def f(x, y, name=None):
        x2 = _wrap(x, like=y if is_tensor(y) else None)
        y2 = _wrap(y, like=x if is_tensor(x) else None)
        return _d(op_type, {"X": [x2], "Y": [y2]}, {})

    return f


add = _binop("elementwise_add")
subtract = _binop("elementwise_sub")
multiply = _binop("elementwise_mul")
divide = _binop("elementwise_div")
floor_divide = _binop("elementwise_floordiv")
mod = _binop("elementwise_mod")
remainder = mod
maximum = _binop("elementwise_max")
minimum = _binop("elementwise_min")
equal = _binop("equal")
not_equal = _binop("not_equal")
less_than = _binop("less_than")
less_equal = _binop("less_equal")
greater_than = _binop("greater_than")
greater_equal = _binop("greater_equal")
logical_and = _binop("logical_and")
logical_or = _binop("logical_or")
logical_xor = _binop("logical_xor")


def logical_not(x, name=None):
    return _d("logical_not", {"X": [x]}, {})


def pow(x, y, name=None):
    if _is_scalar(y):
        return _d("pow", {"X": [x]}, {"factor": float(y)})
    return _d("elementwise_pow", {"X": [x], "Y": [_wrap(y, like=x)]}, {})


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _d(
        "matmul_v2", {"X": [x], "Y": [y]}, {"trans_x": transpose_x, "trans_y": transpose_y}
    )


mm = matmul


def bmm(x, y, name=None):
    return matmul(x, y)


def dot(x, y, name=None):
    return _d("dot", {"X": [x], "Y": [y]}, {})


def mv(x, vec, name=None):
    return _d("matmul_v2", {"X": [x], "Y": [vec]}, {})


def cholesky(x, upper=False, name=None):
    """Parity: tensor/linalg.py cholesky:735."""
    return _d("cholesky", {"X": [x]}, {"upper": bool(upper)})


def inverse(x, name=None):
    """Parity: tensor/math.py inverse (inverse_op.cc)."""
    return _d("inverse", {"Input": [x]}, {}, slot="Output")


def equal_all(x, y, name=None):
    eq = equal(x, y)
    return _d("reduce_all", {"X": [eq]}, {"reduce_all": True})


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    diff = abs(subtract(x, y))
    tol = add(full_like(diff, atol), scale(abs(y), rtol))
    return _d("reduce_all", {"X": [less_equal(diff, tol)]}, {"reduce_all": True})


# ---------------------------------------------------------------------------
# unary math
# ---------------------------------------------------------------------------


def _unop(op_type):
    def f(x, name=None):
        return _d(op_type, {"X": [x]}, {})

    return f


abs = _unop("abs")
sqrt = _unop("sqrt")
rsqrt = _unop("rsqrt")
square = _unop("square")
exp = _unop("exp")
log = _unop("log")
log2 = _unop("log2")
log10 = _unop("log10")
log1p = _unop("log1p")
sin = _unop("sin")
cos = _unop("cos")
tan = _unop("tan")
asin = _unop("asin")
acos = _unop("acos")
atan = _unop("atan")
sinh = _unop("sinh")
cosh = _unop("cosh")
tanh = _unop("tanh")
floor = _unop("floor")
ceil = _unop("ceil")
round = _unop("round")
sign = _unop("sign")
reciprocal = _unop("reciprocal")
isnan = _unop("isnan_v2")
isinf = _unop("isinf_v2")
isfinite = _unop("isfinite_v2")


def clip(x, min=None, max=None, name=None):
    attrs = {}
    if min is not None:
        attrs["min"] = float(min)
    if max is not None:
        attrs["max"] = float(max)
    return _d("clip", {"X": [x]}, attrs)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    out = _d(
        "scale",
        {"X": [x]},
        {"scale": float(scale), "bias": float(bias), "bias_after_scale": bias_after_scale},
    )
    if act:
        out = _d(act, {"X": [out]}, {})
    return out


def increment(x, value=1.0, name=None):
    return scale(x, 1.0, value)


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """``paddle.create_parameter``: a trainable parameter."""
    from .nn.layer_base import Layer, ParamAttr

    helper = Layer()
    if name is not None:
        attr = attr or ParamAttr(name=name)
    return helper.create_parameter(
        shape, attr=attr, dtype=dtype, is_bias=is_bias,
        default_initializer=default_initializer)


def cumsum(x, axis=None, dtype=None, name=None):
    flatten = axis is None
    out = _d("cumsum", {"X": [x]}, {"axis": axis if axis is not None else -1, "flatten": flatten})
    if dtype is not None:
        out = cast(out, dtype)
    return out


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    attrs = _attrs_axis(axis)
    attrs["keep_dim"] = keepdim
    out = _d("reduce_sum", {"X": [x]}, attrs)
    if dtype is not None:
        out = cast(out, dtype)
    return out


def mean(x, axis=None, keepdim=False, name=None):
    attrs = _attrs_axis(axis)
    attrs["keep_dim"] = keepdim
    return _d("reduce_mean", {"X": [x]}, attrs)


def max(x, axis=None, keepdim=False, name=None):
    attrs = _attrs_axis(axis)
    attrs["keep_dim"] = keepdim
    return _d("reduce_max", {"X": [x]}, attrs)


def min(x, axis=None, keepdim=False, name=None):
    attrs = _attrs_axis(axis)
    attrs["keep_dim"] = keepdim
    return _d("reduce_min", {"X": [x]}, attrs)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    attrs = _attrs_axis(axis)
    attrs["keep_dim"] = keepdim
    out = _d("reduce_prod", {"X": [x]}, attrs)
    if dtype is not None:
        out = cast(out, dtype)
    return out


def add_n(inputs, name=None):
    if is_tensor(inputs):
        inputs = [inputs]
    return _d("sum", {"X": list(inputs)}, {})


def numel(x, name=None):
    n = 1
    for s in x.shape:
        n *= s
    if fw.in_dygraph_mode():
        return to_tensor(np.asarray(n, dtype="int64"))
    return full([1], n, "int64")


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    if p == "fro":
        return sqrt(sum(square(x), axis=axis, keepdim=keepdim))
    return _d(
        "p_norm",
        {"X": [x]},
        {
            "porder": float(p),
            "axis": axis if axis is None or isinstance(axis, int) else list(axis),
            "keepdim": keepdim,
        },
    )


def dist(x, y, p=2.0, name=None):
    return norm(subtract(x, y), p=p)


# ---------------------------------------------------------------------------
# manipulation
# ---------------------------------------------------------------------------


def cast(x, dtype):
    return _d("cast", {"X": [x]}, {"out_dtype": convert_dtype(dtype)})


def reshape(x, shape, name=None):
    if is_tensor(shape):
        shape = [int(s) for s in np.asarray(shape.numpy())]
    shape = [int(s) if not is_tensor(s) else int(s.numpy()) for s in shape]
    return _d("reshape2", {"X": [x]}, {"shape": shape})


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _d(
        "flatten_contiguous_range",
        {"X": [x]},
        {"start_axis": start_axis, "stop_axis": stop_axis},
    )


def squeeze(x, axis=None, name=None):
    if axis is None:
        axis = []
    elif isinstance(axis, int):
        axis = [axis]
    return _d("squeeze2", {"X": [x]}, {"axes": list(axis)})


def unsqueeze(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return _d("unsqueeze2", {"X": [x]}, {"axes": list(axis)})


def transpose(x, perm, name=None):
    return _d("transpose2", {"X": [x]}, {"axis": list(perm)})


def t(x, name=None):
    if len(x.shape) <= 1:
        return x
    return transpose(x, [1, 0])


def concat(x, axis=0, name=None):
    if is_tensor(axis):
        axis = int(axis.numpy())
    return _d("concat", {"X": list(x)}, {"axis": axis})


def split(x, num_or_sections, axis=0, name=None):
    if is_tensor(axis):
        axis = int(axis.numpy())
    if isinstance(num_or_sections, int):
        attrs = {"num": num_or_sections, "sections": [], "axis": axis}
        n = num_or_sections
    else:
        secs = list(num_or_sections)
        dim = x.shape[axis]
        known = [s for s in secs if s not in (-1, None)]
        secs = [s if s not in (-1, None) else dim - int(np.sum(known)) for s in secs]
        attrs = {"num": 0, "sections": secs, "axis": axis}
        n = len(secs)
    out = dispatch("split", {"X": [x]}, attrs)
    return list(out["Out"])


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def stack(x, axis=0, name=None):
    return single(dispatch("stack", {"X": list(x)}, {"axis": axis}), "Y")


def unstack(x, axis=0, num=None, name=None):
    return list(dispatch("unstack", {"X": [x]}, {"axis": axis})["Y"])


def expand(x, shape, name=None):
    shape = [int(s) if not is_tensor(s) else int(s.numpy()) for s in shape]
    return _d("expand_v2", {"X": [x]}, {"shape": shape})


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_to(x, shape, name=None):
    return _d("broadcast_to", {"X": [x]}, {"shape": list(shape)})


def tile(x, repeat_times, name=None):
    return _d("tile", {"X": [x]}, {"repeat_times": list(repeat_times)})


def gather(x, index, axis=0, name=None):
    if is_tensor(axis):
        axis = int(axis.numpy())
    return _d("gather", {"X": [x], "Index": [index]}, {"axis": axis})


def gather_nd(x, index, name=None):
    return _d("gather_nd", {"X": [x], "Index": [index]}, {})


def scatter(x, index, updates, overwrite=True, name=None):
    return _d(
        "scatter", {"X": [x], "Ids": [index], "Updates": [updates]}, {"overwrite": overwrite}
    )


def scatter_nd_add(x, index, updates, name=None):
    return _d("scatter_nd_add", {"X": [x], "Index": [index], "Updates": [updates]}, {})


def index_select(x, index, axis=0, name=None):
    return _d("index_select", {"X": [x], "Index": [index]}, {"dim": axis})


def masked_select(x, mask, name=None):
    return single(dispatch("masked_select", {"X": [x], "Mask": [mask]}, {}), "Y")


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    return _d("where", {"Condition": [condition], "X": [x], "Y": [y]}, {})


def nonzero(x, as_tuple=False, name=None):
    out = _d("where_index", {"Condition": [x]}, {})
    if as_tuple:
        n = out.shape[-1]
        return tuple(single(dispatch("slice", {"Input": [out]}, {
            "axes": [1], "starts": [i], "ends": [i + 1], "decrease_axis": [1]
        })) for i in range(n))
    return out


def roll(x, shifts, axis=None, name=None):
    return _d(
        "roll",
        {"X": [x]},
        {"shifts": shifts if isinstance(shifts, (list, tuple)) else [shifts],
         "axis": list(axis) if isinstance(axis, (list, tuple)) else ([axis] if axis is not None else None)},
    )


def flip(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return _d("flip", {"X": [x]}, {"axis": list(axis)})


def tril(x, diagonal=0, name=None):
    return _d("tril_triu", {"X": [x]}, {"diagonal": diagonal, "lower": True})


def triu(x, diagonal=0, name=None):
    return _d("tril_triu", {"X": [x]}, {"diagonal": diagonal, "lower": False})


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None, dtype="int64", name=None):
    outs = dispatch("unique", {"X": [x]}, {})
    result = [outs["Out"][0]]
    if return_index:
        result.append(outs["Index"][0])
    if return_inverse:
        result.append(outs["Indices"][0])
    if return_counts:
        result.append(outs["Counts"][0])
    return result[0] if len(result) == 1 else tuple(result)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    outs = dispatch("top_k_v2", {"X": [x]}, {"k": int(k), "axis": axis, "largest": largest})
    return outs["Out"][0], outs["Indices"][0]


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    flatten_ = axis is None
    return _d(
        "arg_max",
        {"X": [x]},
        {"axis": axis if axis is not None else -1, "flatten": flatten_,
         "keepdims": keepdim, "dtype": convert_dtype(dtype)},
    )


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _d(
        "arg_min",
        {"X": [x]},
        {"axis": axis if axis is not None else -1, "flatten": axis is None,
         "keepdims": keepdim, "dtype": convert_dtype(dtype)},
    )


def argsort(x, axis=-1, descending=False, name=None):
    return dispatch("argsort", {"X": [x]}, {"axis": axis, "descending": descending})["Indices"][0]


def sort(x, axis=-1, descending=False, name=None):
    return dispatch("argsort", {"X": [x]}, {"axis": axis, "descending": descending})["Out"][0]


def slice(x, axes, starts, ends, name=None):
    return _d(
        "slice",
        {"Input": [x]},
        {"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _d(
        "strided_slice",
        {"Input": [x]},
        {"axes": list(axes), "starts": list(starts), "ends": list(ends), "strides": list(strides)},
    )


def take_along_axis(arr, indices, axis, name=None):
    return single(
        dispatch("take_along_axis", {"Input": [arr], "Index": [indices]}, {"Axis": axis}),
        "Result",
    )


def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(dispatch("meshgrid", {"X": list(args)}, {})["Out"])


def diag(x, offset=0, padding_value=0, name=None):
    return _d("diag_v2", {"X": [_wrap(x)]}, {"offset": offset, "padding_value": padding_value})


def kron(x, y, name=None):
    return _d("kron", {"X": [_wrap(x)], "Y": [_wrap(y)]}, {})


def cross(x, y, axis=None, name=None):
    return _d("cross", {"X": [x], "Y": [y]}, {"dim": axis if axis is not None else -1})


def histogram(input, bins=100, min=0, max=0, name=None):
    return _d("histogram", {"X": [input]}, {"bins": bins, "min": min, "max": max})


def bincount(x, weights=None, minlength=0, name=None):
    ins = {"X": [x]}
    if weights is not None:
        ins["Weights"] = [weights]
    return _d("bincount", ins, {"minlength": minlength})


def multiplex(inputs, index, name=None):
    return _d("multiplex", {"X": list(inputs), "Ids": [index]}, {})


def shape(x):
    return single(dispatch("shape", {"Input": [x]}, {}))


def flops(net, input_size, custom_ops=None, print_detail=False):
    """``paddle.flops``: :func:`paddle_tpu_torch.hapi.flops`."""
    from .hapi.dynamic_flops import flops as _flops

    return _flops(net, input_size, custom_ops=custom_ops,
                  print_detail=print_detail)


# -- LoDTensorArray surface (dygraph semantics: a python list — the same
# -- thing the reference's dygraph mode uses; fluid/layers/tensor.py
# -- create_array:1480, array_write, array_read, array_length) --------------


def create_array(dtype="float32", initialized_list=None):
    arr = list(initialized_list or [])
    for v in arr:
        if not isinstance(v, Tensor):
            raise TypeError(
                f"create_array initialized_list expects Tensors, got {type(v)}")
    return arr


def array_write(x, i, array=None):
    idx = int(np.asarray(i.numpy() if is_tensor(i) else i))
    if array is None:
        array = []
    if idx > len(array):
        # reference dygraph path asserts i <= len(array): a gap would make
        # a later array_read return nothing, crashing far from the bad write
        raise IndexError(
            f"array_write index {idx} out of range for array of length "
            f"{len(array)} (must be <= length)")
    if idx == len(array):
        array.append(x)
    else:
        array[idx] = x
    return array


def array_read(array, i):
    idx = int(np.asarray(i.numpy() if is_tensor(i) else i))
    return array[idx]


def array_length(array):
    return Tensor(np.asarray(len(array), dtype="int64"), stop_gradient=True)


# ---------------------------------------------------------------------------
# method / operator patching (math_op_patch parity)
# ---------------------------------------------------------------------------

_METHODS = {
    "add": add, "subtract": subtract, "multiply": multiply, "divide": divide,
    "matmul": matmul, "mm": mm, "bmm": bmm, "dot": dot, "pow": pow,
    "mod": mod, "floor_divide": floor_divide, "maximum": maximum,
    "minimum": minimum, "abs": abs, "sqrt": sqrt, "rsqrt": rsqrt,
    "square": square, "exp": exp, "log": log, "sin": sin, "cos": cos,
    "tanh": tanh, "floor": floor, "ceil": ceil, "round": round,
    "sign": sign, "reciprocal": reciprocal, "clip": clip, "scale": scale,
    "sum": sum, "mean": mean, "max": max, "min": min, "prod": prod,
    "norm": norm, "cumsum": cumsum, "isnan": isnan, "isinf": isinf,
    "isfinite": isfinite, "equal": equal, "not_equal": not_equal,
    "less_than": less_than, "less_equal": less_equal,
    "greater_than": greater_than, "greater_equal": greater_equal,
    "equal_all": equal_all, "allclose": allclose,
    "logical_and": logical_and, "logical_or": logical_or,
    "logical_not": logical_not, "logical_xor": logical_xor,
    "reshape": reshape, "flatten": flatten, "squeeze": squeeze,
    "unsqueeze": unsqueeze, "transpose": transpose, "concat": concat,
    "split": split, "chunk": chunk, "expand": expand, "expand_as": expand_as,
    "tile": tile, "gather": gather, "gather_nd": gather_nd,
    "scatter": scatter, "index_select": index_select,
    "masked_select": masked_select, "where": where, "nonzero": nonzero,
    "roll": roll, "flip": flip, "tril": tril, "triu": triu, "unique": unique,
    "topk": topk, "argmax": argmax, "argmin": argmin, "argsort": argsort,
    "sort": sort, "slice": slice, "strided_slice": strided_slice,
    "broadcast_to": broadcast_to, "unstack": unstack, "stack": None,
    "take_along_axis": take_along_axis, "dist": dist,
}


def _patch(cls):
    for name, fn in _METHODS.items():
        if fn is None or hasattr(cls, name):
            continue
        setattr(cls, name, fn)

    cls.__add__ = lambda s, o: add(s, o)
    cls.__radd__ = lambda s, o: add(o, s)
    cls.__sub__ = lambda s, o: subtract(s, o)
    cls.__rsub__ = lambda s, o: subtract(o, s)
    cls.__mul__ = lambda s, o: multiply(s, o)
    cls.__rmul__ = lambda s, o: multiply(o, s)
    cls.__truediv__ = lambda s, o: divide(s, o)
    cls.__rtruediv__ = lambda s, o: divide(o, s)
    cls.__floordiv__ = lambda s, o: floor_divide(s, o)
    cls.__mod__ = lambda s, o: mod(s, o)
    cls.__pow__ = lambda s, o: pow(s, o)
    cls.__rpow__ = lambda s, o: pow(_wrap(o, like=s), s)
    cls.__matmul__ = lambda s, o: matmul(s, o)
    cls.__neg__ = lambda s: scale(s, -1.0)
    cls.__abs__ = lambda s: globals()["abs"](s)
    cls.__eq__ = lambda s, o: equal(s, o)
    cls.__ne__ = lambda s, o: not_equal(s, o)
    cls.__lt__ = lambda s, o: less_than(s, o)
    cls.__le__ = lambda s, o: less_equal(s, o)
    cls.__gt__ = lambda s, o: greater_than(s, o)
    cls.__ge__ = lambda s, o: greater_equal(s, o)


_patch(Tensor)
Tensor.__hash__ = lambda self: id(self)
_patch(fw.Variable)
fw.Variable.__hash__ = lambda self: id(self)
fw.Variable.cast = lambda self, dtype: cast(self, dtype)


_SLICE_END = 2 ** 31 - 1  # an end past any dim: the slice op clamps it


def slice_attrs(idx, ndim):
    """The ``slice`` op's attributes for a basic index (ints, and slices
    without a step, over the leading dims), or None for any other."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    if len(idx) > ndim:
        return None
    axes, starts, ends, decrease = [], [], [], []
    for axis, i in enumerate(idx):
        if isinstance(i, (builtins.bool, np.bool_)):
            return None
        if isinstance(i, (int, np.integer)):
            i = int(i)
            axes.append(axis)
            starts.append(i)
            ends.append(i + 1 if i != -1 else _SLICE_END)
            decrease.append(axis)
        elif isinstance(i, builtins.slice) and i.step in (None, 1):
            if i.start is None and i.stop is None:
                continue
            if not builtins.all(v is None or isinstance(v, (int, np.integer))
                                for v in (i.start, i.stop)):
                return None
            axes.append(axis)
            starts.append(0 if i.start is None else int(i.start))
            ends.append(_SLICE_END if i.stop is None else int(i.stop))
        else:
            return None
    return {"axes": axes, "starts": starts, "ends": ends,
            "decrease_axis": decrease}


def _variable_getitem(self, idx):
    """``var[idx]`` in a static program: a basic index (ints and unit-step
    slices) is the registered ``slice`` op, so the program saves and loads
    in another process; any other index is the Tensor's indexing as a
    one-off op of this process."""
    from .dygraph import tracer
    from .dygraph.tensor import _normalize_index

    attrs = slice_attrs(idx, len(self.shape))
    if attrs is not None:
        if not attrs["axes"]:
            return self
        return _d("slice", {"Input": [self]}, attrs)
    return tracer.trace_fn(lambda a: a[_normalize_index(idx, a.device)],
                           [self], name="getitem")


fw.Variable.__getitem__ = _variable_getitem


# ---------------------------------------------------------------------------
# surface-completeness batch (reference python/paddle/__init__.py parity)
# ---------------------------------------------------------------------------


def erf(x, name=None):
    return _d("erf", {"X": [x]})


def expm1(x, name=None):
    return _d("expm1", {"X": [x]})


def lgamma(x, name=None):
    return _d("lgamma", {"X": [x]})


def digamma(x, name=None):
    return _d("digamma", {"X": [x]})


def trunc(x, name=None):
    return _d("trunc", {"X": [x]})


def conj(x, name=None):
    return _d("conj", {"X": [x]})


def real(x, name=None):
    return _d("real", {"X": [x]})


def imag(x, name=None):
    return _d("imag", {"X": [x]})


def atan2(x, y, name=None):
    return _d("atan2", {"X": [x], "Y": [y]})


def bitwise_and(x, y, out=None, name=None):
    return _d("bitwise_and", {"X": [x], "Y": [y]})


def bitwise_or(x, y, out=None, name=None):
    return _d("bitwise_or", {"X": [x], "Y": [y]})


def bitwise_xor(x, y, out=None, name=None):
    return _d("bitwise_xor", {"X": [x], "Y": [y]})


def bitwise_not(x, out=None, name=None):
    return _d("bitwise_not", {"X": [x]})


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _d("stanh", {"X": [x]}, {"scale_a": scale_a, "scale_b": scale_b})


def logsumexp(x, axis=None, keepdim=False, name=None):
    attrs = {"keepdim": keepdim}
    if axis is None:
        attrs["reduce_all"] = True
    else:
        attrs["axis"] = [axis] if isinstance(axis, int) else list(axis)
    return _d("logsumexp", {"X": [x]}, attrs)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _d("trace", {"Input": [x]},
              {"offset": offset, "axis1": axis1, "axis2": axis2})


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return _d("diagonal", {"Input": [x]},
              {"offset": offset, "axis1": axis1, "axis2": axis2})


def diagflat(x, offset=0, name=None):
    return _d("diagflat", {"X": [x]}, {"offset": offset})


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    attrs = {"unbiased": bool(unbiased), "keep_dim": keepdim}
    if axis is None:
        attrs["reduce_all"] = True
    else:
        attrs["dim"] = [axis] if isinstance(axis, int) else list(axis)
    return _d("reduce_std", {"X": [x]}, attrs)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    attrs = {"unbiased": bool(unbiased), "keep_dim": keepdim}
    if axis is None:
        attrs["reduce_all"] = True
    else:
        attrs["dim"] = [axis] if isinstance(axis, int) else list(axis)
    return _d("reduce_var", {"X": [x]}, attrs)


def median(x, axis=None, keepdim=False, name=None):
    return _d("median", {"X": [x]}, {"axis": axis, "keepdim": keepdim})


def reverse(x, axis, name=None):
    return _d("reverse", {"X": [x]},
              {"axis": [axis] if isinstance(axis, int) else list(axis)})


def multinomial(x, num_samples=1, replacement=False, name=None):
    return _d("multinomial", {"X": [x]},
              {"num_samples": num_samples, "replacement": bool(replacement)})


def index_sample(x, index):
    return _d("index_sample", {"X": [x], "Index": [index]})


def scatter_nd(index, updates, shape, name=None):
    """Parity: paddle.scatter_nd — scatter into zeros of ``shape``."""
    z = zeros(shape, dtype=updates.dtype)
    return scatter_nd_add(z, index, updates)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    if not 0 <= shard_id < nshards:
        raise ValueError(
            f"shard_id({shard_id}) must be in [0, nshards({nshards}))")
    return _d("shard_index", {"X": [input]},
              {"index_num": index_num, "nshards": nshards,
               "shard_id": shard_id, "ignore_value": ignore_value})


def crop(x, shape=None, offsets=None, name=None):
    xs = list(x.shape)
    offsets = [int(o) for o in offsets] if offsets is not None else [0] * len(xs)
    shape = list(shape) if shape is not None else xs
    # paddle semantics: -1/None means "to the end" = input dim minus offset
    shape = [xs[i] - offsets[i] if (s is None or int(s) < 0) else int(s)
             for i, s in enumerate(shape)]
    return _d("crop_tensor", {"X": [x]},
              {"offsets": offsets, "shape": shape})


crop_tensor = crop


def neg(x, name=None):
    return scale(x, scale=-1.0)


def all(x, axis=None, keepdim=False, name=None):
    attrs = {"keep_dim": keepdim}
    if axis is None:
        attrs["reduce_all"] = True
    else:
        attrs["dim"] = [axis] if isinstance(axis, int) else list(axis)
    return _d("reduce_all", {"X": [x]}, attrs)


def any(x, axis=None, keepdim=False, name=None):
    attrs = {"keep_dim": keepdim}
    if axis is None:
        attrs["reduce_all"] = True
    else:
        attrs["dim"] = [axis] if isinstance(axis, int) else list(axis)
    return _d("reduce_any", {"X": [x]}, attrs)


def floor_mod(x, y, name=None):
    return mod(x, y)


def is_empty(x, name=None):
    n = int(np.prod(x.shape)) if 0 not in x.shape else 0
    return full([1], n == 0, dtype="bool")


def rank(input):
    return to_tensor(np.asarray(len(input.shape), "int32"))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def broadcast_tensors(input, name=None):
    tgt = list(np.broadcast_shapes(*[tuple(t.shape) for t in input]))
    return [broadcast_to(t, tgt) for t in input]


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype=dtype)


def unbind(input, axis=0):
    """Parity: paddle.unbind — split + squeeze along ``axis``."""
    n = input.shape[axis]
    parts = split(input, n, axis=axis)
    return [squeeze(p, [axis]) for p in parts]


def tolist(x):
    return np.asarray(x.numpy()).tolist()


def assign(x, output=None):
    """Parity: paddle.assign (assign_op.cc) — copy into ``output`` or a new
    tensor."""
    if not is_tensor(x):
        x = _wrap(x)
    out = _d("assign", {"X": [x]})
    if output is not None:
        output.set_value(out)
        return output
    return out


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """Parity: paddle.addmm (addmm_op.cc): beta*input + alpha*(x @ y)."""
    return _d("addmm", {"Input": [input], "X": [x], "Y": [y]},
              {"Beta": float(beta), "Alpha": float(alpha)})


# -- in-place surface variants (reference *_ API) ---------------------------
# A receiver with gradient history takes the result as an op on the tape
# (Tensor._rebind); otherwise the value is rebound without gradient.


def _inplace_apply(x, fn, tensor_inputs, name):
    if torch.is_grad_enabled() and x._has_history():
        x._rebind(fn(x._t, *[t._t for t in tensor_inputs]))
        return x
    with torch.no_grad():
        new = fn(x._t, *[t._t for t in tensor_inputs])
    if x._t.requires_grad and x._t.is_leaf:
        new = new.requires_grad_(True)
    x._t = new
    return x


def _resolve_reshape(shape, cur_shape):
    """paddle reshape semantics: 0 copies the input dim, one -1 is
    inferred."""
    out = [cur_shape[i] if int(s) == 0 else int(s)
           for i, s in enumerate(shape)]
    if out.count(-1) > 1:
        raise ValueError(f"only one -1 allowed in shape, got {shape}")
    if -1 in out:
        known = int(np.prod([s for s in out if s != -1])) or 1
        total = int(np.prod(cur_shape)) if cur_shape else 1
        out[out.index(-1)] = total // known
    return out


def reshape_(x, shape, name=None):
    tgt = _resolve_reshape(list(shape), list(x.shape))
    return _inplace_apply(x, lambda a: torch.reshape(a, tgt), (), "reshape_")


def squeeze_(x, axis=None, name=None):
    ax = (tuple(axis) if isinstance(axis, (list, tuple))
          else (axis,) if axis is not None else None)
    return _inplace_apply(
        x, lambda a: torch.squeeze(a) if ax is None else torch.squeeze(a, ax),
        (), "squeeze_")


def unsqueeze_(x, axis, name=None):
    axes = sorted(axis if isinstance(axis, (list, tuple)) else [axis])

    def fn(a):
        for ax in axes:
            a = torch.unsqueeze(a, ax)
        return a

    return _inplace_apply(x, fn, (), "unsqueeze_")


def tanh_(x, name=None):
    return _inplace_apply(x, torch.tanh, (), "tanh_")


def scatter_(x, index, updates, overwrite=True, name=None):
    def fn(a, idx, upd):
        return torch.index_put(a, (idx.long(),), upd.to(a.dtype),
                               accumulate=not overwrite)

    return _inplace_apply(x, fn, (index, updates), "scatter_")

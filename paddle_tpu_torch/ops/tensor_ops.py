"""Tensor creation, manipulation and indexing ops.

Counterpart of ``paddle_tpu/ops/tensor_ops.py``, op for op.  Creation ops
make their tensors on the current place's device
(:func:`paddle_tpu_torch.framework.place.current_device`); the random
ones (``needs_rng``) draw from a ``torch.Generator`` seeded with the
op's key, so the same key draws the same numbers (the numbers are not
JAX's).  Indexing keeps jnp's semantics: ``gather`` is ``jnp.take`` over
any index shape, ``argsort`` and ``top_k_v2`` are stable (ties keep the
lower index first), ``strided_slice`` takes negative strides,
``scatter`` writes out of place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..framework import random as _random
from ..framework.dtype import to_torch_dtype
from ..framework.place import current_device
from .registry import register_op


def _dt(attrs, key="dtype", default="float32"):
    return to_torch_dtype(attrs.get(key, default))


def _gen(rng):
    return _random.generator(rng, current_device())


# -- creation ---------------------------------------------------------------


@register_op("fill_constant", no_grad=True)
def fill_constant_kernel(ins, attrs):
    shape = tuple(attrs.get("shape", ()))
    dtype = _dt(attrs)
    value = attrs.get("value", 0.0)
    if isinstance(value, str):
        value = float(value)
    if isinstance(value, (list, tuple)):
        return {"Out": torch.as_tensor(np.asarray(value).reshape(shape),
                                       dtype=dtype, device=current_device())}
    return {"Out": torch.full(shape, value, dtype=dtype,
                              device=current_device())}


@register_op("fill_any_like", nondiff_slots=("X",), no_grad=True)
def fill_any_like_kernel(ins, attrs):
    x = ins["X"]
    dtype = attrs.get("dtype", None)
    dt = to_torch_dtype(dtype) if dtype not in (None, -1) else x.dtype
    return {"Out": torch.full(tuple(x.shape), attrs.get("value", 0.0),
                              dtype=dt, device=x.device)}


@register_op("fill_zeros_like", nondiff_slots=("X",), no_grad=True)
def fill_zeros_like_kernel(ins, attrs):
    return {"Out": torch.zeros_like(ins["X"])}


@register_op("gaussian_random", needs_rng=True, no_grad=True)
def gaussian_random_kernel(ins, attrs, rng=None):
    shape = tuple(attrs.get("shape", ()))
    z = torch.randn(shape, generator=_gen(rng), dtype=_dt(attrs),
                    device=current_device())
    return {"Out": attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z}


@register_op("uniform_random", needs_rng=True, no_grad=True)
def uniform_random_kernel(ins, attrs, rng=None):
    shape = tuple(attrs.get("shape", ()))
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(shape, generator=_gen(rng), dtype=_dt(attrs),
                   device=current_device())
    return {"Out": u * (hi - lo) + lo}


@register_op("truncated_gaussian_random", needs_rng=True, no_grad=True)
def truncated_gaussian_random_kernel(ins, attrs, rng=None):
    shape = tuple(attrs.get("shape", ()))
    z = torch.empty(shape, dtype=_dt(attrs), device=current_device())
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=_gen(rng))
    return {"Out": attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z}


@register_op("randint", needs_rng=True, no_grad=True)
def randint_kernel(ins, attrs, rng=None):
    shape = tuple(attrs.get("shape", ()))
    out = torch.randint(attrs.get("low", 0), attrs.get("high", 1), shape,
                        generator=_gen(rng), device=current_device())
    return {"Out": out.to(_dt(attrs, default="int64"))}


@register_op("randperm", needs_rng=True, no_grad=True)
def randperm_kernel(ins, attrs, rng=None):
    out = torch.randperm(attrs.get("n"), generator=_gen(rng),
                         device=current_device())
    return {"Out": out.to(_dt(attrs, default="int64"))}


@register_op("bernoulli", needs_rng=True, nondiff_slots=("X",), no_grad=True)
def bernoulli_kernel(ins, attrs, rng=None):
    x = ins["X"]
    u = _random.uniform(rng, x.shape, x.device)
    return {"Out": (u < x.float()).to(x.dtype)}


@register_op("range", no_grad=True)
def range_kernel(ins, attrs):
    return {"Out": torch.arange(attrs["start"], attrs["end"], attrs["step"],
                                dtype=_dt(attrs, default="int64"),
                                device=current_device())}


@register_op("eye", no_grad=True)
def eye_kernel(ins, attrs):
    r = attrs["num_rows"]
    c = attrs.get("num_columns", r)
    return {"Out": torch.eye(r, c, dtype=_dt(attrs),
                             device=current_device())}


@register_op("linspace", no_grad=True)
def linspace_kernel(ins, attrs):
    return {"Out": torch.linspace(attrs["start"], attrs["stop"], attrs["num"],
                                  dtype=_dt(attrs), device=current_device())}


@register_op("assign")
def assign_kernel(ins, attrs):
    return {"Out": ins["X"].clone()}


@register_op("assign_value", no_grad=True)
def assign_value_kernel(ins, attrs):
    """A literal (the ``Assign`` initializer)."""
    vals = attrs.get("values", attrs.get("fp32_values", []))
    return {"Out": torch.as_tensor(np.asarray(vals), dtype=_dt(attrs),
                                   device=current_device()).reshape(
                                       attrs["shape"])}


@register_op("shape", nondiff_slots=("Input",), no_grad=True)
def shape_kernel(ins, attrs):
    x = ins["Input"]
    return {"Out": torch.tensor(list(x.shape), dtype=torch.int32,
                                device=x.device)}


@register_op("cast")
def cast_kernel(ins, attrs):
    return {"Out": ins["X"].to(to_torch_dtype(
        attrs.get("out_dtype", attrs.get("dtype", "float32"))))}


# -- shape manipulation -----------------------------------------------------


@register_op("reshape2")
def reshape2_kernel(ins, attrs):
    x = ins["X"]
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": torch.reshape(x, shape)}


@register_op("transpose2")
def transpose2_kernel(ins, attrs):
    return {"Out": ins["X"].permute(*attrs["axis"])}


@register_op("flatten_contiguous_range")
def flatten_kernel(ins, attrs):
    x = ins["X"]
    start = attrs.get("start_axis", 1) % x.ndim
    stop = attrs.get("stop_axis", -1) % x.ndim
    return {"Out": torch.flatten(x, start, stop)}


@register_op("squeeze2")
def squeeze2_kernel(ins, attrs):
    x = ins["X"]
    axes = attrs.get("axes", [])
    if not axes:
        return {"Out": torch.squeeze(x)}
    axes = tuple(a % x.ndim for a in axes if x.shape[a % x.ndim] == 1)
    return {"Out": torch.squeeze(x, axes) if axes else x.view_as(x)}


@register_op("unsqueeze2")
def unsqueeze2_kernel(ins, attrs):
    x = ins["X"]
    for a in sorted(attrs["axes"]):
        x = torch.unsqueeze(x, a)
    return {"Out": x}


@register_op("concat", list_slots=("X",))
def concat_kernel(ins, attrs):
    return {"Out": torch.cat(ins["X"], dim=attrs.get("axis", 0))}


@register_op("split", list_slots=("Out",))
def split_kernel(ins, attrs):
    x = ins["X"]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    num = attrs.get("num", 0)
    if x.shape[axis] % num:
        raise ValueError(f"split: {x.shape[axis]} does not split into "
                         f"{num} equal parts")
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register_op("stack", list_slots=("X",))
def stack_kernel(ins, attrs):
    return {"Y": torch.stack(ins["X"], dim=attrs.get("axis", 0))}


@register_op("unstack", list_slots=("Y",))
def unstack_kernel(ins, attrs):
    return {"Y": list(torch.unbind(ins["X"], dim=attrs.get("axis", 0)))}


@register_op("expand_v2")
def expand_v2_kernel(ins, attrs):
    x = ins["X"]
    shape = list(attrs["shape"])
    xshape = (1,) * (len(shape) - x.ndim) + tuple(x.shape)
    x = x.reshape(xshape)
    return {"Out": torch.broadcast_to(x, [xs if s == -1 else s
                                          for s, xs in zip(shape, xshape)])}


@register_op("tile")
def tile_kernel(ins, attrs):
    return {"Out": torch.tile(ins["X"], tuple(attrs["repeat_times"]))}


@register_op("slice")
def slice_kernel(ins, attrs):
    x = ins["Input"]
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    decrease = attrs.get("decrease_axis", [])
    if decrease:
        out = torch.squeeze(out, tuple(decrease))
    return {"Out": out}


@register_op("strided_slice")
def strided_slice_kernel(ins, attrs):
    x = ins["Input"]
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs["strides"]):
        keep = range(*slice(s, e, st).indices(x.shape[a]))
        x = x.index_select(a, torch.tensor(list(keep), dtype=torch.long,
                                           device=x.device))
    return {"Out": x}


@register_op("flip")
def flip_kernel(ins, attrs):
    return {"Out": torch.flip(ins["X"], tuple(attrs["axis"]))}


@register_op("roll")
def roll_kernel(ins, attrs):
    axis = attrs.get("axis", None)
    shifts = list(attrs["shifts"])
    if not axis:
        return {"Out": torch.roll(ins["X"], sum(shifts))}
    return {"Out": torch.roll(ins["X"], shifts, tuple(axis))}


@register_op("pad3d")
def pad3d_kernel(ins, attrs):
    """paddings [l, r, t, b, front, back] over NCDHW's W, H, D."""
    x = ins["X"]
    p = [int(v) for v in attrs["paddings"]]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": F.pad(x, p, value=attrs.get("value", 0.0))}
    return {"Out": F.pad(x, p, mode={"reflect": "reflect",
                                     "replicate": "replicate"}[mode])}


@register_op("pad")
def pad_kernel(ins, attrs):
    x = ins["X"]
    p = [int(v) for v in attrs["paddings"]]
    flat = []
    for i in reversed(range(x.ndim)):
        flat += [p[2 * i], p[2 * i + 1]]
    return {"Out": F.pad(x, flat, value=attrs.get("pad_value", 0.0))}


@register_op("tril_triu")
def tril_triu_kernel(ins, attrs):
    x = ins["X"]
    diag = attrs.get("diagonal", 0)
    if attrs.get("lower", True):
        return {"Out": torch.tril(x, diag)}
    return {"Out": torch.triu(x, diag)}


# -- indexing ---------------------------------------------------------------


def _take(x, index, axis):
    """``jnp.take(x, index, axis)`` for any index shape."""
    axis = axis % x.ndim
    flat = x.index_select(axis, index.reshape(-1).long())
    return flat.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                        + tuple(x.shape[axis + 1:]))


@register_op("lookup_table_v2", nondiff_slots=("Ids",))
def lookup_table_v2_kernel(ins, attrs):
    """The embedding lookup; ids equal to ``padding_idx`` read zeros.
    ``torch.nn.functional.embedding`` (not ``index_select``, whose CUDA
    backward adds repeated rows by atomics in no fixed order): its
    backward sums a row's gradients in a fixed order, so a step repeats
    bit for bit on the card."""
    w, ids = ins["W"], ins["Ids"]
    out = torch.nn.functional.embedding(ids.long(), w)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return {"Out": out}


@register_op("gather", nondiff_slots=("Index",))
def gather_kernel(ins, attrs):
    return {"Out": _take(ins["X"], ins["Index"], attrs.get("axis", 0))}


def _nd(index):
    return tuple(index[..., i].long() for i in range(index.shape[-1]))


@register_op("gather_nd", nondiff_slots=("Index",))
def gather_nd_kernel(ins, attrs):
    return {"Out": ins["X"][_nd(ins["Index"])]}


@register_op("scatter", nondiff_slots=("Ids",))
def scatter_kernel(ins, attrs):
    x, ids, updates = ins["X"], ins["Ids"].long(), ins["Updates"]
    return {"Out": torch.index_put(x, (ids,), updates.to(x.dtype),
                                   accumulate=not attrs.get("overwrite",
                                                            True))}


@register_op("scatter_nd_add", nondiff_slots=("Index",))
def scatter_nd_add_kernel(ins, attrs):
    x = ins["X"]
    return {"Out": torch.index_put(x, _nd(ins["Index"]),
                                   ins["Updates"].to(x.dtype),
                                   accumulate=True)}


@register_op("index_select", nondiff_slots=("Index",))
def index_select_kernel(ins, attrs):
    return {"Out": _take(ins["X"], ins["Index"], attrs.get("dim", 0))}


@register_op("where", nondiff_slots=("Condition",))
def where_kernel(ins, attrs):
    return {"Out": torch.where(ins["Condition"], ins["X"], ins["Y"])}


@register_op("where_index", nondiff_slots=("Condition",), no_grad=True)
def where_index_kernel(ins, attrs):
    return {"Out": torch.nonzero(ins["Condition"])}


@register_op("masked_select", nondiff_slots=("Mask",), no_grad=True)
def masked_select_kernel(ins, attrs):
    return {"Y": ins["X"][ins["Mask"]]}


@register_op("one_hot_v2", nondiff_slots=("X",), no_grad=True)
def one_hot_v2_kernel(ins, attrs):
    return {"Out": F.one_hot(ins["X"].long(), attrs["depth"]).float()}


def _arg(fn):
    def kernel(ins, attrs):
        x = ins["X"]
        if attrs.get("flatten", False):
            out = fn(x.reshape(-1), 0)
        else:
            axis = attrs.get("axis", -1)
            out = fn(x, axis)
            if attrs.get("keepdims", False):
                out = torch.unsqueeze(out, axis)
        return {"Out": out.to(_dt(attrs, default="int64"))}

    return kernel


register_op("arg_max", nondiff_slots=("X",), no_grad=True)(
    _arg(lambda x, a: torch.argmax(x, dim=a)))
register_op("arg_min", nondiff_slots=("X",), no_grad=True)(
    _arg(lambda x, a: torch.argmin(x, dim=a)))


@register_op("argsort", nondiff_slots=("X",), no_grad=True)
def argsort_kernel(ins, attrs):
    x = ins["X"]
    axis = attrs.get("axis", -1)
    key = -x if attrs.get("descending", False) else x
    idx = torch.argsort(key, dim=axis, stable=True)
    return {"Out": torch.take_along_dim(x, idx, dim=axis), "Indices": idx}


@register_op("top_k_v2", nondiff_out_slots=("Indices",))
def top_k_v2_kernel(ins, attrs):
    """The k largest (or smallest) along ``axis``, ties to the lower
    index, as ``lax.top_k``."""
    x = ins["X"]
    k, axis = attrs.get("k", 1), attrs.get("axis", -1)
    key = x if attrs.get("largest", True) else -x
    idx = torch.argsort(key, dim=axis, descending=True, stable=True)
    idx = idx.narrow(axis, 0, k)
    return {"Out": torch.take_along_dim(x, idx, dim=axis), "Indices": idx}


@register_op("unique", nondiff_slots=("X",), no_grad=True)
def unique_kernel(ins, attrs):
    x = ins["X"]
    out, index, inverse, counts = np.unique(
        x.detach().cpu().numpy(), return_index=True, return_inverse=True,
        return_counts=True)

    def back(a):
        return torch.as_tensor(a, device=x.device)

    return {"Out": back(out), "Index": back(index.astype("int64")),
            "Indices": back(inverse.astype("int64").reshape(-1)),
            "Counts": back(counts.astype("int64"))}


@register_op("take_along_axis", nondiff_slots=("Index",))
def take_along_axis_kernel(ins, attrs):
    return {"Result": torch.take_along_dim(ins["Input"], ins["Index"].long(),
                                           dim=attrs.get("Axis", 0))}


@register_op("meshgrid", list_slots=("X", "Out"))
def meshgrid_kernel(ins, attrs):
    return {"Out": list(torch.meshgrid(*ins["X"], indexing="ij"))}


@register_op("broadcast_to")
def broadcast_to_kernel(ins, attrs):
    return {"Out": torch.broadcast_to(ins["X"], tuple(attrs["shape"]))}


@register_op("diag_v2")
def diag_v2_kernel(ins, attrs):
    x = ins["X"]
    offset = attrs.get("offset", 0)
    if x.ndim == 1:
        out = torch.diag(x, offset)
        pad = attrs.get("padding_value", 0.0)
        if pad != 0.0:
            mask = torch.diag(torch.ones_like(x), offset) > 0
            out = torch.where(mask, out, torch.tensor(pad, dtype=x.dtype))
        return {"Out": out}
    return {"Out": torch.diagonal(x, offset)}


@register_op("kron")
def kron_kernel(ins, attrs):
    return {"Out": torch.kron(ins["X"], ins["Y"])}


@register_op("cross")
def cross_kernel(ins, attrs):
    return {"Out": torch.linalg.cross(ins["X"], ins["Y"],
                                      dim=attrs.get("dim", -1))}


@register_op("multiplex", list_slots=("X",), nondiff_slots=("Ids",))
def multiplex_kernel(ins, attrs):
    """Row i of Out comes from input Ids[i]."""
    xs = torch.stack(ins["X"], dim=0)
    ids = ins["Ids"].reshape(-1).long()
    idx = ids.reshape((1, -1) + (1,) * (xs.ndim - 2)).expand(
        (1,) + tuple(xs.shape[1:]))
    return {"Out": torch.take_along_dim(xs, idx, dim=0)[0]}


@register_op("histogram", nondiff_slots=("X",), no_grad=True)
def histogram_kernel(ins, attrs):
    x = ins["X"].double()
    bins = attrs.get("bins", 100)
    lo, hi = attrs.get("min", 0), attrs.get("max", 0)
    if lo == 0 and hi == 0:
        lo, hi = float(x.min()), float(x.max())
    return {"Out": torch.histc(x, bins=bins, min=lo, max=hi).long()}


@register_op("bincount", nondiff_slots=("X",), no_grad=True)
def bincount_kernel(ins, attrs):
    x = ins["X"]
    w = ins.get("Weights")
    out = np.bincount(x.detach().cpu().numpy(),
                      weights=None if w is None else w.detach().cpu().numpy(),
                      minlength=attrs.get("minlength", 0))
    return {"Out": torch.as_tensor(out, device=x.device)}

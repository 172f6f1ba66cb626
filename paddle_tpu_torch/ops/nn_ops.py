"""Neural-net ops: the 2-D and 3-D vision ops, the interpolations, norms,
dropout, the fused losses and attention.

Counterpart of ``paddle_tpu/ops/nn_ops.py``, op for op, and of the
reference's registered ``scaled_dot_product_attention``
(``paddle_tpu/kernels/attention.py:111-125``), whose kernel here is
:func:`paddle_tpu_torch.kernels.attention.sdpa`: on the card it launches
the flash kernels, forward and backward, or raises.

The 2-D vision ops (``conv2d``, ``depthwise_conv2d``, ``conv2d_transpose``,
``pool2d``, ``max_pool2d_with_index``) keep the reference's attributes and
semantics.  The reference computes them with ``lax.conv_general_dilated``
and ``lax.reduce_window``, outside any Pallas kernel, so here
``torch.nn.functional`` computes them (cuDNN on the card):

* padding: 2- and 4-element paddings and ``"SAME"`` / ``"VALID"`` give
  ``(lo, hi)`` pairs per spatial dim, XLA's SAME putting the odd pixel on
  the high side; where lo != hi the input is padded explicitly (with -inf
  for max pooling), since torch pads symmetrically only;
* NHWC: the input is read as a ``permute(0, 3, 1, 2)`` view, which is
  channels-last memory, and the output permuted back, with no copy, so
  cuDNN runs its NHWC kernels;
* fp32 on the card: a conv follows the fp32 matmul precision
  (``FLAGS_tpu_matmul_precision``, ``torch.set_float32_matmul_precision``):
  cuDNN's TF32 is off at ``"highest"``, the default, as the reference's
  convs are fp32 (``preferred_element_type=float32``);
* average pooling pads, sums and divides by the count of real elements
  in the window (``exclusive``) or by kh * kw, as the reference does, and
  ``ceil_mode`` extends the high pads (``_ceil_extend``): torch's own
  divisors and ceil rule differ;
* ``max_pool2d_with_index``'s Mask is the flat ``h * W + w`` index of the
  first maximum of each window.

The 3-D ops (``conv3d``, ``conv3d_transpose``, ``pool3d``, NCDHW) follow
the same rules over three spatial dims, fp32 convs included; ``pool3d``
reads no ``ceil_mode``, as the reference's does not.  The interpolations
(``nearest_interp_v2``, ``bilinear_interp_v2``) resize with the
reference's ``jax.image.resize`` formula: half-pixel centres, the
bilinear kernel antialiased where it shrinks.

:func:`dropout` is the GPT's dropout, the reference's ``dropout`` kernel
decision for decision:

* ``p == 0`` in training is the identity, with NO draw;
* in eval (``training=False``) it is the identity (``upscale_in_train``,
  the mode the GPT uses);
* otherwise keep = ``uniform(float32) < float32(1 - p)``; the kept
  values are multiplied by ``1 / (1 - p)`` rounded to x's dtype (0 when
  p >= 1) and the dropped ones are 0.

The uniforms come from :func:`paddle_tpu_torch.framework.random.draw`
of the caller's key: the same key draws the same mask; the ``dropout``
op draws them the same way from its op key.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..framework import random as _random
from ..kernels import attention as _attention
from .registry import GRAD_SUFFIX, register_op


def dropout(x, p: float, key: Optional[int], training: bool = True):
    """Dropout of ``x`` at rate ``p`` with the mask of ``key``
    (``upscale_in_train``)."""
    if p == 0.0 or not training:
        return x
    keep = _random.draw(key, x.shape, x.device) < np.float32(1.0 - p)
    scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
    scale = torch.tensor(scale, dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# the 2-D vision ops
# ---------------------------------------------------------------------------


def _same_pads(sizes, ksize, strides, dilations):
    """XLA's SAME padding: out = ceil(in / stride), the odd pixel of
    padding on the high side."""
    pads = []
    for n, k, st, d in zip(sizes, ksize, strides, dilations):
        total = max((-(-n // st) - 1) * st + d * (k - 1) + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pairs(p):
    """A paddle padding list as (lo, hi) pairs for the 2 spatial dims."""
    p = list(p)
    if len(p) == 2:
        return [(p[0], p[0]), (p[1], p[1])]
    if len(p) == 4:
        return [(p[0], p[1]), (p[2], p[3])]
    raise ValueError(f"bad paddings {p}")


def _conv_padding(paddings, algorithm, sizes, ksize, strides, dilations):
    if algorithm == "SAME":
        return _same_pads(sizes, ksize, strides, dilations)
    if algorithm == "VALID":
        return [(0, 0), (0, 0)]
    return _pairs(paddings)


def _pad_hw(x, pads, value=0.0):
    """``x`` (N, C, H, W) padded by ``pads`` ((top, bottom), (left,
    right)); a negative pad crops."""
    (t, b), (l, r) = pads
    return F.pad(x, (l, r, t, b), value=value)


def _conv_precision(x):
    """cuDNN's TF32 for an fp32 conv on the card follows the fp32 matmul
    precision: off at ``"highest"``."""
    if x.is_cuda and x.dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = (
            torch.get_float32_matmul_precision() != "highest")


@register_op("conv2d")
def conv2d_kernel(ins, attrs):
    """``F.conv2d`` over the NCHW view of the input (NHWC: channels-last
    memory), explicit padding where it is asymmetric."""
    x, w = ins["Input"], ins["Filter"]
    strides = tuple(attrs.get("strides", [1, 1]))
    dilations = tuple(attrs.get("dilations", [1, 1]))
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    xv = x.permute(0, 3, 1, 2) if nhwc else x
    pads = _conv_padding(attrs.get("paddings", [0, 0]),
                         attrs.get("padding_algorithm", "EXPLICIT"),
                         xv.shape[2:], w.shape[-2:], strides, dilations)
    if all(lo == hi for lo, hi in pads):
        pad = tuple(lo for lo, _ in pads)
    else:
        xv, pad = _pad_hw(xv, pads), 0
    _conv_precision(x)
    out = F.conv2d(xv, w, None, strides, pad, dilations,
                   attrs.get("groups", 1))
    return {"Output": out.permute(0, 2, 3, 1) if nhwc else out}


@register_op("depthwise_conv2d")
def depthwise_conv2d_kernel(ins, attrs):
    attrs = dict(attrs)
    x = ins["Input"]
    attrs["groups"] = x.shape[1] if attrs.get(
        "data_format", "NCHW") == "NCHW" else x.shape[-1]
    return conv2d_kernel(ins, attrs)


@register_op("conv2d_transpose")
def conv2d_transpose_kernel(ins, attrs):
    """The adjoint of conv2d (NCHW; the Filter is (in, out / groups, kh,
    kw)): the whole transposed conv, then the pads cropped and
    ``output_padding`` added on the high side."""
    x, w = ins["Input"], ins["Filter"]
    pads = _pairs(attrs.get("paddings", [0, 0]))
    out_pad = attrs.get("output_padding", [0, 0]) or [0, 0]
    if isinstance(out_pad, int):
        out_pad = [out_pad, out_pad]
    _conv_precision(x)
    full = F.conv_transpose2d(x, w, None, tuple(attrs.get("strides", [1, 1])),
                              0, 0, attrs.get("groups", 1),
                              tuple(attrs.get("dilations", [1, 1])))
    (t, b), (l, r) = pads
    return {"Output": _pad_hw(full, [(-t, out_pad[0] - b),
                                     (-l, out_pad[1] - r)])}


def _ceil_extend(sp_pad, sizes, ksize, strides):
    """ceil_mode: extend the HIGH-side pads so the last partial window is
    kept: out = ceil((in + pads - k) / s) + 1 (the extra padding never
    starts a new window)."""
    out = list(sp_pad)
    for i in range(2):
        size = sizes[i] + out[i][0] + out[i][1]
        rem = (size - ksize[i]) % strides[i]
        if rem:
            out[i] = (out[i][0], out[i][1] + strides[i] - rem)
    return out


def _lowest(x):
    if x.is_floating_point():
        return float("-inf")
    return torch.iinfo(x.dtype).min


def _adaptive_window(h, w, oh, ow):
    if h % oh or w % ow:
        raise AssertionError("adaptive pool requires divisible sizes")
    return [h // oh, w // ow]


@register_op("pool2d")
def pool2d_kernel(ins, attrs):
    """Max or average pooling: global, adaptive (sizes that divide) or
    windowed with the reference's padding, ``ceil_mode`` and ``exclusive``
    divisor."""
    x = ins["X"]
    ptype = attrs.get("pooling_type", "max")
    ksize = list(attrs.get("ksize", [1, 1]))
    strides = tuple(attrs.get("strides", ksize))
    adaptive = attrs.get("adaptive", False)
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    sp = (1, 2) if nhwc else (2, 3)
    if attrs.get("global_pooling", False) or (adaptive
                                             and tuple(ksize) == (1, 1)):
        red = torch.amax if ptype == "max" else torch.mean
        return {"Out": red(x, dim=sp, keepdim=True)}
    if adaptive:
        oh, ow = ksize
        h, w = x.shape[sp[0]], x.shape[sp[1]]
        kh, kw = _adaptive_window(h, w, oh, ow)
        red = torch.amax if ptype == "max" else torch.mean
        if nhwc:
            x5 = x.reshape(x.shape[0], oh, kh, ow, kw, x.shape[3])
            return {"Out": red(x5, dim=(2, 4))}
        x5 = x.reshape(x.shape[0], x.shape[1], oh, kh, ow, kw)
        return {"Out": red(x5, dim=(3, 5))}
    xv = x.permute(0, 3, 1, 2) if nhwc else x
    sp_pad = _pairs(attrs.get("paddings", [0, 0]))
    if attrs.get("ceil_mode", False):
        sp_pad = _ceil_extend(sp_pad, xv.shape[2:], ksize, strides)
    padded = any(pi != (0, 0) for pi in sp_pad)
    if ptype == "max":
        if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(sp_pad,
                                                               ksize)):
            out = F.max_pool2d(xv, ksize, strides,
                               tuple(lo for lo, _ in sp_pad))
        else:
            out = F.max_pool2d(_pad_hw(xv, sp_pad, _lowest(x)), ksize,
                               strides)
    else:
        xp = _pad_hw(xv, sp_pad) if padded else xv
        total = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
        if attrs.get("exclusive", True) and padded:
            ones = torch.ones((1, 1) + tuple(xv.shape[2:]), dtype=x.dtype,
                              device=x.device)
            count = F.avg_pool2d(_pad_hw(ones, sp_pad), ksize, strides,
                                 divisor_override=1)
            out = total / count
        else:
            out = total / (ksize[0] * ksize[1])
    return {"Out": out.permute(0, 2, 3, 1) if nhwc else out}


@register_op("max_pool2d_with_index", nondiff_out_slots=("Mask",))
def max_pool2d_with_index_kernel(ins, attrs):
    """Max pooling (NCHW) with the argmax as a flat index into the input
    feature map (h * W + w): the windows as patches (``F.unfold`` of the
    input padded with the dtype's finite minimum), their max and the
    first position of it, clamped to the input."""
    x = ins["X"]
    ksize = list(attrs.get("ksize", [1, 1]))
    n, c, h, w = x.shape
    if attrs.get("adaptive", False):
        ksize = _adaptive_window(h, w, *ksize)
        strides = tuple(ksize)
        sp_pad = [(0, 0), (0, 0)]
    else:
        strides = tuple(attrs.get("strides", ksize))
        sp_pad = _pairs(attrs.get("paddings", [0, 0]))
        if attrs.get("ceil_mode", False):
            sp_pad = _ceil_extend(sp_pad, (h, w), ksize, strides)
    neg = (torch.finfo(x.dtype).min if x.is_floating_point()
           else torch.iinfo(x.dtype).min)
    xp = _pad_hw(x, sp_pad, neg)
    oh = (xp.shape[2] - ksize[0]) // strides[0] + 1
    ow = (xp.shape[3] - ksize[1]) // strides[1] + 1
    patches = F.unfold(xp, ksize, stride=strides).reshape(
        n, c, ksize[0] * ksize[1], oh, ow)
    out = torch.amax(patches, dim=2)
    k_loc = torch.argmax(patches, dim=2)
    oy = torch.arange(oh, device=x.device).reshape(1, 1, -1, 1)
    ox = torch.arange(ow, device=x.device).reshape(1, 1, 1, -1)
    gh = (oy * strides[0] - sp_pad[0][0] + k_loc // ksize[1]).clamp(0, h - 1)
    gw = (ox * strides[1] - sp_pad[1][0] + k_loc % ksize[1]).clamp(0, w - 1)
    return {"Out": out, "Mask": (gh * w + gw).to(torch.int32)}


# ---------------------------------------------------------------------------
# the 3-D vision ops (NCDHW)
# ---------------------------------------------------------------------------


def _triples(p):
    """A paddle 3-D padding list (3 or 6 elements) as (lo, hi) pairs."""
    p = list(p)
    if len(p) == 3:
        return [(v, v) for v in p]
    if len(p) == 6:
        return [(p[0], p[1]), (p[2], p[3]), (p[4], p[5])]
    raise ValueError(f"bad 3-D paddings {p}")


def _pad_dhw(x, pads, value=0.0):
    """``x`` (N, C, D, H, W) padded by ``pads`` ((lo, hi) for D, H, W); a
    negative pad crops."""
    (d0, d1), (h0, h1), (w0, w1) = pads
    return F.pad(x, (w0, w1, h0, h1, d0, d1), value=value)


@register_op("conv3d")
def conv3d_kernel(ins, attrs):
    """``F.conv3d`` (NCDHW, filter OIDHW), explicit padding where it is
    asymmetric."""
    x, w = ins["Input"], ins["Filter"]
    pads = _triples(attrs.get("paddings", [0, 0, 0]))
    if all(lo == hi for lo, hi in pads):
        xv, pad = x, tuple(lo for lo, _ in pads)
    else:
        xv, pad = _pad_dhw(x, pads), 0
    _conv_precision(x)
    out = F.conv3d(xv, w, None, tuple(attrs.get("strides", [1, 1, 1])), pad,
                   tuple(attrs.get("dilations", [1, 1, 1])),
                   attrs.get("groups", 1))
    return {"Output": out}


@register_op("conv3d_transpose")
def conv3d_transpose_kernel(ins, attrs):
    """The adjoint of conv3d (the Filter is (in, out / groups, kd, kh,
    kw)): the whole transposed conv, then the pads cropped and
    ``output_padding`` added on the high side."""
    x, w = ins["Input"], ins["Filter"]
    pads = _triples(attrs.get("paddings", [0, 0, 0]))
    out_pad = attrs.get("output_padding", [0, 0, 0]) or [0, 0, 0]
    if isinstance(out_pad, int):
        out_pad = [out_pad] * 3
    _conv_precision(x)
    full = F.conv_transpose3d(x, w, None,
                              tuple(attrs.get("strides", [1, 1, 1])), 0, 0,
                              attrs.get("groups", 1),
                              tuple(attrs.get("dilations", [1, 1, 1])))
    return {"Output": _pad_dhw(full, [(-lo, op - hi) for (lo, hi), op
                                      in zip(pads, out_pad)])}


@register_op("pool3d")
def pool3d_kernel(ins, attrs):
    """Max or average pooling over D, H, W: global, adaptive (sizes that
    divide) or windowed with the reference's padding (max pads with the
    lowest value; average divides by the count of real elements in the
    window, or by kd * kh * kw when ``exclusive`` is False).  As the
    reference's op, it reads no ``ceil_mode``."""
    x = ins["X"]
    ptype = attrs.get("pooling_type", "max")
    ksize = list(attrs.get("ksize", [1, 1, 1]))
    strides = tuple(attrs.get("strides", ksize))
    red = torch.amax if ptype == "max" else torch.mean
    if attrs.get("global_pooling", False) or (
            attrs.get("adaptive", False) and tuple(ksize) == (1, 1, 1)):
        return {"Out": red(x, dim=(2, 3, 4), keepdim=True)}
    if attrs.get("adaptive", False):
        od, oh, ow = ksize
        d, h, w = x.shape[2:]
        if d % od or h % oh or w % ow:
            raise AssertionError("adaptive pool3d requires divisible sizes")
        x8 = x.reshape(x.shape[0], x.shape[1], od, d // od, oh, h // oh,
                       ow, w // ow)
        return {"Out": red(x8, dim=(3, 5, 7))}
    pads = _triples(attrs.get("paddings", [0, 0, 0]))
    padded = any(p != (0, 0) for p in pads)
    if ptype == "max":
        if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads,
                                                               ksize)):
            return {"Out": F.max_pool3d(x, ksize, strides,
                                        tuple(lo for lo, _ in pads))}
        return {"Out": F.max_pool3d(_pad_dhw(x, pads, _lowest(x)), ksize,
                                    strides)}
    xp = _pad_dhw(x, pads) if padded else x
    total = F.avg_pool3d(xp, ksize, strides, divisor_override=1)
    if attrs.get("exclusive", True) and padded:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        count = F.avg_pool3d(_pad_dhw(ones, pads), ksize, strides,
                             divisor_override=1)
        return {"Out": total / count}
    return {"Out": total / float(np.prod(ksize))}


# ---------------------------------------------------------------------------
# the interpolation ops (NCHW)
# ---------------------------------------------------------------------------


def _interp_size(x, attrs):
    """(out_h, out_w): ``out_h`` / ``out_w`` where given (> 0), else the
    input's size times ``scale``, truncated (the reference's rule)."""
    oh, ow = attrs.get("out_h", -1), attrs.get("out_w", -1)
    scale = attrs.get("scale", [])
    if oh <= 0 and scale:
        oh = int(x.shape[2] * scale[0])
        ow = int(x.shape[3] * (scale[1] if len(scale) > 1 else scale[0]))
    return int(oh), int(ow)


@register_op("nearest_interp_v2")
def nearest_interp_kernel(ins, attrs):
    """Nearest resize of the spatial dims 2 and 3 with the reference's
    half-pixel rule (``jax.image.resize``'s "nearest"): output pixel i
    reads input pixel floor((i + 0.5) * in / out), which is torch's
    ``nearest-exact``.  The reference's op reads no ``align_corners``,
    ``align_mode`` or ``data_format``, and neither does this one."""
    x = ins["X"]
    return {"Out": F.interpolate(x, size=_interp_size(x, attrs),
                                 mode="nearest-exact")}


@register_op("bilinear_interp_v2")
def bilinear_interp_kernel(ins, attrs):
    """Bilinear resize of dims 2 and 3 as ``jax.image.resize``'s
    "bilinear": half-pixel centres, a triangle kernel widened by the
    factor where it shrinks (antialiased) and renormalised at the edges,
    which is torch's bilinear with ``antialias=True``."""
    x = ins["X"]
    return {"Out": F.interpolate(x, size=_interp_size(x, attrs),
                                 mode="bilinear", align_corners=False,
                                 antialias=True)}


# ---------------------------------------------------------------------------
# batch_norm (hand-written grad: uses the saved batch statistics)
# ---------------------------------------------------------------------------


def _bn_axes(x, data_layout):
    if data_layout == "NHWC":
        return tuple(range(x.ndim - 1)), (1,) * (x.ndim - 1) + (-1,)
    return (0,) + tuple(range(2, x.ndim)), (1, -1) + (1,) * (x.ndim - 2)


def _data_group():
    """BatchNorm's data-parallel group: ``(group, first rank)`` of the
    installed mesh's dp x sharding axes when they hold more than one rank,
    else None.  The reference shards one global batch over those axes
    (``DataParallelSPMD``), so its BatchNorm normalises by the global
    batch's moments; here each rank holds its rows, and the statistics
    and the backward's sums are all-reduced over this group.  Ranks that
    hold the same rows (a batch not sharded) get the moments of those
    rows, as they would alone."""
    from ..distributed import mesh as mesh_mod

    mesh = mesh_mod.get_mesh()
    axes = ("dp", "sharding")
    if mesh is None or mesh.degree(axes) <= 1:
        return None
    return mesh.group(axes), mesh.group_ranks(axes)[0]


def _batch_norm_grad_maker(ins, outs, ogs):
    return "batch_norm_grad", {
        "X": ins["X"], "Scale": ins["Scale"], "Bias": ins["Bias"],
        "Mean": ins["Mean"], "Variance": ins["Variance"],
        "SavedMean": outs["SavedMean"], "SavedVariance": outs["SavedVariance"],
        "Y" + GRAD_SUFFIX: ogs["Y"]}


@register_op("batch_norm", nondiff_slots=("Mean", "Variance"),
             nondiff_out_slots=("MeanOut", "VarianceOut", "SavedMean",
                                "SavedVariance"),
             grad_maker=_batch_norm_grad_maker)
def batch_norm_kernel(ins, attrs):
    """Batch statistics in one pass over x shifted by a per-channel value
    of its first sample (the reference's form), or the running ones in
    eval; MeanOut / VarianceOut are the updated running statistics.
    Under a data-parallel group (:func:`_data_group`) the batch is the
    global one: the shift is the global first sample's (broadcast from
    the rank that holds it), and the count, the shifted sum and the
    shifted sum of squares are all-reduced in fp32, so every rank
    normalises by, and updates its running statistics with, the global
    mean and (population) variance, as the reference does."""
    x = ins["X"]
    scale, bias = ins["Scale"], ins["Bias"]
    mean_rt, var_rt = ins["Mean"], ins["Variance"]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False) and not attrs.get(
        "trainable_statistics", False)
    use_global = attrs.get("use_global_stats", False) or is_test
    layout = attrs.get("data_layout", "NCHW")
    axes, bshape = _bn_axes(x, layout)
    xf = x.float()
    if use_global:
        mean, var = mean_rt, var_rt
        mean_out, var_out = mean_rt, var_rt
        saved_mean, saved_var = mean_rt, torch.rsqrt(var_rt + eps)
    else:
        if layout == "NHWC":
            first = xf[(slice(0, 1),) * (x.ndim - 1)]
        else:
            first = xf[(slice(0, 1), slice(None))
                       + (slice(0, 1),) * (x.ndim - 2)]
        shift = torch.mean(first, dim=axes).detach()
        data = _data_group()
        if data is not None:
            shift = shift.contiguous()
            dist.broadcast(shift, src=data[1], group=data[0])
        xc = xf - shift.reshape(bshape)
        if data is None:
            mean_c = torch.mean(xc, dim=axes)
            msq = torch.mean(torch.square(xc), dim=axes)
        else:
            c = shift.numel()
            sums = torch.cat([torch.sum(xc, dim=axes),
                              torch.sum(torch.square(xc), dim=axes),
                              xc.new_full((1,), xc.numel() // c)])
            dist.all_reduce(sums, group=data[0])
            mean_c, msq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        var = torch.clamp_min(msq - torch.square(mean_c), 0.0)
        mean = mean_c + shift
        mean_out = momentum * mean_rt + (1.0 - momentum) * mean
        var_out = momentum * var_rt + (1.0 - momentum) * var
        saved_mean, saved_var = mean, torch.rsqrt(var + eps)
    inv_std = torch.rsqrt(var + eps)
    y = (xf - mean.reshape(bshape)) * inv_std.reshape(bshape)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    return {"Y": y.to(x.dtype), "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": saved_mean, "SavedVariance": saved_var}


@register_op("batch_norm_grad", no_grad=True)
def batch_norm_grad_kernel(ins, attrs):
    x, scale = ins["X"], ins["Scale"]
    dy = ins["Y" + GRAD_SUFFIX]
    eps = attrs.get("epsilon", 1e-5)
    use_global = attrs.get("use_global_stats", False) or attrs.get(
        "is_test", False)
    axes, bshape = _bn_axes(x, attrs.get("data_layout", "NCHW"))
    xf, dyf = x.float(), dy.float()
    m = 1
    for a in axes:
        m *= x.shape[a]
    if use_global:
        inv_std = torch.rsqrt(ins["Variance"] + eps)
        xhat = (xf - ins["Mean"].reshape(bshape)) * inv_std.reshape(bshape)
        dx = dyf * (scale * inv_std).reshape(bshape)
        dscale = torch.sum(dyf * xhat, dim=axes)
        dbias = torch.sum(dyf, dim=axes)
    else:
        inv_std = ins["SavedVariance"]  # rsqrt(var + eps)
        xhat = (xf - ins["SavedMean"].reshape(bshape)) \
            * inv_std.reshape(bshape)
        dbias = torch.sum(dyf, dim=axes)
        dscale = torch.sum(dyf * xhat, dim=axes)
        # under a data-parallel group dx takes the global batch's sums
        # and count; the parameters' gradients stay this rank's, which
        # the data-parallel wrapper averages
        gb, gs, n = dbias, dscale, m
        data = _data_group()
        if data is not None:
            c = dbias.numel()
            sums = torch.cat([dbias, dscale, dbias.new_full((1,), m)])
            dist.all_reduce(sums, group=data[0])
            gb, gs, n = sums[:c], sums[c:2 * c], sums[-1]
        dx = ((scale * inv_std).reshape(bshape) / n
              * (n * dyf - gb.reshape(bshape) - xhat * gs.reshape(bshape)))
    return {"X" + GRAD_SUFFIX: dx.to(x.dtype), "Scale" + GRAD_SUFFIX: dscale,
            "Bias" + GRAD_SUFFIX: dbias}


def _moments(xf, axes):
    """Mean and population variance over ``axes`` (kept)."""
    var, mean = torch.var_mean(xf, dim=axes, correction=0, keepdim=True)
    return mean, var


@register_op("layer_norm", nondiff_out_slots=("Mean", "Variance"))
def layer_norm_kernel(ins, attrs):
    """LayerNorm over the dims from ``begin_norm_axis``, in fp32, cast
    back to x's dtype."""
    x = ins["X"]
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(bna, x.ndim))
    xf = x.float()
    mean, var = _moments(xf, axes)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = tuple(x.shape[bna:])
    if ins.get("Scale") is not None:
        y = y * ins["Scale"].reshape(norm_shape).float()
    if ins.get("Bias") is not None:
        y = y + ins["Bias"].reshape(norm_shape).float()
    return {"Y": y.to(x.dtype), "Mean": mean.squeeze(axes),
            "Variance": var.squeeze(axes)}


@register_op("group_norm", nondiff_out_slots=("Mean", "Variance"))
def group_norm_kernel(ins, attrs):
    x = ins["X"]  # NCHW
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:])).float()
    axes = tuple(range(2, xg.ndim))
    mean, var = _moments(xg, axes)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    cshape = (1, c) + (1,) * (x.ndim - 2)
    if ins.get("Scale") is not None:
        y = y * ins["Scale"].reshape(cshape)
    if ins.get("Bias") is not None:
        y = y + ins["Bias"].reshape(cshape)
    return {"Y": y.to(x.dtype), "Mean": mean.squeeze(axes),
            "Variance": var.squeeze(axes)}


@register_op("instance_norm",
             nondiff_out_slots=("SavedMean", "SavedVariance"))
def instance_norm_kernel(ins, attrs):
    x = ins["X"]
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    mean, var = _moments(x.float(), axes)
    y = (x.float() - mean) * torch.rsqrt(var + eps)
    cshape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    if ins.get("Scale") is not None:
        y = y * ins["Scale"].reshape(cshape)
    if ins.get("Bias") is not None:
        y = y + ins["Bias"].reshape(cshape)
    return {"Y": y.to(x.dtype), "SavedMean": mean.squeeze(axes),
            "SavedVariance": var.squeeze(axes)}


# ---------------------------------------------------------------------------
# dropout (hand-written grad: reuses the Mask)
# ---------------------------------------------------------------------------


def _dropout_grad_maker(ins, outs, ogs):
    return "dropout_grad", {"Mask": outs["Mask"],
                            "Out" + GRAD_SUFFIX: ogs["Out"]}


@register_op("dropout", needs_rng=True, nondiff_out_slots=("Mask",),
             grad_maker=_dropout_grad_maker)
def dropout_kernel(ins, attrs, rng=None):
    """The op of :func:`dropout`, with the reference's attributes
    (``dropout_prob``, ``is_test``, ``dropout_implementation`` and a mask
    restricted to ``axis``); the Mask (uint8) is saved for the
    backward."""
    x = ins["X"]
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False)
    impl = attrs.get("dropout_implementation", "upscale_in_train")
    ones = torch.ones(tuple(x.shape), dtype=torch.uint8, device=x.device)
    if p == 0.0 and not is_test:
        return {"Out": x.view_as(x), "Mask": ones}
    if is_test:
        if impl == "upscale_in_train":
            return {"Out": x.view_as(x), "Mask": ones}
        return {"Out": x * (1.0 - p), "Mask": ones}
    axes = attrs.get("axis")
    if axes is not None:
        axes = [axes] if isinstance(axes, int) else list(axes)
        mask_shape = tuple(x.shape[i] if i in axes else 1
                           for i in range(x.ndim))
    else:
        mask_shape = tuple(x.shape)
    keep = _random.draw(rng, mask_shape, x.device) < np.float32(1.0 - p)
    keep = torch.broadcast_to(keep, tuple(x.shape))
    if impl == "upscale_in_train":
        scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
        out = torch.where(keep, x * torch.tensor(scale, dtype=x.dtype),
                          torch.zeros_like(x))
    else:
        out = torch.where(keep, x, torch.zeros_like(x))
    return {"Out": out, "Mask": keep.to(torch.uint8)}


@register_op("dropout_grad", no_grad=True)
def dropout_grad_kernel(ins, attrs):
    dy = ins["Out" + GRAD_SUFFIX]
    mask = ins["Mask"].to(dy.dtype)
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("dropout_implementation",
                 "upscale_in_train") == "upscale_in_train":
        scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
        dx = dy * mask * torch.tensor(scale, dtype=dy.dtype)
    else:
        dx = dy * mask
    return {"X" + GRAD_SUFFIX: dx}


# ---------------------------------------------------------------------------
# softmax + cross entropy (fused; hand-written grad)
# ---------------------------------------------------------------------------


def _swce_grad_maker(ins, outs, ogs):
    return "softmax_with_cross_entropy_grad", {
        "Softmax": outs["Softmax"], "Label": ins["Label"],
        "Loss" + GRAD_SUFFIX: ogs["Loss"]}


def _hard_label(label, axis, ndim, ignore_index):
    lab = label
    if lab.ndim == ndim:
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    return torch.where(valid, lab, torch.zeros_like(lab)).long(), valid


@register_op("softmax_with_cross_entropy", nondiff_slots=("Label",),
             nondiff_out_slots=("Softmax",), grad_maker=_swce_grad_maker)
def softmax_with_cross_entropy_kernel(ins, attrs):
    """The log-sum-exp form, always numerically stable; hard labels equal
    to ``ignore_index`` (whatever its sign) give 0."""
    logits, label = ins["Logits"], ins["Label"]
    axis = attrs.get("axis", -1) % logits.ndim
    ignore_index = attrs.get("ignore_index", -100)
    lse = torch.logsumexp(logits, dim=axis, keepdim=True)
    log_softmax = logits - lse
    softmax = torch.exp(log_softmax)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * log_softmax, dim=axis, keepdim=True)
    else:
        safe, valid = _hard_label(label, axis, logits.ndim, ignore_index)
        safe = safe.clamp(0, logits.shape[axis] - 1)
        picked = torch.take_along_dim(log_softmax, safe.unsqueeze(axis),
                                      dim=axis)
        loss = torch.where(valid.unsqueeze(axis), -picked,
                           torch.zeros_like(picked))
    return {"Softmax": softmax, "Loss": loss.to(logits.dtype)}


@register_op("softmax_with_cross_entropy_grad", no_grad=True)
def softmax_with_cross_entropy_grad_kernel(ins, attrs):
    softmax, label = ins["Softmax"], ins["Label"]
    dloss = ins["Loss" + GRAD_SUFFIX]
    axis = attrs.get("axis", -1) % softmax.ndim
    if attrs.get("soft_label", False):
        dlogits = (softmax - label) * dloss
    else:
        safe, valid = _hard_label(label, axis, softmax.ndim,
                                  attrs.get("ignore_index", -100))
        onehot = F.one_hot(safe, softmax.shape[axis]).to(softmax.dtype)
        onehot = onehot.movedim(-1, axis)
        dlogits = (softmax - onehot) * dloss
        dlogits = torch.where(valid.unsqueeze(axis), dlogits,
                              torch.zeros_like(dlogits))
    return {"Logits" + GRAD_SUFFIX: dlogits}


@register_op("cross_entropy", nondiff_slots=("Label",))
def cross_entropy_kernel(ins, attrs):
    """X is probabilities (not logits)."""
    x, label = ins["X"], ins["Label"]
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp_min(x, 1e-12)),
                          dim=-1, keepdim=True)
    else:
        lab = label.squeeze(-1) if label.ndim == x.ndim else label
        lab = lab.long().clamp(0, x.shape[-1] - 1)
        picked = torch.take_along_dim(x, lab.unsqueeze(-1), dim=-1)
        loss = -torch.log(torch.clamp_min(picked, 1e-12))
    return {"Y": loss}


@register_op("sigmoid_cross_entropy_with_logits")
def bce_with_logits_kernel(ins, attrs):
    x, label = ins["X"], ins["Label"]
    loss = torch.clamp_min(x, 0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))
    ignore_index = attrs.get("ignore_index", -100)
    if ignore_index >= 0:
        loss = torch.where(label == ignore_index, torch.zeros_like(loss),
                           loss)
    if attrs.get("normalize", False):
        norm = torch.clamp_min(torch.sum((label != ignore_index).to(
            loss.dtype)), 1.0)
        loss = loss / norm
    return {"Out": loss}


@register_op("bce_loss")
def bce_loss_kernel(ins, attrs):
    x, label = ins["X"], ins["Label"]
    x = torch.clamp(x, 1e-12, 1.0 - 1e-7)
    return {"Out": -(label * torch.log(x) + (1.0 - label) * torch.log1p(-x))}


@register_op("huber_loss", nondiff_out_slots=("Residual",))
def huber_loss_kernel(ins, attrs):
    x, y = ins["X"], ins["Y"]
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    loss = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {"Out": loss, "Residual": r}


@register_op("smooth_l1_loss", nondiff_out_slots=("Diff",))
def smooth_l1_kernel(ins, attrs):
    x, y = ins["X"], ins["Y"]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    return {"Out": torch.sum(loss, dim=-1, keepdim=True), "Diff": d}


@register_op("kldiv_loss")
def kldiv_loss_kernel(ins, attrs):
    x, target = ins["X"], ins["Target"]
    loss = target * (torch.log(torch.clamp_min(target, 1e-12)) - x)
    loss = torch.where(target > 0, loss, torch.zeros_like(loss))
    red = attrs.get("reduction", "mean")
    if red == "mean":
        return {"Loss": torch.mean(loss)}
    if red == "sum":
        return {"Loss": torch.sum(loss)}
    if red == "batchmean":
        return {"Loss": torch.sum(loss) / x.shape[0]}
    return {"Loss": loss}


@register_op("square_error_cost")
def square_error_cost_kernel(ins, attrs):
    return {"Out": torch.square(ins["X"] - ins["Y"])}


@register_op("accuracy", nondiff_slots=("Out", "Indices", "Label"),
             no_grad=True)
def accuracy_kernel(ins, attrs):
    """The share of samples whose top-k Indices hit Label."""
    indices, label = ins["Indices"], ins["Label"]
    if label.ndim < indices.ndim:
        label = label[..., None]
    correct = torch.any(indices == label, dim=-1)
    return {"Accuracy": torch.mean(correct.float()),
            "Correct": torch.sum(correct.to(torch.int32)).to(torch.int32),
            "Total": torch.tensor(label.shape[0], dtype=torch.int32,
                                  device=label.device)}


@register_op("label_smooth")
def label_smooth_kernel(ins, attrs):
    x = ins["X"]
    eps = attrs.get("epsilon", 0.0)
    return {"Out": (1.0 - eps) * x + eps / x.shape[-1]}


@register_op("norm", nondiff_out_slots=("Norm",))
def norm_kernel(ins, attrs):
    x = ins["X"]
    n = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                             keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": x / n, "Norm": n}


def _data_norm_grad_maker(ins, outs, ogs):
    return "data_norm_grad", {
        "X": ins["X"], "BatchSize": ins["BatchSize"],
        "BatchSum": ins["BatchSum"], "BatchSquareSum": ins["BatchSquareSum"],
        "Y" + GRAD_SUFFIX: ogs["Y"]}


@register_op("data_norm", nondiff_slots=("BatchSize", "BatchSum",
                                         "BatchSquareSum"),
             nondiff_out_slots=("BatchSizeOut", "BatchSumOut",
                                "BatchSquareSumOut"),
             grad_maker=_data_norm_grad_maker,
             grad_rebinds={"BatchSizeOut": "BatchSize",
                           "BatchSumOut": "BatchSum",
                           "BatchSquareSumOut": "BatchSquareSum"})
def data_norm_kernel(ins, attrs):
    """y = (x - sum / size) * sqrt(size / square_sum); the statistics'
    update runs in the grad op, as in the reference."""
    x = ins["X"]
    size = ins["BatchSize"].detach()
    ssum = ins["BatchSum"].detach()
    ssq = ins["BatchSquareSum"].detach()
    y = (x - ssum / size) * torch.sqrt(size / ssq)
    return {"Y": y, "BatchSizeOut": size, "BatchSumOut": ssum,
            "BatchSquareSumOut": ssq}


@register_op("data_norm_grad", no_grad=True)
def data_norm_grad_kernel(ins, attrs):
    """dX = dY * scale, plus the statistics' update (training only)."""
    x = ins["X"]
    dy = ins["Y" + GRAD_SUFFIX]
    size, ssum, ssq = ins["BatchSize"], ins["BatchSum"], \
        ins["BatchSquareSum"]
    mean = ssum / size
    scale = torch.sqrt(size / ssq)
    out = {"BatchSizeOut": size, "BatchSumOut": ssum,
           "BatchSquareSumOut": ssq}
    if not attrs.get("is_test", False):
        decay = attrs.get("summary_decay_rate", 0.9999999)
        out = {"BatchSizeOut": decay * size + x.shape[0],
               "BatchSumOut": decay * ssum + torch.sum(x, dim=0),
               "BatchSquareSumOut": decay * ssq
               + torch.sum(torch.square(x - mean), dim=0)}
    out["X" + GRAD_SUFFIX] = dy * scale
    return out


@register_op("fused_softmax_mask")
def fused_softmax_mask_kernel(ins, attrs):
    """softmax(x + mask) in fp32."""
    x = ins["X"]
    s = x.float() + ins["Mask"].float()
    s = s - torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s)
    return {"Out": (e / torch.sum(e, dim=-1, keepdim=True)).to(x.dtype)}


@register_op("fused_softmax_mask_upper_triangle")
def fused_softmax_mask_upper_triangle_kernel(ins, attrs):
    """The causal softmax: keys after the query's position get -1e9."""
    x = ins["X"]
    q, k = x.shape[-2], x.shape[-1]
    mask = torch.tril(torch.ones((q, k), dtype=torch.bool, device=x.device),
                      diagonal=k - q)
    s = torch.where(mask, x.float(), torch.tensor(-1e9))
    s = s - torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s) * mask
    return {"Out": (e / torch.clamp_min(torch.sum(e, dim=-1, keepdim=True),
                                        1e-30)).to(x.dtype)}


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@register_op("scaled_dot_product_attention", needs_rng=True)
def sdpa_kernel(ins, attrs, rng=None):
    """:func:`~paddle_tpu_torch.kernels.attention.sdpa`: on the card the
    flash kernels (forward here, dQ and dK/dV in the backward), on the
    CPU their plain version; dropout with the op's key."""
    p = 0.0 if attrs.get("is_test", False) else attrs.get("dropout_p", 0.0)
    return {"Out": _attention.sdpa(
        ins["Q"], ins["K"], ins["V"], mask=ins.get("Mask"),
        scale=attrs.get("scale"), is_causal=attrs.get("is_causal", False),
        dropout_p=p, layout=attrs.get("layout", "bnsd"),
        window=attrs.get("window"), key=rng)}

"""Program -> ONNX GraphProto.

Counterpart of ``paddle_tpu/onnx/convert.py`` (the reference hands ONNX
export to the external ``paddle2onnx`` package): each op of the port's
``Program`` appends ONNX nodes through its converter, the scope's
persistable values become initializers, and :mod:`.proto` encodes the
result.  The op map is the JAX package's: the op types and attribute
names of a traced inference program (Linear, Conv, BatchNorm, LayerNorm,
pools, activations, softmax, elementwise and shape ops).  An op without a
converter raises, naming it.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..framework.dtype import convert_dtype
from . import proto


class _Ctx:
    def __init__(self, block, opset=17):
        self.block = block
        self.opset = opset  # requested target opset (node-form selection)
        self.nodes: List[bytes] = []
        self.extra_inits: List[bytes] = []
        self.min_opset = 13  # raised by converters needing newer forms
        self._n = 0

    def emit(self, op_type, inputs, outputs, **attrs):
        self._n += 1
        self.nodes.append(proto.node(
            op_type, inputs, outputs, name=f"{op_type}_{self._n}",
            attrs=attrs or None))

    def require_opset(self, v: int):
        self.min_opset = max(self.min_opset, v)

    def tmp(self, hint="t"):
        self._n += 1
        return f"_onnx_{hint}_{self._n}"

    def const_i64(self, values, hint="shape"):
        name = self.tmp(hint)
        arr = np.asarray(values, "int64")
        self.extra_inits.append(proto.tensor(
            name, arr.shape, proto.DTYPE["int64"], arr.tobytes()))
        return name

    def const_f32(self, values, hint="c"):
        name = self.tmp(hint)
        arr = np.asarray(values, "float32")
        self.extra_inits.append(proto.tensor(
            name, arr.shape, proto.DTYPE["float32"], arr.tobytes()))
        return name

    def rank(self, var_name):
        v = self.block._var_recursive(var_name)
        return len(tuple(v.shape)) if v.shape is not None else None

    def shape(self, var_name):
        v = self.block._var_recursive(var_name)
        return list(v.shape) if v.shape is not None else None


def _unary(onnx_type):
    def cv(ctx, op):
        ctx.emit(onnx_type, [op.input("X")[0]], [op.output("Out")[0]])
    return cv


def _binary(onnx_type):
    def cv(ctx, op):
        x, y = op.input("X")[0], op.input("Y")[0]
        axis = op.attrs.get("axis", -1)
        xr, yr = ctx.rank(x), ctx.rank(y)
        if axis not in (-1, None) and xr and yr and axis != xr - yr:
            # paddle mid-axis broadcast (e.g. conv bias at axis=1): align Y
            # by appending trailing 1-dims so numpy/ONNX broadcasting matches
            yshape = list(ctx.block._var_recursive(y).shape)
            new_shape = yshape + [1] * (xr - axis - yr)
            ry = ctx.tmp("bcast")
            ctx.emit("Reshape", [y, ctx.const_i64(new_shape)], [ry])
            y = ry
        ctx.emit(onnx_type, [x, y], [op.output("Out")[0]])
    return cv


def _cv_matmul(ctx, op):
    x, y = op.input("X")[0], op.input("Y")[0]
    for slot, flag in (("X", "trans_x"), ("Y", "trans_y")):
        if op.attrs.get(flag):
            src = x if slot == "X" else y
            r = ctx.rank(src)
            perm = list(range(r))
            perm[-1], perm[-2] = perm[-2], perm[-1]
            t = ctx.tmp("trans")
            ctx.emit("Transpose", [src], [t], perm=perm)
            if slot == "X":
                x = t
            else:
                y = t
    ctx.emit("MatMul", [x, y], [op.output("Out")[0]])


def _onnx_pads(paddings):
    """Paddle 2-elt [h, w] or 4-elt [top, bottom, left, right] paddings
    (ops/nn_ops.py:_conv_padding) -> ONNX [top, left, bottom, right]."""
    p = [int(v) for v in paddings]
    if len(p) == 2:
        return [p[0], p[1], p[0], p[1]]
    return [p[0], p[2], p[1], p[3]]


def _cv_conv2d(ctx, op):
    a = op.attrs
    pads = _onnx_pads(a.get("paddings", [0, 0]))
    ctx.emit("Conv", [op.input("Input")[0], op.input("Filter")[0]],
             [op.output("Output")[0]],
             strides=list(a.get("strides", [1, 1])),
             pads=pads,
             dilations=list(a.get("dilations", [1, 1])),
             group=int(a.get("groups", 1)))


def _cv_pool2d(ctx, op):
    a = op.attrs
    x, out = op.input("X")[0], op.output("Out")[0]
    if a.get("global_pooling") or (a.get("adaptive") and
                                   list(a.get("ksize")) == [1, 1]):
        kind = ("GlobalAveragePool" if a.get("pooling_type") == "avg"
                else "GlobalMaxPool")
        ctx.emit(kind, [x], [out])
        return
    if a.get("adaptive"):
        # adaptive pooling derives kernel/stride from the in/out sizes; it
        # only maps onto a plain ONNX pool when the input divides evenly
        shape = ctx.shape(x)
        osize = [int(v) for v in a.get("ksize")]
        hw = ([int(d) for d in shape[2:4]]
              if shape and len(shape) >= 4
              and all(d is not None and int(d) > 0 for d in shape[2:4])
              else None)
        if hw is None or any(i % o for i, o in zip(hw, osize)):
            raise NotImplementedError(
                f"adaptive pool2d with output {osize} on input {shape}: "
                "not expressible as a fixed-kernel ONNX pool")
        kern = [i // o for i, o in zip(hw, osize)]
        kind = ("AveragePool" if a.get("pooling_type") == "avg"
                else "MaxPool")
        ctx.emit(kind, [x], [out], kernel_shape=kern, strides=kern,
                 pads=[0, 0, 0, 0])
        return
    pads = _onnx_pads(a.get("paddings", [0, 0]))
    kind = "AveragePool" if a.get("pooling_type") == "avg" else "MaxPool"
    attrs = dict(kernel_shape=list(a.get("ksize")),
                 strides=list(a.get("strides", a.get("ksize"))),
                 pads=pads,
                 ceil_mode=int(bool(a.get("ceil_mode", False))))
    if kind == "AveragePool" and not a.get("exclusive", True):
        # paddle exclusive=False divides by the full window incl. padding
        attrs["count_include_pad"] = 1
    ctx.emit(kind, [x], [out], **attrs)


def _cv_batch_norm(ctx, op):
    ctx.emit("BatchNormalization",
             [op.input("X")[0], op.input("Scale")[0], op.input("Bias")[0],
              op.input("Mean")[0], op.input("Variance")[0]],
             [op.output("Y")[0]],
             epsilon=float(op.attrs.get("epsilon", 1e-5)),
             momentum=float(op.attrs.get("momentum", 0.9)))


def _cv_layer_norm(ctx, op):
    ctx.require_opset(17)  # LayerNormalization
    ctx.emit("LayerNormalization",
             [op.input("X")[0], op.input("Scale")[0], op.input("Bias")[0]],
             [op.output("Y")[0]],
             axis=int(op.attrs.get("begin_norm_axis", -1)),
             epsilon=float(op.attrs.get("epsilon", 1e-5)))


def _cv_softmax(ctx, op):
    ctx.emit("Softmax", [op.input("X")[0]], [op.output("Out")[0]],
             axis=int(op.attrs.get("axis", -1)))


def _cv_flatten(ctx, op):
    # ONNX Flatten always produces rank 2 (collapse around one axis), which
    # only matches paddle's flatten_contiguous_range for start_axis=1,
    # stop_axis=-1 on rank-N inputs; every other case lowers to Reshape
    # with the statically-known target shape.
    start = int(op.attrs.get("start_axis", 1))
    stop = int(op.attrs.get("stop_axis", -1))
    x, out = op.input("X")[0], op.output("Out")[0]
    shape = ctx.shape(x)
    if shape is None:
        raise NotImplementedError("flatten of unknown-rank input")
    r = len(shape)
    if start < 0:
        start += r
    if stop < 0:
        stop += r
    if start == 1 and stop == r - 1:
        ctx.emit("Flatten", [x], [out], axis=1)
        return
    def known(d):
        return d is not None and int(d) >= 0

    seg = shape[start:stop + 1]
    collapsed = (int(np.prod([int(d) for d in seg])) if seg
                 and all(known(d) for d in seg) else (-1 if seg else 1))
    # Reshape's 0 copies the input dim at the SAME index — valid only for
    # the leading (unshifted) dims; trailing dims shift by the collapse, so
    # they need static values (at most one -1 in the whole shape).
    lead = [0 if not known(d) else int(d) for d in shape[:start]]
    trail = []
    for d in shape[stop + 1:]:
        if known(d):
            trail.append(int(d))
        elif collapsed != -1:
            trail.append(-1)
            if trail.count(-1) > 1:
                raise NotImplementedError(
                    "flatten: multiple unknown trailing dims")
        else:
            raise NotImplementedError(
                "flatten: unknown dims both inside and after the "
                "collapsed range")
    new_shape = lead + [collapsed] + trail
    if new_shape.count(-1) > 1:
        raise NotImplementedError("flatten: shape underdetermined")
    ctx.emit("Reshape", [x, ctx.const_i64(new_shape)], [out])


def _cv_reshape(ctx, op):
    shape = list(op.attrs.get("shape", []))
    ctx.emit("Reshape", [op.input("X")[0], ctx.const_i64(shape)],
             [op.output("Out")[0]])


def _cv_transpose(ctx, op):
    ctx.emit("Transpose", [op.input("X")[0]], [op.output("Out")[0]],
             perm=list(op.attrs.get("axis")))


def _cv_scale(ctx, op):
    a = op.attrs
    x, out = op.input("X")[0], op.output("Out")[0]
    scale, bias = float(a.get("scale", 1.0)), float(a.get("bias", 0.0))
    after = bool(a.get("bias_after_scale", True))
    sname = ctx.const_f32([scale], "scale")
    if bias == 0.0:
        ctx.emit("Mul", [x, sname], [out])
        return
    bname = ctx.const_f32([bias], "bias")
    t = ctx.tmp("scale_t")
    if after:  # scale*x + bias
        ctx.emit("Mul", [x, sname], [t])
        ctx.emit("Add", [t, bname], [out])
    else:      # scale*(x + bias)
        ctx.emit("Add", [x, bname], [t])
        ctx.emit("Mul", [t, sname], [out])


def _cv_gelu(ctx, op):
    x, out = op.input("X")[0], op.output("Out")[0]
    if op.attrs.get("approximate"):
        # tanh approximation: 0.5x(1 + tanh(sqrt(2/pi)(x + 0.044715 x^3)))
        x3 = ctx.tmp("x3")
        ctx.emit("Mul", [x, x], [x3 + "_sq"])
        ctx.emit("Mul", [x3 + "_sq", x], [x3])
        ka = ctx.tmp("inner")
        ctx.emit("Mul", [x3, ctx.const_f32([0.044715])], [ka + "_c"])
        ctx.emit("Add", [x, ka + "_c"], [ka])
        th = ctx.tmp("tanh")
        ctx.emit("Mul", [ka, ctx.const_f32([float(np.sqrt(2.0 / np.pi))])],
                 [th + "_s"])
        ctx.emit("Tanh", [th + "_s"], [th])
        ctx.emit("Add", [th, ctx.const_f32([1.0])], [th + "_1"])
        xm = ctx.tmp("xmul")
        ctx.emit("Mul", [x, th + "_1"], [xm])
        ctx.emit("Mul", [xm, ctx.const_f32([0.5])], [out])
        return
    # exact: 0.5 * x * (1 + erf(x / sqrt(2)))
    inv = ctx.tmp("gelu_div")
    ctx.emit("Mul", [x, ctx.const_f32([float(1.0 / np.sqrt(2.0))])], [inv])
    e = ctx.tmp("erf")
    ctx.emit("Erf", [inv], [e])
    ep = ctx.tmp("erf1")
    ctx.emit("Add", [e, ctx.const_f32([1.0])], [ep])
    xm = ctx.tmp("xmul")
    ctx.emit("Mul", [x, ep], [xm])
    ctx.emit("Mul", [xm, ctx.const_f32([0.5])], [out])


def _cv_dropout(ctx, op):
    # inference graphs only: dropout is identity
    ctx.emit("Identity", [op.input("X")[0]], [op.output("Out")[0]])


def _cv_cast(ctx, op):
    to = proto.DTYPE[convert_dtype(op.attrs["out_dtype"])]
    ctx.emit("Cast", [op.input("X")[0]], [op.output("Out")[0]], to=to)


def _cv_reduce(onnx_type):
    def cv(ctx, op):
        a = op.attrs
        axes = a.get("dim", a.get("axis"))
        keep = int(bool(a.get("keep_dim", a.get("keepdim", False))))
        have_axes = axes is not None and not a.get("reduce_all", False)
        axes = [int(v) for v in np.atleast_1d(axes)] if have_axes else None
        if onnx_type == "ReduceSum" or ctx.opset >= 18:
            # ReduceSum takes axes as an INPUT from opset 13; the other
            # reductions (Mean/Max/...) switch from attribute to input at
            # opset 18 — emit the right form for the requested target.
            ins = [op.input("X")[0]]
            if axes is not None:
                ins.append(ctx.const_i64(axes, "axes"))
            ctx.emit(onnx_type, ins, [op.output("Out")[0]], keepdims=keep)
            return
        attrs = {"keepdims": keep}
        if axes is not None:
            attrs["axes"] = axes
        ctx.emit(onnx_type, [op.input("X")[0]], [op.output("Out")[0]],
                 **attrs)
    return cv


def _cv_unsqueeze(ctx, op):
    axes = [int(v) for v in op.attrs.get("axes", [])]
    ctx.emit("Unsqueeze", [op.input("X")[0], ctx.const_i64(axes, "axes")],
             [op.output("Out")[0]])


def _cv_squeeze(ctx, op):
    axes = [int(v) for v in op.attrs.get("axes", [])]
    ins = [op.input("X")[0]]
    if axes:
        ins.append(ctx.const_i64(axes, "axes"))
    ctx.emit("Squeeze", ins, [op.output("Out")[0]])


def _cv_concat(ctx, op):
    ctx.emit("Concat", list(op.input("X")), [op.output("Out")[0]],
             axis=int(op.attrs.get("axis", 0)))


def _cv_clip(ctx, op):
    x, out = op.input("X")[0], op.output("Out")[0]
    lo = ctx.const_f32(float(op.attrs.get("min", -3.4e38)), "min")
    hi = ctx.const_f32(float(op.attrs.get("max", 3.4e38)), "max")
    ctx.emit("Clip", [x, lo, hi], [out])


_CONVERTERS = {
    "matmul_v2": _cv_matmul,
    "matmul": _cv_matmul,
    "mul": _cv_matmul,
    "elementwise_add": _binary("Add"),
    "elementwise_sub": _binary("Sub"),
    "elementwise_mul": _binary("Mul"),
    "elementwise_div": _binary("Div"),
    "elementwise_pow": _binary("Pow"),
    "elementwise_max": _binary("Max"),
    "elementwise_min": _binary("Min"),
    "relu": _unary("Relu"),
    "sigmoid": _unary("Sigmoid"),
    "tanh": _unary("Tanh"),
    "exp": _unary("Exp"),
    "log": _unary("Log"),
    "sqrt": _unary("Sqrt"),
    "abs": _unary("Abs"),
    "floor": _unary("Floor"),
    "ceil": _unary("Ceil"),
    "erf": _unary("Erf"),
    "leaky_relu": lambda ctx, op: ctx.emit(
        "LeakyRelu", [op.input("X")[0]], [op.output("Out")[0]],
        alpha=float(op.attrs.get("alpha", 0.01))),
    "hard_sigmoid": lambda ctx, op: ctx.emit(
        "HardSigmoid", [op.input("X")[0]], [op.output("Out")[0]],
        alpha=float(op.attrs.get("slope", 0.2)),
        beta=float(op.attrs.get("offset", 0.5))),
    "gelu": _cv_gelu,
    "softmax": _cv_softmax,
    "conv2d": _cv_conv2d,
    "depthwise_conv2d": _cv_conv2d,
    "pool2d": _cv_pool2d,
    "batch_norm": _cv_batch_norm,
    "layer_norm": _cv_layer_norm,
    "flatten_contiguous_range": _cv_flatten,
    "reshape2": _cv_reshape,
    "reshape": _cv_reshape,
    "transpose2": _cv_transpose,
    "transpose": _cv_transpose,
    "scale": _cv_scale,
    "dropout": _cv_dropout,
    "cast": _cv_cast,
    "reduce_mean": _cv_reduce("ReduceMean"),
    "reduce_sum": _cv_reduce("ReduceSum"),
    "reduce_max": _cv_reduce("ReduceMax"),
    "unsqueeze2": _cv_unsqueeze,
    "unsqueeze": _cv_unsqueeze,
    "squeeze2": _cv_squeeze,
    "squeeze": _cv_squeeze,
    "concat": _cv_concat,
    "clip": _cv_clip,
}


def _host_bytes(value):
    """(ONNX dtype, shape, raw little-endian bytes) of a scope value on
    any device; None for a dtype ONNX export does not carry."""
    import torch

    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value))
    t = value.detach().cpu().contiguous()
    dt = proto.DTYPE.get(convert_dtype(t.dtype))
    if dt is None:
        return None
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return dt, tuple(t.shape), t.numpy().tobytes()


def convert_program(program, scope, feed_names: List[str],
                    fetch_names: List[str], opset_version: int = 17,
                    graph_name: str = "paddle_tpu_torch") -> bytes:
    """A Program's global block as a serialized ONNX ModelProto."""
    block = program.global_block()
    ctx = _Ctx(block, opset=opset_version)
    if opset_version < 13:
        raise ValueError(
            "ONNX export emits opset-13+ node forms (ReduceSum/Squeeze/"
            f"Unsqueeze axes as inputs, Clip min/max inputs); requested "
            f"opset_version={opset_version} is below that")
    inits: List[bytes] = []
    for name, var in block.vars.items():
        if not getattr(var, "persistable", False) or name in feed_names:
            continue
        value = scope.find_var(name)
        if value is None:
            continue
        host = _host_bytes(value)
        if host is None:
            continue
        dt, shape, raw = host
        inits.append(proto.tensor(name, shape, dt, raw))

    for op in block.ops:
        if op.type in ("feed", "fetch"):
            continue
        cv = _CONVERTERS.get(op.type)
        if cv is None:
            raise NotImplementedError(
                f"ONNX export: op '{op.type}' has no converter (supported: "
                f"{sorted(_CONVERTERS)})")
        cv(ctx, op)

    def vinfo(name):
        var = block._var_recursive(name)
        dt = proto.DTYPE[convert_dtype(var.dtype)]
        shape = list(var.shape) if var.shape is not None else []
        return proto.value_info(name, dt, shape)

    if opset_version < ctx.min_opset:
        raise ValueError(
            f"graph needs opset >= {ctx.min_opset} (e.g. "
            f"LayerNormalization), requested {opset_version}")
    g = proto.graph(
        ctx.nodes, graph_name, inits + ctx.extra_inits,
        [vinfo(n) for n in feed_names],
        [vinfo(n) for n in fetch_names])
    return proto.model(g, opset_version=opset_version)

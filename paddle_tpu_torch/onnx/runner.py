"""A numpy interpreter of exported ONNX graphs.

Counterpart of ``paddle_tpu/onnx/runner.py``: no ``onnx`` or
``onnxruntime`` package is needed, so the exporter is checked by decoding
the serialized ModelProto (:mod:`.proto`'s reader) and running the graph
in numpy, over exactly the op set :mod:`.convert` emits.  A check, not a
deployment runtime (deploy through ``paddle.inference``'s Predictor).

``Conv`` runs as one product over the input's windows per group (im2col
through ``sliding_window_view``) where the JAX package's runner loops
over the output pixels; the sums come in another order, so the two agree
to float32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import proto

_NP_DTYPE = {v: k for k, v in proto.DTYPE.items()}


def _parse_tensor(buf: bytes):
    msg = proto.parse_message(buf)
    dims = [int(v) for v in msg.get(1, [])]
    dt = _NP_DTYPE[int(msg[2][0])]
    name = msg[8][0].decode() if 8 in msg else ""
    if dt == "bfloat16":
        import torch

        arr = torch.frombuffer(bytearray(msg[9][0]),
                               dtype=torch.bfloat16).float().numpy()
    else:
        arr = np.frombuffer(msg[9][0], dtype=dt)
    return name, arr.reshape(dims)


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_attr(buf: bytes):
    msg = proto.parse_message(buf)
    name = msg[1][0].decode()
    atype = int(msg[20][0]) if 20 in msg else None
    if atype == proto.ATTR_INT:
        return name, _signed(int(msg[3][0]))
    if atype == proto.ATTR_FLOAT:
        return name, float(msg[2][0])
    if atype == proto.ATTR_STRING:
        return name, msg[4][0].decode()
    if atype == proto.ATTR_INTS:
        return name, [_signed(int(v)) for v in msg.get(8, [])]
    if atype == proto.ATTR_FLOATS:
        return name, [float(v) for v in msg.get(7, [])]
    raise ValueError(f"attr {name}: unsupported type {atype}")


class Graph:
    def __init__(self, nodes, inits, input_names, output_names):
        self.nodes = nodes
        self.inits = inits
        self.input_names = input_names
        self.output_names = output_names


def load(path: str) -> Graph:
    with open(path, "rb") as f:
        m = proto.parse_message(f.read())
    g = proto.parse_message(m[7][0])
    nodes = []
    for nb in g.get(1, []):
        n = proto.parse_message(nb)
        nodes.append({
            "inputs": [v.decode() for v in n.get(1, [])],
            "outputs": [v.decode() for v in n.get(2, [])],
            "op": n[4][0].decode(),
            "attrs": dict(_parse_attr(a) for a in n.get(5, [])),
        })
    inits = dict(_parse_tensor(t) for t in g.get(5, []))

    def names(field):
        out = []
        for vb in g.get(field, []):
            out.append(proto.parse_message(vb)[1][0].decode())
        return out

    return Graph(nodes, inits, names(11), names(12))


def _conv2d(x, w, strides, pads, dilations, group):
    from numpy.lib.stride_tricks import sliding_window_view

    cout, cing, kh, kw = w.shape
    ph0, pw0, ph1, pw1 = pads
    x = np.pad(x, ((0, 0), (0, 0), (ph0, ph1), (pw0, pw1)))
    dh, dw = dilations
    sh, sw = strides
    eh, ew = dh * (kh - 1) + 1, dw * (kw - 1) + 1
    oh = (x.shape[2] - eh) // sh + 1
    ow = (x.shape[3] - ew) // sw + 1
    # (n, cin, oh, ow, kh, kw): each output pixel's window
    win = sliding_window_view(x, (eh, ew), axis=(2, 3))
    win = win[:, :, ::sh, ::sw, ::dh, ::dw][:, :, :oh, :ow]
    og = cout // group
    out = np.empty((x.shape[0], cout, oh, ow), "float32")
    for g in range(group):
        xs = win[:, g * cing:(g + 1) * cing]
        ws = w[g * og:(g + 1) * og]
        out[:, g * og:(g + 1) * og] = np.tensordot(
            xs, ws, axes=([1, 4, 5], [1, 2, 3])).transpose(0, 3, 1, 2)
    return out


def _pool2d(x, ksize, strides, pads, mode, ceil_mode=0,
            count_include_pad=0):
    kh, kw = ksize
    sh, sw = strides
    ph0, pw0, ph1, pw1 = pads
    fill = -np.inf if mode == "max" else 0.0
    xp = np.pad(x, ((0, 0), (0, 0), (ph0, ph1), (pw0, pw1)),
                constant_values=fill)
    # element-count map for exclusive (count_include_pad=0) averaging:
    # padded positions contribute 0 to both sum and divisor
    ones = np.pad(np.ones(x.shape[2:], "float32"),
                  ((ph0, ph1), (pw0, pw1)))
    rnd = np.ceil if ceil_mode else np.floor
    oh = int(rnd((xp.shape[2] - kh) / sh)) + 1
    ow = int(rnd((xp.shape[3] - kw) / sw)) + 1
    out = np.zeros(xp.shape[:2] + (oh, ow), "float32")
    for i in range(oh):
        for j in range(ow):
            patch = xp[:, :, i * sh:i * sh + kh, j * sw:j * sw + kw]
            if mode == "max":
                out[:, :, i, j] = patch.max((2, 3))
            elif count_include_pad:
                out[:, :, i, j] = patch.mean((2, 3))
            else:
                n = ones[i * sh:i * sh + kh, j * sw:j * sw + kw].sum()
                out[:, :, i, j] = patch.sum((2, 3)) / max(n, 1.0)
    return out


def run(graph: Graph, feeds: Dict[str, np.ndarray]) -> List[np.ndarray]:
    env = dict(graph.inits)
    env.update({k: np.asarray(v) for k, v in feeds.items()})

    for n in graph.nodes:
        op, a = n["op"], n["attrs"]
        x = [env[i] for i in n["inputs"] if i]
        if op == "MatMul":
            r = np.matmul(x[0], x[1])
        elif op == "Gemm":
            r = x[0] @ x[1] + (x[2] if len(x) > 2 else 0)
        elif op in ("Add", "Sub", "Mul", "Div", "Pow", "Max", "Min"):
            f = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
                 "Div": np.divide, "Pow": np.power, "Max": np.maximum,
                 "Min": np.minimum}[op]
            r = f(x[0], x[1])
        elif op == "Relu":
            r = np.maximum(x[0], 0)
        elif op == "Sigmoid":
            r = 1 / (1 + np.exp(-x[0]))
        elif op == "Tanh":
            r = np.tanh(x[0])
        elif op == "Erf":
            from math import erf

            r = np.vectorize(erf)(x[0]).astype("float32")
        elif op == "Exp":
            r = np.exp(x[0])
        elif op == "Log":
            r = np.log(x[0])
        elif op == "Sqrt":
            r = np.sqrt(x[0])
        elif op == "Abs":
            r = np.abs(x[0])
        elif op == "LeakyRelu":
            r = np.where(x[0] > 0, x[0], a.get("alpha", 0.01) * x[0])
        elif op == "Softmax":
            ax = a.get("axis", -1)
            e = np.exp(x[0] - x[0].max(axis=ax, keepdims=True))
            r = e / e.sum(axis=ax, keepdims=True)
        elif op == "Identity":
            r = x[0]
        elif op == "Flatten":
            ax = a.get("axis", 1)
            r = x[0].reshape(int(np.prod(x[0].shape[:ax]) or 1), -1)
        elif op == "Reshape":
            # ONNX (allowzero=0): a 0 entry copies the input dim at the
            # same index — numpy would read it as an empty dimension
            shape = [int(x[0].shape[i]) if int(v) == 0 else int(v)
                     for i, v in enumerate(x[1])]
            r = x[0].reshape(shape)
        elif op == "Transpose":
            r = np.transpose(x[0], a["perm"])
        elif op == "Unsqueeze":
            r = x[0]
            for ax in sorted(int(v) for v in x[1]):
                r = np.expand_dims(r, ax)
        elif op == "Squeeze":
            axes = tuple(int(v) for v in x[1]) if len(x) > 1 else None
            r = np.squeeze(x[0], axis=axes)
        elif op == "Concat":
            r = np.concatenate(x, axis=a.get("axis", 0))
        elif op == "Cast":
            r = x[0].astype(_NP_DTYPE[a["to"]])
        elif op == "Clip":
            r = np.clip(x[0], x[1] if len(x) > 1 else None,
                        x[2] if len(x) > 2 else None)
        elif op == "Conv":
            r = _conv2d(x[0], x[1], a.get("strides", [1, 1]),
                        a.get("pads", [0, 0, 0, 0]),
                        a.get("dilations", [1, 1]), a.get("group", 1))
        elif op in ("MaxPool", "AveragePool"):
            r = _pool2d(x[0], a["kernel_shape"], a.get("strides"),
                        a.get("pads", [0, 0, 0, 0]),
                        "max" if op == "MaxPool" else "avg",
                        a.get("ceil_mode", 0),
                        a.get("count_include_pad", 0))
        elif op == "GlobalAveragePool":
            r = x[0].mean(axis=(2, 3), keepdims=True)
        elif op == "GlobalMaxPool":
            r = x[0].max(axis=(2, 3), keepdims=True)
        elif op == "BatchNormalization":
            xx, scale, bias, mean, var = x
            eps = a.get("epsilon", 1e-5)
            shape = (1, -1) + (1,) * (xx.ndim - 2)
            r = ((xx - mean.reshape(shape))
                 / np.sqrt(var.reshape(shape) + eps)
                 * scale.reshape(shape) + bias.reshape(shape))
        elif op == "LayerNormalization":
            xx, scale, bias = x
            ax = a.get("axis", -1)
            axes = tuple(range(ax if ax >= 0 else xx.ndim + ax, xx.ndim))
            mu = xx.mean(axis=axes, keepdims=True)
            var = xx.var(axis=axes, keepdims=True)
            r = ((xx - mu) / np.sqrt(var + a.get("epsilon", 1e-5))
                 * scale + bias)
        elif op in ("ReduceMean", "ReduceMax"):
            # axes: attribute through opset 17, second input from opset 18
            if len(x) > 1:
                axes = tuple(int(v) for v in x[1])
            else:
                axes = tuple(a["axes"]) if "axes" in a else None
            f = np.mean if op == "ReduceMean" else np.max
            r = f(x[0], axis=axes, keepdims=bool(a.get("keepdims", 0)))
        elif op == "ReduceSum":
            axes = tuple(int(v) for v in x[1]) if len(x) > 1 else None
            r = np.sum(x[0], axis=axes, keepdims=bool(a.get("keepdims", 0)))
        else:
            raise NotImplementedError(f"runner: op {op}")
        env[n["outputs"][0]] = np.asarray(r)

    return [env[o] for o in graph.output_names]

"""The int8 inference program rewrite of ``Config.enable_int8()``.

Counterpart of ``paddle_tpu/static/quant_int8.py``, decision for decision.
The pass walks a loaded inference Program: every ``matmul_v2`` / ``mul`` /
``matmul`` whose ``Y`` is a persistable 2-D parameter of at least
``min_weight_elements`` values becomes the ``quantized_matmul`` op
(:mod:`paddle_tpu_torch.ops.quant_ops`), its per-output-channel int8
weight ``<name>@int8`` [K, N] and fp32 scale ``<name>@wscale`` [N] put in
the scope, computed on the host exactly as the reference computes them
(so the scope arrays equal the reference's bit for bit) and set on the
weight's device.  The op transposes the int8 weight to the GEMM kernel's
(N, K) layout once, on its first run.  Where the graph carries calibrated
activation scales (a frozen ``fake_quantize_dequantize_moving_average_
abs_max`` feeding the matmul, from PTQ or QAT), the scale is wired in as
``XScale`` and the fake-quant op is bypassed, then dropped with the other
dead ops; otherwise activations quantize per batch.  ``quantize_convs``
does the same for ``conv2d`` (``quantized_conv2d``).
"""

from __future__ import annotations

import numpy as np
import torch

from .io import _host

__all__ = ["rewrite_program_int8"]

_FAKE_ACT_OPS = (
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_quantize_dequantize_abs_max",
)


def rewrite_program_int8(program, scope, fetch_names=None,
                         min_weight_elements=1 << 16,
                         quantize_convs=False) -> int:
    """Rewrite in place; returns the number of matmuls and convs
    quantized.

    ``min_weight_elements`` keeps small layers off the int8 path, whose
    activation quantize and rescale passes they would not amortize (the
    reference's gate, kept).  ``quantize_convs`` is off by default, as in
    the reference."""
    block = program.global_block()
    n = 0
    # map: activation var -> (producer fake-quant op, its frozen scale var)
    fake_out = {}
    # map: weight fake-quant output -> underlying persistable weight name
    fake_weight = {}
    for op in block.ops:
        if op.type in _FAKE_ACT_OPS:
            outs = op.output("Out")
            scales = op.output("OutScale")
            ins = op.input("InScale")
            if outs:
                fake_out[outs[0]] = (op, ins[0] if ins else
                                     (scales[0] if scales else None))
        elif op.type in ("fake_channel_wise_quantize_dequantize_abs_max",
                         "fake_quantize_dequantize_abs_max"):
            outs = op.output("Out")
            src = op.input("X")
            if outs and src:
                svar = block.vars.get(src[0])
                if svar is not None and getattr(svar, "persistable", False):
                    fake_weight[outs[0]] = src[0]

    for op in block.ops:
        if op.type == "conv2d":
            if quantize_convs:
                n += _rewrite_conv(block, scope, op, fake_out, fake_weight,
                                   min_weight_elements)
            continue
        if op.type not in ("matmul_v2", "mul", "matmul"):
            continue
        if op.attrs.get("trans_x") or op.attrs.get("transpose_X"):
            continue
        ys = op.input("Y")
        xs_in = op.input("X")
        if not ys or not xs_in:
            continue
        # PTQ/QAT export: Y is a fake-quantized view of the weight — the
        # int8 path quantizes the underlying weight itself (same channel
        # abs-max scales), so see through the fake node
        yname = fake_weight.get(ys[0], ys[0])
        yvar = block.vars.get(yname)
        if yvar is None or not getattr(yvar, "persistable", False):
            continue
        w_dev = scope.find_var(yname)
        if w_dev is None:
            continue
        w = _host(w_dev)
        if w.ndim != 2 or w.size < min_weight_elements:
            continue
        if op.attrs.get("trans_y") or op.attrs.get("transpose_Y"):
            w = w.T
        # per-output-channel symmetric scale
        ws = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127.0
        wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
        qname, sname = f"{yname}@int8", f"{yname}@wscale"
        _set_beside(scope, w_dev, qname, wq)
        _set_beside(scope, w_dev, sname, ws.astype(np.float32))
        block.create_var(name=qname, shape=wq.shape, dtype="int8",
                         persistable=True, stop_gradient=True)
        block.create_var(name=sname, shape=ws.shape, dtype="float32",
                         persistable=True, stop_gradient=True)
        new_inputs = {"X": [xs_in[0]], "Y": [qname], "WScale": [sname]}
        # calibrated activation scale: X produced by a frozen fake-quant
        src = fake_out.get(xs_in[0])
        if src is not None and src[1] is not None:
            new_inputs["X"] = [src[0].input("X")[0]]  # bypass the fake node
            new_inputs["XScale"] = [src[1]]
        op.type = "quantized_matmul"
        op.inputs = new_inputs
        op.attrs = {}
        n += 1

    if n:
        _eliminate_dead_ops(block, fetch_names)
    return n


def _set_beside(scope, like, name, arr):
    """``arr`` (numpy) into the scope on the device of ``like`` (the
    weight it was made from)."""
    dev = like.device if isinstance(like, torch.Tensor) else None
    scope.set(name, torch.as_tensor(arr, device=dev))


def _rewrite_conv(block, scope, op, fake_out, fake_weight,
                  min_weight_elements) -> int:
    """conv2d -> quantized_conv2d when Filter is a persistable OIHW
    weight."""
    fs = op.input("Filter")
    xs_in = op.input("Input")
    if not fs or not xs_in:
        return 0
    wname = fake_weight.get(fs[0], fs[0])
    wvar = block.vars.get(wname)
    if wvar is None or not getattr(wvar, "persistable", False):
        return 0
    w_dev = scope.find_var(wname)
    if w_dev is None:
        return 0
    w = _host(w_dev)
    if w.ndim != 4 or w.size < min_weight_elements:
        return 0
    # per-output-channel symmetric scale over (I, KH, KW)
    ws = np.maximum(np.abs(w).max(axis=(1, 2, 3)), 1e-8) / 127.0
    wq = np.clip(np.round(w / ws.reshape(-1, 1, 1, 1)), -127,
                 127).astype(np.int8)
    qname, sname = f"{wname}@int8", f"{wname}@wscale"
    _set_beside(scope, w_dev, qname, wq)
    _set_beside(scope, w_dev, sname, ws.astype(np.float32))
    block.create_var(name=qname, shape=wq.shape, dtype="int8",
                     persistable=True, stop_gradient=True)
    block.create_var(name=sname, shape=ws.shape, dtype="float32",
                     persistable=True, stop_gradient=True)
    new_inputs = {"Input": [xs_in[0]], "Filter": [qname], "WScale": [sname]}
    src = fake_out.get(xs_in[0])
    if src is not None and src[1] is not None:
        new_inputs["Input"] = [src[0].input("X")[0]]
        new_inputs["XScale"] = [src[1]]
    op.type = "quantized_conv2d"
    op.inputs = new_inputs
    return 1


def _eliminate_dead_ops(block, fetch_names=None):
    """Drop ops whose outputs nothing consumes (the bypassed fake-quant
    ops): a backward liveness sweep over the flat block."""
    live = set(fetch_names or [])
    for op in block.ops:
        if op.type == "fetch":
            live.update(op.input_arg_names)
    keep = []
    for op in reversed(block.ops):
        if op.type in ("feed", "fetch") or any(
                o in live for o in op.output_arg_names) or not op.outputs:
            keep.append(op)
            live.update(op.input_arg_names)
    block.ops[:] = list(reversed(keep))

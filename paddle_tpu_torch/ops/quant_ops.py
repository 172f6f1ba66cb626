"""Int8 / int4 quantization decisions of the W8A8 and quantized-KV paths.

Own copy of the W8A8 section of ``paddle_tpu/ops/quant_ops.py``
(``quantize_per_token`` … ``w8a8_apply``), decision for decision, so that
the port quantizes bit-identically to the reference:

* symmetric scales ``max(absmax, 1e-8) / 127`` (``/ 7`` for int4), in fp32;
* the value is DIVIDED by its scale (no reciprocal multiply), rounded half
  to even and clipped to ±127 (±7);
* int4 values pack two per byte in the SPLIT-HALVES layout:
  ``byte[i] = (q[i] & 0xF) | (q[i + D/2] << 4)``.

:func:`w8a8_matmul` is the differentiable W8A8 product of the training
path (the reference's ``_w8a8_ste``): int8 forward through the
``w8a8_gemm`` kernel, straight-through gradients.  It is also the
registered ``w8a8_matmul`` op, which the GPT layers dispatch, so a static
program records it by name.

The module registers the reference's other quant ops too: the fake-quant
ops of quantization-aware training (abs-max, channel-wise and
moving-average, with a straight-through grad op) and the int8 inference
ops ``quantized_matmul`` and ``quantized_conv2d``, which the int8 program
rewrite (:mod:`paddle_tpu_torch.static.quant_int8`) puts in place of
matmuls and convs.
"""

from __future__ import annotations

import torch

from .registry import GRAD_SUFFIX, register_op

_QMAX = 127.0
_QMAX4 = 7.0
_EPS = 1e-8


def _scale(absmax, qmax):
    """``max(absmax, 1e-8) / qmax`` in fp32, by a true division: the
    divisor is a tensor on absmax's device, since PyTorch's CUDA division
    by a Python number multiplies by its reciprocal instead, which can
    differ in the last bit."""
    div = torch.full((), qmax, dtype=torch.float32, device=absmax.device)
    return absmax.clamp_min(_EPS) / div


def quantize_per_token(x):
    """Dynamic symmetric per-row int8 quantization over the last axis:
    ``(xq int8, scale fp32 [..., 1])`` with ``scale = max(absmax,
    1e-8) / 127`` and ``xq = clip(round_half_even(x / scale), ±127)``."""
    xf = x.float()
    sx = _scale(xf.abs().amax(-1, keepdim=True), _QMAX)
    xq = torch.round(xf / sx).clamp(-_QMAX, _QMAX).to(torch.int8)
    return xq, sx


def pack_int4(q):
    """Pack int8 tensors of int4 values (last dim even) two per byte, split
    halves: the low nibble of byte i holds ``q[..., i]``, the high nibble
    ``q[..., i + D/2]``.  The last dim halves."""
    d2 = q.shape[-1] // 2
    lo = q[..., :d2].to(torch.int32) & 0xF
    hi = q[..., d2:].to(torch.int32) & 0xF
    # 0..255 wraps to the int8 byte, as the reference's astype does
    return (lo | (hi << 4)).to(torch.int8)


def _sign_extend4(n):
    """A 4-bit two's-complement nibble (int32, 0..15) as its value -8..7."""
    return n - ((n & 0x8) << 1)


def unpack_int4(packed):
    """Inverse of :func:`pack_int4`: int8 bytes -> int8 int4 values, the
    last dim doubled (low nibbles first, then high nibbles), each nibble
    sign-extended."""
    b = packed.to(torch.int32)
    lo = _sign_extend4(b & 0xF)
    hi = _sign_extend4((b >> 4) & 0xF)
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def quantize_int4_per_token(x):
    """Dynamic symmetric per-row int4 quantization: ``(packed int8
    [..., D/2], scale fp32 [..., 1])`` with ``scale = max(absmax, 1e-8)
    / 7``, values clipped to ±7 and packed by :func:`pack_int4`."""
    xf = x.float()
    sx = _scale(xf.abs().amax(-1, keepdim=True), _QMAX4)
    xq = torch.round(xf / sx).clamp(-_QMAX4, _QMAX4).to(torch.int8)
    return pack_int4(xq), sx


def dequantize_int4(packed, scale):
    """:func:`quantize_int4_per_token` output back to fp32."""
    return unpack_int4(packed).float() * scale


def quantize_per_channel(w, axis: int = 1):
    """Symmetric per-output-channel int8 weight quantization: ``w`` float
    with output channels on ``axis`` -> ``(wq int8 of w's shape, scale
    fp32 [N])``."""
    wf = w.float()
    red = tuple(i for i in range(wf.dim()) if i != axis)
    ws = _scale(wf.abs().amax(dim=red), _QMAX)
    shape = [1] * wf.dim()
    shape[axis] = -1
    wq = torch.round(wf / ws.reshape(shape)).clamp(-_QMAX, _QMAX)
    return wq.to(torch.int8), ws


def w8a8_apply(x, wq, ws, out_dtype=None):
    """``x @ W`` through a pre-quantized int8 weight with dynamic per-token
    activation quantization (the decode path).

    ``x`` (..., K) float; ``wq`` (N, K) int8 — the reference's (K, N)
    weight TRANSPOSED, K contiguous, as the tensor-core kernel reads it;
    ``ws`` (N,) fp32.  Returns (..., N) in ``out_dtype`` (default x's).
    Goes through :func:`~paddle_tpu_torch.kernels.w8a8_gemm`: the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors."""
    from ..kernels.int8_gemm import w8a8_gemm

    lead = x.shape[:-1]
    out = w8a8_gemm(x.reshape(-1, x.shape[-1]).contiguous(), wq, ws)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out.reshape(*lead, wq.shape[0])


class _W8A8STE(torch.autograd.Function):
    """The reference's ``_w8a8_ste`` custom VJP: an int8 forward, a
    straight-through backward computed as for the float ``x @ w``."""

    @staticmethod
    def forward(ctx, x, w, transpose_y):
        # the live weight, quantized per output channel on every call; the
        # kernel reads it (N, K), K contiguous, which the transposed
        # weight already is under transpose_y
        wt = w.float() if transpose_y else w.float().t()
        wq, ws = quantize_per_channel(wt, axis=0)
        ctx.save_for_backward(x, w)
        ctx.transpose_y = transpose_y
        return w8a8_apply(x, wq.contiguous(), ws, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        # fp32 products, as _w8a8_bwd: they stay torch.matmul, since the
        # reference computes them outside any kernel of its own
        x, w = ctx.saved_tensors
        gf, wf = g.float(), w.float()
        x2 = x.reshape(-1, x.shape[-1]).float()
        g2 = gf.reshape(-1, gf.shape[-1])
        if ctx.transpose_y:
            dx, dw = gf @ wf, g2.t() @ x2              # [.., K], [N, K]
        else:
            dx, dw = gf @ wf.t(), x2.t() @ g2          # [.., K], [K, N]
        return dx.to(x.dtype), dw.to(w.dtype), None


def w8a8_matmul(x, w, transpose_y: bool = False):
    """``x @ w`` (``x @ w.T`` with ``transpose_y``) from FLOAT weights, the
    W8A8 way: per-output-channel int8 quantization of the live weight and
    dynamic per-token quantization of ``x`` on every call, the int8 product
    through :func:`~paddle_tpu_torch.kernels.w8a8_gemm` (the CUDA kernel for
    CUDA tensors, its plain version for CPU tensors), output in x's dtype.
    Differentiable with straight-through gradients: ``dx = g @ w^T`` and
    ``dw = x^T @ g`` in fp32, cast to x's and w's dtypes."""
    return _W8A8STE.apply(x, w, bool(transpose_y))


# ---------------------------------------------------------------------------
# the registered quant ops (the reference's ``ops/quant_ops.py:31-213`` and
# ``w8a8_matmul``, :364)
# ---------------------------------------------------------------------------

def _div(x, d):
    """``x / d`` by a true division on x's device (see :func:`_scale`)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _fake_qdq(x, scale, bit_length):
    """``clip(round(x / s * bnd), ±bnd) * s / bnd`` with ``s = max(scale,
    1e-8)``, as the reference's ``_fake_qdq``."""
    bnd = float(2 ** (bit_length - 1) - 1)
    s = scale.clamp_min(_EPS)
    q = torch.round(x / s * bnd).clamp(-bnd, bnd)
    return _div(q * s, bnd)


def _ste_grad_maker(ins, outs, ogs):
    """Straight-through: ``dX = dOut`` (the reference's ``assign``)."""
    return "fake_quantize_dequantize_grad", {"Out" + GRAD_SUFFIX: ogs["Out"]}


@register_op("fake_quantize_dequantize_grad", no_grad=True)
def fake_qdq_grad_kernel(ins, attrs):
    """The straight-through gradient of the fake-quant ops."""
    return {"X" + GRAD_SUFFIX: ins["Out" + GRAD_SUFFIX]}


@register_op("fake_quantize_dequantize_abs_max",
             nondiff_out_slots=("OutScale",), grad_maker=_ste_grad_maker)
def fake_qdq_abs_max_kernel(ins, attrs):
    x = ins["X"]
    scale = x.abs().amax()
    return {"Out": _fake_qdq(x, scale, attrs.get("bit_length", 8)),
            "OutScale": scale.reshape(1)}


@register_op("fake_channel_wise_quantize_dequantize_abs_max",
             nondiff_out_slots=("OutScale",), grad_maker=_ste_grad_maker)
def fake_qdq_channel_kernel(ins, attrs):
    x = ins["X"]
    axis = attrs.get("quant_axis", 0)
    red = tuple(i for i in range(x.dim()) if i != axis)
    scale = x.abs().amax(dim=red, keepdim=True)
    return {"Out": _fake_qdq(x, scale, attrs.get("bit_length", 8)),
            "OutScale": scale.reshape(-1)}


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             nondiff_slots=("InScale", "InState", "InAccum"),
             nondiff_out_slots=("OutScale", "OutState", "OutAccum"),
             grad_maker=_ste_grad_maker)
def fake_qdq_moving_avg_kernel(ins, attrs):
    """Activation fake-quant with a moving-average scale, the reference's
    recurrence: with ``InState`` / ``InAccum``, ``state = rate * state + 1``,
    ``accum = rate * accum + max|x|`` and ``scale = accum / state``;
    without them ``rate * InScale + (1 - rate) * max|x|``; with
    ``is_test`` the scale is ``InScale`` as it is."""
    x, in_scale = ins["X"], ins["InScale"]
    bits = attrs.get("bit_length", 8)
    rate = attrs.get("moving_rate", 0.9)
    has_state = "InState" in ins and "InAccum" in ins
    if attrs.get("is_test", False):
        new_scale = in_scale.reshape(())
        outs = {"Out": _fake_qdq(x, new_scale, bits),
                "OutScale": new_scale.reshape(1)}
        if has_state:
            outs["OutState"] = ins["InState"].reshape(1)
            outs["OutAccum"] = ins["InAccum"].reshape(1)
        return outs
    cur = x.abs().amax()
    if has_state:
        state = rate * ins["InState"].reshape(()) + 1.0
        accum = rate * ins["InAccum"].reshape(()) + cur
        new_scale = accum / state
        return {"Out": _fake_qdq(x, new_scale, bits),
                "OutScale": new_scale.reshape(1),
                "OutState": state.reshape(1),
                "OutAccum": accum.reshape(1)}
    new_scale = rate * in_scale.reshape(()) + (1.0 - rate) * cur
    return {"Out": _fake_qdq(x, new_scale, bits),
            "OutScale": new_scale.reshape(1)}


def _tensor_scale(xf, xs):
    """The per-tensor activation scale of the int8 inference ops:
    ``max(XScale or max|x|, 1e-8) / 127`` in fp32."""
    absmax = xf.abs().amax() if xs is None else xs.reshape(()).float()
    return _scale(absmax, _QMAX)


def _quantize_with(xf, sx):
    return torch.round(xf / sx).clamp(-_QMAX, _QMAX).to(torch.int8)


@register_op("quantized_conv2d", nondiff_slots=("Filter", "WScale", "XScale"),
             no_grad=True)
def quantized_conv2d_kernel(ins, attrs):
    """Int8 inference conv: the input quantized per tensor (the calibrated
    ``XScale`` where the graph carries one, else its abs-max), the int8 x
    int8 convolution summed exactly (a float64 convolution: its sums are
    integers below 2^53, where fp32 would round past 2^24), then
    ``float(acc) * (sx * WScale[o])``.  ``Filter`` is the int8 OIHW weight,
    ``WScale`` [O] its per-output-channel scale; the layout attributes are
    conv2d's."""
    from .nn_ops import conv2d_kernel

    x, wq, ws = ins["Input"], ins["Filter"], ins["WScale"]
    xf = x.float()
    sx = _tensor_scale(xf, ins.get("XScale"))
    xq = _quantize_with(xf, sx)
    acc = conv2d_kernel({"Input": xq.double(), "Filter": wq.double()},
                        attrs)["Output"]
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    cshape = (1, 1, 1, -1) if nhwc else (1, -1, 1, 1)
    out = acc.float() * (sx * ws.float().reshape(cshape))
    return {"Output": out.to(x.dtype)}


@register_op("quantized_matmul", nondiff_slots=("Y", "WScale", "XScale"),
             no_grad=True)
def quantized_matmul_kernel(ins, attrs):
    """Int8 inference matmul against a pre-quantized weight ``Y`` [K, N]
    int8 (or a stack [B, K, N] against x [B, ..., K]) with its
    per-output-channel scale ``WScale`` [N] (or [B, N]).

    The activations quantize per tensor (the calibrated ``XScale`` where
    the graph carries one, else their abs-max), or per row with
    ``per_token`` (which ignores XScale).  The int8 product runs through
    :mod:`~paddle_tpu_torch.kernels.int8_gemm`: per tensor, on rows
    quantized here, by :func:`w8a8_gemm_prequant` with the activation
    scale folded into the column scale (``sx * WScale``, the reference's
    rescale ``float(acc) * (sx * WScale)`` bit for bit); per row by
    :func:`w8a8_gemm`; each batch of a stack by :func:`w8a8_gemm_prequant`
    with the row scale (the reference's ``float(acc) * sx * WScale``).
    The weight is read (N, K), K contiguous: its transpose is made once per
    weight tensor (:func:`_weight_nk`), not on each call."""
    from ..kernels.int8_gemm import w8a8_gemm, w8a8_gemm_prequant

    x, wq, ws = ins["X"], ins["Y"], ins["WScale"].float()
    if x.device.type == "meta":  # shape inference
        return {"Out": x.new_empty(*x.shape[:-1], wq.shape[-1])}
    xf = x.float()
    k = x.shape[-1]
    if wq.dim() == 3:
        b, n = wq.shape[0], wq.shape[2]
        sx = _tensor_scale(xf, ins.get("XScale"))
        xq = _quantize_with(xf, sx).reshape(b, -1, k)
        rows = torch.full((xq.shape[1], 1), 1.0, device=x.device) * sx
        wsb = ws if ws.dim() == 2 else ws.expand(b, n)
        wt = _weight_nk(wq)
        out = torch.stack([
            w8a8_gemm_prequant(xq[i], rows, wt[i], wsb[i].contiguous(),
                               out_dtype=torch.float32)
            for i in range(b)])
        return {"Out": out.reshape(*x.shape[:-1], n).to(x.dtype)}
    n = wq.shape[1]
    x2 = xf.reshape(-1, k)
    if attrs.get("per_token", False):
        out = w8a8_gemm(x2.contiguous(), _weight_nk(wq), ws)
    else:
        sx = _tensor_scale(xf, ins.get("XScale"))
        ones = torch.ones((x2.shape[0], 1), device=x.device)
        out = w8a8_gemm_prequant(_quantize_with(x2, sx), ones, _weight_nk(wq),
                                 (sx * ws).contiguous(),
                                 out_dtype=torch.float32)
    return {"Out": out.reshape(*x.shape[:-1], n).to(x.dtype)}


def _weight_nk(wq):
    """``wq`` [..., K, N] int8 as [..., N, K], K contiguous, made once per
    weight tensor (and again only after the tensor changes in place): an
    inference program's int8 weights are transposed on their first run.
    The transpose rides on the tensor object, and dies with it."""
    hit = getattr(wq, "_int8_weight_nk", None)
    if hit is not None and hit[0] == wq._version:
        return hit[1]
    wt = wq.transpose(-1, -2).contiguous()
    wq._int8_weight_nk = (wq._version, wt)
    return wt


@register_op("w8a8_matmul")
def w8a8_matmul_kernel(ins, attrs):
    """:func:`w8a8_matmul` as an op: ``X`` [.., K] float activations and
    the FLOAT weight ``W`` [K, N] ([N, K] with ``transpose_y``, the tied
    head's layout), both quantized on every call; the gradient is the
    straight-through one of :class:`_W8A8STE`, which the registry's grad
    op takes by autograd."""
    x, w = ins["X"], ins["W"]
    transpose_y = bool(attrs.get("transpose_y", False))
    if x.device.type == "meta":  # shape inference
        n = w.shape[0] if transpose_y else w.shape[1]
        return {"Out": x.new_empty(*x.shape[:-1], n)}
    return {"Out": _W8A8STE.apply(x, w, transpose_y)}

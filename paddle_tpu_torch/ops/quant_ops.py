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
``w8a8_gemm`` kernel, straight-through gradients.  The registered
fake-quant training ops are not ported.
"""

from __future__ import annotations

import torch

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

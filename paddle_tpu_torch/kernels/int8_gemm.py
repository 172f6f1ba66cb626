"""W8A8 GEMM: the CUDA kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/kernels/int8_gemm.py`` (``w8a8_gemm``,
``w8a8_gemm_ref``).  Both compute, in this order: per-row dynamic int8
quantization of the activations (:func:`~paddle_tpu_torch.ops.quant_ops.
quantize_per_token`), the int8 x int8 product summed in int32, and the
rescale ``float(acc) * sx[row] * ws[col]``, cast to x's dtype.

The weight is stored **(N, K)**, K contiguous: the reference's (K, N)
per-output-channel int8 weight transposed once at setup, which is the
layout the tensor core's ``.col`` B operand reads.  Both versions here take
that layout.  The kernel is ``paddle_tpu_torch/csrc/w8a8_gemm.cu`` (a
row-quantize pass, then an ``mma.sync`` s8 GEMM with the rescale in its
epilogue); see the source for its design and what bounds it on the card.

:func:`w8a8_gemm` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; a shape the kernel cannot take raises, it is
never rerouted.  Each call counts one ``w8a8_gemm`` launch (the two passes
of one kernel).
"""

from __future__ import annotations

import torch

from ..ops.quant_ops import quantize_per_token
from . import _build
from .paged_attention import _DTYPES

_build.LAUNCHES["w8a8_gemm"] = 0


def w8a8_gemm_plain(x, wq, ws, *, return_quantized=False):
    """The kernel's plain PyTorch version, decision for decision the
    reference's ``w8a8_gemm_ref``: ``x`` (M, K) float, ``wq`` (N, K) int8,
    ``ws`` (N,) fp32 -> (M, N) in x's dtype.  The integer product is formed
    in float64, which is exact here (|acc| <= 127^2 * K < 2^53) and runs
    on the card too, where PyTorch has no int32 matmul.  With
    ``return_quantized`` also returns ``xq`` (M, K) int8 and ``sx`` (M, 1)
    fp32."""
    xq, sx = quantize_per_token(x)
    acc = xq.double() @ wq.double().t()
    out = (acc.float() * sx * ws.float()).to(x.dtype)
    return (out, xq, sx) if return_quantized else out


def w8a8_gemm(x, wq, ws, *, return_quantized=False):
    """Dynamic per-token quantize + int8 GEMM + rescale.

    ``x`` (M, K) fp32/bf16 contiguous, any M >= 1; ``wq`` (N, K) int8
    contiguous with K % 64 == 0 and N % 16 == 0; ``ws`` (N,) fp32.
    Returns (M, N) in x's dtype (and ``xq``, ``sx`` (M, 1) with
    ``return_quantized``).

    CPU tensors take :func:`w8a8_gemm_plain`.  CUDA tensors launch the
    kernel on the current stream without synchronising, or raise."""
    if x.device.type == "cpu":
        return w8a8_gemm_plain(x, wq, ws, return_quantized=return_quantized)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_gemm runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("w8a8_gemm: x must be a contiguous (M, K) fp32 or "
                         "bf16 tensor")
    m, k = x.shape
    if (wq.device != x.device or wq.dtype != torch.int8 or wq.dim() != 2
            or wq.shape[1] != k or not wq.is_contiguous()):
        raise ValueError(f"w8a8_gemm: wq must be a contiguous (N, {k}) int8 "
                         "tensor on x's device")
    n = wq.shape[0]
    if (ws.device != x.device or ws.dtype != torch.float32
            or tuple(ws.shape) != (n,) or not ws.is_contiguous()):
        raise ValueError(f"w8a8_gemm: ws must be a contiguous ({n},) fp32 "
                         "tensor on x's device")
    if m < 1 or k % 64 or n % 16:
        raise ValueError(f"w8a8_gemm: the kernel takes M >= 1, K % 64 == 0 "
                         f"and N % 16 == 0, not M={m}, K={k}, N={n}")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("w8a8_gemm: x and wq must be 16-byte aligned")
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = _build.kernel("w8a8_gemm")
    code = fn(x.data_ptr(), xq.data_ptr(), sx.data_ptr(), wq.data_ptr(),
              ws.data_ptr(), out.data_ptr(), m, n, k, _DTYPES[x.dtype],
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("w8a8_gemm", code)
    _build.LAUNCHES["w8a8_gemm"] += 1
    return (out, xq, sx) if return_quantized else out

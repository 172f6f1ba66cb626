"""W8A8 GEMM: the CUDA kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/kernels/int8_gemm.py`` (``w8a8_gemm``,
``w8a8_gemm_ref``).  Both compute, in this order: per-row dynamic int8
quantization of the activations (:func:`~paddle_tpu_torch.ops.quant_ops.
quantize_per_token`), the int8 x int8 product summed in int32, and the
rescale ``float(acc) * sx[row] * ws[col]``, cast to x's dtype.

The weight is stored **(N, K)**, K contiguous: the reference's (K, N)
per-output-channel int8 weight transposed once at setup, which is the
layout both tensor-core paths read (``mma.sync``'s ``.col`` B operand,
``wgmma``'s K-major B).  Both versions here take that layout.  The kernel
is ``paddle_tpu_torch/csrc/w8a8_gemm.cu``, with two bodies that
:func:`gemm_plan` picks from the shapes alone: for few rows one launch of
a weight-streaming split-K ``mma.sync`` body whose thread-block clusters
sum their splits in distributed shared memory, for many rows a persistent
TMA + ``wgmma`` body, each launched as a dependent of one row-quantize
pass.  See the source for the design and what bounds each on the card.

:func:`w8a8_gemm_prequant` runs the same GEMM bodies alone, on int8 rows
that the caller quantized and their scales: the int8 inference ops
(``quantized_matmul``) quantize per tensor, which a row-local pass cannot
do.  Its plain version is :func:`w8a8_gemm_prequant_plain`.

:func:`w8a8_gemm` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors, never rerouted.  The kernel's bodies read K in
64-byte chunks and N in 16-column groups; any other K or N is zero-padded
by the wrapper (:func:`pad_operands`) and the output sliced back, which is
exact: zero K columns change neither a row's absmax nor the int32 sums,
and zero weight rows (scale 1) only fill the columns cut off.  Each call
counts one ``w8a8_gemm`` launch (its quantize and GEMM are one kernel's),
or one ``w8a8_gemm_fp16`` launch for fp16 activations.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops.quant_ops import quantize_per_token
from . import _build

#: activation (and output) dtype -> the kernel's dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: x's dtype -> the launch-count name of a w8a8_gemm call
_LAUNCH = {torch.float32: "w8a8_gemm", torch.bfloat16: "w8a8_gemm",
           torch.float16: "w8a8_gemm_fp16"}
_build.LAUNCHES.update({n: 0 for n in _LAUNCH.values()})
_build.LAUNCHES["w8a8_gemm_prequant"] = 0

#: K bytes per ring stage of the split path (one ``mma.sync`` k32 pair)
GEMM_KC = 64
#: output rows and columns per block of the split path
SPLIT_BM, SPLIT_BN = 16, 32
#: the split path cuts K into a power of two of splits, as many as keep the
#: grid within this many blocks (about six on each of the H100's 132 SMs;
#: measured: PERF.md) ...
SPLIT_BLOCKS = 768
#: ... and at most this many: the blocks of a tile form one thread-block
#: cluster (the portable maximum), whose partial sums meet in distributed
#: shared memory
SPLIT_MAX = 8
#: output rows per tile of the wgmma path (two m64 warpgroups)
WGMMA_BM = 128
#: the wgmma path's tile widths: the wide one where its tiles fill the
#: card's 132 SMs, the narrow one below (more blocks stream the weight)
WGMMA_BN_CHOICES, WGMMA_SMS = (128, 256), 132
#: rows up to which the split path runs; more rows take the wgmma path
#: (measured on an H100 by chip_smoke.py's sweep: see PERF.md)
GEMM_CROSSOVER = 16

_PATHS = {"split": 0, "wgmma": 1}


class GemmPlan(NamedTuple):
    """One launch of the kernel: ``path`` ("split" or "wgmma"), its output
    tile ``bm`` x ``bn``, and the 64-byte K chunks each split takes
    (``chunks_per_split``; the last split fewer) and how many splits there
    are.  Neither path needs a workspace: the split path's partial sums
    meet in its cluster's shared memory."""
    path: str
    bm: int
    bn: int
    chunks_per_split: int
    n_split: int


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def gemm_plan(m, n, k, *, path=None, bn=None, n_split=None):
    """The kernel's launch for an (m, k) x (n, k)^T product, from the shapes
    alone: the split path for ``m <= GEMM_CROSSOVER`` rows, the wgmma path
    above.  Split: :data:`SPLIT_BM` x :data:`SPLIT_BN` tiles, and K cut
    into ``n_split`` equal ranges of ``chunks_per_split`` chunks of
    :data:`GEMM_KC` bytes (the last one fewer), a power of two, as many
    as keep the grid within :data:`SPLIT_BLOCKS` blocks, at most
    :data:`SPLIT_MAX`.
    Wgmma: :data:`WGMMA_BM` x 256 tiles over all of K where they are at
    least :data:`WGMMA_SMS`, 128 x 128 below.

    ``path``, ``bn`` (wgmma) and ``n_split`` (the splits wanted; split)
    override the choices, for tests and measurements."""
    if m < 1 or k < GEMM_KC or k % GEMM_KC or n < 16 or n % 16:
        raise ValueError(f"gemm_plan: the kernel takes M >= 1, K % 64 == 0 "
                         f"and N % 16 == 0, not M={m}, K={k}, N={n}")
    chunks = k // GEMM_KC
    path = path or ("split" if m <= GEMM_CROSSOVER else "wgmma")
    if path == "wgmma":
        wide = _cdiv(m, WGMMA_BM) * _cdiv(n, 256) >= WGMMA_SMS
        bn = bn or WGMMA_BN_CHOICES[wide]
        if bn not in WGMMA_BN_CHOICES:
            raise ValueError(f"gemm_plan: wgmma takes bn in "
                             f"{WGMMA_BN_CHOICES}")
        return GemmPlan("wgmma", WGMMA_BM, bn, chunks, 1)
    if path != "split" or bn not in (None, SPLIT_BN):
        raise ValueError(f"gemm_plan: no path {path!r} with bn={bn}")
    if n_split is None:
        tiles = _cdiv(m, SPLIT_BM) * _cdiv(n, SPLIT_BN)
        n_split = 1
        while n_split * 2 <= min(SPLIT_MAX, SPLIT_BLOCKS // tiles):
            n_split *= 2
    cps = _cdiv(chunks, min(n_split, SPLIT_MAX))
    return GemmPlan("split", SPLIT_BM, SPLIT_BN, cps, _cdiv(chunks, cps))


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


def _validate(x, wq, ws):
    """The shapes, dtypes and layouts the kernel takes; returns (m, k, n)."""
    if x.dtype not in _DTYPES or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("w8a8_gemm: x must be a contiguous (M, K) fp32, "
                         "bf16 or fp16 tensor")
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
    return m, k, n


def _launch(x, wq, ws, plan):
    """Allocate the call's scratch (xq, then sx: one buffer) and output, and
    launch; returns (out, scratch)."""
    m, k = x.shape
    n = wq.shape[0]
    scratch = torch.empty(m * k + 4 * m, dtype=torch.uint8, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    base = scratch.data_ptr()
    code = _build.kernel("w8a8_gemm")(
        x.data_ptr(), base, base + m * k, wq.data_ptr(), ws.data_ptr(),
        out.data_ptr(), m, n, k, _DTYPES[x.dtype], _PATHS[plan.path], plan.bm,
        plan.bn, plan.chunks_per_split,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("w8a8_gemm", code)
    return out, scratch


def pad_operands(x, wq, ws):
    """The operands zero-padded to the kernel's granularity: K up to a
    multiple of :data:`GEMM_KC` (zero columns of ``x`` and ``wq``), N up to
    a multiple of 16 (zero rows of ``wq``, scale 1).  Returned unchanged
    when both are aligned already."""
    m, k = x.shape
    n = wq.shape[0]
    kp = max(GEMM_KC, _cdiv(k, GEMM_KC) * GEMM_KC)
    np_ = max(16, _cdiv(n, 16) * 16)
    if (kp, np_) == (k, n):
        return x, wq, ws
    xp = x.new_zeros((m, kp))
    xp[:, :k] = x
    wqp = wq.new_zeros((np_, kp))
    wqp[:n, :k] = wq
    wsp = ws.new_ones((np_,))
    wsp[:n] = ws
    return xp, wqp, wsp


def w8a8_gemm(x, wq, ws, *, return_quantized=False, plan=None):
    """Dynamic per-token quantize + int8 GEMM + rescale.

    ``x`` (M, K) fp32/bf16/fp16 contiguous; ``wq`` (N, K) int8 contiguous;
    ``ws`` (N,) fp32; any M, K, N >= 1.  Returns (M, N) in x's dtype (and
    ``xq``, ``sx`` (M, 1) with ``return_quantized``).  ``plan`` (a
    :class:`GemmPlan`, for the padded shape) overrides :func:`gemm_plan`'s.

    CPU tensors take :func:`w8a8_gemm_plain`.  CUDA tensors launch the
    kernel on the current stream without synchronising, or raise; a K or
    N off the kernel's granularity is padded (:func:`pad_operands`) and
    the output sliced back."""
    if x.device.type == "cpu":
        return w8a8_gemm_plain(x, wq, ws, return_quantized=return_quantized)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_gemm runs on cpu or cuda, not {x.device}")
    return _kernel_gemm(x, wq, ws, return_quantized, plan)


def _kernel_gemm(x, wq, ws, return_quantized, plan):
    """The CUDA path: pad to the kernel's granularity, launch, slice."""
    if (x.dim() != 2 or wq.dim() != 2 or wq.shape[1] != x.shape[1]
            or min(x.shape[1], wq.shape[0]) < 1
            or tuple(ws.shape) != (wq.shape[0],)):
        raise ValueError(f"w8a8_gemm: x (M, K), wq (N, K) and ws (N,) with "
                         f"K, N >= 1, not {tuple(x.shape)}, "
                         f"{tuple(wq.shape)} and {tuple(ws.shape)}")
    k, n = x.shape[1], wq.shape[0]
    xp, wqp, wsp = pad_operands(x, wq, ws)
    m, kp, np_ = _validate(xp, wqp, wsp)
    out, scratch = _launch(xp, wqp, wsp, plan or gemm_plan(m, np_, kp))
    _build.LAUNCHES[_LAUNCH[x.dtype]] += 1
    if np_ != n:
        out = out[:, :n].contiguous()
    if not return_quantized:
        return out
    xq = scratch[:m * kp].view(torch.int8).view(m, kp)[:, :k]
    sx = scratch[m * kp:m * kp + 4 * m].view(torch.float32).view(m, 1)
    return out, xq, sx


def w8a8_gemm_prequant_plain(xq, sx, wq, ws, *, out_dtype=torch.float32,
                             return_acc=False):
    """The pre-quantized launch's plain version: ``xq`` (M, K) int8 rows
    quantized by the caller with scales ``sx`` (M, 1) fp32, ``wq`` (N, K)
    int8, ``ws`` (N,) fp32 -> ``float(acc) * sx[row] * ws[col]`` (M, N) in
    ``out_dtype``, the two products rounded one at a time as the kernel's
    epilogue rounds them.  The integer product is formed in float64 (exact,
    as in :func:`w8a8_gemm_plain`); ``return_acc`` also returns it as
    int32."""
    acc = xq.double() @ wq.double().t()
    out = (acc.float() * sx.reshape(-1, 1).float() * ws.float()).to(out_dtype)
    return (out, acc.to(torch.int32)) if return_acc else out


def w8a8_gemm_prequant(xq, sx, wq, ws, *, out_dtype=torch.float32,
                       plan=None):
    """The int8 GEMM alone, on rows the caller quantized (the int8
    inference ops': per tensor, or per row): ``xq`` (M, K) int8, ``sx``
    (M, 1) fp32 row scales, ``wq`` (N, K) int8, ``ws`` (N,) fp32; any M, K,
    N >= 1.  Returns ``float(acc) * sx[row] * ws[col]`` (M, N) in
    ``out_dtype`` (fp32, bf16 or fp16).

    CPU tensors take :func:`w8a8_gemm_prequant_plain`.  CUDA
    tensors launch the kernel's ``w8a8_gemm_prequant`` entry (the
    :func:`gemm_plan` body of :func:`w8a8_gemm`, without its quantize) on
    the current stream, or raise; K and N are zero-padded as for
    :func:`w8a8_gemm`.  Each call counts one ``w8a8_gemm_prequant``
    launch."""
    if xq.device.type == "cpu":
        return w8a8_gemm_prequant_plain(xq, sx, wq, ws, out_dtype=out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"w8a8_gemm_prequant runs on cpu or cuda, not "
                         f"{xq.device}")
    if (xq.dtype != torch.int8 or xq.dim() != 2 or wq.dim() != 2
            or wq.shape[1] != xq.shape[1] or min(xq.shape[1], wq.shape[0]) < 1
            or tuple(ws.shape) != (wq.shape[0],) or sx.numel() != xq.shape[0]
            or sx.dtype != torch.float32 or sx.device != xq.device
            or out_dtype not in _DTYPES):
        raise ValueError(
            f"w8a8_gemm_prequant: xq (M, K) int8, sx (M, 1) fp32, wq (N, K) "
            f"int8, ws (N,) and an fp32, bf16 or fp16 output, not "
            f"{tuple(xq.shape)} {xq.dtype}, {tuple(sx.shape)} {sx.dtype}, "
            f"{tuple(wq.shape)}, {tuple(ws.shape)}, {out_dtype}")
    n = wq.shape[0]
    xqp, wqp, wsp = pad_operands(xq.contiguous(), wq, ws)
    m, kp = xqp.shape
    np_ = wqp.shape[0]
    if (wqp.dtype != torch.int8 or not wqp.is_contiguous()
            or wqp.device != xq.device or wsp.dtype != torch.float32
            or not wsp.is_contiguous() or wsp.device != xq.device
            or xqp.data_ptr() % 16 or wqp.data_ptr() % 16):
        raise ValueError("w8a8_gemm_prequant: wq must be contiguous int8 and "
                         "ws contiguous fp32 on xq's device, xq and wq "
                         "16-byte aligned")
    plan = plan or gemm_plan(m, np_, kp)
    out = torch.empty((m, np_), dtype=out_dtype, device=xq.device)
    code = _build.kernel("w8a8_gemm_prequant")(
        xqp.data_ptr(), sx.contiguous().data_ptr(), wqp.data_ptr(),
        wsp.data_ptr(), out.data_ptr(), m, np_, kp, _DTYPES[out_dtype],
        _PATHS[plan.path], plan.bm, plan.bn, plan.chunks_per_split,
        torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check("w8a8_gemm_prequant", code)
    _build.LAUNCHES["w8a8_gemm_prequant"] += 1
    return out[:, :n].contiguous() if np_ != n else out

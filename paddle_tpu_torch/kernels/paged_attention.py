"""Paged decode and multi-query verify attention: the CUDA kernels'
wrappers and their plain versions.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``
(``paged_attention``, ``paged_attention_mq``, ``paged_attention_ref``,
``paged_attention_mq_ref``, ``gather_pages``, ``_group_scores``) over
float, int8 and nibble-packed int4 pages.  The kernels are
``paddle_tpu_torch/csrc/paged_attention.cu`` (decode) and
``paddle_tpu_torch/csrc/paged_attention_mq.cu`` (verify: T draft rows per
slot).  For bf16 and fp16 queries both run the split-KV body of
``csrc/paged_split.cuh`` (one template over the 16-bit element type):
each slot's block-table row is cut into splits
of :func:`split_plan`'s ``pages_per_split`` entries, one thread block per
(KV head, slot, split), and a second kernel merges the splits' partials
from a workspace this module allocates; fp32 queries take one block per
(KV head, slot) with exact fp32 products.  See the sources for their
design and what bounds them on the card.

Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors; there is no other path.  Launches count per
wrapper call, page kind and, for fp16 queries, apart: ``paged_attention``,
``paged_attention_int8``, ``paged_attention_int4`` (fp32 and bf16
queries), the same three with ``_fp16`` appended (fp16 queries), and the
six of ``paged_attention_mq``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quant_ops import unpack_int4
from . import _build

_NEG_INF = -1e30
#: query dtype -> the kernels' dtype code
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the query dtypes of the split-KV body
_HALF = (torch.bfloat16, torch.float16)
_SUFFIX = {0: "", 8: "_int8", 4: "_int4"}   # page kind -> variant name


def _variants(kernel):
    """{(page kind, fp16 queries): launch-count name} of one kernel."""
    return {(b, f16): kernel + s + ("_fp16" if f16 else "")
            for b, s in _SUFFIX.items() for f16 in (False, True)}


_DECODE = _variants("paged_attention")
_MQ = _variants("paged_attention_mq")
_build.LAUNCHES.update({n: 0 for n in (*_DECODE.values(), *_MQ.values())})
#: what the split plan aims for: thread blocks per call (four per SM of an
#: H100's 132), and key positions per split at least (four 32-key tiles for
#: each of a block's four warps, so that each warp's cp.async ring runs
#: ahead of its math)
SPLIT_BLOCKS = 528
SPLIT_MIN_POSITIONS = 512
#: head dims the 16-bit body takes (it pads D to 64, 128 or 256)
_MAX_HALF_D = 256


def split_plan(batch, kv_heads, max_pages, page_size):
    """How the bf16 and fp16 decode and verify kernels cut each slot's
    block-table row of ``max_pages`` entries: ``(pages_per_split,
    n_split)``, split s taking entries ``[s * pages_per_split, (s + 1) *
    pages_per_split)`` (the last one fewer).  Enough splits that ``batch * kv_heads *
    n_split`` blocks reach :data:`SPLIT_BLOCKS`, each of at least
    :data:`SPLIT_MIN_POSITIONS` positions.

    A function of host-known shapes only: the slots' lengths live on the
    device, and the wrapper never reads them (no sync, and a CUDA graph
    can capture the call as it is).  A kernel block whose split holds no
    position its rows can see exits at once."""
    if min(batch, kv_heads, max_pages, page_size) < 1:
        raise ValueError("split_plan: every shape must be positive")
    want = -(-SPLIT_BLOCKS // (batch * kv_heads))
    pps = max(-(-SPLIT_MIN_POSITIONS // page_size), -(-max_pages // want))
    pps = min(pps, max_pages)
    return pps, -(-max_pages // pps)


def gather_pages(pages, block_tables, scales=None, head_dim=None):
    """Each slot's paged K or V as a dense (B, Hkv, S, D) tensor,
    S = max_pages * page_size: ``pages[block_tables]`` and a layout
    shuffle.  With ``scales`` the pages are quantized and come back
    dequantized to fp32 — int4 nibbles unpacked first when the pages' last
    dim is narrower than ``head_dim`` — the dequant decision the kernels
    make right after their page loads."""
    bt = block_tables.long()
    g = pages[bt]                                  # (B, maxp, Hkv, ps, Ds)
    if scales is not None:
        if head_dim is not None and g.shape[-1] != head_dim:
            g = unpack_int4(g)
        g = g.float() * scales[bt]
    b, maxp, hkv, ps, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, maxp * ps, d)


def _group_scores(q, k_eff):
    """fp32 scores with the query heads grouped over their shared KV head
    (never repeating K/V): q (B, H, D), k_eff (B, Hkv, S, D) ->
    (B, Hkv, G, S)."""
    b, h, d = q.shape
    hkv = k_eff.shape[1]
    qg = q.reshape(b, hkv, h // hkv, d)
    return torch.einsum("bngd,bnsd->bngs", qg.float(), k_eff.float())


def _scale_scores(s, d, scale):
    """Scores DIVIDED by sqrt(D) when ``scale`` is None (as the dense
    decoder scales them, which keeps paged and dense decode
    bit-comparable), else multiplied by ``scale``."""
    if scale is None:
        return s / np.float32(np.sqrt(d))
    return s * np.float32(scale)


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, *,
                          k_scales=None, v_scales=None, scale=None,
                          window=None):
    """The decode kernel's plain PyTorch version, decision for decision
    the reference's ``paged_attention_ref``: dense gather (with dequant),
    scaled scores, -1e30 masking, softmax, then the probabilities cast to
    V's dtype (fp32 for quantized pages) before the PV product."""
    b, h, d = q.shape
    k_eff = gather_pages(k_pages, block_tables, k_scales, d)
    v_eff = gather_pages(v_pages, block_tables, v_scales, d)
    s = _scale_scores(_group_scores(q, k_eff), d, scale)
    pos = torch.arange(k_eff.shape[2], device=q.device)[None, :]
    lens = lengths.long()[:, None]
    keep = pos < lens
    if window is not None:
        keep = keep & (pos >= lens - window)
    s = torch.where(keep[:, None, None], s, _NEG_INF)
    att = torch.softmax(s, dim=-1).to(v_eff.dtype)
    out = torch.einsum("bngs,bnsd->bngd", att, v_eff)
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_mq_plain(q, k_pages, v_pages, block_tables, lengths, *,
                             k_scales=None, v_scales=None, scale=None,
                             window=None):
    """The verify kernel's plain PyTorch version, decision for decision
    the reference's ``paged_attention_mq_ref``: row t of slot b sees page
    position j iff ``j <= lengths[b] + t`` (and ``j > lengths[b] + t -
    window``).  T == 1 is the decode version with ``lengths + 1``."""
    b, t, h, d = q.shape
    if t == 1:
        out = paged_attention_plain(q[:, 0], k_pages, v_pages, block_tables,
                                    lengths + 1, k_scales=k_scales,
                                    v_scales=v_scales, scale=scale,
                                    window=window)
        return out[:, None]
    k_eff = gather_pages(k_pages, block_tables, k_scales, d)
    v_eff = gather_pages(v_pages, block_tables, v_scales, d)
    hkv = k_eff.shape[1]
    qg = q.reshape(b, t, hkv, h // hkv, d)
    s = torch.einsum("btngd,bnsd->bngts", qg.float(), k_eff.float())
    s = _scale_scores(s, d, scale)
    pos = torch.arange(k_eff.shape[2], device=q.device)[None, None, :]
    qpos = lengths.long()[:, None, None] \
        + torch.arange(t, device=q.device)[None, :, None]
    keep = pos <= qpos                                      # (B, T, S)
    if window is not None:
        keep = keep & (pos > qpos - window)
    s = torch.where(keep[:, None, None], s, _NEG_INF)
    att = torch.softmax(s, dim=-1).to(v_eff.dtype)
    out = torch.einsum("bngts,bnsd->btngd", att, v_eff)
    return out.reshape(b, t, h, d).to(q.dtype)


def _check_pages(name, q, k_pages, v_pages, n_heads, head_dim, k_scales,
                 v_scales) -> int:
    """Validate the operands a page kernel reads; returns the page kind
    (0 float, 8 int8, 4 int4)."""
    if k_pages.device != q.device or v_pages.device != q.device:
        raise ValueError(f"{name}: q and the pages must share a device")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q is fp32, bf16 or fp16, got {q.dtype}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: pages must be (P, Hkv, page_size, D)")
    _, hkv, _, d_store = k_pages.shape
    if n_heads % hkv:
        raise ValueError(f"{name}: {hkv} KV heads do not divide {n_heads} "
                         "query heads")
    tensors = [q, k_pages, v_pages]
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f"{name}: pass both k_scales and v_scales or neither")
    if k_scales is None:
        bits = 0
        if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
            raise TypeError(f"{name}: float pages must have q's dtype")
        if d_store != head_dim or (d_store * q.element_size()) % 16:
            raise ValueError(f"{name}: the kernel loads 16-byte vectors of "
                             f"D={head_dim} {q.dtype} rows")
    else:
        bits = 8 if d_store == head_dim else 4
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise TypeError(f"{name}: quantized pages are int8 tensors")
        if bits == 4 and 2 * d_store != head_dim:
            raise ValueError(f"{name}: pages of last dim {d_store} fit "
                             f"neither int8 nor int4 rows of D={head_dim}")
        if d_store % 16:
            raise ValueError(f"{name}: the kernel loads 16-byte vectors; a "
                             f"{d_store}-byte page row is not a multiple")
        want = tuple(k_pages.shape[:3]) + (1,)
        for sc in (k_scales, v_scales):
            if (sc.device != q.device or sc.dtype != torch.float32
                    or tuple(sc.shape) != want):
                raise ValueError(f"{name}: scales must be fp32 {want} on "
                                 "q's device")
        tensors += [k_scales, v_scales]
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: pages must be 16-byte aligned")
    return bits


def _check_index(name, t, device, shape=None, dim=None):
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name}: index tensors must be contiguous int32 on "
                         "q's device")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected an index tensor of shape {shape}")
    if dim is not None and t.dim() != dim:
        raise ValueError(f"{name}: expected a {dim}-d index tensor")


def _scale_arg(scale, d):
    return float(1.0 / np.sqrt(d) if scale is None else scale)


def _launch(name, q, k_pages, v_pages, block_tables, lengths, k_scales,
            v_scales, bits, scale, window):
    """Launch the decode (q (B, H, D)) or verify (q (B, T, H, D)) kernel
    on validated operands; bf16 and fp16 queries get the split plan and,
    with more than one split, the partials' workspace.  Returns the
    output."""
    *lead, d = q.shape                             # (B, H) or (B, T, H)
    p, hkv, ps, _ = k_pages.shape
    maxp = block_tables.shape[1]
    pps, ws = maxp, None
    if q.dtype in _HALF:
        if d > _MAX_HALF_D:
            raise ValueError(f"{name}: {q.dtype} queries take D <= "
                             f"{_MAX_HALF_D}, got {d}")
        pps, n_split = split_plan(lead[0], hkv, maxp, ps)
        if n_split > 1:
            # per split and (slot, KV head): the G * T rows' O, m and l
            ws = torch.empty(n_split * math.prod(lead) * (d + 2),
                             dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    code = _build.kernel(name)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if bits == 0 else k_scales.data_ptr(),
        None if bits == 0 else v_scales.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), *lead, hkv, ps, d, maxp, p,
        pps, _scale_arg(scale, d), 0 if window is None else int(window),
        _DTYPES[q.dtype], bits, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(name, code)
    return out


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    k_scales=None, v_scales=None, scale=None, window=None):
    """Single-query decode attention through a paged KV pool.

    ``q`` (B, H, D) fp32/bf16/fp16; ``k_pages``/``v_pages`` (P, Hkv,
    page_size, D) of q's dtype, Hkv dividing H (GQA) — or int8 with
    ``k_scales``/``v_scales`` (P, Hkv, page_size, 1) fp32, or packed int4
    (last dim D // 2, detected from the shape) with the same scales;
    ``block_tables`` (B, max_pages) int32 page ids (entries beyond a
    slot's pages name the null page 0); ``lengths`` (B,) int32 visible
    positions per slot, at least 1; ``window`` keeps only positions >=
    ``lengths - window``.  Returns (B, H, D) in q's dtype.

    CPU tensors take :func:`paged_attention_plain`.  CUDA tensors launch
    the kernel on the current stream without synchronising, or raise."""
    kw = dict(k_scales=k_scales, v_scales=v_scales, scale=scale,
              window=window)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    b, h, d = q.shape
    bits = _check_pages("paged_attention", q, k_pages, v_pages, h, d,
                        k_scales, v_scales)
    _check_index("paged_attention", block_tables, q.device, dim=2)
    _check_index("paged_attention", lengths, q.device, shape=(b,))
    if block_tables.shape[0] != b:
        raise ValueError("paged_attention: block_tables must be (B, max_pages)")
    out = _launch("paged_attention", q, k_pages, v_pages, block_tables,
                  lengths, k_scales, v_scales, bits, scale, window)
    _build.LAUNCHES[_DECODE[bits, q.dtype == torch.float16]] += 1
    return out


def paged_attention_mq(q, k_pages, v_pages, block_tables, lengths, *,
                       k_scales=None, v_scales=None, scale=None, window=None):
    """Multi-query (speculative verify) attention through a paged KV pool.

    ``q`` (B, T, H, D) fp32/bf16/fp16, row t of slot b at position
    ``lengths[b] + t``; ``lengths`` (B,) int32 counts the positions valid
    BEFORE the block, whose own K/V must already be in the pages.  Row t
    attends to page position j iff ``j <= lengths[b] + t`` (and ``j >
    lengths[b] + t - window``).  Other operands as
    :func:`paged_attention`.  Returns (B, T, H, D) in q's dtype.

    T == 1 is the decode kernel with ``lengths + 1`` (the masks coincide),
    as in the reference.  Otherwise CPU tensors take
    :func:`paged_attention_mq_plain`, and CUDA tensors launch the verify
    kernel on the current stream without synchronising, or raise."""
    kw = dict(k_scales=k_scales, v_scales=v_scales, scale=scale,
              window=window)
    b, t, h, d = q.shape
    if t == 1:
        out = paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                              block_tables, lengths + 1, **kw)
        return out[:, None]
    if q.device.type == "cpu":
        return paged_attention_mq_plain(q, k_pages, v_pages, block_tables,
                                        lengths, **kw)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_attention_mq runs on cpu or cuda, not {q.device}")
    bits = _check_pages("paged_attention_mq", q, k_pages, v_pages, h, d,
                        k_scales, v_scales)
    _check_index("paged_attention_mq", block_tables, q.device, dim=2)
    _check_index("paged_attention_mq", lengths, q.device, shape=(b,))
    if block_tables.shape[0] != b:
        raise ValueError(
            "paged_attention_mq: block_tables must be (B, max_pages)")
    out = _launch("paged_attention_mq", q, k_pages, v_pages, block_tables,
                  lengths, k_scales, v_scales, bits, scale, window)
    _build.LAUNCHES[_MQ[bits, q.dtype == torch.float16]] += 1
    return out

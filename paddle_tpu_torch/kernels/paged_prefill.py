"""Paged chunk-prefill attention: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``paddle_tpu/kernels/paged_prefill.py`` (``paged_prefill``,
``paged_prefill_ref``) over float, int8 and nibble-packed int4 pages.  The
kernel is ``paddle_tpu_torch/csrc/paged_prefill.cu``.  For bf16 and fp16
queries it runs the split-KV body of ``csrc/paged_split.cuh``: blocks of
:data:`PREFILL_ROWS` rows (the chunk's rows times the query heads of a
GQA group) over :func:`prefill_plan`'s splits of the slot's block table,
and a second kernel that merges the splits' partials from a workspace
this module allocates; fp32 queries take blocks over (query tile of the
chunk, KV head) with exact fp32 products.  See the sources for their
design and what bounds them on the card.

:func:`paged_prefill` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; there is no other path.  Launches count per
page kind: ``paged_prefill``, ``paged_prefill_int8``,
``paged_prefill_int4`` (fp32 and bf16 queries), and the same three with
``_fp16`` appended for fp16 queries.
"""

from __future__ import annotations

import torch

from . import _build
from .paged_attention import (_DTYPES, _HALF, _MAX_HALF_D, _NEG_INF,
                              SPLIT_BLOCKS, _check_index, _check_pages,
                              _scale_arg, _scale_scores, _variants,
                              gather_pages)

_PREFILL = _variants("paged_prefill")
_build.LAUNCHES.update({n: 0 for n in _PREFILL.values()})
#: the 16-bit kernel's query rows per thread block (four warps of 16 rows on
#: one K/V tile ring), and key positions per split at least (four 32-key
#: tiles, so that the ring runs ahead of the math)
PREFILL_ROWS = 64
PREFILL_MIN_POSITIONS = 128


def prefill_plan(chunk, heads, kv_heads, max_pages, page_size):
    """How the bf16 and fp16 prefill kernel cuts the slot's block-table
    row of ``max_pages`` entries: ``(pages_per_split, n_split)``, split s
    taking entries ``[s * pages_per_split, (s + 1) * pages_per_split)``
    (the last one fewer).  Enough splits that the ``kv_heads`` x row blocks of
    :data:`PREFILL_ROWS` (the ``chunk`` x ``heads / kv_heads`` rows of a
    KV head) x ``n_split`` blocks reach :data:`SPLIT_BLOCKS`, each split
    of at least :data:`PREFILL_MIN_POSITIONS` positions.

    A function of host-known shapes only, and not of the chunk's start:
    every chunk of a bucket gets the same grid (a CUDA graph can capture
    the call), and a block whose split holds no position its rows can see
    exits at once."""
    if min(chunk, heads, kv_heads, max_pages, page_size) < 1 \
            or heads % kv_heads:
        raise ValueError("prefill_plan: every shape must be positive, and "
                         "kv_heads must divide heads")
    rows = chunk * (heads // kv_heads)
    blocks = kv_heads * -(-rows // PREFILL_ROWS)
    want = -(-SPLIT_BLOCKS // blocks)
    pps = max(-(-PREFILL_MIN_POSITIONS // page_size), -(-max_pages // want))
    pps = min(pps, max_pages)
    return pps, -(-max_pages // pps)


def paged_prefill_plain(q, k_pages, v_pages, block_table, start, *,
                        k_scales=None, v_scales=None, scale=None,
                        window=None):
    """The kernel's plain PyTorch version, decision for decision the
    reference's ``paged_prefill_ref``: this slot's pages gathered dense
    (with dequant), scaled scores, the causal rule ``pos <= start + i``
    (and ``pos > start + i - window``) masked to -1e30, softmax,
    probabilities cast to V's dtype before the PV product."""
    c, h, d = q.shape
    k_eff = gather_pages(k_pages, block_table[None], k_scales, d)[0]
    v_eff = gather_pages(v_pages, block_table[None], v_scales, d)[0]
    hkv = k_eff.shape[0]
    qg = q.reshape(c, hkv, h // hkv, d)
    s = torch.einsum("cngd,nsd->ngcs", qg.float(), k_eff.float())
    s = _scale_scores(s, d, scale)
    pos = torch.arange(k_eff.shape[1], device=q.device)[None, None, :]
    qpos = int(start) + torch.arange(c, device=q.device)[None, :, None]
    keep = pos <= qpos
    if window is not None:
        keep = keep & (pos > qpos - window)
    s = torch.where(keep, s, _NEG_INF)
    att = torch.softmax(s, dim=-1).to(v_eff.dtype)
    out = torch.einsum("ngcs,nsd->cngd", att, v_eff)
    return out.reshape(c, h, d).to(q.dtype)


def _launch(q, k_pages, v_pages, block_table, start, k_scales, v_scales,
            bits, scale, window):
    """Launch the kernel on validated operands; bf16 and fp16 queries get
    the prefill plan and, with more than one split, the partials'
    workspace.  Returns the output."""
    c, h, d = q.shape
    p, hkv, ps, _ = k_pages.shape
    maxp = block_table.shape[0]
    pps, ws = maxp, None
    if q.dtype in _HALF:
        if d > _MAX_HALF_D:
            raise ValueError(f"paged_prefill: {q.dtype} queries take D <= "
                             f"{_MAX_HALF_D}, got {d}")
        pps, n_split = prefill_plan(c, h, hkv, maxp, ps)
        if n_split > 1:
            # per split: the C * H rows' O, m and l
            ws = torch.empty(n_split * c * h * (d + 2), dtype=torch.float32,
                             device=q.device)
    out = torch.empty_like(q)
    code = _build.kernel("paged_prefill")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if bits == 0 else k_scales.data_ptr(),
        None if bits == 0 else v_scales.data_ptr(), block_table.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), start, c, h,
        hkv, ps, d, maxp, p, pps, _scale_arg(scale, d),
        0 if window is None else int(window), _DTYPES[q.dtype], bits,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_prefill", code)
    return out


def paged_prefill(q, k_pages, v_pages, block_table, start, *, k_scales=None,
                  v_scales=None, scale=None, window=None):
    """Chunk attention through a paged KV pool.

    ``q`` (C, H, D) fp32/bf16/fp16, row i at position ``start + i``;
    ``k_pages``/``v_pages`` (P, Hkv, page_size, D) of q's dtype, Hkv
    dividing H — or int8 / packed int4 with ``k_scales``/``v_scales``
    (P, Hkv, page_size, 1) fp32, as :func:`paged_attention` takes them;
    ``block_table`` (max_pages,) int32 page ids of THIS slot; ``start`` a
    Python int, the positions valid before the chunk; ``window`` keeps row
    i's positions in ``(start + i - window, start + i]``.  The chunk's own
    K/V must already be in the pages.  Returns (C, H, D) in q's dtype.

    CPU tensors take :func:`paged_prefill_plain`.  CUDA tensors launch the
    kernel on the current stream without synchronising, or raise."""
    kw = dict(k_scales=k_scales, v_scales=v_scales, scale=scale,
              window=window)
    if q.device.type == "cpu":
        return paged_prefill_plain(q, k_pages, v_pages, block_table, start,
                                   **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill runs on cpu or cuda, not {q.device}")
    c, h, d = q.shape
    bits = _check_pages("paged_prefill", q, k_pages, v_pages, h, d,
                        k_scales, v_scales)
    _check_index("paged_prefill", block_table, q.device, dim=1)
    start = int(start)
    if start < 0:
        raise ValueError(f"paged_prefill: start must be >= 0, got {start}")
    out = _launch(q, k_pages, v_pages, block_table, start, k_scales,
                  v_scales, bits, scale, window)
    _build.LAUNCHES[_PREFILL[bits, q.dtype == torch.float16]] += 1
    return out

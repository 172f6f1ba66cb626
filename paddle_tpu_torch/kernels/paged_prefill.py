"""Paged chunk-prefill attention: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``paddle_tpu/kernels/paged_prefill.py`` (``paged_prefill``,
``paged_prefill_ref``) over float, int8 and nibble-packed int4 pages.  The
kernel is ``paddle_tpu_torch/csrc/paged_prefill.cu``: blocks over (query
tile of the chunk, KV head) walk the slot's block table up to the last
page the tile can see; see the source for its design and what bounds it
on the card.

:func:`paged_prefill` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; there is no other path.  Launches count per
page kind: ``paged_prefill``, ``paged_prefill_int8``,
``paged_prefill_int4``.
"""

from __future__ import annotations

import torch

from . import _build
from .paged_attention import (_DTYPES, _NEG_INF, _SUFFIX, _check_index,
                              _check_pages, _scale_arg, _scale_scores,
                              gather_pages)

_PREFILL = {b: "paged_prefill" + s for b, s in _SUFFIX.items()}
_build.LAUNCHES.update({n: 0 for n in _PREFILL.values()})


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


def paged_prefill(q, k_pages, v_pages, block_table, start, *, k_scales=None,
                  v_scales=None, scale=None, window=None):
    """Chunk attention through a paged KV pool.

    ``q`` (C, H, D) fp32/bf16, row i at position ``start + i``;
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
    p, hkv, ps, _ = k_pages.shape
    _check_index("paged_prefill", block_table, q.device, dim=1)
    start = int(start)
    if start < 0:
        raise ValueError(f"paged_prefill: start must be >= 0, got {start}")
    out = torch.empty_like(q)
    fn = _build.kernel("paged_prefill")
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              None if bits == 0 else k_scales.data_ptr(),
              None if bits == 0 else v_scales.data_ptr(),
              block_table.data_ptr(), out.data_ptr(), start, c, h, hkv, ps, d,
              block_table.shape[0], p, _scale_arg(scale, d),
              0 if window is None else int(window), _DTYPES[q.dtype], bits,
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_prefill", code)
    _build.LAUNCHES[_PREFILL[bits]] += 1
    return out

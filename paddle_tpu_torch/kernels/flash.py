"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd function that ties them together.

Counterpart of ``paddle_tpu/kernels/flash.py`` (``flash_attention``,
``supported``, ``_pick_block``, ``_layout_s_axis`` and the forward / dQ /
dK-dV Pallas bodies behind its six ``pallas_call`` sites).  The kernels
are ``paddle_tpu_torch/csrc/flash_fwd.cu`` and ``flash_bwd.cu`` (one
kernel each for the forward, dQ and dK/dV); see the sources for their
design and what bounds them on the card.

Layouts, as in the reference: ``"bnsd"`` ([..., S, D], q/k/v with the same
heads), ``"bsnd"`` ([B, S, H, D]) and ``"sbnd"`` ([S, B, H, D]); the two
seq-major layouts take GQA (k/v with fewer heads, a divisor of q's).  The
kernels read every layout in place through strides, so a caller's views
(the head slices of a fused QKV projection) need no transposes or copies.

:func:`flash_attention` differentiates through :class:`_Flash`, which
saves ``(q, k, v, out, lse)`` as the reference's ``_flash_fwd_rule`` does.
CPU tensors take the plain versions (:func:`flash_fwd_plain`,
:func:`flash_bwd_plain`); CUDA tensors launch the kernels, or raise.
Launches count as ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``.

Beyond the reference's Pallas kernels, which refuse a mask, every entry
here takes an additive fp32 score ``bias`` that broadcasts to the heads'
[B, H, S, S] (:func:`mask_bias` makes it from an attention mask: a float
mask as it is, a boolean one as 0 / -1e9, the reference's
``_sdpa_reference`` decisions).  It is added to the scaled scores before
the causal band and the window mask them; no gradient flows to it.  The
kernels read it through its strides, so a [B, 1, 1, S] pad mask or an
[S, S] decoder mask is never copied along a broadcast dimension.
:func:`attention` is the entry that the card's ``sdpa`` takes: the
kernels at any sequence length, with a bias; :func:`flash_attention`
keeps the reference's signature and block gate.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_build.LAUNCHES.update({name: 0 for name in _KERNELS})


def _pick_block(s: int, want: int = 512):
    """The reference's block choice: the first of ``want``, 512, 256, ...,
    8 that divides ``s`` (None when none does).  It decides which lengths
    :func:`supported` admits; the CUDA kernels use their own tiles and take
    any length."""
    for b in (want, 512, 256, 128, 64, 32, 16, 8):
        if b <= s and s % b == 0:
            return b
    return None


def _layout_s_axis(layout, ndim=4):
    if layout == "bsnd":
        return -3
    if layout == "sbnd":
        return -ndim  # seq leads: [s, b, nh, d]
    return -2


def _shape_reason(q, k, layout):
    """The shape checks that :func:`flash_attention` makes as the
    reference's does (layout rank, cross-attention lengths, GQA), as a
    reason, or None."""
    s_axis = _layout_s_axis(layout, q.ndim)
    if layout in ("bsnd", "sbnd") and q.ndim != 4:
        return f"layout {layout!r} needs 4-D q/k/v, got {q.ndim}-D"
    if q.shape[s_axis] != k.shape[s_axis]:
        return "q/k of other lengths (cross-attention)"
    if q.ndim < 3:
        return None
    h_axis = 2 if layout in ("bsnd", "sbnd") else -3
    nh, nkv = q.shape[h_axis], k.shape[h_axis]
    if nh != nkv and (layout not in ("bsnd", "sbnd") or nkv == 0
                      or nh % nkv != 0):
        return (f"{nh} query heads over {nkv} KV heads in layout "
                f"{layout!r} (GQA needs bsnd or sbnd and a divisor)")
    return None


def _head_dim_reason(d):
    if d % 8 != 0 or not (16 <= d <= 256):
        return f"head_dim {d} (needs a multiple of 8 in 16..256)"
    return None


def _heads_shape(q, layout):
    """The [B, H, S, S] shape of the scores of q's [B, H, S, D] heads
    view (3-D bnsd: [B*H, 1, S, S])."""
    b, h, s, _ = _heads(q, layout).shape
    return (b, h, s, s)


def _mask_shape(q, layout):
    """The scores' shape in the reference's terms, which a mask broadcasts
    to: [..., S, S] of q's bnsd shape, [B, H, S, S] for seq-major."""
    if layout == "bnsd":
        return (*q.shape[:-1], q.shape[-2])
    return _heads_shape(q, layout)


def kernel_reason(q, k, mask=None, layout="bnsd"):
    """Why the CUDA kernels cannot take these inputs, or None when they
    can: what ``sdpa`` on the card checks.  Any sequence length and a mask
    that broadcasts to the scores pass; q/k of other lengths, a head dim
    outside the kernels' tiles, and a mask that requires grad do not."""
    if q.ndim < 3:
        return f"{q.ndim}-D q (needs at least 3 dims)"
    reason = _shape_reason(q, k, layout) or _head_dim_reason(q.shape[-1])
    if reason is not None or mask is None:
        return reason
    if mask.requires_grad:
        return "an attention mask that requires grad (no gradient flows " \
               "to the kernels' score bias)"
    scores = _mask_shape(q, layout)
    try:
        fits = torch.broadcast_shapes(mask.shape, scores) == scores
    except RuntimeError:
        fits = False
    if not fits:
        return (f"a mask of shape {tuple(mask.shape)} that does not "
                f"broadcast to the scores {scores}")
    return None


def mask_bias(mask, q, layout="bnsd"):
    """The kernels' score bias for an attention ``mask`` (None for none):
    fp32, a float mask as it is and a boolean one as 0 where True and -1e9
    where False (the reference's ``jnp.where(mask, logits, -1e9)``), as an
    ``expand`` view of the [B, H, S, S] scores of q's heads view.  The
    mask broadcasts against the scores in the reference's terms
    (:func:`_mask_shape`)."""
    if mask is None:
        return None
    if mask.dtype == torch.bool:
        bias = torch.zeros(mask.shape, device=mask.device).masked_fill(
            ~mask, -1e9)
    else:
        bias = mask.float()
    return bias.expand(_mask_shape(q, layout)).reshape(
        _heads_shape(q, layout))


def unsupported_reason(q, k, mask=None, dropout_p=0.0, layout="bnsd"):
    """Why the flash kernels cannot take these inputs, or None when they
    can: the reference's :func:`supported` gate, reason by reason."""
    if mask is not None:
        return "an explicit attention mask"
    if dropout_p != 0.0:
        return f"dropout_p={dropout_p}"
    if q.ndim < 3:
        return f"{q.ndim}-D q (needs at least 3 dims)"
    reason = _shape_reason(q, k, layout) or _head_dim_reason(q.shape[-1])
    if reason is not None:
        return reason
    s_len = q.shape[_layout_s_axis(layout, q.ndim)]
    if _pick_block(s_len) is None:
        return f"sequence length {s_len} (needs a multiple of 8)"
    return None


def supported(q, k, mask=None, dropout_p=0.0, layout="bnsd") -> bool:
    """Shape/feature gate of :func:`flash_attention` (the reference's)."""
    return unsupported_reason(q, k, mask, dropout_p, layout) is None


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def _canon(x, layout):
    """``x`` as a [B, S, H, D] view: bsnd as it is, sbnd permuted, 4-D
    bnsd transposed (a view of any strides: the head views of a fused QKV
    that the model transposes are read in place, where flattening B and H
    would copy them), other bnsd [..., S, D] flattened to (B*H, S, 1,
    D)."""
    if layout == "bsnd":
        return x
    if layout == "sbnd":
        return x.permute(1, 0, 2, 3)
    if x.dim() == 4:
        return x.transpose(1, 2)
    return x.reshape(-1, x.shape[-2], x.shape[-1]).unsqueeze(2)


def _heads(x, layout):
    """``x`` as a [B, H, S, D] view."""
    return _canon(x, layout).transpose(1, 2)


def _from_heads(xh, layout, shape):
    """A [B, H, S, D] result back to ``layout``, as a fresh tensor of
    ``shape``."""
    if layout == "bsnd":
        return xh.transpose(1, 2).contiguous()
    if layout == "sbnd":
        return xh.permute(2, 0, 1, 3).contiguous()
    return xh.reshape(shape).contiguous()


def _visible(s_len, causal, window, device):
    """(S, S) bool: key j visible to query i."""
    i = torch.arange(s_len, device=device)[:, None]
    j = torch.arange(s_len, device=device)[None, :]
    keep = torch.ones(s_len, s_len, dtype=torch.bool, device=device)
    if causal:
        keep = j <= i
        if window is not None:
            keep = keep & (j > i - window)
    return keep


def _grouped(q, k, v, layout):
    """q as (B, Hkv, G, S, D) and k, v as (B, Hkv, S, D): query heads
    grouped over their KV head by a reshape, never by repeating K/V."""
    qh, kh, vh = (_heads(t, layout) for t in (q, k, v))
    b, h, s, d = qh.shape
    hkv = kh.shape[1]
    return qh.reshape(b, hkv, h // hkv, s, d), kh, vh


def _scores(qg, kh, scale, causal, window, bias=None):
    """fp32 scores of the kernels: products of the inputs' values summed
    in fp32, times ``scale``, plus ``bias`` (:func:`mask_bias`'s [B, H, S,
    S] view), -1e30 where masked."""
    s = torch.einsum("bngqd,bnkd->bngqk", qg.float(), kh.float()) * scale
    if bias is not None:
        s = s + bias.reshape(s.shape)
    if causal:
        keep = _visible(s.shape[-1], causal, window, s.device)
        s = torch.where(keep, s, _NEG_INF)
    return s


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def flash_fwd_plain(q, k, v, causal=False, scale=None, window=None,
                    layout="bnsd", bias=None):
    """The forward kernel's plain version: the reference's ``_fwd_kernel``
    recurrence written densely.  Returns ``out`` (q's shape and dtype) and
    ``lse`` (B*H, S) fp32, row ``b * H + h`` (for bnsd, the flattened
    leading index).  P is cast to V's dtype before P.V and
    ``l = max(l, 1e-30)``, as in the kernel.  ``bias``: the score bias
    (:func:`mask_bias`), added to the scaled scores in fp32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qg, kh, vh = _grouped(q, k, v, layout)
    s = _scores(qg, kh, scale, causal, window, bias)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(1e-30)
    acc = torch.einsum("bngqk,bnkd->bngqd", p.to(v.dtype).float(), vh.float())
    b, hkv, g, s_len, d = qg.shape
    out = (acc / l[..., None]).to(q.dtype).reshape(b, hkv * g, s_len, d)
    lse = (m + torch.log(l)).reshape(b * hkv * g, s_len)
    return _from_heads(out, layout, q.shape), lse


def flash_bwd_plain(q, k, v, out, lse, do, causal=False, scale=None,
                    window=None, layout="bnsd", bias=None):
    """The backward kernels' plain version: dQ, dK, dV recomputed from the
    forward's ``lse`` and ``delta = rowsum(dO * O)`` as the reference's
    ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` compute them: ``p = exp(s -
    lse)``, ``dp = dO.V^T`` and ``ds = p * (dp - delta) * scale`` in fp32;
    ``dQ = ds.K`` with ds cast to K's dtype, ``dV = P^T.dO`` with P in
    fp32, ``dK = ds^T.Q`` with ds cast to Q's dtype.  GQA: each KV head's
    gradient sums its query-head group in fp32.

    ``dp`` and ``delta`` are summed in fp64 and their difference rounded
    to fp32 once: where they cancel (a query that sees one key has O
    equal to that key's V, and its dQ is 0 exactly, as the reference's
    autodiff gives) no fp32 summation noise, which another summation
    order would not reproduce, is left.  The fp32 kernels take delta
    summed in fp64 too, and dp in fp64 for a pair that holds at least
    1/16 of its query's probability.  ``bias``: the forward's score
    bias, added again where p is recomputed from lse."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qg, kh, vh = _grouped(q, k, v, layout)
    b, hkv, g, s_len, d = qg.shape
    dog = _heads(do, layout).reshape(qg.shape).float()
    og = _heads(out, layout).reshape(qg.shape).double()
    delta = (dog.double() * og).sum(-1)
    lse = lse.reshape(b, hkv, g, s_len)
    p = torch.exp(_scores(qg, kh, scale, causal, window, bias)
                  - lse[..., None])
    dp = torch.einsum("bngqd,bnkd->bngqk", dog.double(), vh.double())
    ds = p * (dp - delta[..., None]).float() * scale
    dq = torch.einsum("bngqk,bnkd->bngqd", ds.to(k.dtype).float(), kh.float())
    dv = torch.einsum("bngqk,bngqd->bnkd", p, dog)
    dk = torch.einsum("bngqk,bngqd->bnkd", ds.to(q.dtype).float(), qg.float())
    dq = dq.to(q.dtype).reshape(b, hkv * g, s_len, d)
    return (_from_heads(dq, layout, q.shape),
            _from_heads(dk.to(k.dtype), layout, k.shape),
            _from_heads(dv.to(v.dtype), layout, v.shape))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _operand(x, layout):
    """``x`` as the [B, S, H, D] view the kernels read, copied to a
    contiguous one only when its strides or address are not whole 16-byte
    vectors (d must be contiguous)."""
    c = _canon(x, layout)
    vec = 16 // c.element_size()
    ok = ((c.stride(3) == 1 or c.shape[3] == 1) and c.data_ptr() % 16 == 0
          and all(st % vec == 0 for st in c.stride()[:3]))
    return c if ok else c.contiguous()


def _check(q, k, v, bias, layout):
    """What the kernels ask beyond :func:`flash_attention`'s shape checks,
    which their callers have made: one float dtype, one device, a head
    dim that their tiles take, and a ``bias`` that is None or, as
    :func:`mask_bias` makes it, an fp32 view of the heads' [B, H, S, S]
    scores on q's device (read through its strides: a broadcast dimension
    keeps stride 0 and nothing is copied along it)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernels take fp32 or bf16 q/k/v of one "
                         f"dtype, not {q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash kernels: q, k and v must share a device")
    reason = _head_dim_reason(q.shape[-1])
    if reason is not None:
        raise ValueError(f"flash kernels cannot take {reason}")
    if bias is not None and (
            bias.dtype != torch.float32 or bias.device != q.device
            or tuple(bias.shape) != _heads_shape(q, layout)):
        raise ValueError(f"flash kernels take an fp32 bias of the scores' "
                         f"shape {_heads_shape(q, layout)} on q's device "
                         f"(mask_bias), not {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")


def _launch(name, tensors, strided, dims, scale, causal, window, dtype,
            bias=None):
    """Launch ``name`` over raw ``tensors`` (pointers in argument order),
    with the strides of the ``strided`` [B, S, H, D] views, and the score
    ``bias`` (None, or an fp32 [B, H, S, S] view) with its strides."""
    strides = [st for t in strided for st in t.stride()[:3]]
    arr = (ctypes.c_longlong * len(strides))(*strides)
    barr = (ctypes.c_longlong * 4)(*(bias.stride() if bias is not None
                                     else (0, 0, 0, 0)))
    dev = tensors[0].device
    code = _build.kernel(name)(
        *[t.data_ptr() for t in tensors], ctypes.addressof(arr),
        None if bias is None else bias.data_ptr(), ctypes.addressof(barr),
        *dims, float(scale), int(causal), int(window or 0), _DTYPES[dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(name, code)
    _build.LAUNCHES[name] += 1


def _dims(qc, kc):
    b, s, h, d = qc.shape
    return b, h, kc.shape[2], s, d


def flash_fwd_cuda(q, k, v, causal, scale, window, layout, bias=None):
    """The forward kernel: ``out`` (q's shape and dtype), ``lse`` (B*H, S)
    fp32.  CUDA tensors only."""
    _check(q, k, v, bias, layout)
    qc, kc, vc = (_operand(t, layout) for t in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    oc = _canon(out, layout)
    b, h, hkv, s, d = _dims(qc, kc)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (qc, kc, vc, oc, lse), (qc, kc, vc, oc),
            (b, h, hkv, s, d), scale, causal, window, q.dtype, bias)
    return out, lse


def flash_delta(out, do, layout="bnsd"):
    """``delta = rowsum(dO * O)``, row ``b * H + h``: the backward's
    per-row input, summed by PyTorch as the reference sums it outside
    Pallas.  For bf16 ``out`` (B*H, S) fp32.  For fp32 ``out`` it is
    summed in fp64, as :func:`flash_bwd_plain` forms it, and handed over
    as (B*H, S, 2) fp32, hi and lo with hi + lo that sum: where a query's
    probability sits on few keys, dp - delta cancels and the fp32 kernels
    need delta's low bits."""
    dc, oc = _canon(do, layout), _canon(out, layout)
    if out.dtype != torch.float32:
        delta = (dc.float() * oc.float()).sum(-1)
        b, s, h = delta.shape
        return delta.transpose(1, 2).reshape(b * h, s).contiguous()
    d64 = (dc.double() * oc.double()).sum(-1)
    hi = d64.float()
    delta = torch.stack((hi, (d64 - hi.double()).float()), -1)
    b, s, h, _ = delta.shape
    return delta.transpose(1, 2).reshape(b * h, s, 2).contiguous()


def _bwd_operands(q, k, v, lse, delta, do, layout, bias):
    """The backward kernels' read operands as [B, S, H, D] views, the
    contiguous lse and delta, and the dims (B, H, Hkv, S, D).  delta must
    have :func:`flash_delta`'s layout for q's dtype: the kernels read it
    through a raw pointer."""
    _check(q, k, v, bias, layout)
    qc, kc, vc, dc = (_operand(t, layout) for t in (q, k, v, do.to(q.dtype)))
    dims = _dims(qc, kc)
    b, h, _, s, _ = dims
    want = (b * h, s, 2) if q.dtype == torch.float32 else (b * h, s)
    if delta.dtype != torch.float32 or tuple(delta.shape) != want:
        raise ValueError(f"flash backward: delta must be fp32 {want} "
                         f"(flash_delta), not {delta.dtype} "
                         f"{tuple(delta.shape)}")
    return (qc, kc, vc, dc), lse.contiguous(), delta.contiguous(), dims


def flash_bwd_dq_cuda(q, k, v, out, lse, delta, do, causal, scale, window,
                      layout, bias=None):
    """The dQ kernel: ``dq`` in q's shape and dtype.  CUDA tensors only.
    The kernel reads ``delta``; ``out`` is handed over because the C entry
    point takes it, and no body reads it."""
    (qc, kc, vc, dc), lse, delta, dims = _bwd_operands(q, k, v, lse, delta,
                                                       do, layout, bias)
    oc = _operand(out.to(q.dtype), layout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dqc = _canon(dq, layout)
    _launch("flash_bwd_dq", (qc, kc, vc, oc, dc, lse, delta, dqc),
            (qc, kc, vc, oc, dc, dqc), dims, scale, causal, window, q.dtype,
            bias)
    return dq


def flash_bwd_dkv_cuda(q, k, v, lse, delta, do, causal, scale, window,
                       layout, bias=None):
    """The dK/dV kernel: ``dk, dv`` in k's and v's shapes and dtypes.
    CUDA tensors only."""
    (qc, kc, vc, dc), lse, delta, dims = _bwd_operands(q, k, v, lse, delta,
                                                       do, layout, bias)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    dkc, dvc = _canon(dk, layout), _canon(dv, layout)
    _launch("flash_bwd_dkv", (qc, kc, vc, dc, lse, delta, dkc, dvc),
            (qc, kc, vc, dc, dkc, dvc), dims, scale, causal, window, q.dtype,
            bias)
    return dk, dv


def _device_of(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    return q.device.type


def flash_fwd(q, k, v, causal=False, scale=None, window=None, layout="bnsd",
              bias=None):
    """``(out, lse)``: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _device_of(q) == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale, window, layout, bias)
    return flash_fwd_cuda(q, k, v, causal, scale, window, layout, bias)


def flash_bwd(q, k, v, out, lse, do, causal=False, scale=None, window=None,
              layout="bnsd", bias=None):
    """``(dq, dk, dv)``: the plain version for CPU tensors, the kernels
    for CUDA tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _device_of(q) == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, do, causal, scale, window,
                               layout, bias)
    delta = flash_delta(out, do, layout)
    opts = (causal, scale, window, layout, bias)
    return (flash_bwd_dq_cuda(q, k, v, out, lse, delta, do, *opts),
            *flash_bwd_dkv_cuda(q, k, v, lse, delta, do, *opts))


class _Flash(torch.autograd.Function):
    """Forward kernel; backward from the saved ``(q, k, v, out, lse)`` and
    the score bias, which gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, layout, bias):
        out, lse = flash_fwd(q, k, v, causal, scale, window, layout, bias)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.opts = (causal, scale, window, layout)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, bias = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do, *ctx.opts, bias)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, causal=False, scale=None, layout="bnsd", window=None,
              bias=None):
    """Flash attention at any sequence length, with an optional score
    ``bias`` (:func:`mask_bias`): what ``sdpa`` runs on the card, where the
    kernels take every length (ragged last tiles are masked).  The
    reference's shape checks raise ValueError; the block gate of
    :func:`flash_attention` is not applied."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if window is not None and not causal:
        raise ValueError("flash_attention: window requires causal=True")
    reason = _shape_reason(q, k, layout)
    if reason is not None:
        raise ValueError(f"flash_attention: {reason}")
    if bias is not None and bias.requires_grad:
        raise NotImplementedError("flash attention: no gradient flows to "
                                  "the score bias")
    win = None if window is None else int(window)
    return _Flash.apply(q, k, v, bool(causal), float(scale), win, layout,
                        bias)


def flash_attention(q, k, v, causal=False, scale=None, block_q=None,
                    block_k=None, layout="bnsd", window=None):
    """Flash attention over ``layout`` (see the module docstring), with the
    reference's arguments and ValueErrors.  ``window`` (causal only) masks
    keys more than ``window - 1`` positions behind each query.
    ``block_q``/``block_k`` are checked as the reference checks them (a
    length with no block raises); the CUDA kernels pick their own tiles."""
    if window is not None and not causal:
        raise ValueError("flash_attention: window requires causal=True")
    s_axis = _layout_s_axis(layout, q.ndim)
    s_len = q.shape[s_axis]
    if (block_q or _pick_block(s_len)) is None or \
            (block_k or _pick_block(s_len)) is None:
        raise ValueError(
            f"flash_attention: unsupported seq len {s_len} (needs a power-of-"
            f"two-ish divisor >= 8)")
    return attention(q, k, v, causal, scale, layout, window)

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
[B, H, Sq, Sk] (:func:`_bias_of` makes it from an attention mask: a
float mask as it is, a boolean one as 0 / -1e9, the reference's
``_sdpa_reference`` decisions).  It is added to the scaled scores before
the causal band and the window mask them.  The kernels read it through
its strides, so a [B, 1, 1, Sk] pad mask or an [Sq, Sk] decoder mask is
never copied along a broadcast dimension.  A float mask that requires
grad gets its gradient, as ``jax.vjp`` of ``_sdpa_reference`` gives it:
d(logit) = p (dp - delta) at every position, summed by the dQ kernel
over the bias's broadcast dimensions (launches ``flash_bwd_dq_dbias``).

Beyond them too, q and k may have lengths of their own, Sq and Sk
(cross-attention over a memory, one decode step against a cache).  A
causal band is then aligned at the bottom right: query i sits at
position ``i + Sk - Sq``, as ``_sdpa_reference`` places its queries.
Causal with Sq > Sk leaves the first ``Sq - Sk`` queries no key; the
reference fills their logits with -1e9 in q's dtype, adds a float mask
(in q's dtype) and softmaxes that, and so do the kernels and the plain
versions (:func:`_fill_logits`, the row's logits less the fill, so that
its fp32 lse keeps the log of its sum): such a row averages V over the
keys its mask leaves, q and k get no gradient from it, v and the mask do.
A boolean mask leaves the fill as it is (the reference's ``where`` picks
-1e9 either way), so :func:`_bias_of` makes its bias 0 in those rows.
fp16 has no finite -1e9 (the reference's fill is -inf there and its
row NaN): the kernels keep that fill in fp32, a recorded choice.

q, k and v may be fp32, bf16 or fp16.  Head dims the tiles do not take
(not a multiple of 8, under 16, or v's other than q's) are zero-padded
by :func:`attention` (a copy of q, k and v) and the output sliced back;
the scale stays that of the real head dim.  Above 256 no tile takes it.

:func:`attend` is the entry that the card's ``sdpa`` takes, with the
reference's inputs (bnsd GQA, 2-D q, broadcast leading dims, a mask in
the reference's terms); :func:`attention` the kernels at any lengths,
with a bias; :func:`flash_attention` keeps the reference's signature,
its one-length rule and its block gate.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

_NEG_INF = -1e30
_FILL = -1e9        # the reference's masked logit, before its dtype rounds it
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_HEAD_DIM = 256
# flash_bwd_dq_dbias: a dQ launch that also writes the bias's gradient
_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dq_dbias",
            "flash_bwd_dkv")
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


def _layout_reason(q, k, layout, bnsd_gqa=False):
    """The layout checks that the kernels need (layout rank, GQA), as a
    reason, or None.  GQA takes the seq-major layouts, as the reference's
    kernels do, and with ``bnsd_gqa`` also 4-D bnsd (what the card's
    ``sdpa`` hands :func:`attention`)."""
    if layout in ("bsnd", "sbnd") and q.ndim != 4:
        return f"layout {layout!r} needs 4-D q/k/v, got {q.ndim}-D"
    if q.ndim < 3:
        return None
    h_axis = 2 if layout in ("bsnd", "sbnd") else -3
    nh, nkv = q.shape[h_axis], k.shape[h_axis]
    grouped_ok = layout in ("bsnd", "sbnd") or (bnsd_gqa and q.ndim == 4)
    if nh != nkv and (not grouped_ok or nkv == 0 or nh % nkv != 0):
        return (f"{nh} query heads over {nkv} KV heads in layout "
                f"{layout!r} (GQA needs bsnd or sbnd and a divisor)")
    return None


def _shape_reason(q, k, layout):
    """The shape checks that :func:`flash_attention` makes as the
    reference's does, in its order (layout rank, one length for q and k,
    GQA), as a reason, or None."""
    rank_ok = layout not in ("bsnd", "sbnd") or q.ndim == 4
    if rank_ok and len(set(_lengths(q, k, layout))) > 1:
        return "q/k of other lengths (cross-attention)"
    return _layout_reason(q, k, layout)


def _lengths(q, k, layout):
    """(Sq, Sk): the query and key lengths."""
    s_axis = _layout_s_axis(layout, q.ndim)
    return q.shape[s_axis], k.shape[s_axis]


def _head_dim_reason(d):
    if d % 8 != 0 or not (16 <= d <= 256):
        return f"head_dim {d} (needs a multiple of 8 in 16..256)"
    return None


def _heads_shape(q, layout, k=None):
    """The [B, H, Sq, Sk] shape of the scores of q's [B, H, Sq, D] heads
    view against k's Sk keys (3-D bnsd: [B*H, 1, Sq, Sk]); k None: k of
    q's length."""
    b, h, sq, _ = _heads(q, layout).shape
    sk = sq if k is None else _lengths(q, k, layout)[1]
    return (b, h, sq, sk)


def _mask_shape(q, layout, k=None):
    """The scores' shape in the reference's terms, which a mask broadcasts
    to: [..., Sq, Sk] of q's bnsd shape, [B, H, Sq, Sk] for seq-major."""
    if layout == "bnsd":
        return (*q.shape[:-1], _heads_shape(q, layout, k)[-1])
    return _heads_shape(q, layout, k)


def _as_bnsd(x, layout):
    """A seq-major tensor as the reference's bnsd view of it."""
    if layout == "sbnd":
        return x.permute(1, 2, 0, 3)
    if layout == "bsnd":
        return x.transpose(1, 2)
    return x


def _ref_shapes(q, k, v, layout):
    """(logits shape, grouped) of ``_sdpa_reference`` on these inputs (the
    seq-major layouts as their bnsd views): the scores q.k^T broadcast
    over the leading dims, [..., Hkv, G, Sq, Sk] when k and v carry fewer
    heads than q on dim -3 (GQA).  Raises ValueError where the reference's
    reshape or einsum would fail."""
    q, k, v = (_as_bnsd(t, layout) for t in (q, k, v))
    if q.ndim < 2 or k.ndim < 2 or v.ndim < 2:
        raise ValueError("q, k and v need at least 2 dims")
    if k.shape[-1] != q.shape[-1]:
        raise ValueError(f"q and k of head dims {q.shape[-1]} and "
                         f"{k.shape[-1]}")
    if v.shape[-2] != k.shape[-2]:
        raise ValueError(f"k and v of lengths {k.shape[-2]} and "
                         f"{v.shape[-2]}")
    nh = q.shape[-3] if q.ndim >= 3 else 1
    nkv = k.shape[-3] if k.ndim >= 3 else 1
    sq, sk = q.shape[-2], k.shape[-2]
    try:
        if q.ndim >= 3 and nh != nkv:
            if nkv == 0 or nh % nkv != 0:
                raise ValueError(f"{nh} query heads over {nkv} KV heads "
                                 f"(GQA needs a divisor)")
            kv_lead = [t.shape[:-3] for t in (k, v) if t.ndim > 3]
            if v.ndim >= 3 and v.shape[-3] != nkv:
                raise ValueError(f"k and v of {nkv} and {v.shape[-3]} heads")
            lead = torch.broadcast_shapes(q.shape[:-3], *kv_lead)
            return tuple(lead) + (nkv, nh // nkv, sq, sk), True
        lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2],
                                      v.shape[:-2])
    except RuntimeError as e:
        raise ValueError(f"leading dims that do not broadcast ({e})")
    return tuple(lead) + (sq, sk), False


def kernel_reason(q, k, mask=None, layout="bnsd", is_causal=False, v=None):
    """Why the card's ``sdpa`` cannot take these inputs, or None when it
    can.  It takes whatever ``_sdpa_reference`` takes (any lengths, causal
    Sq > Sk, fp16, a mask that requires grad, any head dim, GQA in every
    layout, 2-D q, broadcast leading dims), except what is named here: a
    head dim above 256 (no tile takes it), a dtype other than fp32, bf16
    and fp16, q, k and v of other dtypes (the reference would promote),
    and seq-major q and k/v of other batch sizes.  ``v`` None: k's
    shape.  ``is_causal`` decides nothing: every causal band is taken."""
    v = k if v is None else v
    if layout not in ("bnsd", "bsnd", "sbnd"):
        return f"layout {layout!r}"
    if layout in ("bsnd", "sbnd") and not q.ndim == k.ndim == v.ndim == 4:
        return f"layout {layout!r} needs 4-D q/k/v, got {q.ndim}-D"
    if q.dtype not in _DTYPES:
        return f"{q.dtype} q (the kernels take fp32, bf16 and fp16)"
    if k.dtype != q.dtype or v.dtype != q.dtype:
        return f"q/k/v of other dtypes ({q.dtype}/{k.dtype}/{v.dtype})"
    d = max(q.shape[-1], v.shape[-1])
    if d > _MAX_HEAD_DIM:
        return f"head_dim {d} (above {_MAX_HEAD_DIM}: no tile takes it)"
    b_axis = 1 if layout == "sbnd" else 0
    if layout != "bnsd" and len({t.shape[b_axis] for t in (q, k, v)}) > 1:
        return "seq-major q and k/v of other batch sizes"
    try:
        scores = _ref_shapes(q, k, v, layout)[0]
    except ValueError as e:
        return str(e)
    if mask is None:
        return None
    try:
        fits = torch.broadcast_shapes(mask.shape, scores) == scores
    except RuntimeError:
        fits = False
    if not fits:
        return (f"a mask of shape {tuple(mask.shape)} that does not "
                f"broadcast to the scores {tuple(scores)}")
    return None


def _bias_of(mask, q, layout="bnsd", k=None, causal=False):
    """The kernels' fp32 score bias of an attention ``mask`` at its own
    broadcast shape: a float mask as it is (its graph kept, so that a
    mask that requires grad gets one), a boolean one as 0 where True and
    -1e9 where False (the reference's ``jnp.where(mask, logits, -1e9)``).
    4-D q (and the seq-major layouts): the mask padded to 4-D, which
    broadcasts to the heads' [B, H, Sq, Sk]; other bnsd ranks: the
    [B*H, 1, Sq, Sk] view of the reference's [..., Sq, Sk] scores; ``k``
    None: k of q's length.  ``causal`` with Sq > Sk: a boolean mask's
    bias is 0 in the rows that see no key (expanded over Sq), where the
    reference's ``where`` keeps the -1e9 fill at every key.  The kernels
    read the bias's ``expand`` to :func:`_heads_shape`."""
    if mask.dtype == torch.bool:
        bias = torch.zeros(mask.shape, device=mask.device).masked_fill(
            ~mask, _FILL)
    else:
        bias = mask.float()
    if q.ndim == 4:
        bias = bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape))
    else:
        bias = bias.expand(_mask_shape(q, layout, k)).reshape(
            _heads_shape(q, layout, k))
    sq, sk = _heads_shape(q, layout, k)[-2:]
    if mask.dtype == torch.bool and causal and sq > sk:
        rows = torch.arange(sq, device=bias.device)[:, None]
        bias = torch.where(rows < sq - sk, 0.0, bias)
    return bias


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


def _visible(s_len, causal, window, device, k_len=None):
    """(Sq, Sk) bool: key j visible to query i (``k_len`` None: Sk = Sq).
    The causal band is aligned at the bottom right: query i sits at
    position ``i + Sk - Sq``."""
    k_len = s_len if k_len is None else k_len
    i = torch.arange(k_len - s_len, k_len, device=device)[:, None]
    j = torch.arange(k_len, device=device)[None, :]
    keep = torch.ones(s_len, k_len, dtype=torch.bool, device=device)
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


def _fill_logits(bias, dtype, shape, device):
    """The logits of the rows that see no key (the first Sq - Sk of a
    causal band with Sq > Sk), ``shape`` [..., Sq - Sk, Sk]: the
    reference's fill, -1e9 in q's ``dtype``, plus the bias there in q's
    dtype (a boolean mask's is 0 there: :func:`_bias_of`), rounded to
    q's dtype; then less the fill, as the
    kernels take them (the softmax does not move, and the row's fp32 lse
    keeps the log of its sum, which -1e9's spacing of 64 would round
    away).  fp16 has no finite -1e9 (the reference's fill is -inf and its
    row NaN): its fill stays fp32, plus the bias in fp16."""
    if bias is None:
        return torch.zeros(shape, device=device)
    fill = torch.tensor(_FILL, device=device)
    if dtype != torch.float16:
        fill = fill.to(dtype).float()
    b = bias[..., :shape[-2], :].float().to(dtype).float()
    if dtype == torch.float16:
        return ((fill + b) - fill).expand(shape)
    return ((fill + b).to(dtype).float() - fill).expand(shape)


def _scores(qg, kh, scale, causal, window, bias=None, dtype=torch.float32):
    """fp32 scores of the kernels: products of the inputs' values summed
    in fp32, times ``scale``, plus ``bias`` (a [B, H, Sq, Sk] view of
    :func:`_bias_of`'s), -1e30 where masked; the rows that see no key take
    :func:`_fill_logits` of q's ``dtype``."""
    s = torch.einsum("bngqd,bnkd->bngqk", qg.float(), kh.float()) * scale
    if bias is not None:
        bias = bias.reshape(s.shape)
        s = s + bias
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = _visible(sq, causal, window, s.device, sk)
        s = torch.where(keep, s, _NEG_INF)
        if sq > sk:
            fill = _fill_logits(bias, dtype, s.shape[:-2] + (sq - sk, sk),
                                s.device)
            s = torch.cat((fill, s[..., sq - sk:, :]), -2)
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
    (an fp32 [B, H, Sq, Sk] view of :func:`_bias_of`'s), added to the
    scaled scores in fp32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qg, kh, vh = _grouped(q, k, v, layout)
    s = _scores(qg, kh, scale, causal, window, bias, q.dtype)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(1e-30)
    acc = torch.einsum("bngqk,bnkd->bngqd", p.to(v.dtype).float(), vh.float())
    b, hkv, g, s_len, d = qg.shape
    out = (acc / l[..., None]).to(q.dtype).reshape(b, hkv * g, s_len, d)
    lse = (m + torch.log(l)).reshape(b * hkv * g, s_len)
    return _from_heads(out, layout, q.shape), lse


def flash_bwd_plain(q, k, v, out, lse, do, causal=False, scale=None,
                    window=None, layout="bnsd", bias=None, dbias_shape=None):
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
    bias, added again where p is recomputed from lse.

    The rows that see no key (causal, Sq > Sk) have p from their fill:
    they add P^T.dO to dV and nothing to dQ or dK.  ``dbias_shape`` (a
    shape that broadcasts to the heads' [B, H, Sq, Sk]): also return the
    bias's gradient d(logit) = p (dp - delta) (unscaled, every position),
    fp32, summed to that shape, as a fourth output."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qg, kh, vh = _grouped(q, k, v, layout)
    b, hkv, g, s_len, d = qg.shape
    dog = _heads(do, layout).reshape(qg.shape).float()
    og = _heads(out, layout).reshape(qg.shape).double()
    delta = (dog.double() * og).sum(-1)
    lse = lse.reshape(b, hkv, g, s_len)
    p = torch.exp(_scores(qg, kh, scale, causal, window, bias, q.dtype)
                  - lse[..., None])
    dp = torch.einsum("bngqd,bnkd->bngqk", dog.double(), vh.double())
    dlogit = p * (dp - delta[..., None]).float()
    ds = dlogit * scale
    nokey = s_len - kh.shape[-2] if causal else 0
    if nokey > 0:
        ds = torch.cat((torch.zeros_like(ds[..., :nokey, :]),
                        ds[..., nokey:, :]), -2)
    dq = torch.einsum("bngqk,bnkd->bngqd", ds.to(k.dtype).float(), kh.float())
    dv = torch.einsum("bngqk,bngqd->bnkd", p, dog)
    dk = torch.einsum("bngqk,bngqd->bnkd", ds.to(q.dtype).float(), qg.float())
    dq = dq.to(q.dtype).reshape(b, hkv * g, s_len, d)
    grads = (_from_heads(dq, layout, q.shape),
             _from_heads(dk.to(k.dtype), layout, k.shape),
             _from_heads(dv.to(v.dtype), layout, v.shape))
    if dbias_shape is None:
        return grads
    dl = dlogit.reshape(b, hkv * g, s_len, kh.shape[-2])
    return grads + (dl.sum_to_size(dbias_shape).contiguous(),)


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
    """What the kernels ask beyond :func:`attention`'s shape checks,
    which their callers have made: one float dtype, one device, k and v
    of one shape, one head dim that their tiles take, and a ``bias`` that
    is None or an fp32 view of the heads' [B, H, Sq, Sk] scores (an
    ``expand`` of :func:`_bias_of`'s) on q's device (read through its strides: a
    broadcast dimension keeps stride 0 and nothing is copied along it)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernels take fp32, bf16 or fp16 q/k/v of "
                         f"one dtype, not {q.dtype}/{k.dtype}/{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash kernels: q, k and v must share a device")
    if k.shape != v.shape or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"flash kernels take k and v of one shape and "
                         f"q's head dim, not q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    reason = _head_dim_reason(q.shape[-1])
    if reason is not None:
        raise ValueError(f"flash kernels cannot take {reason}")
    scores = _heads_shape(q, layout, k)
    if bias is not None and (
            bias.dtype != torch.float32 or bias.device != q.device
            or tuple(bias.shape) != scores):
        raise ValueError(f"flash kernels take an fp32 bias of the scores' "
                         f"shape {scores} on q's device "
                         f"(_bias_of), not {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")


def _launch(name, tensors, strided, dims, scale, causal, window, dtype,
            bias=None, dbias=None):
    """Launch ``name`` over raw ``tensors`` (pointers in argument order),
    with the strides of the ``strided`` [B, S, H, D] views, the score
    ``bias`` (None, or an fp32 [B, H, Sq, Sk] view) with its strides and,
    for the dQ kernel, ``dbias`` (None, or the zeroed fp32 gradient
    of the bias as a [B, H, Sq, Sk] view, stride 0 where it sums).
    ``dims``: (B, H, Hkv, Sq, Sk, D).  A dQ launch that writes dbias
    counts as ``flash_bwd_dq_dbias``."""
    strides = [st for t in strided for st in t.stride()[:3]]
    arr = (ctypes.c_longlong * len(strides))(*strides)
    barr = (ctypes.c_longlong * 4)(*(bias.stride() if bias is not None
                                     else (0, 0, 0, 0)))
    extra = ()
    if name == "flash_bwd_dq":
        darr = (ctypes.c_longlong * 4)(*(dbias.stride() if dbias is not None
                                         else (0, 0, 0, 0)))
        extra = (None if dbias is None else dbias.data_ptr(),
                 ctypes.addressof(darr))
    dev = tensors[0].device
    code = _build.kernel(name)(
        *[t.data_ptr() for t in tensors], ctypes.addressof(arr),
        None if bias is None else bias.data_ptr(), ctypes.addressof(barr),
        *dims, float(scale), int(causal), int(window or 0), _DTYPES[dtype],
        *extra,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(name, code)
    _build.LAUNCHES[name + ("_dbias" if dbias is not None else "")] += 1


def _dims(qc, kc):
    """(B, H, Hkv, Sq, Sk, D) of the [B, S, H, D] views of q and k."""
    b, sq, h, d = qc.shape
    return b, h, kc.shape[2], sq, kc.shape[1], d


def flash_fwd_cuda(q, k, v, causal, scale, window, layout, bias=None):
    """The forward kernel: ``out`` (q's shape and dtype), ``lse`` (B*H,
    Sq) fp32.  CUDA tensors only."""
    _check(q, k, v, bias, layout)
    qc, kc, vc = (_operand(t, layout) for t in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    oc = _canon(out, layout)
    dims = _dims(qc, kc)
    lse = torch.empty((dims[0] * dims[1], dims[3]), dtype=torch.float32,
                      device=q.device)
    _launch("flash_fwd", (qc, kc, vc, oc, lse), (qc, kc, vc, oc), dims,
            scale, causal, window, q.dtype, bias)
    return out, lse


def flash_delta(out, do, layout="bnsd"):
    """``delta = rowsum(dO * O)``, row ``b * H + h``: the backward's
    per-row input, summed by PyTorch as the reference sums it outside
    Pallas.  For bf16 and fp16 ``out`` (B*H, S) fp32.  For fp32 ``out`` it is
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
    contiguous lse and delta, and the dims (B, H, Hkv, Sq, Sk, D).  delta
    must have :func:`flash_delta`'s layout for q's dtype: the kernels read
    it through a raw pointer."""
    _check(q, k, v, bias, layout)
    qc, kc, vc, dc = (_operand(t, layout) for t in (q, k, v, do.to(q.dtype)))
    dims = _dims(qc, kc)
    b, h, _, s, _, _ = dims
    want = (b * h, s, 2) if q.dtype == torch.float32 else (b * h, s)
    if delta.dtype != torch.float32 or tuple(delta.shape) != want:
        raise ValueError(f"flash backward: delta must be fp32 {want} "
                         f"(flash_delta), not {delta.dtype} "
                         f"{tuple(delta.shape)}")
    return (qc, kc, vc, dc), lse.contiguous(), delta.contiguous(), dims


def flash_bwd_dq_cuda(q, k, v, out, lse, delta, do, causal, scale, window,
                      layout, bias=None, dbias=None):
    """The dQ kernel: ``dq`` in q's shape and dtype.  CUDA tensors only.
    The kernel reads ``delta``; ``out`` is handed over because the C entry
    point takes it, and no body reads it.  ``dbias``: None, or a zeroed
    fp32 tensor of a shape that broadcasts to the heads' [B, H, Sq, Sk]
    scores, into which the kernel adds the bias's gradient (it needs
    ``bias``)."""
    (qc, kc, vc, dc), lse, delta, dims = _bwd_operands(q, k, v, lse, delta,
                                                       do, layout, bias)
    oc = _operand(out.to(q.dtype), layout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dqc = _canon(dq, layout)
    if dbias is not None:
        if (bias is None or dbias.dtype != torch.float32
                or dbias.device != q.device):
            raise ValueError("flash backward: dbias needs a bias, and is "
                             "fp32 on q's device")
        dbias = dbias.expand(_heads_shape(q, layout, k))
    _launch("flash_bwd_dq", (qc, kc, vc, oc, dc, lse, delta, dqc),
            (qc, kc, vc, oc, dc, dqc), dims, scale, causal, window, q.dtype,
            bias, dbias)
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
              layout="bnsd", bias=None, dbias_shape=None):
    """``(dq, dk, dv)``: the plain version for CPU tensors, the kernels
    for CUDA tensors; with ``dbias_shape`` also the bias's gradient, fp32,
    summed to that shape (which broadcasts to the heads' scores)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _device_of(q) == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, do, causal, scale, window,
                               layout, bias, dbias_shape)
    delta = flash_delta(out, do, layout)
    opts = (causal, scale, window, layout, bias)
    dbias = (None if dbias_shape is None else
             torch.zeros(dbias_shape, dtype=torch.float32, device=q.device))
    grads = (flash_bwd_dq_cuda(q, k, v, out, lse, delta, do, *opts, dbias),
             *flash_bwd_dkv_cuda(q, k, v, lse, delta, do, *opts))
    return grads if dbias is None else grads + (dbias,)


class _Flash(torch.autograd.Function):
    """Forward kernel; backward from the saved ``(q, k, v, out, lse)`` and
    the score bias.  ``bias`` is any fp32 tensor that broadcasts to the
    heads' [B, H, Sq, Sk] scores (the kernels read its expand view); when
    it needs a gradient, the dQ kernel sums one at its own shape."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, layout, bias):
        view = None if bias is None else bias.expand(
            _heads_shape(q, layout, k))
        out, lse = flash_fwd(q, k, v, causal, scale, window, layout, view)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.opts = (causal, scale, window, layout)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, bias = ctx.saved_tensors
        layout = ctx.opts[3]
        view = None if bias is None else bias.expand(
            _heads_shape(q, layout, k))
        want = bias is not None and ctx.needs_input_grad[7]
        grads = flash_bwd(q, k, v, out, lse, do, *ctx.opts, view,
                          bias.shape if want else None)
        dbias = grads[3] if want else None
        return (*grads[:3], None, None, None, None, dbias)


def _padded_head_dim(d):
    """The head dim the tiles take: a multiple of 8, at least 16."""
    return max(16, -(-d // 8) * 8)


def attention(q, k, v, causal=False, scale=None, layout="bnsd", window=None,
              bias=None):
    """Flash attention at any lengths of q and k, with an optional score
    ``bias`` (:func:`_bias_of`, or any fp32 tensor that broadcasts to the
    heads' [B, H, Sq, Sk]; if it requires grad it gets one): what ``sdpa``
    runs on the card, where the kernels take every length (ragged last
    tiles are masked).  The rows that see no key (causal, Sq > Sk) add
    the bias to their fill.  Head dims the tiles do not take, and a v head dim other than
    q's, are zero-padded (a copy of q, k and v) with the scale of q's real
    head dim, and the output sliced back; above 256 the kernels raise
    (the plain versions take any).  The reference's layout checks raise
    ValueError; neither the one-length rule nor the block gate of
    :func:`flash_attention` is applied."""
    d, dv = q.shape[-1], v.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if window is not None and not causal:
        raise ValueError("flash_attention: window requires causal=True")
    reason = _layout_reason(q, k, layout, bnsd_gqa=True)
    if reason is not None:
        raise ValueError(f"flash_attention: {reason}")
    dp = _padded_head_dim(max(d, dv))
    if (dp != d or dp != dv) and dp <= _MAX_HEAD_DIM:
        q, k, v = (F.pad(t, (0, dp - t.shape[-1])) for t in (q, k, v))
    win = None if window is None else int(window)
    out = _Flash.apply(q, k, v, bool(causal), float(scale), win, layout,
                       bias)
    return out if dp == dv else out[..., :dv]


def _as_4d(x):
    """A bnsd tensor of any rank as a 4-D [N, H, S, D] view (2-D [S, D]
    as [1, 1, S, D], 3-D [H, S, D] as [1, H, S, D]; leading dims beyond
    two flattened, a copy where their strides do not merge)."""
    if x.ndim == 2:
        return x[None, None]
    if x.ndim == 3:
        return x[None]
    return x.reshape(-1, *x.shape[-3:])


def attend(q, k, v, mask=None, scale=None, is_causal=False, layout="bnsd",
           window=None):
    """The card's ``sdpa`` on the reference's inputs (:func:`kernel_reason`
    None): bnsd q, k and v of any rank (2-D q, broadcast leading dims,
    GQA with k and v of fewer heads on dim -3) as 4-D views, a ``mask``
    in the reference's terms (it broadcasts to ``_sdpa_reference``'s
    scores, [..., Hkv, G, Sq, Sk] under GQA) as the heads' score bias,
    then :func:`attention`; the output in the reference's shape."""
    shape, grouped = _ref_shapes(q, k, v, layout)
    if layout == "bnsd":
        if grouped:
            k, v = (t.reshape((1,) * (3 - t.ndim) + tuple(t.shape))
                    for t in (k, v))
            lead = shape[:-4]
            q = q.expand(*lead, *q.shape[-3:])
            k, v = (t.expand(*lead, *t.shape[-3:]) for t in (k, v))
        else:
            lead = shape[:-2]
            q, k, v = (t.expand(*lead, *t.shape[-2:]) for t in (q, k, v))
        out_shape = q.shape[:-1] + (v.shape[-1],)
        q, k, v = (_as_4d(t) for t in (q, k, v))
    bias = None
    if mask is not None:
        m = mask.reshape((1,) * (len(shape) - mask.ndim) + tuple(mask.shape))
        if grouped:                      # (Hkv, G) -> the query heads
            hkv, g = shape[-4], shape[-3]
            if m.shape[-4] == m.shape[-3] == 1:
                m = m.reshape(*m.shape[:-4], 1, *m.shape[-2:])
            else:
                m = m.expand(*m.shape[:-4], hkv, g, *m.shape[-2:]).reshape(
                    *m.shape[:-4], hkv * g, *m.shape[-2:])
        if m.ndim > 4:
            lead = shape[:m.ndim - 3]
            m = m.expand(*lead, *m.shape[-3:]).reshape(-1, *m.shape[-3:])
        bias = _bias_of(m, q, layout, k, is_causal)
    out = attention(q, k, v, is_causal, scale, layout, window, bias)
    return out.reshape(out_shape) if layout == "bnsd" else out


def flash_attention(q, k, v, causal=False, scale=None, block_q=None,
                    block_k=None, layout="bnsd", window=None):
    """Flash attention over ``layout`` (see the module docstring), with the
    reference's arguments and ValueErrors.  ``window`` (causal only) masks
    keys more than ``window - 1`` positions behind each query.
    ``block_q``/``block_k`` are checked as the reference checks them (a
    length with no block raises); the CUDA kernels pick their own tiles.
    q and k of other lengths raise, as the reference's do."""
    if window is not None and not causal:
        raise ValueError("flash_attention: window requires causal=True")
    reason = _shape_reason(q, k, layout)
    if reason is not None:
        raise ValueError(f"flash_attention: {reason}")
    s_axis = _layout_s_axis(layout, q.ndim)
    s_len = q.shape[s_axis]
    if (block_q or _pick_block(s_len)) is None or \
            (block_k or _pick_block(s_len)) is None:
        raise ValueError(
            f"flash_attention: unsupported seq len {s_len} (needs a power-of-"
            f"two-ish divisor >= 8)")
    return attention(q, k, v, causal, scale, layout, window)

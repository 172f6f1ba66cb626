"""Scaled-dot-product attention: the dense plain version and the
dispatcher that sends CUDA tensors to the flash kernels.

Counterpart of ``paddle_tpu/kernels/attention.py`` (``_sdpa_reference``,
``sdpa``).  :func:`sdpa_plain` is the reference's jnp attention, decision
for decision; the CPU training path runs it.  On the card :func:`sdpa`
launches the flash kernels whenever :func:`~.flash.supported` holds, at
every length (the reference's ``seq >= 512`` gate is a TPU tuning choice),
and raises otherwise: it never runs the plain version there.
"""

from __future__ import annotations

import math

import torch

from . import flash


def sdpa_plain(q, k, v, mask=None, scale=None, is_causal=False, window=None):
    """q, k, v: [..., seq, head_dim].  GQA: k/v may carry fewer heads on
    dim -3 than q (a divisor); query heads group over their K/V head by a
    reshape, never by repeating K/V.  Scores are scaled in q's dtype,
    masked to -1e9 (causal band, ``window``, a boolean ``mask``; a float
    ``mask`` adds), softmaxed in fp32 and cast back to q's dtype before
    the product with V."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    nh = q.shape[-3] if q.ndim >= 3 else 1
    nkv = k.shape[-3] if k.ndim >= 3 else 1
    grouped = q.ndim >= 3 and nh != nkv
    sc = torch.tensor(s, dtype=q.dtype, device=q.device)
    if grouped:
        g = nh // nkv
        qg = q.reshape(q.shape[:-3] + (nkv, g, q.shape[-2], d))
        logits = torch.einsum("...gqd,...kd->...gqk", qg, k) * sc
    else:
        logits = torch.einsum("...qd,...kd->...qk", q, k) * sc
    neg = torch.tensor(-1e9, dtype=logits.dtype, device=q.device)
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        qpos = torch.arange(kl - ql, kl, device=q.device)[:, None]
        kpos = torch.arange(kl, device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (kpos > qpos - window)
        logits = torch.where(keep, logits, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, neg)
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if grouped:
        out = torch.einsum("...gqk,...kd->...gqd", probs, v)
        return out.reshape(q.shape[:-1] + (v.shape[-1],))
    return torch.einsum("...qk,...kd->...qd", probs, v)


def sdpa(q, k, v, mask=None, scale=None, is_causal=False, dropout_p=0.0,
         layout="bnsd", window=None):
    """Attention over ``layout`` ("bnsd" [..., S, D], "bsnd" [B, S, H, D]
    or "sbnd" [S, B, H, D]; GQA in the seq-major layouts).

    CPU tensors run :func:`sdpa_plain` (the seq-major layouts transposed
    in and out, as the reference's CPU path does).  CUDA tensors launch the
    flash kernels, which read the layout in place, or raise
    NotImplementedError naming what the kernels cannot take.  Dropout is
    not ported (the reference routes it to its jnp path with a JAX key)."""
    if dropout_p != 0.0:
        raise NotImplementedError(
            f"sdpa: attention dropout (dropout_p={dropout_p}) is not ported")
    if q.device.type == "cuda":
        reason = flash.unsupported_reason(q, k, mask=mask, layout=layout)
        if reason is not None:
            raise NotImplementedError(
                f"sdpa: the flash kernels cannot take {reason}")
        return flash.flash_attention(q, k, v, causal=is_causal, scale=scale,
                                     layout=layout, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"sdpa runs on cpu or cuda, not {q.device}")
    if layout in ("bsnd", "sbnd"):
        if q.ndim != 4:
            raise ValueError(
                f"layout={layout!r} expects 4-D q/k/v, got {tuple(q.shape)}")
        perm = (1, 2, 0, 3) if layout == "sbnd" else (0, 2, 1, 3)
        back = (2, 0, 1, 3) if layout == "sbnd" else (0, 2, 1, 3)
        out = sdpa_plain(q.permute(perm), k.permute(perm), v.permute(perm),
                         mask=mask, scale=scale, is_causal=is_causal,
                         window=window)
        return out.permute(back)
    return sdpa_plain(q, k, v, mask=mask, scale=scale, is_causal=is_causal,
                      window=window)

"""Scaled-dot-product attention: the dense plain version, the
reference's attention with dropout, and the dispatcher that sends CUDA
tensors to the flash kernels.

Counterpart of ``paddle_tpu/kernels/attention.py`` (``_sdpa_reference``,
``sdpa``).  :func:`sdpa_plain` is the reference's jnp attention, decision
for decision; the CPU training path runs it.  On the card :func:`sdpa`
launches the flash kernels whenever :func:`~.flash.kernel_reason` finds
nothing they cannot take: at every sequence length (the reference's
``seq >= 512`` and block-divisor gates are TPU tuning choices; the
kernels mask a ragged last tile) and with an attention mask, which they
take as an additive fp32 score bias (:func:`~.flash.mask_bias`: a float
mask as it is, a boolean one as 0 / -1e9, as ``_sdpa_reference`` masks).
It raises otherwise (q and k of other lengths, a head dim outside the
kernels' tiles, a mask that requires grad): it never runs the plain
version there.

Attention dropout (``dropout_p > 0``) takes :func:`sdpa_dropout` on either
device, as the reference routes it: "dropout always takes the reference
path" — its flash gate refuses dropout, so its Pallas kernels never see
it, and its ``_sdpa_reference`` draws the mask on the probabilities.
:func:`sdpa_dropout` is the port of that non-kernel path, not the flash
kernels' plain version and not a fallback: the card runs it as plain
PyTorch operations and launches no flash kernel for it.  At
``dropout_p == 0`` the card launches the flash kernels as before.
"""

from __future__ import annotations

import math

import torch

from ..framework import random as _random
from . import flash


def _attend(q, k, v, mask, scale, is_causal, window, dropout_p=0.0,
            key=None):
    """The reference's ``_sdpa_reference``: scores in q's dtype, masks,
    an fp32 softmax cast back to q's dtype, dropout on those
    probabilities when ``dropout_p > 0`` and a ``key`` is given, then the
    product with V."""
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
    if dropout_p > 0.0 and key is not None:
        keep = (_random.draw(key, probs.shape, q.device)
                < torch.tensor(1.0 - dropout_p, dtype=torch.float32))
        # a division by a tensor of probs' dtype, as jnp divides by the
        # weakly typed 1 - p (PyTorch divides by a Python number through
        # its reciprocal on the card)
        kept = probs / torch.tensor(1.0 - dropout_p, dtype=q.dtype,
                                    device=q.device)
        probs = torch.where(keep, kept, torch.zeros_like(probs))
    if grouped:
        out = torch.einsum("...gqk,...kd->...gqd", probs, v)
        return out.reshape(q.shape[:-1] + (v.shape[-1],))
    return torch.einsum("...qk,...kd->...qd", probs, v)


def sdpa_plain(q, k, v, mask=None, scale=None, is_causal=False, window=None):
    """The flash kernels' plain version.  q, k, v: [..., seq, head_dim].
    GQA: k/v may carry fewer heads on dim -3 than q (a divisor); query
    heads group over their K/V head by a reshape, never by repeating K/V.
    Scores are scaled in q's dtype, masked to -1e9 (causal band,
    ``window``, a boolean ``mask``; a float ``mask`` adds), softmaxed in
    fp32 and cast back to q's dtype before the product with V."""
    return _attend(q, k, v, mask, scale, is_causal, window)


def _seq_major(layout, q, k, v, fn):
    """``fn`` over bnsd views of seq-major q, k, v, its output transposed
    back; bnsd passes straight through."""
    if layout not in ("bsnd", "sbnd"):
        return fn(q, k, v)
    if q.ndim != 4:
        raise ValueError(
            f"layout={layout!r} expects 4-D q/k/v, got {tuple(q.shape)}")
    perm = (1, 2, 0, 3) if layout == "sbnd" else (0, 2, 1, 3)
    back = (2, 0, 1, 3) if layout == "sbnd" else (0, 2, 1, 3)
    return fn(q.permute(perm), k.permute(perm), v.permute(perm)).permute(back)


def sdpa_dropout(q, k, v, dropout_p, key, mask=None, scale=None,
                 is_causal=False, layout="bnsd", window=None):
    """The port of ``_sdpa_reference``'s dropout branch
    (``paddle_tpu/kernels/attention.py:62-65``), the reference's own
    non-kernel path for attention with dropout: the attention of
    :func:`sdpa_plain`, then keep = ``uniform(float32) < float32(1 -
    dropout_p)`` over the probabilities (in q's dtype), kept ones divided
    by ``1 - dropout_p``, dropped ones 0, then the product with V.  The
    uniforms come from :func:`paddle_tpu_torch.framework.random.uniform`
    of ``key`` (no key: no dropout, as the reference without an rng).
    Runs as plain PyTorch operations on either device: it is neither the
    flash kernels' plain version nor a fallback from them."""
    return _seq_major(layout, q, k, v, lambda q, k, v: _attend(
        q, k, v, mask, scale, is_causal, window, dropout_p, key))


def sdpa(q, k, v, mask=None, scale=None, is_causal=False, dropout_p=0.0,
         layout="bnsd", window=None, key=None):
    """Attention over ``layout`` ("bnsd" [..., S, D], "bsnd" [B, S, H, D]
    or "sbnd" [S, B, H, D]; GQA in the seq-major layouts).

    ``dropout_p > 0`` takes :func:`sdpa_dropout` with the mask of ``key``
    on either device, as the reference routes dropout to its jnp path.
    Otherwise CPU tensors run :func:`sdpa_plain` (the seq-major layouts
    transposed in and out, as the reference's CPU path does), and CUDA
    tensors launch the flash kernels, which read the layout in place and
    take ``mask`` as a score bias, or raise NotImplementedError naming
    what the kernels cannot take."""
    if dropout_p > 0.0:
        return sdpa_dropout(q, k, v, dropout_p, key, mask=mask, scale=scale,
                            is_causal=is_causal, layout=layout,
                            window=window)
    if q.device.type == "cuda":
        reason = flash.kernel_reason(q, k, mask=mask, layout=layout)
        if reason is not None:
            raise NotImplementedError(
                f"sdpa: the flash kernels cannot take {reason}")
        return flash.attention(q, k, v, causal=is_causal, scale=scale,
                               layout=layout, window=window,
                               bias=flash.mask_bias(mask, q, layout))
    if q.device.type != "cpu":
        raise ValueError(f"sdpa runs on cpu or cuda, not {q.device}")
    return _seq_major(layout, q, k, v, lambda q, k, v: sdpa_plain(
        q, k, v, mask=mask, scale=scale, is_causal=is_causal, window=window))

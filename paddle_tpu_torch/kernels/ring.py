"""Ring attention: attention over a sequence split across the ranks of a
mesh axis, K/V blocks passed around the ring.

Counterpart of ``paddle_tpu/kernels/ring.py`` (``ring_attention`` :86,
``ring_flash_attention`` :195).  Each rank keeps its query shard and sees
every rank's K/V block in turn: at ring step ``t`` rank ``i`` holds the
block of rank ``(i - t) % n``, then passes it on (``batch_isend_irecv``
to ``i + 1``, from ``i - 1``, over the axis's process group).  Causal
masking uses global positions.  Two block engines, as in the reference:

* the einsum engine (:func:`ring_attention`): the online-softmax
  accumulator of the reference's ``_ring_block`` (running max, normaliser,
  unnormalised output in fp32), with GQA (query heads grouped over their
  K/V head by a reshape) and a sliding ``window``; every block runs, a
  masked one contributing nothing;
* the flash engine (:func:`ring_flash_attention`): the port's flash
  kernels (:func:`~paddle_tpu_torch.kernels.flash.flash_fwd` /
  :func:`~.flash.flash_bwd`; their plain versions on the CPU) on each
  block: the diagonal block with the causal mask, the blocks before it
  whole, and (causal) the blocks after it not launched at all, where the
  reference computes them and sets their lse to -inf (the merge weights
  them 0, so the function is the same).  Block outputs merge by their
  log-sum-exp into the exact softmax.

Both have an explicit backward from the saved global output ``O`` and
global log-sum-exp ``L``: each block replays ``p = exp(s - L)``, ``ds = p
(dO.V^T - rowsum(dO O))`` (the flash engine through the flash backward
kernels, fed the global ``L`` and ``O``); dQ accumulates on its rank, and
each block's dK / dV accumulators travel the ring with it and arrive home
after the full cycle.

The public functions take the global q, k, v (the same on every rank of
the axis, like the reference's global arrays), check ``S % ring``
(ValueError), run this rank's shard and return the global output,
all-gathered; their gradients are the global ones on every rank.  The
per-rank work is :func:`_rank_forward` / :func:`_rank_backward`, fed a
sequence of visiting blocks: by the ring (:func:`_p2p_visits`), or from a
list of shards in one process (:func:`_local_ring_forward` /
:func:`_local_ring_backward`), the same operations in the same order.

Routing mirrors the reference's: a ring of one rank (no mesh, or the axis
of size 1) is :func:`~.attention.sdpa`; GQA or a window take the einsum
engine; so does a shard length or head dim the flash kernels refuse
(``_pick_block`` finds no block, head dim not a multiple of 8 in
16..256).  ``use_flash=None`` takes the flash engine for CUDA tensors (the
reference: on the TPU) and the einsum engine on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..distributed import mesh as mesh_mod
from ..distributed.collective import _c_concat, _c_split
from . import flash as _fl
from .attention import sdpa

NEG_INF = -1e30


def _bnsd(x, layout):
    """A shard as (B, H, S, D): sbnd (S, B, H, D) permuted, bnsd as is."""
    return x.permute(1, 2, 0, 3) if layout == "sbnd" else x


def _from_bnsd(x, layout):
    return x.permute(2, 0, 1, 3).contiguous() if layout == "sbnd" else x


def _scores(q, k, q_off, kv_off, scale, causal, window):
    """fp32 scores (B, H, Sq, Sk) of a block, masked to NEG_INF by global
    positions; GQA groups the query heads over their K/V head."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if h != hkv:
        qg = q.float().reshape(b, hkv, h // hkv, sq, d)
        s = torch.einsum("bngqd,bnkd->bngqk", qg, k.float()) * scale
        s = s.reshape(b, h, sq, sk)
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_off + torch.arange(sq, device=q.device)
        kv_pos = kv_off + torch.arange(sk, device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
    return s


def _pv(p, v):
    """p (B, H, Sq, Sk) fp32 times v (B, Hkv, Sk, D), grouped under GQA."""
    b, h, sq, sk = p.shape
    hkv = v.shape[1]
    if h != hkv:
        pg = p.reshape(b, hkv, h // hkv, sq, sk)
        return torch.einsum("bngqk,bnkd->bngqd", pg,
                            v.float()).reshape(b, h, sq, v.shape[-1])
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


def _ring_block(q, k, v, o, m, l, q_off, kv_off, scale, causal, window):
    """One visiting block folded into the online-softmax accumulator (the
    reference's ``_ring_block``)."""
    s = _scores(q, k, q_off, kv_off, scale, causal, window)
    m_new = torch.maximum(m, s.amax(-1))
    # fully masked rows (m_new == NEG_INF) keep zero weight
    m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
    l_new = alpha * l + p.sum(-1)
    o_new = o * alpha[..., None] + _pv(p, v)
    return o_new, m_new, l_new


def _merge(o_acc, L, o_r, lse_r):
    """LSE-weighted merge of a normalised block output into the
    accumulator (the reference's ``_merge``); o (B, H, S, D) fp32, lse /
    L (B, H, S) fp32."""
    m = torch.maximum(L, lse_r)
    m_safe = torch.where(torch.isinf(m) & (m < 0), 0.0, m)
    w_old = torch.where(L <= NEG_INF / 2, 0.0, torch.exp(L - m_safe))
    w_new = torch.where(lse_r <= NEG_INF / 2, 0.0, torch.exp(lse_r - m_safe))
    denom = torch.clamp_min(w_old + w_new, 1e-30)
    o_new = (o_acc * (w_old / denom)[..., None]
             + o_r.float() * (w_new / denom)[..., None])
    return o_new, m_safe + torch.log(denom)


def _block_kind(rank, j, causal):
    """How rank ``rank``'s queries see block ``j``: "diag" (its own, the
    causal mask applies), "full" (wholly visible) or None (wholly
    masked, causal, a later block)."""
    if j == rank:
        return "diag"
    if causal and j > rank:
        return None
    return "full"


def _rank_forward(q, visits, rank, ring, causal, scale, window, flash):
    """This rank's output and global log-sum-exp: ``q`` (B, H, Sl, D) its
    query shard; ``visits`` yields ``(k, v)`` blocks (B, Hkv, Sl, D), the
    t-th being rank ``(rank - t) % ring``'s.  Returns ``out`` (q's dtype)
    and ``lse`` (B, H, Sl) fp32."""
    b, h, sl, d = q.shape
    q_off = rank * sl
    if flash:
        o = torch.zeros(b, h, sl, d, dtype=torch.float32, device=q.device)
        L = torch.full((b, h, sl), NEG_INF, device=q.device)
        for t, (k, v) in enumerate(visits):
            kind = _block_kind(rank, (rank - t) % ring, causal)
            if kind is None:
                continue
            o_r, lse_r = _fl.flash_fwd(q, k, v, causal=causal and kind ==
                                       "diag", scale=scale)
            o, L = _merge(o, L, o_r, lse_r.reshape(b, h, sl))
        return o.to(q.dtype), L
    o = torch.zeros(b, h, sl, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sl), NEG_INF, device=q.device)
    l = torch.zeros(b, h, sl, device=q.device)
    for t, (k, v) in enumerate(visits):
        kv_off = ((rank - t) % ring) * sl
        o, m, l = _ring_block(q, k, v, o, m, l, q_off, kv_off, scale, causal,
                              window)
    l = torch.where(l == 0.0, 1.0, l)
    out = (o / l[..., None]).to(q.dtype)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    return out, m_safe + torch.log(l)


def _einsum_block_bwd(q, k, v, out, lse, do, q_off, kv_off, scale, causal,
                      window):
    """dq, dk, dv (fp32) of one block from the global ``out`` / ``lse``."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    p = torch.exp(_scores(q, k, q_off, kv_off, scale, causal, window)
                  - lse[..., None])
    dof = do.float()
    delta = (dof * out.float()).sum(-1)
    if h != hkv:
        g = h // hkv
        dog = dof.reshape(b, hkv, g, sq, d)
        dp = torch.einsum("bngqd,bnkd->bngqk", dog, v.float()).reshape(p.shape)
        ds = p * (dp - delta[..., None])
        dsg = ds.reshape(b, hkv, g, sq, -1)
        dq = torch.einsum("bngqk,bnkd->bngqd", dsg,
                          k.float()).reshape(q.shape) * scale
        qg = q.float().reshape(b, hkv, g, sq, d)
        dk = torch.einsum("bngqk,bngqd->bnkd", dsg, qg) * scale
        dv = torch.einsum("bngqk,bngqd->bnkd",
                          p.reshape(b, hkv, g, sq, -1), dog)
        return dq, dk, dv
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq, dk, dv


def _rank_backward(q, out, lse, do, visits, rank, ring, causal, scale,
                   window, flash):
    """This rank's dQ (q's dtype); ``visits`` yields ``(k, v, dk_acc,
    dv_acc)`` in :func:`_rank_forward`'s order, and each block's dK / dV
    contributions are added (fp32) into its accumulators in place."""
    b, h, sl, d = q.shape
    q_off = rank * sl
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_flat = lse.reshape(b * h, sl)
    for t, (k, v, dk_acc, dv_acc) in enumerate(visits):
        j = (rank - t) % ring
        if flash:
            kind = _block_kind(rank, j, causal)
            if kind is None:
                continue
            dq_r, dk_r, dv_r = _fl.flash_bwd(
                q, k, v, out, lse_flat, do,
                causal=causal and kind == "diag", scale=scale)
        else:
            dq_r, dk_r, dv_r = _einsum_block_bwd(q, k, v, out, lse, do, q_off,
                                                 j * sl, scale, causal,
                                                 window)
        dq += dq_r.float()
        dk_acc += dk_r.float()
        dv_acc += dv_r.float()
    return dq.to(q.dtype)


# -- drivers -------------------------------------------------------------------


def _rotate(tensors, group, ranks, i):
    """Each tensor to the next rank of the ring, the previous rank's in."""
    n = len(ranks)
    nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
    outs = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), nxt, group)
            for t in tensors]
           + [dist.P2POp(dist.irecv, o, prv, group) for o in outs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _p2p_visits(blocks, group, ranks, i, home=None):
    """The ring's visiting blocks at rank ``i``: yields ``blocks`` (k, v,
    and in the backward their dK / dV accumulators), then passes them on,
    ``len(ranks)`` times.  The accumulators take one more pass, home,
    into ``home``."""
    cur = list(blocks)
    n = len(ranks)
    for t in range(n):
        yield tuple(cur)
        if t < n - 1:
            cur = _rotate(cur, group, ranks, i)
    if home is not None:
        home.extend(_rotate(cur[2:], group, ranks, i))


def _local_order(r, ring):
    return [(r - t) % ring for t in range(ring)]


def _local_ring_forward(qs, ks, vs, causal=False, scale=None, window=None,
                        flash=True):
    """Every rank's :func:`_rank_forward` from lists of (B, H, Sl, D)
    shards held in one process: ``(outs, lses)``."""
    ring = len(qs)
    scale = scale if scale is not None else 1.0 / math.sqrt(qs[0].shape[-1])
    res = [_rank_forward(qs[r], [(ks[j], vs[j]) for j in _local_order(
        r, ring)], r, ring, causal, scale, window, flash)
           for r in range(ring)]
    return [o for o, _ in res], [lse for _, lse in res]


def _local_ring_backward(qs, ks, vs, outs, lses, dos, causal=False,
                         scale=None, window=None, flash=True):
    """Every rank's :func:`_rank_backward` from shards held in one
    process: ``(dqs, dks, dvs)``.  Each block's contributions are summed
    in the ring's order (the block's own rank first), so the result is
    the ring's bit for bit."""
    ring = len(qs)
    scale = scale if scale is not None else 1.0 / math.sqrt(qs[0].shape[-1])
    part = {}
    dqs = []
    for r in range(ring):
        visits = []
        for j in _local_order(r, ring):
            part[r, j] = (torch.zeros(ks[j].shape, dtype=torch.float32,
                                      device=ks[j].device),
                          torch.zeros(vs[j].shape, dtype=torch.float32,
                                      device=vs[j].device))
            visits.append((ks[j], vs[j], *part[r, j]))
        dqs.append(_rank_backward(qs[r], outs[r], lses[r], dos[r], visits, r,
                                  ring, causal, scale, window, flash))
    dks, dvs = [], []
    for j in range(ring):
        dk = torch.zeros(ks[j].shape, dtype=torch.float32, device=ks[j].device)
        dv = torch.zeros(vs[j].shape, dtype=torch.float32, device=vs[j].device)
        for t in range(ring):
            dk += part[(j + t) % ring, j][0]
            dv += part[(j + t) % ring, j][1]
        dks.append(dk.to(ks[j].dtype))
        dvs.append(dv.to(vs[j].dtype))
    return dqs, dks, dvs


class _Ring(torch.autograd.Function):
    """This rank's shards (B, H, Sl, D) through the P2P ring."""

    @staticmethod
    def forward(ctx, q, k, v, group, ranks, causal, scale, window, flash):
        i = ranks.index(dist.get_rank())
        ctx.opts = (group, ranks, i, causal, scale, window, flash)
        out, lse = _rank_forward(q, _p2p_visits((k, v), group, ranks, i), i,
                                 len(ranks), causal, scale, window, flash)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, ranks, i, causal, scale, window, flash = ctx.opts
        accs = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                for t in (k, v)]
        home = []
        dq = _rank_backward(q, out, lse, do.contiguous(),
                            _p2p_visits((k, v, *accs), group, ranks, i, home),
                            i, len(ranks), causal, scale, window, flash)
        dk, dv = home
        return (dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None,
                None, None)


def _ring_axis(axis):
    """(group, global ranks) of ``axis`` on the installed mesh, or None
    when there is no ring (no mesh, or the axis has one rank)."""
    mesh = mesh_mod.get_mesh()
    if mesh is None or mesh.shape.get(axis, 1) <= 1:
        return None
    return mesh.group(axis), mesh.group_ranks(axis)


def _run(q, k, v, axis, causal, scale, layout, window, flash):
    group, ranks = _ring_axis(axis)
    ring = len(ranks)
    s_dim = 0 if layout == "sbnd" else 2
    s = q.shape[s_dim]
    if s % ring:
        raise ValueError(f"seq len {s} must divide the ring size {ring}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ql, kl, vl = (_bnsd(_c_split(t, group, s_dim), layout).contiguous()
                  for t in (q, k, v))
    out = _Ring.apply(ql, kl, vl, group, ranks, bool(causal), float(scale),
                      window, flash)
    return _c_concat(_from_bnsd(out, layout), group, s_dim)


def ring_attention(q, k, v, axis: str = "mp", causal: bool = False,
                   scale: Optional[float] = None,
                   use_flash: Optional[bool] = None, layout: str = "bnsd",
                   window: Optional[int] = None):
    """Attention of global ``q``, ``k``, ``v`` (B, H, S, D), or (S, B, H, D)
    with ``layout="sbnd"``, with the sequence split over the installed
    mesh's ``axis``; returns the global output.  ``use_flash`` picks the
    block engine (see the module docstring)."""
    if _ring_axis(axis) is None:
        return sdpa(q, k, v, scale=scale, is_causal=causal, layout=layout,
                    window=window)
    h_axis = 2 if layout == "sbnd" else 1
    if q.shape[h_axis] != k.shape[h_axis] or window is not None:
        use_flash = False
    if use_flash is None:
        use_flash = q.is_cuda and _fl.supported(q, k, layout=layout)
    if use_flash:
        return ring_flash_attention(q, k, v, axis=axis, causal=causal,
                                    scale=scale, layout=layout)
    return _run(q, k, v, axis, causal, scale, layout, window, False)


def ring_flash_attention(q, k, v, axis: str = "mp", causal: bool = False,
                         scale: Optional[float] = None,
                         layout: str = "bnsd",
                         window: Optional[int] = None):
    """:func:`ring_attention` with the flash engine: the flash kernels on
    each visiting block (their plain versions for CPU tensors).  GQA, a
    window, or a shard the kernels refuse take the einsum engine, as in
    the reference."""
    axis_ring = _ring_axis(axis)
    if axis_ring is None:
        return sdpa(q, k, v, scale=scale, is_causal=causal, layout=layout,
                    window=window)
    h_axis = 2 if layout == "sbnd" else 1
    if q.shape[h_axis] != k.shape[h_axis] or window is not None:
        return ring_attention(q, k, v, axis=axis, causal=causal, scale=scale,
                              use_flash=False, layout=layout, window=window)
    s = q.shape[0 if layout == "sbnd" else 2]
    ring = len(axis_ring[1])
    if s % ring:
        raise ValueError(f"seq len {s} must divide the ring size {ring}")
    d = q.shape[-1]
    if (_fl._pick_block(s // ring) is None or d % 8 != 0
            or not (16 <= d <= 256)):
        return ring_attention(q, k, v, axis=axis, causal=causal, scale=scale,
                              use_flash=False, layout=layout)
    return _run(q, k, v, axis, causal, scale, layout, None, True)

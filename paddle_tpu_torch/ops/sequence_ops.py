"""The sequence ops over the padded batch and its lengths.

Counterpart of ``paddle_tpu/ops/sequence_ops.py``, op for op.  A sequence
batch is a padded dense tensor ``[B, T, ...]`` in slot ``X`` plus a
length per row in slot ``Length`` ([B]; absent means every row is full).
Positions at or past a row's length neither feed a valid output nor
receive a value, except where a pad value is asked for.  Lengths (and
offsets, ids) take no gradient; the values take autograd's over the
kernel.  Every shape is static (``sequence_mask`` needs its ``maxlen``),
so graph mode infers the outputs on ``meta`` tensors.  Output lengths
are int32, as the reference's.
"""

from __future__ import annotations

import torch

from ..framework.dtype import to_torch_dtype
from .registry import register_op


def _lengths(ins, x):
    ln = ins.get("Length")
    if ln is None or (isinstance(ln, list) and not ln):
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                          device=x.device)
    if isinstance(ln, list):
        ln = ln[0]
    return ln.to(torch.int32).reshape(-1)


def _time_mask(x, lengths):
    """[B, T, 1...] validity mask broadcastable onto x [B, T, ...]."""
    t = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    m = t[None, :] < lengths[:, None]
    return m.reshape(tuple(m.shape) + (1,) * (x.ndim - 2))


def _trail(idx, x):
    """An index [B, T'] broadcast over x's trailing dims."""
    return idx.reshape(tuple(idx.shape) + (1,) * (x.ndim - 2)).expand(
        tuple(idx.shape) + tuple(x.shape[2:]))


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register_op("sequence_pad", nondiff_slots=("Length",))
def sequence_pad_kernel(ins, attrs):
    """``pad_value`` past each row's length, the time axis cut or padded
    to ``maxlen`` where it is given."""
    x = ins["X"]
    ln = _lengths(ins, x)
    maxlen = int(attrs.get("maxlen") or 0)
    if maxlen > 0:
        if maxlen < x.shape[1]:
            x = x[:, :maxlen]
        elif maxlen > x.shape[1]:
            x = torch.cat([x, x.new_zeros((x.shape[0], maxlen - x.shape[1])
                                          + tuple(x.shape[2:]))], dim=1)
        ln = torch.clamp(ln, max=maxlen)
    pad = torch.tensor(attrs.get("pad_value", 0.0), dtype=x.dtype,
                       device=x.device)
    return {"Out": torch.where(_time_mask(x, ln), x, pad), "Length": ln}


@register_op("sequence_unpad", nondiff_slots=("Length",))
def sequence_unpad_kernel(ins, attrs):
    """The pad region zeroed (the dense stand-in for a ragged result)."""
    x = ins["X"]
    return {"Out": torch.where(_time_mask(x, _lengths(ins, x)), x,
                               _zero(x))}


@register_op("sequence_mask", nondiff_slots=("X",), no_grad=True)
def sequence_mask_kernel(ins, attrs):
    ln = ins["X"].to(torch.int32).reshape(-1)
    maxlen = int(attrs.get("maxlen") or 0)
    if maxlen <= 0:
        raise ValueError(
            "sequence_mask needs a static maxlen (max(length) would make "
            "the output's shape depend on the data)")
    t = torch.arange(maxlen, dtype=torch.int32, device=ln.device)
    return {"Y": (t[None, :] < ln[:, None]).to(
        to_torch_dtype(attrs.get("out_dtype", "int64")))}


@register_op("sequence_softmax", nondiff_slots=("Length",))
def sequence_softmax_kernel(ins, attrs):
    """Softmax over each row's valid steps; 0 on the pad."""
    x = ins["X"]
    m = _time_mask(x, _lengths(ins, x))
    z = torch.where(m, x, torch.tensor(-1e9, dtype=x.dtype,
                                       device=x.device))
    z = z - torch.amax(z, dim=1, keepdim=True).detach()
    e = torch.exp(z) * m.to(x.dtype)
    s = torch.sum(e, dim=1, keepdim=True)
    return {"Out": e / torch.clamp_min(s, 1e-30)}


@register_op("sequence_pool", nondiff_slots=("Length",))
def sequence_pool_kernel(ins, attrs):
    """SUM, AVERAGE, SQRT (sum over sqrt(length)), MAX, FIRST or LAST
    over each row's valid steps (a length of 0 divides by 1)."""
    x = ins["X"]
    ln = _lengths(ins, x)
    m = _time_mask(x, ln)
    pt = str(attrs.get("pooltype", attrs.get("pool_type", "AVERAGE"))).upper()
    lnf = torch.clamp_min(ln, 1).to(x.dtype).reshape(
        (-1,) + (1,) * (x.ndim - 2))
    xm = x * m.to(x.dtype)
    if pt == "SUM":
        out = torch.sum(xm, dim=1)
    elif pt == "AVERAGE":
        out = torch.sum(xm, dim=1) / lnf
    elif pt == "SQRT":
        out = torch.sum(xm, dim=1) / torch.sqrt(lnf)
    elif pt == "MAX":
        neg = -3.4e38 if x.dtype != torch.float64 else -1e308
        out = torch.amax(torch.where(m, x, torch.tensor(
            neg, dtype=x.dtype, device=x.device)), dim=1)
    elif pt == "FIRST":
        out = x[:, 0]
    elif pt == "LAST":
        idx = torch.clamp_min(ln - 1, 0).to(torch.int64)[:, None]
        out = torch.gather(x, 1, _trail(idx, x)).squeeze(1)
    else:
        raise ValueError(f"sequence_pool: unknown pooltype {pt!r}")
    return {"Out": out}


@register_op("sequence_reverse", nondiff_slots=("Length",))
def sequence_reverse_kernel(ins, attrs):
    """Each row's valid prefix reversed; the pad stays in place."""
    x = ins["X"]
    ln = _lengths(ins, x)[:, None]
    t = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
    src = torch.where(t < ln, ln - 1 - t, t).to(torch.int64)
    return {"Out": torch.gather(x, 1, _trail(src, x))}


@register_op("sequence_slice", nondiff_slots=("Offset", "SliceLength",
                                              "Length"))
def sequence_slice_kernel(ins, attrs):
    """out[b, j] = x[b, offset[b] + j] for j < slice_len[b], else 0."""
    x = ins["X"]
    off = ins["Offset"].to(torch.int32).reshape(-1)
    sl = ins["SliceLength"].to(torch.int32).reshape(-1)
    t = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
    src = torch.clamp(off[:, None] + t, 0, x.shape[1] - 1).to(torch.int64)
    g = torch.gather(x, 1, _trail(src, x))
    m = (t < sl[:, None]).reshape(tuple(x.shape[:2]) + (1,) * (x.ndim - 2))
    return {"Out": g * m.to(x.dtype), "Length": sl}


@register_op("sequence_reshape", nondiff_slots=("Length",))
def sequence_reshape_kernel(ins, attrs):
    """[B, T, D] -> [B, T * D / new_dim, new_dim]; the lengths scale by
    D / new_dim."""
    x = ins["X"]
    ln = _lengths(ins, x)
    new_dim = int(attrs["new_dim"])
    d = x.shape[-1]
    xz = torch.where(_time_mask(x, ln), x, _zero(x))
    out = xz.reshape(x.shape[0], x.shape[1] * d // new_dim, new_dim)
    return {"Out": out,
            "Length": torch.div(ln * d, new_dim, rounding_mode="floor")}


@register_op("sequence_concat", list_slots=("X", "Length"),
             nondiff_slots=("Length",))
def sequence_concat_kernel(ins, attrs):
    """Each row's valid segments one after another, padded to the summed
    T."""
    xs = ins["X"]
    lens = ins.get("Length") or []
    if not lens:
        lens = [torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                           device=x.device) for x in xs]
    lens = [l.to(torch.int32).reshape(-1) for l in lens]
    total = sum(x.shape[1] for x in xs)
    b = xs[0].shape[0]
    out = xs[0].new_zeros((b, total) + tuple(xs[0].shape[2:]))
    t_out = torch.arange(total, dtype=torch.int32,
                         device=xs[0].device)[None, :]
    offset = torch.zeros((b,), dtype=torch.int32, device=xs[0].device)
    for x, ln in zip(xs, lens):
        # the rows of x land at [offset, offset + ln)
        rel = t_out - offset[:, None]
        valid = (rel >= 0) & (rel < ln[:, None])
        src = torch.clamp(rel, 0, x.shape[1] - 1).to(torch.int64)
        idx = src.reshape(tuple(src.shape) + (1,) * (x.ndim - 2)).expand(
            (b, total) + tuple(x.shape[2:]))
        g = torch.gather(x, 1, idx)
        out = torch.where(valid.reshape(tuple(valid.shape)
                                        + (1,) * (x.ndim - 2)), g, out)
        offset = offset + ln
    return {"Out": out, "Length": offset}


@register_op("sequence_expand_as", nondiff_slots=("Length",))
def sequence_expand_as_kernel(ins, attrs):
    """Each row vector of X [B, ...] broadcast over the first Length[b]
    steps of a time axis of ``maxlen``."""
    x = ins["X"]
    ln = ins["Length"].to(torch.int32).reshape(-1)
    maxlen = int(attrs["maxlen"])
    t = torch.arange(maxlen, dtype=torch.int32, device=x.device)[None, :]
    m = (t < ln[:, None]).reshape((x.shape[0], maxlen) + (1,) * (x.ndim - 1))
    out = x[:, None].expand((x.shape[0], maxlen) + tuple(x.shape[1:]))
    return {"Out": out * m.to(x.dtype), "Length": ln}


@register_op("sequence_enumerate", nondiff_slots=("X", "Length"),
             no_grad=True)
def sequence_enumerate_kernel(ins, attrs):
    """out[b, t, k] = x[b, t + k] (ids [B, T]) while t + k is inside the
    row, else ``pad_value``."""
    x = ins["X"]
    ln = _lengths(ins, x)[:, None, None]
    win = int(attrs["win_size"])
    t = torch.arange(x.shape[1], dtype=torch.int32,
                     device=x.device)[None, :, None]
    k = torch.arange(win, dtype=torch.int32, device=x.device)[None, None, :]
    src = t + k
    valid = (src < ln) & (t < ln)
    srcc = torch.clamp(src, 0, x.shape[1] - 1).to(torch.int64).expand(
        x.shape[0], x.shape[1], win)
    g = torch.gather(x[:, :, None].expand(x.shape[0], x.shape[1], win), 1,
                     srcc)
    pad = torch.tensor(attrs.get("pad_value", 0), dtype=x.dtype,
                       device=x.device)
    return {"Out": torch.where(valid, g, pad)}


@register_op("sequence_scatter", nondiff_slots=("Ids", "Length"))
def sequence_scatter_kernel(ins, attrs):
    """out[b, ids[b, n]] += updates[b, n] for n < Length[b] (ids clipped
    into the row)."""
    x = ins["X"]
    ids = ins["Ids"].to(torch.int64)
    upd = ins["Updates"]
    ln = ins.get("Length")
    if ln is None:
        ln = torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int32,
                        device=ids.device)
    else:
        ln = ln.to(torch.int32).reshape(-1)
    n = torch.arange(ids.shape[1], dtype=torch.int32,
                     device=ids.device)[None, :]
    m = (n < ln[:, None]).to(upd.dtype)
    m = m.reshape(tuple(m.shape) + (1,) * (upd.ndim - 2))
    b_idx = torch.arange(x.shape[0], device=x.device)[:, None].expand(
        ids.shape)
    return {"Out": x.index_put((b_idx, torch.clamp(ids, 0, x.shape[1] - 1)),
                               upd * m, accumulate=True)}


@register_op("sequence_conv", nondiff_slots=("Length",))
def sequence_conv_kernel(ins, attrs):
    """The context-window convolution over time: out[b, t] =
    concat(x[b, t + start : t + start + ctx]) @ Filter, the steps outside
    the row read as 0, the pad of the output 0."""
    x = ins["X"]  # [B, T, D]
    w = ins["Filter"]  # [ctx * D, F]
    ln = _lengths(ins, x)
    ctx = int(attrs.get("contextLength", attrs.get("context_length")))
    start = int(attrs.get("contextStart", attrs.get("context_start",
                                                    -(ctx - 1) // 2)))
    t = x.shape[1]
    xz = torch.where(_time_mask(x, ln), x, _zero(x))
    tt = torch.arange(t, dtype=torch.int32, device=x.device)[None, :]
    cols = []
    for k in range(ctx):
        shift = start + k
        rolled = torch.roll(xz, -shift, dims=1)
        ok = ((tt + shift >= 0) & (tt + shift < ln[:, None]))[..., None]
        cols.append(torch.where(ok, rolled, _zero(x)))
    out = torch.cat(cols, dim=-1) @ w  # [B, T, F]
    return {"Out": out * _time_mask(out, ln).to(out.dtype)}

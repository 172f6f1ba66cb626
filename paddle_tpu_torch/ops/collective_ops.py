"""The collective ops: ``c_*`` all-reduces, gathers and splits, the
vocabulary-split embedding and cross-entropy, point-to-point and the
stream-ordering ops, over ``torch.distributed`` process groups.

Counterpart of ``paddle_tpu/ops/collective_ops.py``, op for op and grad
op for grad op.  A ``ring_id`` names a communicator, as in the
reference: ring 0 is the world, and :func:`set_ring_axis` (which
:class:`~paddle_tpu_torch.distributed.collective.Group` calls) binds
another ring to a process group or to an axis of the installed hybrid
mesh (``"mp"``, ``("dp", "sharding")``); an ``axis_name`` attribute names
the axis directly.  Without an initialised process group an op takes its
one-rank meaning, as the reference's do outside a mesh, so one process
runs a distributed model's program.  On a ``meta`` tensor (shape
inference) an op makes its output's shape and communicates nothing.

Gradients are the reference's.  ``c_allreduce_sum`` / ``mp_allreduce_sum``
and ``c_identity`` name each other as their grad ops (Megatron's g and
f), ``c_embedding`` and ``c_softmax_with_cross_entropy`` their
hand-written grad ops; the others differentiate as ``jax.vjp`` of the
reference's kernel under ``shard_map`` does: the gather's gradient is the
reduce-scatter of the ranks' gradients and the reverse, ``alltoall``'s
the ``alltoall`` of its gradient, ``c_split``'s this rank's slice put back
among zeros, ``c_broadcast``'s the gradient on the root and zeros
elsewhere.  ``c_allreduce_{max,min,prod}`` and the rest have none.

Where the port differs on purpose: ``send_v2`` / ``recv_v2`` /
``partial_send`` run (a port program runs in each rank's process, so a
rank can send what its peer receives), where the reference's SPMD trace
cannot; ``c_allreduce_prod`` is the product, where the reference takes
``exp(sum(log x))``, equal for positive values.  ``c_softmax_with_cross_
entropy`` combines the ranks' row log-sum-exps, so on one rank it is the
``softmax_with_cross_entropy`` op's arithmetic bit for bit.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..framework.dtype import to_torch_dtype
from ..framework.place import current_device
from .registry import GRAD_SUFFIX, register_op

# ring_id -> process group or hybrid-mesh axis name(s)
_RING_AXES: Dict[int, object] = {}


def set_ring_axis(ring_id: int, axis) -> None:
    """Bind ring ``ring_id`` to a process group or a mesh axis name."""
    _RING_AXES[int(ring_id)] = axis


def get_ring_axis(ring_id: int):
    return _RING_AXES.get(int(ring_id))


class _Ring:
    """The group an op's ring names: its process group (None for the
    world), this rank's index in it and its size; ``live`` is False where
    the op takes its one-rank meaning."""

    __slots__ = ("pg", "rank", "n", "live")

    def __init__(self, attrs):
        self.pg, self.rank, self.n = None, 0, 1
        self.live = dist.is_initialized()
        if not self.live:
            return
        axis = attrs.get("axis_name")
        ring = int(attrs.get("ring_id", 0))
        if axis is None:
            axis = get_ring_axis(ring)
        if axis is None and ring != 0:
            raise ValueError(f"ring {ring} is bound to no group (new_group "
                             "binds one)")
        if isinstance(axis, (str, tuple, list)):
            from ..distributed import mesh as mesh_mod

            axis = mesh_mod.axis_group(
                axis if isinstance(axis, str) else tuple(axis))
        self.pg = axis
        self.rank = dist.get_rank(axis)
        self.n = dist.get_world_size(axis)

    def glob(self, rank: int) -> int:
        """The global rank of the group's ``rank``."""
        if self.pg is None:
            return rank
        return dist.get_global_rank(self.pg, rank)


def _live(ring: _Ring, *ts) -> bool:
    """True where the op communicates: a group is up and no tensor is a
    shape-inference ``meta`` tensor."""
    return ring.live and all(t.device.type != "meta" for t in ts)


# -- all-reduce and identity: Megatron's g and f ------------------------------

_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


def _allreduce(red):
    def kernel(ins, attrs):
        x = ins["X"]
        ring = _Ring(attrs)
        if not _live(ring, x):
            return {"Out": x}
        out = x.contiguous().clone()
        dist.all_reduce(out, op=_REDUCE[red], group=ring.pg)
        return {"Out": out}

    return kernel


def _grad_as(op_type):
    """A grad maker whose grad op is ``op_type`` on ``Out@GRAD``, its
    ``Out`` the gradient of ``X``."""

    def maker(ins, outs, ogs):
        return op_type, {"X": ogs["Out"]}

    return maker


register_op("c_allreduce_sum", grad_maker=_grad_as("c_identity"),
            grad_out_slots={"X": "Out"})(_allreduce("sum"))
register_op("c_allreduce_max", no_grad=True)(_allreduce("max"))
register_op("c_allreduce_min", no_grad=True)(_allreduce("min"))
register_op("c_allreduce_prod", no_grad=True)(_allreduce("prod"))
register_op("mp_allreduce_sum", grad_maker=_grad_as("c_identity"),
            grad_out_slots={"X": "Out"})(_allreduce("sum"))


@register_op("c_identity", grad_maker=_grad_as("c_allreduce_sum"),
             grad_out_slots={"X": "Out"})
def c_identity_kernel(ins, attrs):
    return {"Out": ins["X"]}


# -- broadcast, gathers, scatters, alltoall, split ----------------------------


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, root):
        ctx.mine = ring.rank == root
        out = x.contiguous().clone()
        dist.broadcast(out, src=ring.glob(root), group=ring.pg)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None


@register_op("c_broadcast")
def c_broadcast_kernel(ins, attrs):
    x = ins["X"]
    ring = _Ring(attrs)
    if not _live(ring, x):
        return {"Out": x}
    return {"Out": _Broadcast.apply(x, ring, int(attrs.get("root", 0)))}


def _gather0(x, ring):
    """Every rank's ``x`` stacked: ``(n, *x.shape)`` (one flat
    all-gather)."""
    out = x.new_empty(ring.n * x.numel())
    dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(),
                                group=ring.pg)
    return out.view((ring.n,) + tuple(x.shape))


def _scatter0(parts, ring):
    """``parts`` ``(n, ...)`` summed over the ranks, this rank's part
    kept (one flat reduce-scatter)."""
    out = parts.new_empty(parts[0].numel())
    dist.reduce_scatter_tensor(out, parts.reshape(-1).contiguous(),
                               group=ring.pg)
    return out.view(parts.shape[1:])


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` (tiled); the gradient is the reduce-scatter
    of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, ring, dim):
        ctx.ring, ctx.dim = ring, dim
        return torch.cat(list(_gather0(x, ring).unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        parts = torch.stack(g.chunk(ctx.ring.n, dim=ctx.dim))
        return _scatter0(parts, ctx.ring), None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over the ranks, this rank's rows of dim 0 kept; the gradient
    is the all-gather of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return _scatter0(x.reshape((ring.n, -1) + tuple(x.shape[1:])), ring)

    @staticmethod
    def backward(ctx, g):
        gathered = _gather0(g, ctx.ring)
        return gathered.reshape((-1,) + tuple(g.shape[1:])), None


class _AllToAll(torch.autograd.Function):
    """Dim 0 cut into ``n`` chunks, chunk ``s`` to rank ``s``; the
    gradient goes back the same way."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        out = torch.empty_like(x.contiguous())
        dist.all_to_all_single(out, x.contiguous(), group=ring.pg)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g.contiguous())
        dist.all_to_all_single(out, g.contiguous(), group=ctx.ring.pg)
        return out, None


def _tiled(x, ring, dim):
    shape = list(x.shape)
    shape[dim] *= ring.n
    return x.new_empty(shape)


@register_op("c_allgather")
def c_allgather_kernel(ins, attrs):
    """Every rank's ``X`` concatenated along dim 0, in rank order."""
    x = ins["X"]
    ring = _Ring(attrs)
    if not ring.live:
        return {"Out": x}
    if x.device.type == "meta":
        return {"Out": _tiled(x, ring, 0)}
    return {"Out": _Gather.apply(x, ring, 0)}


@register_op("c_reducescatter")
def c_reducescatter_kernel(ins, attrs):
    """``X`` summed over the ranks, this rank's 1/n of dim 0 kept."""
    x = ins["X"]
    ring = _Ring(attrs)
    if not ring.live:
        return {"Out": x}
    if x.shape[0] % ring.n:
        raise ValueError(f"c_reducescatter: dim 0 of {tuple(x.shape)} does "
                         f"not split over {ring.n} ranks")
    if x.device.type == "meta":
        return {"Out": x.new_empty((x.shape[0] // ring.n,)
                                   + tuple(x.shape[1:]))}
    return {"Out": _ReduceScatter.apply(x, ring)}


@register_op("alltoall")
def alltoall_kernel(ins, attrs):
    x = ins["X"]
    ring = _Ring(attrs)
    if not _live(ring, x):
        return {"Out": x}
    if x.shape[0] % ring.n:
        raise ValueError(f"alltoall: dim 0 of {tuple(x.shape)} does not "
                         f"split over {ring.n} ranks")
    return {"Out": _AllToAll.apply(x, ring)}


@register_op("c_concat")
def c_concat_kernel(ins, attrs):
    """Every rank's ``X`` concatenated along the last dim (the
    tensor-parallel activations regrouped)."""
    x = ins["X"]
    ring = _Ring(attrs)
    if not ring.live:
        return {"Out": x}
    if x.device.type == "meta":
        return {"Out": _tiled(x, ring, x.dim() - 1)}
    return {"Out": _Gather.apply(x, ring, x.dim() - 1)}


class _Slice(torch.autograd.Function):
    """This rank's slice of the last dim; the gradient is put back in its
    place among zeros."""

    @staticmethod
    def forward(ctx, x, start, size):
        ctx.start, ctx.width = start, x.shape[-1]
        return x.narrow(-1, start, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        shape = tuple(g.shape[:-1]) + (ctx.width,)
        out = g.new_zeros(shape)
        out.narrow(-1, ctx.start, g.shape[-1]).copy_(g)
        return out, None, None


@register_op("c_split")
def c_split_kernel(ins, attrs):
    """This rank's 1/n of the last dim."""
    x = ins["X"]
    ring = _Ring(attrs)
    if not ring.live:
        return {"Out": x}
    if x.shape[-1] % ring.n:
        raise ValueError(f"c_split: the last dim of {tuple(x.shape)} does "
                         f"not split over {ring.n} ranks")
    size = x.shape[-1] // ring.n
    return {"Out": _Slice.apply(x, ring.rank * size, size)}


# -- point-to-point, barrier, stream ordering --------------------------------


@register_op("send_v2", no_grad=True)
def send_v2_kernel(ins, attrs):
    """``X`` to the group's rank ``peer``."""
    x = ins["X"]
    ring = _Ring(attrs)
    if _live(ring, x):
        dist.send(x.contiguous(), dst=ring.glob(int(attrs["peer"])),
                  group=ring.pg)
    return {}


@register_op("recv_v2", no_grad=True)
def recv_v2_kernel(ins, attrs):
    """A tensor of ``out_shape`` and ``dtype`` from the group's rank
    ``peer``."""
    out = torch.empty(tuple(attrs["out_shape"]),
                      dtype=to_torch_dtype(attrs.get("dtype", "float32")),
                      device=current_device())
    ring = _Ring(attrs)
    if _live(ring, out):
        dist.recv(out, src=ring.glob(int(attrs["peer"])), group=ring.pg)
    return {"Out": out}


@register_op("partial_send", no_grad=True)
def partial_send_kernel(ins, attrs):
    """Part ``id`` of ``num`` equal parts of the flattened ``X`` to the
    group's rank ``peer``."""
    x = ins["X"]
    ring = _Ring(attrs)
    num, part = int(attrs.get("num", 1)), int(attrs.get("id", 0))
    flat = x.reshape(-1)
    if flat.numel() % num:
        raise ValueError(f"partial_send: {flat.numel()} elements do not "
                         f"split into {num} parts")
    if _live(ring, x):
        size = flat.numel() // num
        dist.send(flat[part * size:(part + 1) * size].contiguous(),
                  dst=ring.glob(int(attrs["peer"])), group=ring.pg)
    return {}


@register_op("barrier", no_grad=True)
def barrier_kernel(ins, attrs):
    x = ins.get("X")
    if x is None:
        x = torch.zeros((1,), dtype=torch.int32, device=current_device())
    ring = _Ring(attrs)
    if _live(ring, x):
        dist.barrier(group=ring.pg)
    return {"Out": x}


def _ordered(ins, attrs):
    """Collectives and compute share the current stream's order here, so
    the reference's stream-ordering ops pass ``X`` through."""
    return {"Out": ins["X"]}


register_op("c_sync_calc_stream", no_grad=True)(_ordered)
register_op("c_sync_comm_stream", no_grad=True)(_ordered)
register_op("c_wait_compute", no_grad=True)(_ordered)


# -- the vocabulary-split embedding and cross-entropy ------------------------


def _local_rows(ids, start, n):
    """(the rows of ``ids`` in ``[start, start + n)`` clamped into the
    local table, the mask of those in range)."""
    local = ids.long() - int(start)
    in_range = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), in_range


def _c_embedding_grad_maker(ins, outs, ogs):
    return "c_embedding_grad", {"W": ins["W"], "Ids": ins["Ids"],
                                "Out" + GRAD_SUFFIX: ogs["Out"]}


@register_op("c_embedding", nondiff_slots=("Ids",),
             grad_maker=_c_embedding_grad_maker)
def c_embedding_kernel(ins, attrs):
    """This rank holds rows ``[start_index, start_index + n)``: ids out of
    that range read zeros, and the sum over the ranks completes the
    lookup (``F.embedding``, as the ``lookup_table_v2`` op)."""
    w, ids = ins["W"], ins["Ids"]
    safe, in_range = _local_rows(ids, attrs.get("start_index", 0), w.shape[0])
    out = F.embedding(safe, w)
    out = torch.where(in_range[..., None], out, torch.zeros_like(out))
    ring = _Ring(attrs)
    if _live(ring, out):
        dist.all_reduce(out, group=ring.pg)
    return {"Out": out}


@register_op("c_embedding_grad", no_grad=True)
def c_embedding_grad_kernel(ins, attrs):
    """The rows' gradients summed into the local table by
    ``embedding_dense_backward`` (``F.embedding``'s backward, a fixed
    order on the card)."""
    w, ids = ins["W"], ins["Ids"]
    dout = ins["Out" + GRAD_SUFFIX]
    safe, in_range = _local_rows(ids, attrs.get("start_index", 0), w.shape[0])
    dmask = torch.where(in_range[..., None], dout, torch.zeros_like(dout))
    dw = torch.ops.aten.embedding_dense_backward(dmask, safe, w.shape[0], -1,
                                                  False)
    return {"W" + GRAD_SUFFIX: dw.to(w.dtype)}


def _c_swce_grad_maker(ins, outs, ogs):
    return "c_softmax_with_cross_entropy_grad", {
        "Softmax": outs["Softmax"], "Label": ins["Label"],
        "Loss" + GRAD_SUFFIX: ogs["Loss"]}


def _vocab_label(label, ndim, start, vocab_local):
    lab = label[..., 0] if label.dim() == ndim else label
    return _local_rows(lab, start, vocab_local)


@register_op("c_softmax_with_cross_entropy", nondiff_slots=("Label",),
             nondiff_out_slots=("Softmax",), grad_maker=_c_swce_grad_maker)
def c_softmax_with_cross_entropy_kernel(ins, attrs):
    """Softmax cross-entropy of logits whose last dim (the vocabulary) is
    split over the ranks, rank ``r`` holding columns ``r * V / n`` on,
    against global hard labels; no rank gathers a whole row.  The row's
    log-sum-exp combines the ranks' (``M + log sum exp(lse_r - M)``, ``M``
    their max), the label's logit comes from the rank that holds it;
    ``Loss = lse - logit``, ``Softmax = exp(logits - lse)`` (this rank's
    columns)."""
    logits, label = ins["Logits"], ins["Label"]
    ring = _Ring(attrs)
    vl = logits.shape[-1]
    live = _live(ring, logits)
    safe, in_range = _vocab_label(label, logits.dim(), ring.rank * vl, vl)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    if live:
        top = lse.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=ring.pg)
        s = torch.exp(lse - top)
        dist.all_reduce(s, group=ring.pg)
        lse = top + torch.log(s)
    picked = torch.take_along_dim(logits, safe[..., None], dim=-1)
    picked = torch.where(in_range[..., None], picked, torch.zeros_like(picked))
    if live:
        dist.all_reduce(picked, group=ring.pg)
    return {"Softmax": torch.exp(logits - lse),
            "Loss": (lse - picked).to(logits.dtype)}


@register_op("c_softmax_with_cross_entropy_grad", no_grad=True)
def c_softmax_with_cross_entropy_grad_kernel(ins, attrs):
    """``(softmax - onehot) * dLoss`` on this rank's columns."""
    softmax, label = ins["Softmax"], ins["Label"]
    dloss = ins["Loss" + GRAD_SUFFIX]
    vl = softmax.shape[-1]
    safe, in_range = _vocab_label(label, softmax.dim(),
                                  _Ring(attrs).rank * vl, vl)
    onehot = F.one_hot(safe, vl).to(softmax.dtype)
    onehot = onehot * in_range[..., None].to(softmax.dtype)
    return {"Logits" + GRAD_SUFFIX: (softmax - onehot) * dloss}

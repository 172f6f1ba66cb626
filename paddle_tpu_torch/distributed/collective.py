"""The collective API over ``torch.distributed``, and the Megatron helpers
as autograd Functions.

Counterpart of ``paddle_tpu/distributed/collective.py``.  The reference
binds a group to a mesh axis and lets XLA lower its ``c_*`` ops; here a
group is a ``torch.distributed`` process group, and every call runs the
collective on the tensors' device (NCCL on the card, gloo on the CPU).
``group`` may be None (the world), a :class:`Group`, a process group, or
the name of an axis of the installed hybrid mesh (``"mp"``, or a tuple
such as ``("dp", "sharding")``).  ``src`` / ``dst`` are global ranks.  A
collective that fails raises; nothing retries it elsewhere.

The model-parallel helpers differentiate (each an autograd Function):

* :func:`_c_identity`: identity forward, all-reduce of the gradient
  (the input side of a column-parallel layer);
* :func:`_mp_allreduce`: all-reduce forward, identity backward (the
  output side of a row-parallel layer);
* :func:`_c_concat`: all-gather along a dim forward, this rank's slice of
  the gradient backward; :func:`_c_split`: the reverse;
* :func:`_c_softmax_with_cross_entropy`: cross-entropy over logits whose
  vocabulary is split over the group, without gathering them: the global
  row max and sum of exponentials by all-reduce (MAX, SUM), the label's
  logit by an all-reduce of the rank that holds it; backward ``softmax -
  onehot`` on the local slice.

The flat-buffer helpers (:class:`_Flat`, :func:`_coalesced`,
:func:`_all_gather_flat`, :func:`_reduce_scatter_flat`) run one
collective for many leaves: ZeRO's train step, the pipeline engine's 1/S
storage, the data-parallel wrapper's gradient buckets.  The
point-to-point helpers (:class:`_SendAct`, :class:`_RecvAct`,
:func:`_exchange`) move a pipeline's activations and their gradients
between stages.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import env as dist_env
from . import mesh as mesh_mod

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "all_reduce", "all_gather",
    "broadcast", "reduce", "scatter", "alltoall", "send", "recv", "barrier",
    "wait", "split", "get_rank", "get_world_size", "is_initialized",
]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
        ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """A process group with the reference's accessors: ``rank`` (this
    process's index in it, -1 outside), ``nranks``, ``ranks`` (global),
    ``id``."""

    def __init__(self, rank: int, nranks: int, id: int = 0,
                 ranks: Optional[List[int]] = None, process_group=None):
        self.rank = rank
        self.nranks = nranks
        self.id = id
        self.ranks = list(ranks) if ranks is not None else list(range(nranks))
        self.process_group = process_group

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, nranks={self.nranks}, ranks={self.ranks})"


_GROUPS = {}


def is_initialized() -> bool:
    return dist.is_initialized()


def _require():
    if not dist.is_initialized():
        raise RuntimeError("collectives need an initialised process group: "
                           "call init_parallel_env() first")


def get_group(gid: int = 0) -> Group:
    """Group ``gid`` made by :func:`new_group`; 0 is the world."""
    _require()
    if gid == 0 and 0 not in _GROUPS:
        world = dist.get_world_size()
        _GROUPS[0] = Group(dist.get_rank(), world, 0, list(range(world)),
                           dist.group.WORLD)
    return _GROUPS[gid]


def new_group(ranks: Optional[List[int]] = None, backend=None,
              timeout=None) -> Group:
    """A group over the global ``ranks`` (default all); every rank of the
    world calls it, in the same order."""
    _require()
    from .parallel import _timeout

    ranks = list(ranks) if ranks is not None else list(
        range(dist.get_world_size()))
    pg = dist.new_group(ranks, backend=backend, timeout=_timeout(timeout))
    gid = max(_GROUPS, default=0) + 1
    rank = dist.get_rank()
    g = Group(ranks.index(rank) if rank in ranks else -1, len(ranks), gid,
              ranks, pg)
    _GROUPS[gid] = g
    return g


def _pg(group):
    """The process group of ``group`` (see the module docstring)."""
    _require()
    if group is None:
        return None
    if isinstance(group, Group):
        return group.process_group
    if isinstance(group, (str, tuple)):
        return mesh_mod.axis_group(group)
    return group


def _size(group) -> int:
    return dist.get_world_size(_pg(group))


def _index(group) -> int:
    """This rank's index in ``group``."""
    return dist.get_rank(_pg(group))


def get_rank():
    return dist_env.get_rank()


def get_world_size():
    return dist_env.get_world_size()


def all_reduce(tensor, op=ReduceOp.SUM, group=None, use_calc_stream=True,
               sync_op=True):
    """In place over ``group``; returns ``tensor``.  ``use_calc_stream``
    and ``sync_op`` are the reference's: the collective runs on the
    current stream and is complete for every later op on it."""
    dist.all_reduce(tensor, op=_OPS[op], group=_pg(group))
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Appends every rank's ``tensor`` to ``tensor_list``, in group
    order."""
    pg = _pg(group)
    out = [torch.empty_like(tensor) for _ in range(dist.get_world_size(pg))]
    dist.all_gather(out, tensor.contiguous(), group=pg)
    tensor_list.extend(out)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``tensor`` of global rank ``src`` into every rank's, in place."""
    dist.broadcast(tensor, src=src, group=_pg(group))
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands in global rank ``dst``'s ``tensor``."""
    dist.reduce(tensor, dst=dst, op=_OPS[op], group=_pg(group))
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``src``'s ``tensor_list[i]`` into the i-th rank's ``tensor``."""
    pg = _pg(group)
    mine = dist.get_rank() == src
    dist.scatter(tensor, scatter_list=list(tensor_list) if mine else None,
                 src=src, group=pg)
    return tensor


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True):
    """The i-th of this rank's ``in_tensor_list`` goes to the i-th rank;
    ``out_tensor_list`` receives one tensor from each rank, in order.
    The tensors of one call share a shape."""
    pg = _pg(group)
    n = dist.get_world_size(pg)
    if len(in_tensor_list) != n:
        raise ValueError(f"alltoall needs {n} tensors, got "
                         f"{len(in_tensor_list)}")
    src = torch.stack([t.contiguous() for t in in_tensor_list])
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src, group=pg)
    out_tensor_list.extend(dst.unbind(0))


def send(tensor, dst=0, group=None, sync_op=True):
    dist.send(tensor.contiguous(), dst=dst, group=_pg(group))


def recv(tensor, src=0, group=None, sync_op=True):
    dist.recv(tensor, src=src, group=_pg(group))
    return tensor


def barrier(group=None):
    dist.barrier(group=_pg(group))


def wait(tensor, group=None, use_calc_stream=True):
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


# -- model-parallel helpers ----------------------------------------------------


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_pg(ctx.group))
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=_pg(group))
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x, group, dim):
    pg = _pg(group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(pg))]
    dist.all_gather(parts, x.contiguous(), group=pg)
    return torch.cat(parts, dim=dim)


def _slice(x, group, dim):
    n, i = _size(group), _index(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {n} ranks")
    return x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def _c_identity(tensor, group=None):
    return _Identity.apply(tensor, group)


def _mp_allreduce(tensor, op=ReduceOp.SUM, group=None, use_calc_stream=True,
                  use_model_parallel=True):
    if op != ReduceOp.SUM:
        raise ValueError("_mp_allreduce differentiates a SUM only")
    return _AllReduce.apply(tensor, group)


def _c_concat(tensor, group=None, dim=-1):
    return _Concat.apply(tensor, group, dim)


def _c_split(tensor, group=None, dim=-1):
    return _Split.apply(tensor, group, dim)


class _VocabParallelXent(torch.autograd.Function):
    """Per-row cross-entropy of vocabulary-split logits (see the module
    docstring).  ``start`` is this rank's first vocabulary row."""

    @staticmethod
    def forward(ctx, logits, label, group, start):
        pg = _pg(group)
        lf = logits.float()
        vl = lf.shape[-1]
        m = lf.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=pg)
        e = torch.exp(lf - m[..., None])
        s = e.sum(-1)
        dist.all_reduce(s, group=pg)
        local = label.long() - start
        inr = (local >= 0) & (local < vl)
        safe = torch.where(inr, local, 0)
        picked = torch.where(inr, lf.gather(-1, safe[..., None])[..., 0], 0.0)
        dist.all_reduce(picked, group=pg)
        ctx.save_for_backward(e / s[..., None], safe, inr)
        ctx.dtype = logits.dtype
        return torch.log(s) + m - picked

    @staticmethod
    def backward(ctx, g):
        softmax, safe, inr = ctx.saved_tensors
        onehot = torch.zeros_like(softmax).scatter_(
            -1, safe[..., None], inr[..., None].to(softmax.dtype))
        return ((softmax - onehot) * g[..., None]).to(ctx.dtype), None, None, \
            None


def _c_softmax_with_cross_entropy(logits, label, group=None,
                                  return_softmax=False):
    """Per-row loss ``[..., 1]`` of logits ``[..., V / n]`` split over
    ``group`` (this rank holds rows ``index * V / n`` on) against global
    ``label`` ids ``[...]`` or ``[..., 1]``; with ``return_softmax`` also
    the local slice of the softmax (no gradient)."""
    if label.dim() == logits.dim():
        label = label[..., 0]
    start = _index(group) * logits.shape[-1]
    loss = _VocabParallelXent.apply(logits, label, group, start)[..., None]
    if not return_softmax:
        return loss
    with torch.no_grad():
        lf = logits.float()
        m = lf.amax(-1, keepdim=True)
        all_reduce(m, ReduceOp.MAX, group)
        e = torch.exp(lf - m)
        s = e.sum(-1, keepdim=True)
        all_reduce(s, ReduceOp.SUM, group)
    return loss, e / s


# -- flat buffers: ZeRO's partition of a leaf, coalesced collectives ----------


class _Flat:
    """The partition of one leaf over the ``n`` ranks of a group (ZeRO's
    sharding axis, the pipeline's 1/S storage): flattened, zero-padded to
    a multiple of ``n``, rank ``r`` holding the ``r``-th of ``n`` equal
    chunks.  (The reference's ZeRO puts the axis on
    the leaf's first free divisible dim; AdamW is elementwise, so any
    partition gives the same update, and a flat one divides every leaf.)"""

    def __init__(self, shape, n, r):
        self.shape = tuple(shape)
        self.numel = int(np.prod(self.shape, dtype=np.int64))
        self.n, self.r = n, r
        self.chunk = -(-self.numel // n)

    def padded(self, t):
        """``t`` flattened and zero-padded to ``n * chunk``."""
        flat = t.reshape(-1)
        pad = self.n * self.chunk - self.numel
        return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat

    def shard(self, t):
        """This rank's chunk of ``t``, a new tensor."""
        return self.padded(t)[self.r * self.chunk:
                              (self.r + 1) * self.chunk].clone()

    def whole(self, chunks):
        """The leaf from all ranks' chunks, ``(n, chunk)``."""
        return chunks.reshape(-1)[:self.numel].view(self.shape)


def _coalesced(tensors, fn):
    """``fn`` on one flat buffer of ``tensors`` (one collective for the
    lot), copied back into them."""
    if not tensors:
        return
    buf = torch.cat([t.reshape(-1) for t in tensors])
    fn(buf)
    torch._foreach_copy_(tensors, [c.view_as(t) for c, t in zip(
        torch.split(buf, [t.numel() for t in tensors]), tensors)])


def _all_gather_flat(shards, flats, group, out_dtype):
    """Whole leaves from each rank's ``shards`` (one all-gather)."""
    buf = torch.cat([s.to(out_dtype).reshape(-1) for s in shards])
    out = buf.new_empty(flats[0].n * buf.numel())
    dist.all_gather_into_tensor(out, buf, group=group)
    out = out.view(flats[0].n, buf.numel())
    whole, off = [], 0
    for f in flats:
        whole.append(f.whole(out[:, off:off + f.chunk]))
        off += f.chunk
    return whole


def _reduce_scatter_flat(grads, flats, group):
    """Each leaf's gradient summed over the group, this rank's chunk of
    it kept (one reduce-scatter)."""
    n = flats[0].n
    buf = torch.cat([f.padded(g).view(n, f.chunk)
                     for f, g in zip(flats, grads)], dim=1).reshape(-1)
    out = buf.new_empty(buf.numel() // n)
    dist.reduce_scatter_tensor(out, buf, group=group)
    return list(torch.split(out, [f.chunk for f in flats]))


# -- point-to-point: the pipeline's activations ------------------------------
# The functional train step (models/gpt.py) sends through the autograd
# pair; the pipeline engine, which runs its own schedule, posts its sends
# and receives together (_exchange), each activation behind a header.


class _SendAct(torch.autograd.Function):
    """Pipeline: the stage's output activation sent to the next stage;
    returns a scalar to differentiate from, whose backward receives the
    activation's gradient back (the functional train step's transport,
    :mod:`paddle_tpu_torch.models.gpt`)."""

    @staticmethod
    def forward(ctx, x, peer, group):
        ctx.peer, ctx.group = peer, group
        ctx.like = (x.shape, x.dtype, x.device)
        dist.send(x.detach().contiguous(), dst=peer, group=group)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        gx = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(gx, src=ctx.peer, group=ctx.group)
        return gx, None, None


class _RecvAct(torch.autograd.Function):
    """Pipeline: the previous stage's activation received; its gradient
    goes back there.  ``anchor`` (a scalar requiring grad) ties the
    received tensor into the graph."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, peer, group):
        ctx.peer, ctx.group = peer, group
        x = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(x, src=peer, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), dst=ctx.peer, group=ctx.group)
        return torch.zeros((), device=g.device), None, None, None, None


_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_HEADER = 8      # ndim, up to 6 dims, the dtype's index in _DTYPES


def _header(t):
    """The header that precedes ``t`` on the wire: its dims and dtype."""
    if t.dim() > _HEADER - 2:
        raise ValueError(f"a pipeline activation of {t.dim()} dims")
    h = [t.dim(), *t.shape] + [0] * (_HEADER - 2 - t.dim())
    return torch.tensor(h + [_DTYPES.index(t.dtype)], dtype=torch.long,
                        device=t.device)


def _exchange(sends=(), recvs=()):
    """Post ``sends`` ((tensor, dst) pairs) and ``recvs`` ((tensor, src))
    together and wait for all of them."""
    ops = ([dist.P2POp(dist.isend, t.contiguous(), peer)
            for t, peer in sends]
           + [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs])
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """A row- or column-split linear layer (``operation="linear"``,
    ``axis`` 0 or 1) or a vocabulary-split embedding
    (``"embedding"``) over the mesh's mp axis, built on ``x``'s device
    and applied to ``x`` (a Tensor of the eager API, or a torch tensor);
    returns a Tensor."""
    from ..dygraph.tensor import Tensor
    from .fleet import meta_parallel as mpp

    t = x._t if isinstance(x, Tensor) else x
    if operation == "embedding":
        layer = mpp.VocabParallelEmbedding(size[0], size[1],
                                           weight_attr=weight_attr,
                                           device=t.device)
    elif operation == "linear" and axis == 0:
        layer = mpp.RowParallelLinear(size[0], size[1],
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      device=t.device)
    elif operation == "linear":
        layer = mpp.ColumnParallelLinear(size[0], size[1],
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out,
                                         device=t.device)
    else:
        raise ValueError(f"unknown operation {operation!r}")
    return layer(x)

"""Megatron tensor-parallel layers over the hybrid mesh's ``mp`` axis, as
modules and as functions of their tensors.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``
(``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear``, ``ParallelCrossEntropy``, ``RNGStatesTracker``).
The reference gives its parameters an ``mp`` sharding and lets GSPMD
insert the collectives; here each rank holds its shard and the layers call
them (:mod:`paddle_tpu_torch.distributed.collective`):

* vocab-parallel embedding: rank r holds rows ``[r V/n, (r+1) V/n)``; ids
  outside them look up zeros, and an all-reduce sums the ranks' rows;
* column-parallel linear: columns ``[r N/n, ...)`` and their bias; the
  input enters through ``_c_identity`` (its gradient is all-reduced), and
  ``gather_output`` all-gathers the columns;
* row-parallel linear: rows ``[r K/n, ...)``; the partial products are
  all-reduced, then the (whole) bias is added;
* W8A8 (``int8=True``): column-parallel runs :func:`~paddle_tpu_torch.
  ops.w8a8_matmul` on its columns, whose per-channel scales and per-token
  activation scales are the single-device ones.  Row-parallel needs the
  global scales of a sharded K: the weight's per-column absmax and the
  activation's per-row absmax are all-reduced (MAX) before quantizing,
  and the int32 partial sums (:func:`_int8_products`: the ``w8a8_gemm``
  kernel on the card) are all-reduced before the rescale, so the product
  equals the single-device one bit for bit.

The layers are paddle ``nn.Layer``s (:class:`_Parallel`): their
parameters are ``EagerParameter``s holding this rank's shard, their
``forward`` takes and returns the eager API's Tensors and runs the
functional forms above on their torch tensors, so a paddle model holds
them as sublayers and the port's optimizers take their parameters.  Each
builds the global initialisation (from a generator seeded with ``seed``
on its device, the current place unless ``device`` says otherwise, or
from its ``weight_attr``'s initializer) and keeps its rank's slice, so a
layer equals the slice of the one-rank layer of that seed;
:meth:`~_Parallel.set_global` loads given global weights.

Without a hybrid mesh the layers are one rank's (mp 1), as the
reference's are before ``fleet.init``.  At mp 1 (with a mesh or without)
a static program records what the reference's records, ``F.linear``'s
``matmul_v2`` / ``elementwise_add`` and ``F.embedding``'s
``lookup_table_v2``, and so does an eager call without a mesh.  At mp > 1
a static program records the collectives on the mesh's ``mp`` axis:
``c_identity`` before a column-parallel product and ``c_concat`` after it
(``gather_output``), ``c_split`` (unless ``input_is_parallel``) before a
row-parallel product and ``mp_allreduce_sum`` after it, ``c_embedding``
with this rank's first row as ``start_index``.  The reference records the
one-rank ops there too and lets GSPMD shard them; a port program runs in
each rank's process.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ....device import resolve_device
from ....dygraph.tensor import Tensor
from ....nn.layer_base import Layer
from ....framework import random as _random
from ....nn.initializer import Normal, XavierUniform
from ....ops.quant_ops import _QMAX, _scale, w8a8_matmul
from ... import mesh as mesh_mod
from ...collective import (_c_concat, _c_identity, _c_softmax_with_cross_entropy,
                           _c_split, _mp_allreduce, _pg, _VocabParallelXent)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "RNGStatesTracker",
           "get_rng_state_tracker", "model_parallel_random_seed",
           "vocab_parallel_embedding", "column_parallel_linear",
           "row_parallel_linear", "parallel_cross_entropy",
           "quantize_row_parallel", "row_parallel_w8a8"]


# -- functional forms ----------------------------------------------------------


def vocab_parallel_embedding(ids, weight, group):
    """Rows of the global table for ``ids`` from this rank's shard
    ``weight`` (its rows start at ``index * len(weight)``), summed over
    ``group``."""
    vl = weight.shape[0]
    local = ids.long() - dist.get_rank(_pg(group)) * vl
    inr = (local >= 0) & (local < vl)
    rows = weight[torch.where(inr, local, 0)]
    rows = torch.where(inr[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
    return _mp_allreduce(rows, group=group)


def column_parallel_linear(x, weight, bias, group, gather_output=False,
                           int8=False):
    """``x @ W[:, cols] + b[cols]`` for this rank's columns (all of them
    with ``gather_output``)."""
    x = _c_identity(x, group)
    out = w8a8_matmul(x, weight) if int8 else x @ weight
    if bias is not None:
        out = out + bias
    return _c_concat(out, group) if gather_output else out


#: K columns per call of the exact int32 path: 127^2 * 1024 < 2^24, so a
#: chunk's sums are exact in fp32
INT32_CHUNK = 1024


def _int8_products(xq, wq):
    """int32 sums of the int8 product ``xq`` (M, K) by ``wq`` (N, K): for
    CPU tensors float64 products (exact, |sum| <= 127^2 K < 2^53), for
    CUDA tensors :func:`_kernel_products`."""
    if xq.device.type == "cpu":
        return (xq.double() @ wq.double().t()).to(torch.int32)
    return _kernel_products(xq, wq)


def _kernel_products(xq, wq):
    """The int32 sums through :func:`~paddle_tpu_torch.kernels.w8a8_gemm`
    (the kernel on the card, its plain version on the CPU), made to
    return the sums themselves: each K chunk of :data:`INT32_CHUNK`
    columns gets one more column holding 127 (against a zero weight
    column), so every row's absmax is 127 and the GEMM's own quantize has
    scale 1 and returns the values unchanged; the weight scales are 1;
    and a chunk's sums, below 2^24 in magnitude, are exact in its fp32
    output.  The chunks' sums add up in int32."""
    from ....kernels.int8_gemm import w8a8_gemm

    m, k = xq.shape
    n = wq.shape[0]
    acc = torch.zeros((m, n), dtype=torch.int32, device=xq.device)
    ones = torch.ones(n, dtype=torch.float32, device=xq.device)
    for k0 in range(0, k, INT32_CHUNK):
        xs = xq[:, k0:k0 + INT32_CHUNK]
        x = torch.cat([xs.float(), xs.new_full((m, 1), 127.0,
                                               dtype=torch.float32)], 1)
        w = torch.cat([wq[:, k0:k0 + INT32_CHUNK],
                       wq.new_zeros((n, 1))], 1).contiguous()
        acc += w8a8_gemm(x.contiguous(), w, ones).to(torch.int32)
    return acc


def quantize_row_parallel(w, group):
    """Per-output-channel int8 quantization of a weight whose rows (K) are
    split over ``group``: ``w`` (K/n, N) float -> ``wq`` (N, K/n) int8, K
    contiguous as the W8A8 paths read it, and the global ``ws`` (N,)
    fp32 (the column absmax all-reduced MAX over the ranks)."""
    wt = w.float().t()
    amax = wt.abs().amax(dim=1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=_pg(group))
    ws = _scale(amax, _QMAX)
    wq = torch.round(wt / ws[:, None]).clamp(-_QMAX, _QMAX)
    return wq.to(torch.int8).contiguous(), ws


def row_parallel_w8a8(x, wq, ws, group, out_dtype=None):
    """``x @ W`` for a K-split int8 weight (``wq`` (N, K/n), global ``ws``)
    and activations ``x`` (..., K/n): per-row activation scales from the
    all-reduced (MAX) absmax, the int32 partial sums all-reduced (SUM),
    then the single-device rescale ``float(acc) * sx * ws``."""
    pg = _pg(group)
    lead = x.shape[:-1]
    xf = x.float().reshape(-1, x.shape[-1])
    amax = xf.abs().amax(-1, keepdim=True)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=pg)
    sx = _scale(amax, _QMAX)
    xq = torch.round(xf / sx).clamp(-_QMAX, _QMAX).to(torch.int8)
    acc = _int8_products(xq, wq)
    dist.all_reduce(acc, group=pg)
    out = (acc.float() * sx * ws.float()).to(out_dtype or x.dtype)
    return out.reshape(*lead, wq.shape[0])


class _RowW8A8(torch.autograd.Function):
    """Row-parallel W8A8 from float weights with straight-through
    gradients (the single-device ``w8a8_matmul``'s backward on the
    shards: ``dx = g W^T``, ``dw = x^T g`` in fp32)."""

    @staticmethod
    def forward(ctx, x, w, group):
        wq, ws = quantize_row_parallel(w, group)
        ctx.save_for_backward(x, w)
        return row_parallel_w8a8(x, wq, ws, group)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf, wf = g.float(), w.float()
        x2 = x.reshape(-1, x.shape[-1]).float()
        g2 = gf.reshape(-1, gf.shape[-1])
        return (gf @ wf.t()).to(x.dtype), (x2.t() @ g2).to(w.dtype), None


def row_parallel_linear(x, weight, bias, group, input_is_parallel=True,
                        int8=False):
    """``sum over ranks (x[..., rows] @ W[rows]) + b``; without
    ``input_is_parallel`` this rank's slice of ``x`` is taken first."""
    if not input_is_parallel:
        x = _c_split(x, group)
    if int8:
        out = _RowW8A8.apply(x, weight, group)
    else:
        out = _mp_allreduce(x @ weight, group=group)
    return out if bias is None else out + bias


def parallel_cross_entropy(logits, label, group):
    """Per-row cross-entropy of vocabulary-split ``logits`` against global
    ``label`` ids, never gathering the logits."""
    start = dist.get_rank(_pg(group)) * logits.shape[-1]
    return _VocabParallelXent.apply(logits, label, group, start)


# -- modules -------------------------------------------------------------------


def _mp():
    """(group, degree, rank) of the mesh's ``mp`` axis; without a mesh
    one rank's (None, 1, 0)."""
    mesh = mesh_mod.get_mesh()
    if mesh is None:
        return None, 1, 0
    return mesh.group("mp"), mesh.shape["mp"], mesh.coord["mp"]


def _static(x) -> bool:
    from ....framework import program as fw

    return isinstance(x, fw.Variable)


def _split(n, parts, what):
    if n % parts:
        raise ValueError(f"{what} {n} does not split over mp={parts}")
    return n // parts


def _place_of(device):
    from ....framework.place import CPUPlace, CUDAPlace

    return (CPUPlace() if device.type == "cpu"
            else CUDAPlace(device.index or 0))


@contextlib.contextmanager
def _on(device):
    """The eager API's current place is ``device`` inside (initializer
    ops make their values on the current place)."""
    from ....framework import place as place_mod

    old = getattr(place_mod._state, "place", None)
    place_mod._state.place = _place_of(device)
    try:
        yield
    finally:
        place_mod._state.place = old


def _as_tensor(x):
    return x if isinstance(x, Tensor) else Tensor._wrap(x)


def _amp_cast(op_type, ts):
    """``ts`` as the tracer would cast them for ``op_type`` under
    ``amp.auto_cast`` (the layers run their functional forms through
    ``trace_fn``, which the amp hook does not see)."""
    from ....dygraph import tracer

    amp = tracer.amp_state()
    if amp is None:
        return ts
    from ....amp.auto_cast import maybe_autocast_inputs

    ins, _ = maybe_autocast_inputs(amp, op_type, {"X": list(ts)}, {})
    return ins["X"]


class _Parallel(Layer):
    """Shared set-up of the tensor-parallel layers (paddle ``nn.Layer``s):
    the mp group, degree and rank, the device (the current place unless
    ``device`` names one), the dtype (the layer's, fp32 by default) and a
    generator of ``seed`` for the global initialisation.

    A parameter is drawn whole (its global shape) and this rank keeps its
    part along the split dim: the contiguous ``1/mp`` slice, or the global
    indices a layer is given.  A ``weight_attr`` initializer (or the
    global one) draws it from the seed chain as ``create_parameter`` does;
    without one the weight comes from the generator of ``seed``
    (Xavier-uniform, or N(0, 0.02) for the embedding) and the bias is
    ``Constant(0)``.  Parameters are named by the unique-name counters as
    the reference names them (``columnparallellinear_0.w_0``); a split
    one carries ``is_distributed`` (mp > 1) and ``tp_split``: (dim, the
    global indices it holds, the global length)."""

    def _setup(self, device, dtype, seed):
        from ....framework.dtype import to_torch_dtype
        from ....framework.place import current_device

        self.group, self.mp, self.rank = _mp()
        self.device_ = (current_device() if device is None
                        else resolve_device(device))
        self.dtype_ = to_torch_dtype(dtype or self._dtype)
        self.gen = torch.Generator(device=self.device_).manual_seed(seed)

    def _indices(self, n, dim, index):
        """The global indices along ``dim`` (length ``n``) this rank
        holds, as a torch index on the device; None for a whole one."""
        if dim is None:
            return None
        if index is None:
            per = n // self.mp
            index = range(self.rank * per, (self.rank + 1) * per)
        return torch.as_tensor(list(index), dtype=torch.long,
                               device=self.device_)

    def _make(self, shape, attr, dim, draw, is_bias=False, index=None,
              static_init=None):
        """This rank's part of the global parameter of ``shape``; built in
        static mode, a parameter of the program of this rank's shape,
        initialized by ``static_init`` (or the attr's initializer) in the
        startup program."""
        from ....framework import program as fw
        from ....framework import unique_name
        from ....nn.initializer import Constant, _global_initializer
        from ....nn.layer_base import EagerParameter, ParamAttr

        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if not fw.in_dygraph_mode():
            idx = self._indices(shape[dim] if dim is not None else 0, dim,
                                index)
            local = list(shape)
            if idx is not None:
                local[dim] = len(idx)
            p = self.create_parameter(local, attr, is_bias=is_bias,
                                      default_initializer=static_init)
            p.is_distributed = idx is not None and self.mp > 1
            p.tp_split = (None if idx is None else
                          (dim, idx.cpu().numpy(), int(shape[dim])))
            return p
        init = attr.initializer or _global_initializer(is_bias)
        if init is None and is_bias:
            init = Constant(0.0)
        if init is not None:
            with _on(self.device_):
                full = init.apply_dygraph(list(shape), "float32")
        else:
            full = draw()
        idx = self._indices(shape[dim] if dim is not None else 0, dim,
                            index)
        if idx is not None:
            full = full.index_select(dim, idx)
        p = EagerParameter(
            full.to(self.dtype_).contiguous(), trainable=attr.trainable,
            name=attr.name or unique_name.generate(self._full_name + ".w"),
            learning_rate=attr.learning_rate, regularizer=attr.regularizer,
            need_clip=attr.need_clip,
            is_distributed=idx is not None and self.mp > 1,
            place=_place_of(self.device_))
        p.tp_split = (None if idx is None else
                      (dim, idx.cpu().numpy(), int(shape[dim])))
        return p

    def _xavier(self, fan_in, fan_out):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        w = torch.empty(fan_in, fan_out, device=self.device_)
        return w.uniform_(-limit, limit, generator=self.gen)

    @torch.no_grad()
    def set_global(self, weight, bias=None):
        """Load global ``weight`` (and ``bias``), keeping this rank's
        parts."""
        for name, full in (("weight", weight), ("bias", bias)):
            if full is None:
                continue
            p = getattr(self, name)
            full = torch.as_tensor(np.asarray(full)).to(p._t.device)
            if p.tp_split is not None:
                dim, idx, _ = p.tp_split
                full = full.index_select(dim, torch.as_tensor(
                    idx, device=full.device))
            p._t.copy_(full)

    def _one_rank(self, x) -> bool:
        """The reference's one-rank ops apply: a static program at mp 1,
        or any call without a mesh."""
        return self.group is None or (self.mp == 1 and _static(x))

    def _linear(self, x, collective_in, collective_out):
        """The linear layers' forward: ``F.linear`` for one rank; a static
        program at mp > 1 records ``collective_in(x)``, the product, then
        ``collective_out`` of it (which adds the bias)."""
        from ....nn import functional as F

        if not _static(x):
            x = _as_tensor(x)
        if self._one_rank(x):
            if self.int8:
                from ....ops.quant_ops import w8a8_matmul as op

                out = op(x, self.weight)
                return out if self.bias is None else out + self.bias
            return F.linear(x, self.weight, self.bias)
        from ....tensor_api import matmul

        if self.int8:
            raise NotImplementedError(
                "a static program of W8A8 tensor-parallel layers at mp > 1")
        return collective_out(matmul(collective_in(x), self.weight))

    def _traced(self, fn, x):
        """``fn(x, weight, bias)`` on the torch tensors, recorded by
        autograd (the operands cast as amp casts a matmul); takes and
        returns port Tensors."""
        from ....dygraph import tracer

        x, w = _amp_cast("matmul_v2", [_as_tensor(x), self.weight])
        if self.bias is None:
            return tracer.trace_fn(lambda a, b: fn(a, b, None), [x, w])
        return tracer.trace_fn(fn, [x, w, self.bias])


class VocabParallelEmbedding(_Parallel):
    """Embedding rows (the vocabulary) split over mp; N(0, 0.02) init."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 name=None, *, seed=0, device=None, dtype=None):
        super().__init__()
        self._setup(device, dtype, seed)
        _split(num_embeddings, self.mp, "num_embeddings")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim

        def draw():
            full = torch.empty(num_embeddings, embedding_dim,
                               device=self.device_)
            return full.normal_(0.0, 0.02, generator=self.gen)

        self.weight = self._make([num_embeddings, embedding_dim],
                                 weight_attr, 0, draw,
                                 static_init=Normal(0.0, 0.02))
        self.bias = None

    def forward(self, x):
        from ....dygraph import tracer
        from ....nn import functional as F
        from ....ops.dispatch import dispatch_static

        if not _static(x):
            x = _as_tensor(x)
        if self._one_rank(x):
            return F.embedding(x, self.weight)
        if _static(x):
            rows = self.weight.shape[0]
            return dispatch_static(
                "c_embedding", {"W": [self.weight], "Ids": [x]},
                {"ring_id": 0, "axis_name": "mp",
                 "start_index": self.rank * rows})["Out"][0]
        return tracer.trace_fn(
            lambda ids, w: vocab_parallel_embedding(ids, w, self.group),
            [_as_tensor(x), self.weight])


class ColumnParallelLinear(_Parallel):
    """Weight ``[in, out]`` with its columns (and bias) split over mp;
    Xavier-uniform init, zero bias.  ``columns``: the global column
    indices this rank holds (default its contiguous slice; the GPT's
    fused QKV takes its heads' columns)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, name=None, *, seed=0,
                 device=None, dtype=None, int8=False, columns=None):
        super().__init__()
        self._setup(device, dtype, seed)
        _split(out_features, self.mp, "out_features")
        self.gather_output, self.int8 = gather_output, int8
        self.weight = self._make(
            [in_features, out_features], weight_attr, 1,
            lambda: self._xavier(in_features, out_features), index=columns,
            static_init=XavierUniform())
        self.bias = (self._make([out_features], None, 0, None, True,
                                index=columns) if has_bias else None)

    def forward(self, x):
        if self._one_rank(x) or _static(x):
            def out(y):
                y = y if self.bias is None else y + self.bias
                return _c_concat(y, "mp") if self.gather_output else y

            return self._linear(x, lambda a: _c_identity(a, "mp"), out)
        return self._traced(lambda a, w, b: column_parallel_linear(
            a, w, b, self.group, self.gather_output, self.int8), x)


class RowParallelLinear(_Parallel):
    """Weight ``[in, out]`` with its rows split over mp; the bias whole;
    Xavier-uniform init, zero bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, name=None, *,
                 seed=0, device=None, dtype=None, int8=False):
        super().__init__()
        self._setup(device, dtype, seed)
        _split(in_features, self.mp, "in_features")
        self.input_is_parallel, self.int8 = input_is_parallel, int8
        self.weight = self._make(
            [in_features, out_features], weight_attr, 0,
            lambda: self._xavier(in_features, out_features),
            static_init=XavierUniform())
        self.bias = (self._make([out_features], None, None, None, True)
                     if has_bias else None)

    def forward(self, x):
        if self._one_rank(x) or _static(x):
            def out(y):
                y = _mp_allreduce(y, group="mp")
                return y if self.bias is None else y + self.bias

            return self._linear(
                x, lambda a: a if self.input_is_parallel
                else _c_split(a, "mp"), out)
        return self._traced(lambda a, w, b: row_parallel_linear(
            a, w, b, self.group, self.input_is_parallel, self.int8), x)


class ParallelCrossEntropy(Layer):
    """Softmax cross-entropy over vocabulary-split logits, ``[..., 1]`` per
    row, as the reference's ``c_softmax_with_cross_entropy``; in a static
    program it records that op."""

    def __init__(self, mp_group=None, name=None):
        super().__init__()
        self._group = mp_group

    def forward(self, input, label):
        from ....dygraph import tracer
        from ....framework import program as fw

        if isinstance(input, fw.Variable):
            # a static program records the reference's op on the ring
            return _c_softmax_with_cross_entropy(input, label, self._group)
        group = self._group if self._group is not None else _mp()[0]
        if group is None:
            # one rank: the registered op, as the reference dispatches it
            from ....ops.dispatch import dispatch

            return dispatch("c_softmax_with_cross_entropy",
                            {"Logits": [input], "Label": [label]},
                            {"ring_id": 0})["Loss"][0]
        logits, = _amp_cast("c_softmax_with_cross_entropy",
                            [_as_tensor(input)])
        return tracer.trace_fn(
            lambda lg, lb: _c_softmax_with_cross_entropy(lg, lb, group),
            [logits, _as_tensor(label)])


# -- the RNG state tracker -----------------------------------------------------


class RNGStatesTracker:
    """Named keys of the seed chain, so dropout inside and outside a
    tensor-parallel region can draw from separate chains
    (:mod:`paddle_tpu_torch.framework.random`)."""

    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_.clear()

    def add(self, name, seed):
        self.states_[name] = _random.make_key(seed)

    @contextlib.contextmanager
    def rng_state(self, name="model_parallel_rng"):
        """Draws inside come from ``name``'s chain (added from a random
        seed on first use), which advances; the global chain is put back
        after."""
        if name not in self.states_:
            import random

            self.add(name, random.randrange(2 ** 31))
        old = _random.get_rng_state()
        _random.set_rng_state(self.states_[name])
        try:
            yield
        finally:
            self.states_[name] = _random.get_rng_state()
            _random.set_rng_state(old)


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed: Optional[int] = None):
    """Re-seed the tracker's ``model_parallel_rng`` chain from ``seed``
    (a random one when None or 0, as the reference does)."""
    import random

    seed = seed or random.randrange(2 ** 31)
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add("model_parallel_rng", seed)

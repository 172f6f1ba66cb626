"""The model wrappers ``fleet.distributed_model`` picks by parallel mode.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
parallel_wrappers.py`` (``MetaParallelBase``, ``DataParallelSPMD``,
``TensorParallel``, ``ShardingParallel``, ``PipelineParallel``).  The
reference states its data-parallel gradients as shardings and lets XLA
insert the reduction; here each rank is a process and the wrapper makes
the same promise with collectives:

* wrapping broadcasts every parameter from the data group's first rank;
* ``forward`` takes this rank's rows of each batch-shaped input
  (:func:`~paddle_tpu_torch.distributed.mesh.shard_batch` over the dp and
  sharding axes);
* in the backward each parameter's gradient, once accumulated, marks its
  bucket (``comm_buffer_size`` MB of parameters, in reverse order, 25 MB
  by default); a full bucket is averaged over the data group by one
  all-reduce of its flattened gradients, buckets in order, and the
  backward's end averages the rest (a parameter the backward did not
  reach counts a zero gradient).  After ``loss.backward()`` every
  gradient is the global batch's mean, with no call from the user;
  ``scale_loss`` and ``apply_collective_grads`` stay as no-ops.

The hook that arms the end-of-backward flush sits on the wrapper's
outputs, so the flush belongs to the backward through the model (a
recompute inside it runs a nested backward of its own).
``PipelineParallel`` drives :class:`~.pipeline_engine.PipelineEngine`.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.distributed as dist

from ....dygraph.tensor import Tensor
from ....nn.layer_base import Layer
from ...collective import _coalesced
from ... import mesh as mesh_mod

__all__ = ["MetaParallelBase", "DataParallelSPMD", "TensorParallel",
           "ShardingParallel", "PipelineParallel"]


def _require_mesh():
    mesh = mesh_mod.get_mesh()
    if mesh is None:
        raise RuntimeError("the distributed model wrappers need the hybrid "
                           "mesh: fleet.init() (or init_parallel_env) first")
    return mesh


class MetaParallelBase(Layer):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def train(self):
        self._layers.train()
        return self

    def eval(self):
        self._layers.eval()
        return self


class DataParallelSPMD(MetaParallelBase):
    """Data parallelism over the mesh's dp and sharding axes (see the
    module docstring)."""

    comm_buffer_mb = 25

    def _prepare_for_model(self):
        mesh = _require_mesh()
        self._axes = ("dp", "sharding")
        self._group = mesh.group(self._axes)
        self._n = mesh.degree(self._axes)
        src = mesh.group_ranks(self._axes)[0]
        params = [p for p in self._layers.parameters()
                  if isinstance(p, Tensor)]
        with torch.no_grad():
            for bucket in self._buckets_of(params[::-1]):
                _coalesced([p._t for p in bucket], lambda b: dist.broadcast(
                    b, src=src, group=self._group))
        trainable = [p for p in params if not p.stop_gradient]
        self._buckets = self._buckets_of(trainable[::-1])
        self._where = {}
        # the hooks hold the wrapper weakly: a parameter that outlives it
        # must not keep it (and, through it, every parameter) alive
        ref = weakref.ref(self)

        def ready(t):
            wrapper = ref()
            if wrapper is not None:
                wrapper._ready(t)

        for b, bucket in enumerate(self._buckets):
            for p in bucket:
                self._where[id(p._t)] = b
                p._t.register_post_accumulate_grad_hook(ready)
        self._reset()

    def _buckets_of(self, params):
        """``params`` in runs of at most ``comm_buffer_mb`` MB."""
        limit = self.comm_buffer_mb * 2 ** 20
        out, cur, size = [], [], 0
        for p in params:
            nbytes = p._t.numel() * p._t.element_size()
            if cur and size + nbytes > limit:
                out.append(cur)
                cur, size = [], 0
            cur.append(p)
            size += nbytes
        if cur:
            out.append(cur)
        return out

    def _reset(self):
        self._pending = [len(b) for b in self._buckets]
        self._next = 0
        self._armed = False

    def _reduce(self, b):
        """Average bucket ``b``'s gradients over the data group."""
        grads = []
        for p in self._buckets[b]:
            t = p._t
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            grads.append(t.grad)
        n = float(self._n)

        def mean(buf):
            dist.all_reduce(buf, group=self._group)
            buf.div_(n)

        with torch.no_grad():
            _coalesced(grads, mean)

    def _ready(self, t):
        b = self._where[id(t)]
        self._pending[b] -= 1
        while (self._next < len(self._buckets)
               and self._pending[self._next] <= 0):
            self._reduce(self._next)
            self._next += 1
        if self._next == len(self._buckets):
            self._reset()

    def _arm(self, grad):
        """At the start of a backward through the model: flush at its
        end."""
        if not self._armed:
            self._armed = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._flush)
        return grad

    def _flush(self):
        if not self._armed:
            return
        for b in range(self._next, len(self._buckets)):
            self._reduce(b)
        self._reset()

    def _shard(self, x):
        if isinstance(x, Tensor):
            out = Tensor._wrap(mesh_mod.shard_batch(x._t, self._axes))
            out.stop_gradient = x.stop_gradient
            return out
        if isinstance(x, np.ndarray):
            return mesh_mod.shard_batch(x, self._axes)
        return x

    def forward(self, *inputs, **kwargs):
        out = self._layers(*[self._shard(x) for x in inputs], **kwargs)
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, Tensor) and t._t.requires_grad:
                t._t.register_hook(self._arm)
        return out

    def scale_loss(self, loss):
        return loss          # gradients are global means already

    def apply_collective_grads(self):
        pass                 # the backward reduced them


class TensorParallel(DataParallelSPMD):
    """Tensor parallelism: the model's mp layers hold their shards; the
    batch still splits, and gradients average, over dp."""


class ShardingParallel(DataParallelSPMD):
    """ZeRO over the sharding axis: the optimizer state is sharded by
    ``DygraphShardingOptimizer``; parameters stay whole here and the
    batch splits over dp and sharding."""


class PipelineParallel(MetaParallelBase):
    """``PipelineParallel.train_batch`` over the 1F1B engine."""

    def __init__(self, layers, hcg, strategy=None, loss_fn=None):
        super().__init__(layers, hcg, strategy)
        self._engine = None
        self._loss_fn = loss_fn or getattr(layers, "_loss_fn", None)
        acc = 1
        if strategy is not None:
            acc = strategy.pipeline_configs.get("accumulate_steps", 1)
        self.accumulate_steps = acc

    def _get_engine(self):
        if self._engine is None:
            from .pipeline_engine import PipelineEngine

            self._engine = PipelineEngine(self._layers, loss_fn=self._loss_fn)
        return self._engine

    @staticmethod
    def _torch(x):
        """``x`` (a Tensor, numpy or torch) as a torch tensor on the
        current place's device: this rank's dp rows under a mesh, the
        whole batch in a process without one."""
        from ....framework.place import current_device

        t = x._t if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
        t = t.to(current_device())
        return t if mesh_mod.get_mesh() is None else mesh_mod.shard_batch(t)

    def train_batch(self, data, optimizer=None, lr_scheduler=None,
                    scaler=None):
        """``data`` = (inputs, labels) split into ``accumulate_steps``
        microbatches on the batch dim; one pipelined forward, backward
        and update (the optimizer's mode, betas, weight decay, clip and
        current learning rate).  Steps ``lr_scheduler`` when given.
        Returns the mean loss."""
        if scaler is not None:
            raise NotImplementedError(
                "the pipeline engine takes no loss scaler: train bf16 under "
                "amp.auto_cast, which needs none")
        x, y = (self._torch(d) for d in data)
        M = max(int(self.accumulate_steps), 1)
        if x.shape[0] % M:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"accumulate_steps={M}")
        xs = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
        ys = y.reshape((M, y.shape[0] // M) + tuple(y.shape[1:]))
        loss = self._get_engine().train_step(xs, ys, optimizer=optimizer)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return Tensor._wrap(loss)

    def eval_batch(self, data, compute_loss=True):
        x, y = data
        out = self._get_engine().eval_output(self._torch(x))
        if compute_loss and self._loss_fn is not None:
            with torch.no_grad():
                return self._loss_fn(out, Tensor._wrap(self._torch(y)))
        return out

    def state_dict(self, *a, **k):
        if self._engine is not None:
            self._engine.sync_to_layers()
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        if self._engine is None:
            return self._layers.set_state_dict(*a, **k)
        self._engine.sync_to_layers()
        out = self._layers.set_state_dict(*a, **k)
        self._engine.sync_from_layers()
        return out

"""Fleet meta-optimizers: LocalSGD and DGC momentum.

Counterpart of ``paddle_tpu/distributed/fleet/meta_optimizers.py``
(``LocalSGDOptimizer``, ``DGCMomentumOptimizer``), over the data group
of ``torch.distributed`` (the mesh's dp and sharding ranks, or the world
when no mesh is installed; one process, and nothing to exchange, when no
group is up).

* LocalSGD: ``k_steps`` local steps of the inner optimizer, then the
  parameters averaged over the group (one all-reduce of their flattened
  values).
* DGC (Lin et al. 2018): plain momentum before ``rampup_begin_step``;
  after it each parameter keeps a momentum-corrected accumulation ``u``
  and only its top ``(1 - sparsity)`` share by magnitude is applied, the
  rest stays in ``u`` as the residual.  The exchange is sparse: each rank
  all-gathers its k (value, index) pairs, and the pairs of all ranks are
  scatter-added into a dense update averaged over the group (``2 k``
  words a rank instead of the dense ``n``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from .. import mesh as mesh_mod
from ..collective import _coalesced
from .meta_parallel.pipeline_engine import _unique

__all__ = ["LocalSGDOptimizer", "DGCMomentumOptimizer"]


def _data_group():
    """(the data-parallel group or None for the world, its size); size 1
    without an initialised process group."""
    if not dist.is_initialized():
        return None, 1
    mesh = mesh_mod.get_mesh()
    if mesh is None:
        return None, dist.get_world_size()
    return mesh.group(("dp", "sharding")), mesh.degree(("dp", "sharding"))


class LocalSGDOptimizer:
    """``k_steps`` local steps, then parameter averaging over the data
    group."""

    def __init__(self, optimizer, k_steps: int = 1):
        self._inner = optimizer
        self.k_steps = max(int(k_steps), 1)
        self._params = _unique(optimizer._parameter_list or [])
        self._step = 0

    def step(self):
        self._inner.step()
        self._step += 1
        if self._step % self.k_steps == 0:
            self._average_params()

    def _average_params(self):
        group, n = _data_group()
        if n == 1:
            return

        def mean(buf):
            dist.all_reduce(buf, group=group)
            buf.div_(float(n))

        with torch.no_grad():
            _coalesced([p._t for p in self._params], mean)

    def clear_grad(self):
        self._inner.clear_grad()

    clear_gradients = clear_grad

    def get_lr(self):
        return self._inner.get_lr()

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)


class DGCMomentumOptimizer:
    """Deep Gradient Compression momentum (see the module docstring)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 rampup_begin_step: int = 0, rampup_step: int = 1,
                 sparsity: Optional[List[float]] = None, grad_clip=None,
                 name=None):
        from ... import optimizer as opt_mod

        self._momentum = momentum
        self._sparsity = list(sparsity or [0.999])
        self.rampup_begin_step = int(rampup_begin_step)
        self.rampup_step = max(int(rampup_step), 1)
        self._inner = opt_mod.Momentum(
            learning_rate=learning_rate, momentum=momentum,
            parameters=parameters, grad_clip=grad_clip)
        self._params = _unique(self._inner._parameter_list or [])
        self._u = {}
        self._step = 0

    def _current_sparsity(self) -> float:
        k = (self._step - self.rampup_begin_step - 1) // self.rampup_step
        return self._sparsity[min(max(k, 0), len(self._sparsity) - 1)]

    @torch.no_grad()
    def step(self):
        self._step += 1
        if self._step <= self.rampup_begin_step:
            self._inner.step()
            return
        s = self._current_sparsity()
        lr = float(self._inner.get_lr())
        clip = getattr(self._inner, "_grad_clip", None)
        if clip is not None:
            # the inner optimizer is bypassed after the ramp-up: its clip
            # applies here
            pgs = [(p, p.grad) for p in self._params if p.grad is not None]
            for (p, _), (_, g2) in zip(pgs, clip(pgs)):
                p.grad = g2
        group, world = _data_group()
        for p in self._params:
            if p.grad is None:
                continue
            g = p.grad._t.float()
            u = self._u.get(id(p))
            u = g.clone() if u is None else self._momentum * u + g
            flat = u.reshape(-1)
            n = flat.numel()
            k = max(int(n * (1.0 - s)), 1)
            idx = torch.topk(flat.abs(), k).indices
            vals = flat[idx]
            mask = torch.zeros(n, dtype=u.dtype, device=u.device)
            mask[idx] = 1.0
            self._u[id(p)] = u * (1.0 - mask.reshape(u.shape))
            if world > 1:
                # the sparse exchange: k (value, index) pairs a rank
                all_vals = vals.new_empty(world * k)
                all_idx = idx.new_empty(world * k)
                dist.all_gather_into_tensor(all_vals, vals.contiguous(),
                                            group=group)
                dist.all_gather_into_tensor(all_idx, idx.contiguous(),
                                            group=group)
                send = torch.zeros(n, dtype=u.dtype, device=u.device)
                send.index_add_(0, all_idx, all_vals)
                send = (send / world).reshape(u.shape)
            else:
                send = u * mask.reshape(u.shape)
            # plain SGD on the selected velocity, as the reference's
            # dgc_momentum op after the ramp-up (momentum is in u already)
            p._t.copy_((p._t.float() - lr * send).to(p._t.dtype))
        self._inner.clear_grad()

    def clear_grad(self):
        self._inner.clear_grad()

    clear_gradients = clear_grad

    def get_lr(self):
        return self._inner.get_lr()

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

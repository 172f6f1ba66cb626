"""The sharding (ZeRO-1) and hybrid-parallel optimizer wrappers.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
sharding_optimizer.py`` (``DygraphShardingOptimizer`` with its greedy
``_partition_parameters``, ``HybridParallelOptimizer``).  The reference
shards the accumulators as arrays over the mesh's sharding axis; here
each sharding rank is a process:

* ``DygraphShardingOptimizer``: the parameters are partitioned over the
  sharding ranks, largest first, each to the rank holding the fewest
  elements so far.  A rank's inner optimizer updates its own parameters
  only, so it makes and keeps only their accumulators; after its update
  each rank broadcasts its parameters to the others (one broadcast of
  the rank's flattened parameters).  The gradients are the data group's
  mean already (the model wrapper averaged them over dp and sharding).
* ``HybridParallelOptimizer``: wraps the user's optimizer (in the
  sharding optimizer when the strategy shards and the sharding degree is
  above 1), and runs its global-norm clip on the true global norm: the
  squared norms of tensor-parallel shards summed over mp, of the other
  gradients counted once, over this sharding rank's own parameters summed
  over the sharding ranks, and over the pp ranks.  A group of one rank
  adds nothing, so on one rank the clip is the plain clip, operation for
  operation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .... import tensor_api as T
from ....nn.clip import ClipGradByGlobalNorm
from ...collective import _coalesced
from ... import mesh as mesh_mod

__all__ = ["DygraphShardingOptimizer", "HybridParallelOptimizer"]


def _groups(axes):
    """The installed mesh's group over each of ``axes`` that has more
    than one rank."""
    mesh = mesh_mod.get_mesh()
    if mesh is None:
        return {}
    return {a: mesh.group(a) for a in axes if mesh.shape[a] > 1}


class _HybridClip(ClipGradByGlobalNorm):
    """``ClipGradByGlobalNorm`` over a distributed model: the squared
    norm of the split gradients all-reduced over ``mp``, then the total
    over the other axes of ``groups``; the scale applied as the plain
    clip applies it."""

    def __init__(self, clip, groups):
        super().__init__(clip.clip_norm)
        self._groups = groups

    def _global_norm(self, params_grads):
        whole, split = [], []
        for p, g in params_grads:
            if getattr(p, "need_clip", True):
                (split if getattr(p, "is_distributed", False)
                 else whole).append(g)
        sq = None
        for g in whole:
            s = T.sum(T.square(g))
            sq = s if sq is None else T.add(sq, s)
        if split:
            sq_split = None
            for g in split:
                s = T.sum(T.square(g))
                sq_split = s if sq_split is None else T.add(sq_split, s)
            if "mp" in self._groups:
                dist.all_reduce(sq_split._t, group=self._groups["mp"])
            sq = sq_split if sq is None else T.add(sq, sq_split)
        if sq is None:
            return None
        for axis in ("sharding", "pp"):
            if axis in self._groups:
                dist.all_reduce(sq._t, group=self._groups[axis])
        return T.sqrt(sq)


class _Delegate:
    """Everything an optimizer answers that a wrapper does not, from the
    wrapped one."""

    def __getattr__(self, name):
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)

    def get_lr(self):
        return self._inner.get_lr()

    def set_lr(self, v):
        return self._inner.set_lr(v)

    def state_dict(self):
        return self._inner.state_dict()

    def set_state_dict(self, s):
        return self._inner.set_state_dict(s)

    def minimize(self, loss, *a, **k):
        self.step()
        return None, None


class DygraphShardingOptimizer(_Delegate):
    """ZeRO-1 over the mesh's sharding axis (see the module docstring)."""

    def __init__(self, optimizer=None, hcg=None, user_defined_strategy=None,
                 params=None, inner_optimizer_class=None, **inner_kw):
        if optimizer is None and inner_optimizer_class is not None:
            optimizer = inner_optimizer_class(parameters=params, **inner_kw)
        self._inner = optimizer
        self._hcg = hcg
        mesh = mesh_mod.get_mesh()
        if mesh is None:
            raise RuntimeError("DygraphShardingOptimizer needs the hybrid "
                               "mesh: fleet.init() first")
        self._size = mesh.shape["sharding"]
        self._rank = mesh.coord["sharding"]
        self._group = mesh.group("sharding")
        self._src = mesh.group_ranks("sharding")
        self._all = list(optimizer._parameter_list or [])
        self._rank2params = self._partition_parameters()
        optimizer._parameter_list = self._rank2params[self._rank]

    def _partition_parameters(self) -> dict:
        """rank -> parameters: largest first, each to the rank holding the
        fewest elements so far."""
        mapping = {i: [] for i in range(self._size)}
        sizes = [0] * self._size
        for p in sorted(self._all, key=lambda q: -int(np.prod(q.shape))):
            r = int(np.argmin(sizes))
            mapping[r].append(p)
            sizes[r] += int(np.prod(p.shape))
        return mapping

    def _clip(self, groups):
        clip = self._inner._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm):
            return _HybridClip(clip, dict(groups, sharding=self._group))
        return clip

    def step(self, groups=None):
        clip = self._inner._grad_clip
        self._inner._grad_clip = self._clip(groups or {})
        try:
            self._inner.step()
        finally:
            self._inner._grad_clip = clip
        with torch.no_grad():
            for r, params in self._rank2params.items():
                if params:
                    _coalesced([p._t for p in params],
                               lambda b: dist.broadcast(
                                   b, src=self._src[r], group=self._group))

    def clear_grad(self):
        for p in self._all:
            p.clear_grad()

    clear_gradients = clear_grad


class HybridParallelOptimizer(_Delegate):
    """The user's optimizer for a hybrid run (see the module docstring)."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner = optimizer
        self._hcg = hcg
        self._strategy = strategy
        if (strategy is not None and strategy.sharding
                and mesh_mod.axis_size("sharding") > 1):
            self._inner_wrapped = DygraphShardingOptimizer(optimizer, hcg)
        else:
            self._inner_wrapped = optimizer

    def step(self):
        groups = _groups(("mp", "pp"))
        if isinstance(self._inner_wrapped, DygraphShardingOptimizer):
            return self._inner_wrapped.step(groups)
        clip = self._inner._grad_clip
        if isinstance(clip, ClipGradByGlobalNorm) and groups:
            self._inner._grad_clip = _HybridClip(clip, groups)
        try:
            return self._inner.step()
        finally:
            self._inner._grad_clip = clip

    def clear_grad(self):
        return self._inner_wrapped.clear_grad()

    clear_gradients = clear_grad

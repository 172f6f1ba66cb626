"""Gradient clipping: by value, by each gradient's norm, by the global
norm.

Counterpart of ``paddle_tpu/nn/clip.py``: a clip is a callable over the
optimizer's ``(param, grad)`` pairs, built from dispatched ops, applied
before the update ops.
"""

from __future__ import annotations

from .. import tensor_api as T

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if getattr(p, "need_clip", True):
                g = T.clip(g, self.min, self.max)
            out.append((p, g))
        return out


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        from ..ops.dispatch import dispatch, single

        out = []
        for p, g in params_grads:
            if getattr(p, "need_clip", True):
                g = single(dispatch("clip_by_norm", {"X": [g]}, {"max_norm": self.clip_norm}))
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """scale = clip_norm / max(global_norm, clip_norm) applied to every grad
    (parity: fluid/clip.py ClipGradByGlobalNorm — the hybrid-parallel variant,
    ``_HybridClip`` in distributed/fleet/meta_parallel/sharding_optimizer.py,
    additionally sums the squared norms over the mp, sharding and pp groups)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def _global_norm(self, params_grads):
        sq = None
        for p, g in params_grads:
            if not getattr(p, "need_clip", True):
                continue
            s = T.sum(T.square(g))
            sq = s if sq is None else T.add(sq, s)
        if sq is None:
            return None
        return T.sqrt(sq)

    def __call__(self, params_grads):
        gn = self._global_norm(params_grads)
        if gn is None:
            return params_grads
        clip = T.full_like(gn, self.clip_norm)
        scale = T.divide(clip, T.maximum(gn, clip))
        out = []
        for p, g in params_grads:
            if getattr(p, "need_clip", True):
                g = T.multiply(g, T.cast(scale, g.dtype) if g.dtype != scale.dtype else scale)
            out.append((p, g))
        return out

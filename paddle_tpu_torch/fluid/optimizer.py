"""``paddle.fluid.optimizer``: the v2.1 optimizer names
(SGDOptimizer, MomentumOptimizer, AdamOptimizer, ...), each the 2.x
optimizer with fluid's keywords (``regularization`` is
``weight_decay``, ``parameter_list`` is ``parameters``); ``minimize``
works in both modes."""

from __future__ import annotations

from .. import optimizer as _opt


def _fluidify(cls, **renames):
    class FluidOptimizer(cls):
        def __init__(self, *args, regularization=None, grad_clip=None,
                     parameter_list=None, **kw):
            if regularization is not None and "weight_decay" not in kw:
                kw["weight_decay"] = regularization
            if parameter_list is not None and "parameters" not in kw:
                kw["parameters"] = parameter_list
            if grad_clip is not None:
                kw["grad_clip"] = grad_clip
            for old, new in renames.items():
                if old in kw:
                    kw[new] = kw.pop(old)
            super().__init__(*args, **kw)

    FluidOptimizer.__name__ = cls.__name__ + "Optimizer"
    FluidOptimizer.__qualname__ = FluidOptimizer.__name__
    return FluidOptimizer


SGDOptimizer = _fluidify(_opt.SGD)
MomentumOptimizer = _fluidify(_opt.Momentum)
AdamOptimizer = _fluidify(_opt.Adam)
AdamaxOptimizer = _fluidify(_opt.Adamax)
AdagradOptimizer = _fluidify(_opt.Adagrad)
AdadeltaOptimizer = _fluidify(_opt.Adadelta)
RMSPropOptimizer = _fluidify(_opt.RMSProp)
LambOptimizer = _fluidify(_opt.Lamb)
LarsMomentumOptimizer = _fluidify(_opt.LarsMomentum)

# fluid also exposes the short names
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Lamb = LambOptimizer

from ..incubate import (  # noqa: E402,F401
    ExponentialMovingAverage, LookAhead, ModelAverage,
)

LookaheadOptimizer = LookAhead


def _unsupported(name, instead):
    class _Raiser:
        def __init__(self, *a, **k):
            raise NotImplementedError(
                f"fluid.optimizer.{name} is parameter-server-era; "
                f"use {instead} instead.")

    _Raiser.__name__ = name
    return _Raiser


DGCMomentumOptimizer = _unsupported(
    "DGCMomentumOptimizer",
    "fleet.DistributedStrategy dgc=True (fleet/meta_optimizers)")
PipelineOptimizer = _unsupported(
    "PipelineOptimizer", "fleet hybrid pp (meta_parallel.PipelineParallel)")
RecomputeOptimizer = _unsupported(
    "RecomputeOptimizer",
    "paddle.distributed.fleet recompute / incubate.checkpoint")
GradientMergeOptimizer = _unsupported(
    "GradientMergeOptimizer", "fleet.DistributedStrategy gradient_merge")

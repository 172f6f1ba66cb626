"""``paddle.incubate``: imperative quantization (:mod:`.quant`) and the
automatic checkpoints of elastic jobs (:mod:`.auto_checkpoint`).

Counterpart of ``paddle_tpu/incubate/__init__.py`` for those two.  The
reference's other names (the wrapper optimizers, ``asp``, the fused
softmax masks) wait for ROADMAP A.12: each raises, naming it.
"""

from . import auto_checkpoint  # noqa: F401
from . import quant  # noqa: F401

__all__ = ["quant", "auto_checkpoint"]

_LATER = ("ExponentialMovingAverage", "LookAhead", "ModelAverage",
          "GradientMergeOptimizer", "asp", "softmax_mask_fuse",
          "softmax_mask_fuse_upper_triangle")


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"paddle.incubate.{name} is not in the port yet (ROADMAP A.12)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

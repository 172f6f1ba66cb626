"""``paddle.incubate``: imperative quantization (:mod:`.quant`).

Counterpart of ``paddle_tpu/incubate/__init__.py`` for ``quant``.  The
reference's other names (the wrapper optimizers, ``asp``,
``auto_checkpoint``, the fused softmax masks) wait for ROADMAP A.12:
each raises, naming it.
"""

from . import quant  # noqa: F401

__all__ = ["quant"]

_LATER = ("ExponentialMovingAverage", "LookAhead", "ModelAverage",
          "GradientMergeOptimizer", "asp", "auto_checkpoint",
          "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle")


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"paddle.incubate.{name} is not in the port yet (ROADMAP A.12)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

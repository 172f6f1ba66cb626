"""``paddle.fluid.clip``: the ``GradientClipBy*`` names over the 2.x clip
classes."""

from ..nn import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)

GradientClipByGlobalNorm = ClipGradByGlobalNorm
GradientClipByNorm = ClipGradByNorm
GradientClipByValue = ClipGradByValue


def set_gradient_clip(clip, param_list=None, program=None):
    raise NotImplementedError(
        "fluid.clip.set_gradient_clip is deprecated; pass grad_clip=... to "
        "the optimizer instead.")

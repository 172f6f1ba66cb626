"""``paddle.fluid.backward``: ``append_backward`` and ``gradients``."""

from ..static.backward import append_backward, gradients  # noqa: F401

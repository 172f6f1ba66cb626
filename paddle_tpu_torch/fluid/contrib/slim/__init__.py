"""``fluid.contrib.slim``: the quantization entries."""

from . import quantization  # noqa: F401

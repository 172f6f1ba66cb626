"""``paddle.fluid.contrib``: the mixed-precision and slim entries that
v2.1 code touches."""

from . import mixed_precision  # noqa: F401
from . import slim  # noqa: F401

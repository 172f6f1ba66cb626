"""``paddle.fluid.dygraph.base``: guard, to_variable, enabled, no_grad."""

from . import enabled, guard, no_grad, to_variable  # noqa: F401

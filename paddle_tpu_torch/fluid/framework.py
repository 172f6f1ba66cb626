"""``paddle.fluid.framework``: Program, Variable, Parameter, the default
programs, the guards and the mode probes."""

from ..framework.program import (  # noqa: F401
    Block, Operator, Parameter, Program, Variable, default_main_program,
    default_startup_program, program_guard, in_dygraph_mode, name_scope,
)
from ..framework import unique_name  # noqa: F401
from ..framework.place import (  # noqa: F401
    CPUPlace, CUDAPlace, is_compiled_with_cuda,
)
from ..nn.layer_base import ParamAttr  # noqa: F401
from . import core  # noqa: F401


def _non_static_mode():
    return in_dygraph_mode()


_in_legacy_dygraph = _non_static_mode

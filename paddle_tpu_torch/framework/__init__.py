"""Framework core of the port: dtypes, places, the seed chain of explicit
``torch.Generator``s (:mod:`.random`), the flags (:mod:`.flags`), unique
names, scopes, the NaN/Inf check, the static-graph descs
(:mod:`.program`: ``Program``, ``Block``, ``Variable``, ``Operator``,
``Parameter``) and the mode switch.

Counterpart of ``paddle_tpu/framework/``; ``crypto.py`` waits for the
breadth slice (ROADMAP A.12).
"""

from . import dtype, unique_name  # noqa: F401
from .dtype import convert_dtype, to_numpy_dtype, to_torch_dtype  # noqa: F401
from .place import (  # noqa: F401
    CPUPlace,
    CUDAPinnedPlace,
    CUDAPlace,
    NPUPlace,
    Place,
    TPUPlace,
    XPUPlace,
    _get_current_place,
    get_device,
    is_compiled_with_cuda,
    is_compiled_with_tpu,
    set_device,
)
from .program import (  # noqa: F401
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    _dygraph_guard,
    default_main_program,
    default_startup_program,
    disable_static,
    enable_static,
    grad_var_name,
    in_dygraph_mode,
    name_scope,
    program_guard,
)
from .scope import Scope, global_scope, scope_guard  # noqa: F401

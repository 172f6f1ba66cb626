"""Framework core of the port: dtypes, places, the seed chain of explicit
``torch.Generator``s (:mod:`.random`), the flags (:mod:`.flags`), unique
names, scopes, the NaN/Inf check and the dygraph mode switch.

Counterpart of ``paddle_tpu/framework/``.  Its ``Program`` / ``Block`` /
``Variable`` model and the static branches wait for graph mode (ROADMAP
A.10); ``crypto.py`` waits for the breadth slice (A.12).
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
    _dygraph_guard,
    disable_static,
    enable_static,
    grad_var_name,
    in_dygraph_mode,
    name_scope,
)
from .scope import Scope, global_scope, scope_guard  # noqa: F401

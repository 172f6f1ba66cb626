"""``paddle.fluid``: the pre-2.x namespace.

Counterpart of ``paddle_tpu/fluid/__init__.py``.  v2.1-era model code
writes ``import paddle.fluid as fluid``; every name maps onto the port's
2.x implementation (``static``, ``nn``, ``optimizer`` ...), nothing here
is a second one.  ``examples/fluid_mnist.py`` trains BASELINE config 0
through it.
"""

from __future__ import annotations

# -- framework ---------------------------------------------------------------
from ..framework.program import (  # noqa: F401
    Program, Variable, default_main_program, default_startup_program,
    program_guard, in_dygraph_mode, name_scope,
)
from ..framework import unique_name  # noqa: F401
from ..framework.place import (  # noqa: F401
    CPUPlace, CUDAPlace, CUDAPinnedPlace, TPUPlace,
)
from ..static import cpu_places, cuda_places  # noqa: F401
from ..nn.layer_base import ParamAttr  # noqa: F401
from ..static import WeightNormParamAttr  # noqa: F401

# -- executor ----------------------------------------------------------------
from ..static.executor import Executor  # noqa: F401
from ..framework.scope import Scope, global_scope, scope_guard  # noqa: F401

# -- static graph pieces -----------------------------------------------------
from ..static import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy, ParallelExecutor,
    append_backward, gradients,
)
from ..static.input import data  # noqa: F401

# -- submodules --------------------------------------------------------------
from . import layers  # noqa: F401
from . import dygraph  # noqa: F401
from . import initializer  # noqa: F401
from . import optimizer  # noqa: F401
from . import regularizer  # noqa: F401
from . import clip  # noqa: F401
from . import io  # noqa: F401
from . import nets  # noqa: F401
from . import metrics  # noqa: F401
from . import core  # noqa: F401
from . import framework  # noqa: F401
from . import executor  # noqa: F401
from . import backward  # noqa: F401
from . import param_attr  # noqa: F401
from . import contrib  # noqa: F401

from .layers import embedding, one_hot  # noqa: F401  (fluid.embedding alias)


def enable_dygraph(place=None):
    from ..framework import program as fw

    fw.disable_static()


def disable_dygraph():
    from ..framework import program as fw

    fw.enable_static()


def enable_imperative(place=None):
    enable_dygraph(place)


def disable_imperative():
    disable_dygraph()


def is_compiled_with_cuda() -> bool:
    import torch

    return torch.cuda.is_available()


def get_flags(flags):
    from ..framework import flags as _f

    if isinstance(flags, str):
        flags = [flags]
    return {name: _f.flag(name) for name in flags}


def set_flags(flags_dict):
    from ..framework import flags as _f

    for name, value in flags_dict.items():
        _f.set_flag(name, value)


def memory_optimize(*a, **k):
    """No-op: the executor frees each value after its last reader."""


def release_memory(*a, **k):
    """No-op: the executor frees each value after its last reader."""


def require_version(min_version, max_version=None):
    return None


def load_op_library(*a, **k):
    raise NotImplementedError(
        "fluid.load_op_library loads CUDA .so custom ops; use "
        "paddle_tpu_torch.utils.cpp_extension (C++ run on the host) "
        "instead.")


# -- the remaining fluid names ---------------------------------------------

from ..framework.place import NPUPlace, XPUPlace  # noqa: E402,F401
from .. import profiler  # noqa: E402,F401
from ..dygraph.tensor import Tensor  # noqa: E402,F401


class LoDTensor:
    """LoD tensors are padded with a mask in this build: a plain Tensor
    carries the data."""

    def __new__(cls, *a, **k):
        import numpy as np

        return Tensor(np.zeros([0], "float32")) if not a else Tensor(a[0])


LoDTensorArray = list  # dygraph semantics: a python list of Tensors


class DataFeeder:
    """Per-sample rows into the feed dict the Executor takes."""

    def __init__(self, feed_list, place=None, program=None):
        self._names = [getattr(v, "name", str(v)) for v in feed_list]

    def feed(self, iterable):
        import numpy as np

        cols = list(zip(*iterable))
        if len(cols) != len(self._names):
            raise ValueError(
                f"DataFeeder got {len(cols)} columns for "
                f"{len(self._names)} feed vars")
        return {n: np.stack([np.asarray(v) for v in c])
                for n, c in zip(self._names, cols)}


def save(program, model_path, protocol=4, **configs):
    """``fluid.save``: a Program's persistables to one file."""
    import numpy as np

    from ..framework.scope import global_scope
    from ..static.io import _host

    state = {}
    for var in program.global_block().vars.values():
        if getattr(var, "persistable", False):
            val = global_scope().find_var(var.name)
            if val is not None:
                state[var.name] = _host(val)
    np.savez(model_path + ".pdparams.npz", **state)


def load(program, model_path, executor=None, var_list=None):
    """``fluid.load``: the persistables that ``fluid.save`` wrote, on the
    executor's device (the current place's without one)."""
    import numpy as np

    from ..framework.scope import global_scope
    from ..static.io import _device_of, _put

    data = np.load(model_path + ".pdparams.npz")
    names = set(var_list) if var_list else None
    _put(global_scope(), program, {n: data[n] for n in data.files},
         names=names, device=_device_of(executor))


def install_check():
    """``fluid.install_check.run_check``."""
    from ..utils import run_check

    return run_check()


def _cuda_synchronize(place=None):
    """Wait for the card's queued work."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _TranspilerUnavailable:
    def __getattr__(self, name):
        raise NotImplementedError(
            "fluid.transpiler is the parameter-server-era program rewriter; "
            "the collective path (paddle.distributed.fleet) replaces it in "
            "this build.")


transpiler = _TranspilerUnavailable()

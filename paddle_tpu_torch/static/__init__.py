"""``paddle.static``: Program construction, the Executor, autodiff,
``static.nn``, ``static.amp`` and static io.

Counterpart of ``paddle_tpu/static/__init__.py``, name for name.
"""

import contextlib

from ..framework.program import (  # noqa: F401
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
)
from .backward import append_backward, gradients  # noqa: F401
from .executor import CompiledProgram, Executor, as_compiled  # noqa: F401
from .io import (  # noqa: F401
    deserialize_persistables, deserialize_program, load, load_inference_model,
    load_program_state, load_vars, normalize_program, save,
    save_inference_model, save_vars, serialize_persistables,
    serialize_program, set_program_state)
from .input import InputSpec, data  # noqa: F401
from . import nn  # noqa: F401
from . import amp  # noqa: F401
from .control_flow import cond, while_loop  # noqa: F401
from ..framework.scope import Scope, global_scope, scope_guard  # noqa: F401
from ..tensor_api import create_parameter  # noqa: F401
from ..nn.functional import accuracy  # noqa: F401


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A Variable of the main program filled with ``value`` by the
    startup program."""
    from ..framework import program as _fw
    from ..framework import unique_name as _un

    block = _fw.default_main_program().global_block()
    name = name or _un.generate("global_var")
    var = block.create_var(name=name, shape=list(shape), dtype=dtype,
                           persistable=persistable)
    sb = _fw.default_startup_program().global_block()
    sb.create_var(name=name, shape=list(shape), dtype=dtype,
                  persistable=persistable)
    sb.append_op(type="fill_constant", inputs={}, outputs={"Out": [name]},
                 attrs={"shape": list(shape), "value": float(value),
                        "dtype": dtype})
    return var


def cpu_places(device_count=None):
    import os as _os

    from ..framework.place import CPUPlace

    n = device_count or int(_os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    """The CUDA cards (all of them by default)."""
    import torch

    from ..framework.place import CUDAPlace

    ids = (device_ids if device_ids is not None
           else range(torch.cuda.device_count()))
    return [CUDAPlace(i) for i in ids]


def xpu_places(device_ids=None):
    from ..framework.place import XPUPlace

    ids = device_ids if device_ids is not None else [0]
    return [XPUPlace(i) for i in ids]


def device_guard(device=None):
    """``paddle.static.device_guard``: accepted; a program's ops run on
    its executor's place."""
    return contextlib.nullcontext()


class BuildStrategy:
    """The pass toggles of ``BuildStrategy``, recorded: the executor runs
    the block's ops as they stand."""

    def __init__(self):
        self.enable_inplace = True
        self.memory_optimize = True
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.reduce_strategy = 0
        self.gradient_scale_strategy = 0


class ExecutionStrategy:
    """Thread and iteration knobs, recorded."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1


class ParallelExecutor:
    """``ParallelExecutor``'s surface over the one-device Executor."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 build_strategy=None, exec_strategy=None, scope=None,
                 share_vars_from=None):
        from ..framework import program as _fw

        self._program = main_program or _fw.default_main_program()
        self._exe = Executor()
        self._scope = scope

    def run(self, fetch_list=None, feed=None, return_numpy=True):
        return self._exe.run(self._program, feed=feed,
                             fetch_list=fetch_list, scope=self._scope,
                             return_numpy=return_numpy)


class WeightNormParamAttr:
    """``WeightNormParamAttr``'s surface, accepted."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.trainable = trainable


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """``paddle.static.py_func``: a host Python function as an op of the
    program (see :func:`paddle_tpu_torch.static.nn.py_func`)."""
    return nn.py_func(func, x, out, backward_func,
                      skip_vars_in_backward_input)


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """``paddle.static.Print``: prints the value when the op runs and
    passes it through."""
    from ..dygraph import tracer as _tr

    def fn(a):
        print((message or "") + str(a.detach().cpu()))
        return a

    return _tr.trace_fn(fn, [input], name="print")


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Batch AUC through ``paddle.metric.Auc``."""
    import numpy as _np

    from ..metric import Auc as _Auc
    from ..tensor_api import to_tensor

    m = _Auc(num_thresholds=num_thresholds)
    m.update(_np.asarray(input.numpy()), _np.asarray(label.numpy()))
    return to_tensor(_np.asarray(m.accumulate(), "float32"))


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()

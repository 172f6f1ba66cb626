"""FLAGS registry: global configuration bootstrapped from ``FLAGS_*``
environment variables.

Counterpart of ``paddle_tpu/framework/flags.py`` (``define_flag``,
``flag``, ``get_flags``, ``set_flags``, ``all_flags``, ``is_inert``).
The live flags are read where they act:

* ``FLAGS_check_nan_inf``: the eager tracer checks every op's outputs
  (:mod:`.nan_inf`);
* ``FLAGS_benchmark``: the tracer synchronizes the card after every op
  and opens a :class:`~paddle_tpu_torch.profiler.RecordEvent` span for
  it, and a ``RecordEvent`` synchronizes before it closes, so host spans
  measure the card's work and not the asynchronous enqueue;
* ``FLAGS_profiler_logdir``: where :func:`~paddle_tpu_torch.profiler.
  start_profiler` writes the device trace (under the temporary directory
  by default);
* ``FLAGS_tpu_matmul_precision``: fp32 matmul precision
  (``torch.set_float32_matmul_precision``: ``"float32"`` and
  ``"default"`` are ``highest``, ``"tensorfloat32"`` is ``high``,
  ``"bfloat16"`` is ``medium``); an fp32 conv on the card follows it,
  cuDNN's TF32 off at ``highest`` (``ops/nn_ops.py``), so the flag
  governs both.

The reference's flags that tune subsystems the port does not have
(allocator strategy, cudnn search, eager deletion ...) are accepted and
inert, so scripts that set them keep working.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Sequence, Union


class _FlagDef:
    __slots__ = ("name", "type", "default", "help", "writable", "inert",
                 "on_set")

    def __init__(self, name, type_, default, help_="", writable=True,
                 inert=False, on_set=None):
        self.name = name
        self.type = type_
        self.default = default
        self.help = help_
        self.writable = writable
        self.inert = inert
        self.on_set = on_set


_DEFS: Dict[str, _FlagDef] = {}
_VALUES: Dict[str, Any] = {}


def _parse(defn: _FlagDef, raw: Any) -> Any:
    if defn.type is bool:
        if isinstance(raw, str):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return bool(raw)
    return defn.type(raw)


def define_flag(name: str, default: Any, help: str = "", *, type: type = None,
                writable: bool = True, inert: bool = False,
                on_set=None) -> None:
    """Register a flag (and bootstrap its value from the environment)."""
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    defn = _FlagDef(name, type if type is not None else default.__class__,
                    default, help, writable, inert, on_set)
    _DEFS[name] = defn
    env = os.environ.get(name)
    value = _parse(defn, env) if env is not None else default
    _VALUES[name] = value
    if defn.on_set is not None and env is not None:
        defn.on_set(value)


def flag(name: str) -> Any:
    """A flag's value (KeyError on an unknown flag)."""
    return _VALUES[name]


def get_flags(flags: Union[str, Sequence[str]]) -> Dict[str, Any]:
    """``paddle.get_flags``: the values of one or many flags."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for n in flags:
        if n not in _VALUES:
            raise ValueError(f"Flag {n!r} is not registered "
                             f"(known: {len(_VALUES)} FLAGS_* names)")
        out[n] = _VALUES[n]
    return out


def set_flags(flags: Dict[str, Any]) -> None:
    """``paddle.set_flags``: update writable flags by name."""
    if not isinstance(flags, dict):
        raise TypeError("set_flags expects a dict of {flag_name: value}")
    for n, v in flags.items():
        defn = _DEFS.get(n)
        if defn is None:
            raise ValueError(f"Flag {n!r} is not registered")
        if not defn.writable:
            raise ValueError(f"Flag {n!r} is not public/writable")
        val = _parse(defn, v)
        _VALUES[n] = val
        if defn.on_set is not None:
            defn.on_set(val)


def all_flags() -> List[str]:
    return sorted(_DEFS)


def is_inert(name: str) -> bool:
    return _DEFS[name].inert


_PRECISION = {"": None, "default": "highest", "float32": "highest",
              "tensorfloat32": "high", "bfloat16": "medium"}


def _set_matmul_precision(v: str) -> None:
    if v not in _PRECISION:
        raise ValueError(f"FLAGS_tpu_matmul_precision: unknown {v!r}")
    if _PRECISION[v] is not None:
        import torch

        torch.set_float32_matmul_precision(_PRECISION[v])


define_flag("FLAGS_check_nan_inf", False,
            "check every eager op's outputs for NaN/Inf and raise naming "
            "the op")
define_flag("FLAGS_benchmark", False,
            "synchronize the card after every eager op (and before a "
            "RecordEvent closes), so host spans time the card's work")
define_flag("FLAGS_call_stack_level", 1,
            "error verbosity (accepted; the static executor it steers "
            "waits for graph mode)")
define_flag("FLAGS_tpu_flash_attention", True,
            "accepted: on the card, attention always launches the flash "
            "kernels where they apply, and raises otherwise", inert=True)
define_flag("FLAGS_tpu_matmul_precision", "",
            "fp32 matmul precision: one of '', 'default', 'bfloat16', "
            "'tensorfloat32', 'float32'; an fp32 conv on the card follows "
            "it (cuDNN's TF32 off at full fp32)", type=str,
            on_set=_set_matmul_precision)
define_flag("FLAGS_profiler_logdir",
            os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_profile"),
            "where the profiler writes its device trace")
define_flag("FLAGS_selected_tpus", "",
            "comma list of visible device indices", type=str)

for _name, _default in [
    ("FLAGS_allocator_strategy", "auto_growth"),
    ("FLAGS_eager_delete_tensor_gb", 0.0),
    ("FLAGS_fast_eager_deletion_mode", True),
    ("FLAGS_memory_fraction_of_eager_deletion", 1.0),
    ("FLAGS_fraction_of_gpu_memory_to_use", 0.92),
    ("FLAGS_initial_cpu_memory_in_mb", 500),
    ("FLAGS_init_allocated_mem", False),
    ("FLAGS_paddle_num_threads", 1),
    ("FLAGS_inner_op_parallelism", 0),
    ("FLAGS_cudnn_deterministic", False),
    ("FLAGS_cudnn_exhaustive_search", False),
    ("FLAGS_conv_workspace_size_limit", 512),
    ("FLAGS_sync_nccl_allreduce", True),
    ("FLAGS_fuse_parameter_groups_size", 3),
    ("FLAGS_fuse_parameter_memory_size", -1.0),
    ("FLAGS_check_kernel_launch", False),
    ("FLAGS_max_inplace_grad_add", 0),
    ("FLAGS_use_mkldnn", False),
    ("FLAGS_use_ngraph", False),
]:
    define_flag(_name, _default, "accepted for script compatibility; the "
                "subsystem it tunes is PyTorch's here", inert=True)

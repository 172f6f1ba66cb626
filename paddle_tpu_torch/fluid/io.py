"""``paddle.fluid.io``: save and load in the v2.1 signatures
(``save_inference_model`` by directory and feed names,
``save/load_params``, ``save/load_persistables``), the program-state
functions, and the DataLoader and reader helpers."""

from __future__ import annotations

import os

import numpy as np

from ..io import DataLoader, Dataset  # noqa: F401
from ..io_api import batch  # noqa: F401
from ..reader import shuffle  # noqa: F401
from ..static import io as _sio
from ..static import (  # noqa: F401
    load_program_state, set_program_state,
)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    """v2.1's form: a directory and the feed NAMES (2.x
    ``static.save_inference_model`` takes a path prefix and feed VARS)."""
    from ..framework import program as fw

    program = main_program or fw.default_main_program()
    block = program.global_block()
    feed_vars = [block.var(n) for n in feeded_var_names]
    prefix = os.path.join(dirname, model_filename or "__model__")
    _sio.save_inference_model(prefix, feed_vars, list(target_vars), executor,
                              program=program)
    return [v.name for v in target_vars]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    prefix = os.path.join(dirname, model_filename or "__model__")
    return _sio.load_inference_model(prefix, executor)


def save_params(executor, dirname, main_program=None, filename=None):
    _save_vars(executor, dirname, main_program, filename, params_only=True)


def save_persistables(executor, dirname, main_program=None, filename=None):
    _save_vars(executor, dirname, main_program, filename, params_only=False)


def _save_vars(executor, dirname, main_program, filename, params_only):
    from ..framework import program as fw
    from ..framework.scope import global_scope

    program = main_program or fw.default_main_program()
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    state = {}
    for var in program.global_block().vars.values():
        if not getattr(var, "persistable", False):
            continue
        if params_only and not isinstance(var, fw.Parameter):
            continue
        val = scope.find_var(var.name)
        if val is not None:
            state[var.name] = _sio._host(val)
    np.savez(os.path.join(dirname, filename or "__params__.npz"), **state)


def load_params(executor, dirname, main_program=None, filename=None):
    _load_vars(executor, dirname, main_program, filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    _load_vars(executor, dirname, main_program, filename)


def _load_vars(executor, dirname, main_program, filename):
    from ..framework import program as fw
    from ..framework.scope import global_scope

    program = main_program or fw.default_main_program()
    data = np.load(os.path.join(dirname, filename or "__params__.npz"))
    _sio._put(global_scope(), program, {n: data[n] for n in data.files},
              device=_sio._device_of(executor))

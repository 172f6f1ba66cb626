"""Static model save and load.

Counterpart of ``paddle_tpu/static/io.py``, format for format: the
program as JSON (:meth:`Program.to_dict`), the persistables as an
``.npz`` of numpy arrays (bf16 stored as fp32 and cast back to the
variable's dtype on load).  ``save_inference_model`` prunes the program
to the ops its fetches need, as the reference does.

:func:`set_program_state` carries weights across: given the reference's
scope arrays (numpy, by name) it puts them into this package's scope, on
the current place's device.  A static program built in the same order in
both packages gets the same parameter names from the unique-name
counters.
"""

from __future__ import annotations

import io as _io
import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..framework import program as fw
from ..framework.dtype import to_torch_dtype
from ..framework.place import current_device
from ..framework.scope import global_scope

__all__ = [
    "save", "load", "save_inference_model", "load_inference_model",
    "load_program_state", "set_program_state", "save_vars", "load_vars",
    "normalize_program", "serialize_program", "deserialize_program",
    "serialize_persistables", "deserialize_persistables",
]


def _host(v) -> np.ndarray:
    """A host copy of a scope value (bf16 and fp16 as fp32)."""
    if isinstance(v, torch.Tensor):
        from .executor import _to_numpy

        return _to_numpy(v)
    return np.array(v)


def _state_arrays(program: fw.Program, scope) -> dict:
    out = {}
    for var in program.list_vars():
        if not var.persistable:
            continue
        val = scope.find_var(var.name)
        if val is not None:
            out[var.name] = _host(val)
    return out


def _put(scope, program, arrays, names=None, device=None):
    """Set ``arrays`` (name -> numpy) into ``scope`` on ``device`` (the
    current place's by default), cast to the program's dtypes."""
    device = device if device is not None else current_device()
    dtypes = {v.name: v.dtype for v in program.list_vars()} if program else {}
    for name, arr in arrays.items():
        if names is not None and name not in names:
            continue
        t = torch.tensor(np.asarray(arr), device=device)
        if name in dtypes:
            t = t.to(to_torch_dtype(dtypes[name]))
        scope.set(name, t)


def _device_of(executor):
    return executor.place.torch_device() if executor is not None else None


def save(program: fw.Program, model_path: str, scope=None):
    """``paddle.static.save``: the program and its persistables."""
    scope = scope or global_scope()
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    with open(model_path + ".pdmodel.json", "w") as f:
        json.dump(program.to_dict(), f)
    np.savez(model_path + ".pdparams.npz", **_state_arrays(program, scope))


def load(program: fw.Program, model_path: str, executor=None, scope=None):
    """``paddle.static.load``: the persistables back into the scope."""
    scope = scope or global_scope()
    data = np.load(model_path + ".pdparams.npz", allow_pickle=False)
    _put(scope, program, {n: data[n] for n in data.files},
         device=_device_of(executor))


def _prune_for_inference(program, feed_names, fetch_names):
    """Keep the global block's ops that the fetch targets need (drops the
    loss, backward and optimizer ops)."""
    block = program.global_block()
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if any(o in needed for o in op.output_arg_names):
            keep.append(op)
            needed.update(n for n in op.input_arg_names
                          if n not in feed_names)
    keep.reverse()
    block.ops = keep


def save_inference_model(path_prefix: str, feed_vars: List[fw.Variable],
                         fetch_vars: List[fw.Variable], executor=None,
                         program: Optional[fw.Program] = None, scope=None):
    """The program cloned for test and pruned to ``fetch_vars``, and the
    persistables."""
    program = program or fw.default_main_program()
    infer_prog = program.clone(for_test=True)
    _prune_for_inference(infer_prog, [v.name for v in feed_vars],
                         [v.name for v in fetch_vars])
    meta = {"program": infer_prog.to_dict(),
            "feed_names": [v.name for v in feed_vars],
            "fetch_names": [v.name for v in fetch_vars]}
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with open(path_prefix + ".pdmodel.json", "w") as f:
        json.dump(meta, f)
    np.savez(path_prefix + ".pdparams.npz",
             **_state_arrays(program, scope or global_scope()))


def load_inference_model(path_prefix: str, executor=None, scope=None):
    """Returns (program, feed names, fetch names), the persistables loaded
    into the scope on the executor's device."""
    scope = scope or global_scope()
    with open(path_prefix + ".pdmodel.json") as f:
        meta = json.load(f)
    program = fw.Program.from_dict(meta["program"])
    data = np.load(path_prefix + ".pdparams.npz", allow_pickle=False)
    _put(scope, program, {n: data[n] for n in data.files},
         device=_device_of(executor))
    return program, meta["feed_names"], meta["fetch_names"]


def load_program_state(model_path: str, var_list=None) -> dict:
    """name -> numpy of a saved model's persistables."""
    data = np.load(model_path + ".pdparams.npz", allow_pickle=False)
    names = ({v.name for v in var_list} if var_list is not None
             else set(data.files))
    return {n: data[n] for n in data.files if n in names}


def set_program_state(program: fw.Program, state_dict: dict):
    """Put ``state_dict`` (name -> numpy, e.g. another package's scope
    arrays) into the global scope for the program's persistables, on the
    current place's device."""
    prog_vars = {v.name for v in program.list_vars() if v.persistable}
    _put(global_scope(), program,
         {n: _host(a) for n, a in state_dict.items()}, names=prog_vars)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Save the chosen persistables (all by default)."""
    program = main_program or fw.default_main_program()
    allv = [v for v in program.list_vars() if v.persistable]
    if vars is not None:
        chosen = list(vars)
    elif predicate is not None:
        chosen = [v for v in allv if predicate(v)]
    else:
        chosen = allv
    scope = global_scope()
    out = {}
    for v in chosen:
        val = scope.find_var(v.name)
        if val is not None:
            out[v.name] = _host(val)
    os.makedirs(dirname, exist_ok=True)
    np.savez(os.path.join(dirname, filename or "vars") + ".npz", **out)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Load what :func:`save_vars` saved (the chosen persistables)."""
    data = np.load(os.path.join(dirname, filename or "vars") + ".npz",
                   allow_pickle=False)
    program = main_program or fw.default_main_program()
    allv = {v.name for v in program.list_vars() if v.persistable}
    if vars is not None:
        allv = {v.name for v in vars}
    elif predicate is not None:
        allv = {v.name for v in program.list_vars()
                if v.persistable and predicate(v)}
    _put(global_scope(), program, {n: data[n] for n in data.files},
         names=allv, device=_device_of(executor))


def normalize_program(program: fw.Program, feed_vars, fetch_vars):
    """Prune ``program`` to the slice its feeds and fetches define (the
    same Program, pruned)."""
    feeds = [v.name if hasattr(v, "name") else v for v in feed_vars]
    fetches = [v.name if hasattr(v, "name") else v for v in fetch_vars]
    _prune_for_inference(program, feeds, fetches)
    return program


def serialize_program(feed_vars, fetch_vars, program=None, **kwargs) -> bytes:
    program = program or fw.default_main_program()
    d = program.to_dict()
    d["_feed_names"] = [v.name if hasattr(v, "name") else v
                        for v in feed_vars]
    d["_fetch_names"] = [v.name if hasattr(v, "name") else v
                         for v in fetch_vars]
    return json.dumps(d).encode("utf-8")


def deserialize_program(data: bytes) -> fw.Program:
    return fw.Program.from_dict(json.loads(bytes(data).decode("utf-8")))


def serialize_persistables(feed_vars, fetch_vars, executor=None,
                           program=None, **kwargs) -> bytes:
    program = program or fw.default_main_program()
    buf = _io.BytesIO()
    np.savez(buf, **_state_arrays(program, global_scope()))
    return buf.getvalue()


def deserialize_persistables(program: fw.Program, data: bytes,
                             executor=None):
    arrs = np.load(_io.BytesIO(bytes(data)), allow_pickle=False)
    _put(global_scope(), program, {n: arrs[n] for n in arrs.files},
         device=_device_of(executor))

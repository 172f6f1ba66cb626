"""The static Executor: runs a Program's global block op by op on torch
tensors on its device.

Counterpart of ``paddle_tpu/static/executor.py`` (which traces the whole
block into one jitted XLA function).  Here each op runs its registered
kernel through the registry, as the eager tracer does, so a block's
attention op launches the flash kernels on the card.  What the
reference gets from XLA is done by hand:

* **state in place.**  Persistables (parameters, optimizer state,
  BatchNorm statistics, the learning rate) live in the :class:`Scope`;
  the ops that write them (the optimizer's ``ParamOut``, BatchNorm's
  ``MeanOut``) rebind them for the rest of the step, and at its end the
  new values are copied into the scope's tensors in place (the
  counterpart of the reference's donation);
* **no forward twice.**  A grad op ``<type>_grad`` made by autograd
  would run its forward again (:func:`~paddle_tpu_torch.ops.registry.
  op_grad`).  When the block holds an op's grad op, the executor runs
  that forward keeping its autograd graph for the step
  (:func:`~paddle_tpu_torch.ops.registry.run_kept_forward`) and the
  grad op takes its gradients from it: one ``flash_fwd`` a layer a
  step.  A grad op whose forward was not kept runs its kernel;
* **dead values freed.**  Each value is dropped after its last reader
  (the role of the reference's garbage collector, ``executor_gc_helper``);
* **keys.**  A random op's key is folded from (the program's seed, the
  step, the op's index) by the splitmix64 chain of
  :mod:`paddle_tpu_torch.framework.random`: reproducible, and fresh every
  step.

The prepared op list (the pairing of forwards and grad ops, the
liveness, the state names) is cached per (program identity and version,
feed signature, fetch list), as the reference caches its compiled
function.  Feeds go to the executor's device; fetches come back to the
host (numpy with ``return_numpy``, else Tensors on the device); nothing
else crosses.  ``Executor()`` without a place takes the current place:
the card (``gpu:0``) unless ``set_device`` says otherwise.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework import program as fw
from ..framework import random as _random
from ..framework.dtype import to_torch_dtype
from ..framework.place import Place, _get_current_place, place_guard
from ..framework.scope import Scope, global_scope
from ..ops import registry

__all__ = ["Executor", "CompiledProgram", "as_compiled"]

# op types the runner itself handles
_SKIP_OPS = frozenset({"feed", "fetch"})


class _Prepared:
    """One block made ready to run for a feed signature and fetch list."""

    __slots__ = ("ops", "defs", "keep", "grad_src", "free_after",
                 "state_in", "out_state", "op_labels")


class Executor:
    """``paddle.static.Executor`` (see the module docstring)."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else _get_current_place()
        self._cache: Dict[Any, _Prepared] = {}
        self._step_counters: Dict[int, int] = {}
        # ops run by the last run() (the smoke's host cost per op reads it)
        self.last_run_ops = 0

    def run(self, program: Optional[fw.Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_program_cache: bool = True):
        if program is None:
            program = fw.default_main_program()
        inner = getattr(program, "_program", None)  # CompiledProgram
        if inner is not None:
            program = inner
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, fw.Variable) else str(v)
                       for v in fetch_list]
        block = program.global_block()

        from ..framework import flags

        check_nan = flags.flag("FLAGS_check_nan_inf")
        feed_sig = tuple((name, tuple(np.shape(val)), _dtype_name(val))
                         for name, val in sorted(feed.items()))
        key = (id(program), program._version, feed_sig, tuple(fetch_names),
               check_nan)
        prep = self._cache.get(key) if use_program_cache else None
        if prep is None:
            prep = self._prepare(block, set(feed), fetch_names, scope,
                                 check_nan)
            if use_program_cache:
                self._cache[key] = prep

        dev = self.place.torch_device()
        step_id = self._step_counters.get(id(program), 0)
        self._step_counters[id(program)] = step_id + 1
        step_key = _random.fold_in(_random.make_key(program.random_seed or 0),
                                   step_id)
        prof = sys.modules.get("paddle_tpu_torch.profiler")
        if prof is not None and prof.is_profiling():
            with prof.RecordEvent("executor_run"):
                fetches = self._run(prep, block, feed, fetch_names, scope,
                                    dev, step_key)
        else:
            fetches = self._run(prep, block, feed, fetch_names, scope, dev,
                                step_key)
        self.last_run_ops = len(prep.ops)
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        from ..dygraph.tensor import Tensor

        return [Tensor._wrap(f) for f in fetches]

    # ------------------------------------------------------------------
    def _run(self, prep, block, feed, fetch_names, scope, dev, step_key):
        env: Dict[str, torch.Tensor] = {}
        for n in prep.state_in:
            env[n] = self._state_tensor(scope, n, dev)
        for n, v in feed.items():
            env[n] = self._feed_tensor(v, block, n, dev)
        kept: Dict[int, registry.KeptForward] = {}
        oks = []
        with place_guard(self.place), torch.no_grad():
            for i, op in enumerate(prep.ops):
                op_def = prep.defs[i]
                ins = {}
                for slot, names in op.inputs.items():
                    vals = [env[n] for n in names if n]
                    if vals or slot in op_def.list_slots:
                        ins[slot] = vals
                rng = (_random.fold_in(step_key, i) if op_def.needs_rng
                       else None)
                try:
                    src = prep.grad_src.get(i)
                    handle = kept.pop(src, None) if src is not None else None
                    if handle is not None:
                        outs = handle.grads({
                            s[:-len(fw.GRAD_SUFFIX)]: v
                            for s, v in ins.items()
                            if s.endswith(fw.GRAD_SUFFIX)})
                    elif i in prep.keep:
                        outs, kept[i] = registry.run_kept_forward(
                            op_def, ins, op.attrs, rng)
                    else:
                        outs = registry.run_kernel(op_def, ins, op.attrs,
                                                   rng=rng)
                except Exception as e:
                    fw.raise_with_op_site(op, "failed to run", e)
                if prep.op_labels is not None:
                    from ..framework.nan_inf import op_all_finite

                    oks.append(op_all_finite(outs))
                for slot, names in op.outputs.items():
                    for n, v in zip(names, outs.get(slot, [])):
                        if n:
                            env[n] = v
                for n in prep.free_after[i]:
                    env.pop(n, None)
            if prep.op_labels is not None:
                from ..framework.nan_inf import raise_first_bad_op

                raise_first_bad_op(oks, prep.op_labels)
            for n in prep.out_state:
                v = env.get(n)
                if v is None:
                    continue
                cur = scope.find_var(n)
                if (isinstance(cur, torch.Tensor) and cur is not v
                        and cur.shape == v.shape and cur.dtype == v.dtype
                        and cur.device == v.device):
                    cur.copy_(v)
                else:
                    scope.set(n, v)
        return [env[n] for n in fetch_names]

    # ------------------------------------------------------------------
    def _prepare(self, block, feed_names, fetch_names, scope, check_nan):
        ops = [op for op in block.ops if op.type not in _SKIP_OPS]
        # a counted while_loop baked these fill_constant values into its
        # trip count; feeding them would be ignored silently
        for op in ops:
            baked = op.attrs.get("__trip_const_vars__")
            if baked:
                clash = feed_names.intersection(baked)
                if clash:
                    raise ValueError(
                        f"Executor.run: feed overrides {sorted(clash)}, but "
                        f"op {op.type!r} statically baked those fill_constant "
                        f"values into its loop trip count at build time. "
                        f"Build the loop bound from a data tensor (not a "
                        f"fed constant), or rebuild the program per bound.")

        # state in: what ops read that is neither fed nor produced before;
        # state out: the persistables the block writes
        produced = set()
        state_in: List[str] = []
        seen_in = set()
        for op in ops:
            for n in op.input_arg_names:
                if n in feed_names or n in produced or n in seen_in or not n:
                    continue
                var = block._var_recursive(n)
                seen_in.add(n)
                state_in.append(n)
                if not var.persistable and scope.find_var(n) is None:
                    where = (f"\nOp built at (FLAGS_call_stack_level>=2):\n"
                             f"{op.callstack}"
                             if getattr(op, "callstack", None) else "")
                    raise RuntimeError(
                        f"Op {op.type} reads variable {n!r} which is neither "
                        f"fed, produced earlier, nor present in the scope"
                        + where)
            for n in op.output_arg_names:
                if n:
                    produced.add(n)
        out_state = []
        for n in sorted(produced):
            try:
                var = block._var_recursive(n)
            except ValueError:
                continue
            if var.persistable:
                out_state.append(n)
        # fetches that no op touches are read from the scope
        for n in fetch_names:
            if n not in produced and n not in feed_names and n not in seen_in:
                seen_in.add(n)
                state_in.append(n)

        defs = [registry.get_op_def(op.type) for op in ops]
        # pair each auto grad op with its forward (the op of the forward's
        # type that last wrote the variable whose gradient it reads)
        keep, grad_src = set(), {}
        producer: Dict[str, int] = {}
        for i, op in enumerate(ops):
            fwd_type = op.type[:-len("_grad")]
            if op.type.endswith("_grad") and registry.is_registered(fwd_type):
                fwd_def = registry.get_op_def(fwd_type)
                if fwd_def.grad_maker is None and not fwd_def.no_grad:
                    src = None
                    for slot, names in op.inputs.items():
                        if slot.endswith(fw.GRAD_SUFFIX) and names:
                            j = producer.get(names[0][:-len(fw.GRAD_SUFFIX)])
                            if j is not None and ops[j].type == fwd_type:
                                src = j
                            break
                    if src is not None and src not in keep:
                        keep.add(src)
                        grad_src[i] = src
            for n in op.output_arg_names:
                if n:
                    producer[n] = i

        # free each value after its last reader (fetches and written
        # persistables stay until the end)
        last: Dict[str, int] = {}
        for i, op in enumerate(ops):
            for n in op.input_arg_names + op.output_arg_names:
                if n:
                    last[n] = i
        hold = set(fetch_names) | set(out_state)
        free_after: List[List[str]] = [[] for _ in ops]
        for n, i in last.items():
            if n not in hold:
                free_after[i].append(n)

        prep = _Prepared()
        prep.ops, prep.defs, prep.keep, prep.grad_src = ops, defs, keep, grad_src
        prep.free_after, prep.state_in, prep.out_state = (
            free_after, state_in, out_state)
        prep.op_labels = ([
            f"{op.type}({', '.join(n for ns in op.outputs.values() for n in ns if n)})"
            for op in ops] if check_nan else None)
        return prep

    # ------------------------------------------------------------------
    def _state_tensor(self, scope, name, dev) -> torch.Tensor:
        v = scope.find_var(name)
        if v is None:
            raise RuntimeError(
                f"Persistable variable {name!r} is not initialized; run the "
                f"startup program first (exe.run(startup_program))")
        if isinstance(v, torch.Tensor):
            if v.device != dev:
                raise RuntimeError(
                    f"scope variable {name!r} lives on {v.device} but this "
                    f"executor runs on {dev}: run its startup program with "
                    f"this executor, or set it with set_program_state under "
                    f"this place")
            return v
        # host data set into the scope (numpy): to the device, once
        t = torch.tensor(np.asarray(getattr(v, "_t", v)), device=dev)
        scope.set(name, t)
        return t

    def _feed_tensor(self, val, block, name, dev) -> torch.Tensor:
        try:
            dtype = to_torch_dtype(block._var_recursive(name).dtype)
        except ValueError:
            dtype = None
        t = getattr(val, "_t", val)  # a port Tensor
        if isinstance(t, torch.Tensor):
            if t.device != dev:
                raise RuntimeError(
                    f"feed {name!r} lives on {t.device} but this executor "
                    f"runs on {dev}")
            return t if dtype is None else t.to(dtype)
        arr = np.asarray(t)
        t = torch.as_tensor(arr, device=dev)
        return t if dtype is None else t.to(dtype)

    def close(self):
        self._cache.clear()


def _dtype_name(val) -> str:
    d = getattr(val, "dtype", None)
    return str(d) if d is not None else str(np.asarray(val).dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a tensor the scope updates in
    place); bf16 and fp16 as fp32."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    elif t.device.type == "cpu":
        t = t.clone()
    return t.cpu().numpy()


class CompiledProgram:
    """``fluid.compiler.CompiledProgram``: the executor already prepares
    whole programs, and data parallelism runs through
    ``paddle.distributed``, so this wraps the program."""

    def __init__(self, program: fw.Program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy

    def with_data_parallel(self, loss_name=None, **kwargs):
        return self


def as_compiled(program):
    return CompiledProgram(program)

"""Control-flow ops: ``while_loop`` and ``cond``.

Counterpart of ``paddle_tpu/static/control_flow.py``.  In dygraph mode
both are plain Python control flow over eager tensors.  In static mode
the branch or body is built into a list of ops (the reference's
sub-block) and run by a one-off op of the program (registered with
:func:`~paddle_tpu_torch.ops.registry.register_ephemeral`):

* ``cond``'s op reads its predicate back to the host (one sync a
  branch) and runs the taken branch's ops;
* ``while_loop``'s op runs its body while the condition holds, reading
  the condition on the host each trip.  A counted ``i < N`` loop (its
  counter and bound ``fill_constant``s, its step a positive constant:
  the reference's trip-count inference) runs its body a known number of
  times and is differentiable, since torch autograd records the trips;
  a dynamic loop on the gradient path raises the reference's message
  (``static/backward.py``).

Shape inference runs these ops on ``meta`` tensors: the loop keeps its
variables' shapes and ``cond`` takes the true branch's.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..framework import program as fw
from ..ops import registry

__all__ = ["while_loop", "cond"]

_cf_counter = [0]


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _capture(fn, args):
    """Run a branch/body builder under the current block and pop the ops it
    appended (the sub-Block of while_op/conditional_block_op)."""
    block = fw.default_main_program().current_block()
    start = len(block.ops)
    outs = fn(*args)
    ops = list(block.ops[start:])
    del block.ops[start:]
    return _as_list(outs), outs if isinstance(outs, (list, tuple)) or outs is None else outs, ops


def _externals(op_lists, exclude):
    """Names read by the captured ops but produced outside them."""
    produced = set(exclude)
    ext: List[str] = []
    for ops in op_lists:
        inner = set()
        for op in ops:
            for n in op.input_arg_names:
                if n and n not in produced and n not in inner and n not in ext:
                    ext.append(n)
            for n in op.output_arg_names:
                if n:
                    inner.add(n)
        produced |= inner
    return ext


def _run_ops(ops, env):
    """Run captured ops on an env of tensors (the executor's inner loop)."""
    for op in ops:
        op_def = registry.get_op_def(op.type)
        ins = {}
        for slot, names in op.inputs.items():
            vals = [env[n] for n in names if n]
            if vals or slot in op_def.list_slots:
                ins[slot] = vals
        outs = registry.run_kernel(op_def, ins, op.attrs, rng=None)
        for slot, names in op.outputs.items():
            for n, v in zip(names, outs.get(slot, [])):
                if n:
                    env[n] = v
    return env


def _const_value(name, blocks, _depth=0):
    """Constant produced for ``name``: a fill_constant (scalar or
    1-element list value), seen through ``assign``/``cast`` chains (the
    dy2static promotion path emits assign-of-fill_constant)."""
    if _depth > 8:
        return None
    for block in blocks:
        for op in block.ops:
            if name not in op.output_arg_names:
                continue
            if op.type == "fill_constant":
                v = op.attrs.get("value")
                if isinstance(v, (list, tuple)):
                    flat = np.asarray(v).reshape(-1)
                    return float(flat[0]) if flat.size == 1 else None
                return float(v)
            if op.type in ("assign", "cast"):
                src = (op.inputs.get("X") or [None])[0]
                if src:
                    return _const_value(src, blocks, _depth + 1)
    return None


def _infer_trip_count(cond_ops, cond_out_name, body_ops, body_out_names,
                      loop_names):
    """Static trip count for counted loops.

    Recognized forms:
      cond:  ``less_than(i, N)`` / ``less_equal(i, N)`` with ``i`` a loop var
             and both ``i``'s init and ``N`` produced by ``fill_constant``;
      body:  ``i = scale(i, scale=1, bias=step)`` or
             ``i = elementwise_add(i, fill_constant(step))`` with step > 0.

    Returns ``(trip_count, const_var_names, None)`` on success or
    ``(None, [], reason)`` explaining why the loop stays dynamic — the reason
    is surfaced by ``append_backward`` when a gradient is requested.
    """
    producer = {n: op for op in cond_ops for n in op.output_arg_names}
    last = producer.get(cond_out_name)
    if last is None:
        return None, [], "loop condition is not produced inside cond_fn"
    if last.type not in ("less_than", "less_equal"):
        return None, [], (
            f"loop condition op is {last.type!r}; only less_than/less_equal "
            f"comparisons against a constant bound are recognized as counted")
    inclusive = last.type == "less_equal"
    x = (last.inputs.get("X") or [None])[0]
    y = (last.inputs.get("Y") or [None])[0]
    if x not in loop_names:
        return None, [], (
            f"comparison LHS {x!r} is not a loop variable — the counter must "
            f"be one of loop_vars")
    blocks = [fw.default_main_program().global_block(),
              fw.default_startup_program().global_block(),
              _FakeBlock(cond_ops)]  # bound may be built inside cond_fn
    bound = _const_value(y, blocks)
    init = _const_value(x, blocks)
    if bound is None or init is None:
        missing = y if bound is None else x
        return None, [], (
            f"{missing!r} is not a fill_constant — counter init and bound "
            f"must be compile-time constants for a static trip count")
    idx = loop_names.index(x)
    out_name = body_out_names[idx]
    step = None
    for op in body_ops:
        if out_name in op.output_arg_names:
            if op.type == "scale" and (op.inputs.get("X") or [None])[0] == x:
                if float(op.attrs.get("scale", 1.0)) == 1.0:
                    step = float(op.attrs.get("bias", 0.0))
            elif op.type in ("elementwise_add", "elementwise_sub"):
                a = (op.inputs.get("X") or [None])[0]
                b = (op.inputs.get("Y") or [None])[0]
                other = b if a == x else (a if b == x else None)
                if other is not None:
                    c = _const_value(other, blocks + [_FakeBlock(body_ops)])
                    if c is not None:
                        step = -c if op.type == "elementwise_sub" else c
            break
    if step is None:
        return None, [], (
            f"counter update for {x!r} is not ``scale(bias=step)`` or "
            f"``elementwise_add(i, const)`` — cannot derive a static step")
    if step <= 0:
        return None, [], f"counter step {step} is not positive"
    trips = math.ceil((bound + (1 if inclusive else 0) - init) / step)
    return max(int(trips), 0), [x, y], None


class _FakeBlock:
    """Adapter so _const_value can also scan body ops for constants."""

    def __init__(self, ops):
        self.ops = ops


def _register_one_off(op_type, kernel, no_grad=False, **kw):
    """A one-off op def; the owning Operator keeps it alive through
    ``op._ephemeral_def`` (the registry holds it weakly)."""
    return registry.register_ephemeral(registry.OpDef(
        type=op_type, kernel=kernel,
        list_slots=kw.pop("list_slots", {"X", "Captured", "Out"}),
        no_grad=no_grad, **kw,
    ))


def while_loop(cond: Callable, body: Callable, loop_vars: Sequence,
               is_test: bool = False, name: Optional[str] = None):
    """``paddle.static.nn.while_loop``: ``loop_vars = body(*loop_vars)``
    while ``cond(*loop_vars)``."""
    loop_vars = _as_list(loop_vars)
    if not loop_vars:
        raise ValueError("loop_vars must not be empty")

    if fw.in_dygraph_mode():
        pred = cond(*loop_vars)
        while bool(np.asarray(pred.numpy()).reshape(-1)[0]):
            out = _as_list(body(*loop_vars))
            if len(out) != len(loop_vars):
                raise ValueError(
                    f"body returned {len(out)} vars, expected {len(loop_vars)}")
            loop_vars = out
            pred = cond(*loop_vars)
        return loop_vars

    from ..ops.dispatch import dispatch_static

    block = fw.default_main_program().current_block()
    cond_outs, _, cond_ops = _capture(cond, loop_vars)
    body_outs, _, body_ops = _capture(body, loop_vars)
    if len(body_outs) != len(loop_vars):
        raise ValueError(
            f"body returned {len(body_outs)} vars, expected {len(loop_vars)}")
    loop_names = [v.name for v in loop_vars]
    body_out_names = [v.name for v in body_outs]
    cond_out_name = cond_outs[0].name
    ext_names = _externals([cond_ops, body_ops], set(loop_names))
    ext_vars = [block._var_recursive(n) for n in ext_names]

    if is_test:
        trip, const_vars, why = None, [], "is_test=True loops stay dynamic"
    else:
        trip, const_vars, why = _infer_trip_count(
            cond_ops, cond_out_name, body_ops, body_out_names, loop_names)

    n_loop = len(loop_vars)

    def kernel(kins, attrs):
        xs = tuple(kins["X"])
        if any(t.device.type == "meta" for t in xs):
            return {"Out": list(xs)}  # shape inference: the loop keeps shapes
        exts = dict(zip(ext_names, kins.get("Captured", [])))

        def run_body(carry):
            env = dict(exts)
            env.update(zip(loop_names, carry))
            env = _run_ops(body_ops, env)
            return tuple(env[n] for n in body_out_names)

        def run_cond(carry):
            env = dict(exts)
            env.update(zip(loop_names, carry))
            env = _run_ops(cond_ops, env)
            return bool(env[cond_out_name].reshape(()))

        out = xs
        if trip is not None:
            # a counted loop: a known number of trips (differentiable)
            for _ in range(trip):
                out = run_body(out)
        else:
            while run_cond(out):
                out = run_body(out)
        return {"Out": list(out)}

    _cf_counter[0] += 1
    op_type = f"__while_{_cf_counter[0]}"
    # a dynamic loop has no gradient: no_grad makes append_backward raise
    # its message (carrying ``why``)
    od = _register_one_off(op_type, kernel, no_grad=(trip is None))
    attrs = {"trip_count": -1 if trip is None else trip}
    if trip is None:
        attrs["__no_fori_reason__"] = why
    else:
        # the trip count baked these fill_constant values in; the executor
        # refuses a feed of them
        attrs["__trip_const_vars__"] = list(const_vars)
    outs = dispatch_static(
        op_type, {"X": loop_vars, "Captured": ext_vars}, attrs,
    )["Out"]
    block.ops[-1]._ephemeral_def = od
    return outs[:n_loop]


def cond(pred, true_fn: Optional[Callable] = None,
         false_fn: Optional[Callable] = None, name: Optional[str] = None):
    """``paddle.static.nn.cond``: ``true_fn()`` if ``pred`` else
    ``false_fn()``."""
    if fw.in_dygraph_mode():
        taken = bool(np.asarray(pred.numpy()).reshape(-1)[0])
        fn = true_fn if taken else false_fn
        return fn() if fn is not None else None

    from ..ops.dispatch import dispatch_static

    block = fw.default_main_program().current_block()
    true_outs, _, true_ops = _capture(true_fn, ()) if true_fn else ([], None, [])
    false_outs, _, false_ops = _capture(false_fn, ()) if false_fn else ([], None, [])
    if len(true_outs) != len(false_outs):
        raise ValueError(
            f"true_fn returned {len(true_outs)} vars but false_fn returned "
            f"{len(false_outs)} — branch outputs must match")
    if not true_outs:
        return None
    t_names = [v.name for v in true_outs]
    f_names = [v.name for v in false_outs]
    ext_names = _externals([true_ops, false_ops], set())
    # identity pass-throughs: a branch may RETURN a pre-existing var without
    # creating any op (e.g. the untaken side of a converted break-flag if);
    # those names must ride in as captured externals too
    for names, ops in ((t_names, true_ops), (f_names, false_ops)):
        produced = {n for op in ops for n in op.output_arg_names}
        for n in names:
            if n not in produced and n not in ext_names:
                ext_names.append(n)
    ext_vars = [block._var_recursive(n) for n in ext_names]
    single = len(true_outs) == 1

    def kernel(kins, attrs):
        p = kins["Cond"][0]
        # the predicate is read on the host (shape inference, on meta
        # tensors, takes the true branch)
        taken = True if p.device.type == "meta" else bool(p.reshape(()))
        env = dict(zip(ext_names, kins.get("Captured", [])))
        if taken:
            env = _run_ops(true_ops, env)
            return {"Out": [env[n] for n in t_names]}
        env = _run_ops(false_ops, env)
        return {"Out": [env[n] for n in f_names]}

    _cf_counter[0] += 1
    op_type = f"__cond_{_cf_counter[0]}"
    od = _register_one_off(
        op_type, kernel, list_slots={"Cond", "Captured", "Out"},
        nondiff_slots={"Cond"},
    )
    outs = dispatch_static(
        op_type, {"Cond": [pred], "Captured": ext_vars}, {})["Out"]
    block.ops[-1]._ephemeral_def = od
    return outs[0] if single else outs

"""Shared by the graph-mode tests: one program built in both packages,
run by both Executors from the same weights.

:func:`build` runs ``fn(P, static)`` under a fresh program pair and fresh
unique-name counters in static mode, so both packages name their
parameters and temporaries alike (``linear_0.w_0``, ``matmul_v2_out_0``).
:func:`run_both` runs the reference's startup program, carries its scope
arrays into the port with ``static.set_program_state`` and steps both.
One-off op types (``__pyfunc_getitem_7``) carry a process-wide counter;
:func:`op_list` numbers them by their order in the program instead.

The reference's static ``Variable`` has no indexing, so its BERT (which
takes ``qkv[0]``) does not build; :func:`reference_variable_indexing`
gives it the port's Variable indexing: a basic index (ints, unit-step
slices) as the registered ``slice`` op, any other as a one-off op of
its eager Tensor's indexing.
"""

import re

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu import static as jst
from paddle_tpu.dygraph import tracer as jtracer
from paddle_tpu.dygraph.tensor import _normalize_index as j_normalize_index
from paddle_tpu.framework import program as jfw
from paddle_tpu.ops.dispatch import dispatch_static as jdispatch_static
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard

import paddle_tpu_torch as tp
from paddle_tpu_torch import tensor_api
from paddle_tpu_torch import static as tst
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.framework.scope import Scope as TScope
from paddle_tpu_torch.framework.scope import scope_guard as tscope_guard

PKGS = {"ref": (jp, jst, jnames), "port": (tp, tst, tnames)}


def _reference_getitem(self, idx):
    """The port's Variable indexing, in the reference's ops: a basic
    index is its registered ``slice`` op, any other a one-off op."""
    attrs = tensor_api.slice_attrs(idx, len(self.shape))
    if attrs is None:
        return jtracer.trace_fn(lambda a: a[j_normalize_index(idx)], [self],
                                name="getitem")
    if not attrs["axes"]:
        return self
    return jdispatch_static("slice", {"Input": [self]}, attrs)["Out"][0]


def give_reference_variable_indexing(monkeypatch):
    monkeypatch.setattr(jfw.Variable, "__getitem__", _reference_getitem,
                        raising=False)


@pytest.fixture
def reference_variable_indexing(monkeypatch):
    give_reference_variable_indexing(monkeypatch)


def build(pkg, fn):
    """``fn(P, static)`` in static mode under a fresh program pair and
    fresh unique names; returns (main, startup, fn's result)."""
    P, st, names = PKGS[pkg]
    main, startup = st.Program(), st.Program()
    P.enable_static()
    try:
        with st.program_guard(main, startup), names.guard():
            out = fn(P, st)
    finally:
        P.disable_static()
    return main, startup, out


_ONE_OFF = re.compile(r"(__[a-z]+(?:_[a-z]+)*?)_(\d+)(?=_|$|@)")


def _renumber(program):
    """A name mapper that numbers one-off op types (``__pyfunc_getitem_7``,
    a process-wide counter) by their order in ``program``, in the names of
    the ops and of their outputs alike."""
    order = {}
    for op in program.global_block().ops:
        m = _ONE_OFF.match(op.type)
        if m and m.group(0) not in order:
            order[m.group(0)] = f"{m.group(1)}#{len(order)}"
    return lambda name: _ONE_OFF.sub(
        lambda m: order.get(m.group(0), m.group(0)), name)


def op_list(program):
    """(type, inputs, outputs) of each op of the global block, one-off
    types numbered by their order in the program."""
    norm = _renumber(program)
    return [(norm(op.type),
             {k: [norm(n) for n in v] for k, v in op.inputs.items()},
             {k: [norm(n) for n in v] for k, v in op.outputs.items()})
            for op in program.global_block().ops]


def var_table(program):
    norm = _renumber(program)
    return {norm(n): (tuple(v.shape), v.dtype, v.persistable,
                      v.stop_gradient)
            for n, v in program.global_block().vars.items()}


def scope_arrays(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.local_names()
            if scope.find_var(n) is not None}


def run_both(fn, feeds, fetch, steps=1, programs=None):
    """Build ``fn`` in both packages (or take ``programs``: the two
    (main, startup, out) triples), run the reference's startup, carry its
    values into the port, and run ``steps`` steps of each; ``feeds(i)``
    is step i's feed dict, ``fetch(out)`` the fetch list.  Returns (the
    reference's fetches, the port's fetches), a list per step."""
    (jm, js, jo), (tm, ts, to) = programs or (build("ref", fn),
                                              build("port", fn))
    with jscope_guard(JScope()):
        jexe = jst.Executor(jp.CPUPlace())
        jexe.run(js)
        state = scope_arrays(jst.global_scope())
        got_j = [jexe.run(jm, feed=feeds(i), fetch_list=fetch(jo))
                 for i in range(steps)]
    with tscope_guard(TScope()):
        texe = tst.Executor(tp.CPUPlace())
        texe.run(ts)
        tst.set_program_state(tm, state)
        got_t = [texe.run(tm, feed=feeds(i), fetch_list=fetch(to))
                 for i in range(steps)]
    return got_j, got_t

"""Op dispatch: every ``paddle.*`` and ``paddle.nn.functional.*`` function
funnels through :func:`dispatch`, which runs the op eagerly in dygraph
mode (:func:`dispatch_dygraph`, the tracer) and appends it to a
``Program`` in static mode (:func:`dispatch_static`): one registered
kernel for both.

Counterpart of ``paddle_tpu/ops/dispatch.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..framework import program as fw
from ..framework import unique_name
from . import registry


def dispatch_static(
    op_type: str,
    inputs: Dict[str, List[Any]],
    attrs: Dict[str, Any],
    block: Optional[fw.Block] = None,
    outputs: Optional[Dict[str, List[Any]]] = None,
    stop_gradient: bool = False,
) -> Dict[str, List[fw.Variable]]:
    """Append an op to the current (or given) block; without ``outputs``
    it makes one output Variable per value the kernel returns, named
    ``<op_type>_<slot>_N``."""
    if block is None:
        block = fw.default_main_program().current_block()
    op_def = registry.get_op_def(op_type)
    norm_in: Dict[str, List[fw.Variable]] = {}
    for slot, vals in inputs.items():
        if vals is None:
            continue
        if isinstance(vals, (fw.Variable, str)):
            vals = [vals]
        vs = [block._var_recursive(v) if isinstance(v, str) else v
              for v in vals]
        if vs:
            norm_in[slot] = vs
    if outputs is None:
        ins_structs = {
            slot: [registry.ShapeDtype(
                tuple(registry._PROBE_A if (s is None or s < 0) else s
                      for s in v.shape), v.dtype) for v in vs]
            for slot, vs in norm_in.items()
        }
        try:
            out_shapes = registry.abstract_eval(op_def, ins_structs, attrs)
        except Exception as e:
            shapes = {s: [tuple(v.shape) for v in vs]
                      for s, vs in norm_in.items()}
            raise RuntimeError(
                f"op {op_type!r} failed shape inference for inputs "
                f"{shapes}: {e}") from e
        outputs = {}
        for slot, vals in out_shapes.items():
            outputs[slot] = [
                block.create_var(
                    name=unique_name.generate(f"{op_type}_{slot.lower()}"),
                    stop_gradient=stop_gradient)
                for _ in range(len(vals))
            ]
    block.append_op(
        type=op_type,
        inputs={s: [v.name for v in vs] for s, vs in norm_in.items()},
        outputs={s: [getattr(v, "name", v) for v in vs]
                 for s, vs in outputs.items()},
        attrs=attrs,
    )
    return {slot: [v if isinstance(v, fw.Variable)
                   else block._var_recursive(getattr(v, "name", v))
                   for v in vs]
            for slot, vs in outputs.items()}


def dispatch_dygraph(op_type: str, inputs: Dict[str, List[Any]],
                     attrs: Dict[str, Any]) -> Dict[str, List[Any]]:
    """Eager execution through the dygraph tracer."""
    from ..dygraph import tracer

    return tracer.trace_op(op_type, inputs, attrs)


def dispatch(op_type: str, inputs: Dict[str, Any], attrs: Dict[str, Any],
             **kw):
    if fw.in_dygraph_mode():
        return dispatch_dygraph(op_type, inputs, attrs)
    return dispatch_static(op_type, inputs, attrs, **kw)


def single(out, slot: str = "Out"):
    """The single output tensor (or Variable) of a dispatch result."""
    v = out[slot]
    return v[0] if isinstance(v, (list, tuple)) else v

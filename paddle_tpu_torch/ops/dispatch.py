"""Op dispatch: every ``paddle.*`` and ``paddle.nn.functional.*`` function
funnels through :func:`dispatch`.

Counterpart of ``paddle_tpu/ops/dispatch.py``, with only its dygraph
branch: the port runs eagerly, and the static branch
(``dispatch_static``, ops appended to a ``Program``) waits for graph mode
(ROADMAP A.10).
"""

from __future__ import annotations

from typing import Any, Dict, List


def dispatch_dygraph(op_type: str, inputs: Dict[str, List[Any]],
                     attrs: Dict[str, Any]) -> Dict[str, List[Any]]:
    """Eager execution through the dygraph tracer."""
    from ..dygraph import tracer

    return tracer.trace_op(op_type, inputs, attrs)


def dispatch(op_type: str, inputs: Dict[str, Any], attrs: Dict[str, Any],
             **kw):
    return dispatch_dygraph(op_type, inputs, attrs)


def single(out, slot: str = "Out"):
    """The single output tensor of a dispatch result."""
    v = out[slot]
    return v[0] if isinstance(v, (list, tuple)) else v

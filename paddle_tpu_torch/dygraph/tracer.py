"""The eager op tracer.

Counterpart of ``paddle_tpu/dygraph/tracer.py`` (``trace_op``,
``trace_fn``, ``run_eager_kernel``).  :func:`trace_op` makes the
reference's per-op decisions (its ``tracer.py:183-260``), in its order:

1. inputs that are not Tensors become constant ones;
2. under ``amp.auto_cast`` the amp hook casts the inputs
   (:func:`paddle_tpu_torch.amp.auto_cast.maybe_autocast_inputs`);
3. an op flagged ``needs_rng`` takes the next key of the seed chain;
4. with ``FLAGS_benchmark`` (or while the profiler collects) the op runs
   inside a :class:`~paddle_tpu_torch.profiler.RecordEvent` span of its
   name, and ``FLAGS_benchmark`` synchronizes the card after it;
5. ``FLAGS_check_nan_inf`` checks its outputs;
6. outputs need a gradient when gradients are on, the op has one and a
   differentiable input needs one; the ``nondiff_out_slots`` never do.

The tape is torch autograd: the kernel runs on the inputs' torch tensors
and autograd records it, or, for an op with a hand-written grad op, the
registry's :func:`~paddle_tpu_torch.ops.registry.apply_hand_grad` does.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Dict, List

import torch

from ..framework import flags
from ..ops import registry

_state = threading.local()


def has_grad() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(flag: bool) -> bool:
    old = torch.is_grad_enabled()
    torch.set_grad_enabled(bool(flag))
    return old


def amp_state():
    return getattr(_state, "amp", None)


def set_amp_state(st) -> None:
    _state.amp = st


def _prof_active() -> bool:
    prof = sys.modules.get("paddle_tpu_torch.profiler")
    return prof is not None and prof.is_profiling()


def run_eager_kernel(op_type: str, ins: Dict[str, List[Any]],
                     attrs: Dict[str, Any], rng=None):
    """A registered kernel over raw torch tensors, without gradient
    (initializers and optimizer updates)."""
    with torch.no_grad():
        return registry.run_kernel(registry.get_op_def(op_type), ins, attrs,
                                   rng=rng)


def _run(op_def, ins, attrs, rng, requires_grad):
    if not requires_grad:
        with torch.no_grad():
            return registry.run_kernel(op_def, ins, attrs, rng=rng)
    if op_def.grad_maker is not None:
        return registry.apply_hand_grad(op_def, ins, attrs, rng)
    if op_def.nondiff_slots:
        ins = {s: [t.detach() for t in v] if s in op_def.nondiff_slots else v
               for s, v in ins.items()}
    return registry.run_kernel(op_def, ins, attrs, rng=rng)


def trace_op(op_type: str, inputs: Dict[str, Any], attrs: Dict[str, Any]):
    """Run one op eagerly; returns slot -> list of Tensors."""
    from .tensor import Tensor

    op_def = registry.get_op_def(op_type)
    norm: Dict[str, List[Tensor]] = {}
    for slot, vals in inputs.items():
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        ts = [v if isinstance(v, Tensor) else Tensor(v)
              for v in vals if v is not None]
        if ts or slot in op_def.list_slots:
            norm[slot] = ts

    amp = amp_state()
    if amp is not None:
        from ..amp.auto_cast import maybe_autocast_inputs

        norm, attrs = maybe_autocast_inputs(amp, op_type, norm, attrs)

    ins = {slot: [t._t for t in ts] for slot, ts in norm.items()}
    rng = None
    if op_def.needs_rng:
        from ..framework.random import next_rng_key

        rng = next_rng_key()

    requires_grad = (torch.is_grad_enabled() and not op_def.no_grad and any(
        t.requires_grad for slot, ts in ins.items()
        if slot not in op_def.nondiff_slots for t in ts))
    bench = flags.flag("FLAGS_benchmark")
    if bench or _prof_active():
        from ..profiler import RecordEvent

        with RecordEvent(op_type):
            outs = _run(op_def, ins, attrs, rng, requires_grad)
            if bench and torch.cuda.is_available() \
                    and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    else:
        outs = _run(op_def, ins, attrs, rng, requires_grad)

    if flags.flag("FLAGS_check_nan_inf"):
        from ..framework.nan_inf import assert_all_finite_eager

        assert_all_finite_eager(op_type, outs)

    nondiff = op_def.nondiff_out_slots
    return {slot: [Tensor._wrap(v.detach() if slot in nondiff else v)
                   for v in vals] for slot, vals in outs.items()}


def trace_fn(fn, tensors: List, name: str = "pyfunc"):
    """``fn`` over the tensors' torch tensors, recorded by autograd (the
    composite surface functions: indexing, in-place helpers); returns a
    Tensor, or a list for several outputs."""
    from .tensor import Tensor

    out = fn(*[t._t for t in tensors])
    if isinstance(out, (list, tuple)):
        return [Tensor._wrap(o) for o in out]
    return Tensor._wrap(out)

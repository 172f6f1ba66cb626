"""op_audit: the recorder behind the port's dispatch contracts.

Counterpart of ``paddle_tpu/analysis/jaxpr_audit.py``.  Where the
reference walks a jaxpr, the port records what a call dispatches: under
:func:`record`, a ``TorchDispatchMode`` appends one :class:`OpEvent` per
aten op that reaches the dispatcher (its overload packet name, e.g.
``aten.mm``, and the dtypes of its tensor inputs and outputs), in order.

The recorder does not descend into the kernels' wrappers: each call of a
flash, paged or W8A8 entry point (``KERNEL_ENTRIES``: the CUDA wrappers
and their plain versions) is ONE event of kind ``"kernel"`` named after
the entry, and the ops inside it are not recorded — as ``jaxpr_audit``
stops inside ``pallas_call``: a transpose inside a kernel's plain version
is the kernel's own arithmetic, not a layout change around the call.
Entries are intercepted where the port calls them through their module's
globals (``flash.flash_fwd`` from inside ``flash.py``, ...).

Helpers: :func:`count_op`, :func:`assert_no_op`, :func:`assert_no_transpose`
(no permute, transpose or materialising copy outside the kernel events),
:func:`assert_ops_identical` and :func:`find_f64`.
"""

from __future__ import annotations

import contextlib
import importlib
from collections import Counter
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpEvent", "Recording", "record", "count_op", "count_ops",
           "assert_no_op", "assert_no_transpose", "assert_ops_identical",
           "find_f64", "KERNEL_ENTRIES", "TRANSPOSE_OPS"]

#: the kernels' entry points, by module: each call is one kernel event
KERNEL_ENTRIES = {
    "paddle_tpu_torch.kernels.flash": (
        "flash_fwd", "flash_bwd", "flash_fwd_cuda", "flash_bwd_dq_cuda",
        "flash_bwd_dkv_cuda", "flash_fwd_plain", "flash_bwd_plain"),
    "paddle_tpu_torch.kernels.paged_attention": (
        "paged_attention", "paged_attention_mq", "paged_attention_plain",
        "paged_attention_mq_plain"),
    "paddle_tpu_torch.kernels.paged_prefill": (
        "paged_prefill", "paged_prefill_plain"),
    "paddle_tpu_torch.kernels.int8_gemm": (
        "w8a8_gemm", "w8a8_gemm_plain", "w8a8_gemm_prequant",
        "w8a8_gemm_prequant_plain"),
}

#: ops that transpose or materialise a copy of a layout
TRANSPOSE_OPS = ("aten.permute", "aten.transpose", "aten.t", "aten.clone",
                 "aten.copy_")


@dataclass(frozen=True)
class OpEvent:
    """One dispatched op (kind "op", name like ``aten.mm``) or one kernel
    entry call (kind "kernel", name the entry's), with the dtypes of the
    tensors it took and gave (a kernel event: of its arguments)."""

    kind: str
    name: str
    in_dtypes: Tuple[str, ...]
    out_dtypes: Tuple[str, ...]


def _dtypes(tree) -> Tuple[str, ...]:
    return tuple(str(x.dtype).replace("torch.", "") for x in
                 tree_flatten(tree)[0] if isinstance(x, torch.Tensor))


class Recording(list):
    """The events of one :func:`record` block, in order."""

    def names(self) -> List[str]:
        return [e.name for e in self]


class _Recorder(TorchDispatchMode):
    def __init__(self, events: Recording):
        super().__init__()
        self.events = events
        self.inside = 0         # > 0 while a kernel entry runs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.inside:
            self.events.append(OpEvent(
                "op", str(func.overloadpacket), _dtypes((args, kwargs)),
                _dtypes(out)))
        return out


@contextlib.contextmanager
def record() -> Iterator[Recording]:
    """Record the ops dispatched inside the block (see the module
    docstring); yields the :class:`Recording` it fills."""
    events = Recording()
    rec = _Recorder(events)
    patched = []

    def wrap(name, fn):
        def entry(*args, **kwargs):
            if rec.inside:
                return fn(*args, **kwargs)
            events.append(OpEvent("kernel", name, _dtypes((args, kwargs)),
                                  ()))
            rec.inside += 1
            try:
                return fn(*args, **kwargs)
            finally:
                rec.inside -= 1
        return entry

    for mod_name, names in KERNEL_ENTRIES.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            fn = getattr(mod, name)
            patched.append((mod, name, fn))
            setattr(mod, name, wrap(name, fn))
    try:
        with rec:
            yield events
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def count_op(events: Iterable[OpEvent], name: str) -> int:
    """Events named ``name`` (an op, e.g. ``aten.mm``, or a kernel entry,
    e.g. ``flash_fwd``)."""
    return sum(e.name == name for e in events)


def count_ops(events: Iterable[OpEvent]) -> Counter:
    """Histogram of the event names — the profile a layout change
    shifts."""
    return Counter(e.name for e in events)


def assert_no_op(events: Sequence[OpEvent], name: str,
                 context: str = "") -> None:
    n = count_op(events, name)
    assert n == 0, (
        f"{context + ': ' if context else ''}expected zero '{name}' "
        f"events, found {n}; full set: {sorted(set(e.name for e in events))}")


def assert_no_transpose(events: Sequence[OpEvent], context: str = "") -> None:
    """The layout contract around the kernels: no permute, transpose or
    materialising copy is dispatched outside the kernel events (what a
    kernel's wrapper or plain version does inside is not recorded)."""
    for name in TRANSPOSE_OPS:
        assert_no_op(events, name, context)


def assert_ops_identical(a: Sequence[OpEvent], b: Sequence[OpEvent],
                         context: str = "") -> None:
    """Two recordings are the same program: the same events in the same
    order, dtypes included."""
    if list(a) == list(b):
        return
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            raise AssertionError(
                f"{context + ': ' if context else ''}recordings differ at "
                f"event {i}:\n  a: {x}\n  b: {y}")
    raise AssertionError(
        f"{context + ': ' if context else ''}recordings differ in length: "
        f"{len(a)} vs {len(b)} events")


def find_f64(events: Iterable[OpEvent]) -> List[str]:
    """The distinct events that take or give a float64 tensor (float64
    arrays double the bytes and leave the tensor cores): their names."""
    return sorted({e.name for e in events
                   if "float64" in e.in_dtypes + e.out_dtypes})

"""Operator registry: op type -> kernel over torch tensors.

Counterpart of ``paddle_tpu/ops/registry.py`` (``OpDef``,
``register_op``, ``get_op_def``, ``run_kernel``).  A kernel is a function
``kernel(ins, attrs[, rng=key]) -> outs`` over torch tensors, ``ins`` and
``outs`` mapping slots (``"X"``, ``"Out"`` ...) to tensors or, for the
variadic ``list_slots``, lists of them; the same kernel runs on the CPU
and on the card.

Gradients come from torch autograd over the kernel: that replaces the
reference's ``<type>_grad`` ops that ``jax.vjp`` derives
(``registry.py:288-343``).  The ops whose backward the reference writes
by hand (``dropout_grad``, ``softmax_with_cross_entropy_grad``,
``batch_norm_grad``, ``data_norm_grad``) are registered here too, and
their forward op names the hand-written gradient with ``grad_maker``:
the eager tape then runs that grad op in the backward, as the reference
does (:func:`apply_hand_grad`).  :func:`op_grad` gives any op's input
gradients for given output gradients, by whichever of the two routes the
op takes.

Ops flagged ``needs_rng`` take a ``rng`` key (a splitmix64 integer of
:mod:`paddle_tpu_torch.framework.random`) and draw from
:func:`~paddle_tpu_torch.framework.random.generator` of it.

Graph mode (the reference's :188-406):

* :func:`infer_shape` / :func:`abstract_eval` run the kernel on
  ``meta``-device tensors, so a Variable's shape and dtype are what the
  kernel makes; a kernel that cannot run there runs on CPU zeros at the
  probe size instead.  Dims of ``-1`` are probed at two sizes and marked
  ``-1`` again where the output dim follows them.  Shape inference only:
  nothing runs on the card.
* :func:`make_grad_op_descs` wires ``<type>_grad`` ops exactly as the
  reference does (the forward inputs by slot, ``<out>@GRAD`` for every
  differentiable output, the ``nondiff_out_slots`` as values, and
  ``<in>@GRAD`` outputs with ``""`` for inputs in the no-grad set).  The
  grad op's kernel (:func:`get_grad_op_def`) is :func:`op_grad`, or the
  op's hand-written grad op where ``grad_maker`` names one.
* :func:`run_kept_forward` runs a forward and keeps its autograd graph:
  the static executor takes the grad op's gradients from it
  (:meth:`KeptForward.grads`) instead of running the forward again.
* :func:`register_ephemeral` registers a one-off op (a ``trace_fn``
  closure, a control-flow body) weakly: it lives as long as the
  Operators that hold it (``op._ephemeral_def``).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Set

import torch

from ..framework.dtype import convert_dtype, to_torch_dtype
from ..framework.place import CPUPlace, Place, place_guard

GRAD_SUFFIX = "@GRAD"


class OpNotRegistered(KeyError):
    pass


@dataclass
class OpDef:
    type: str
    kernel: Callable
    needs_rng: bool = False
    # slots whose value is always a list (variadic)
    list_slots: Set[str] = field(default_factory=set)
    # input slots that never receive gradients (indices, labels, ...)
    nondiff_slots: Set[str] = field(default_factory=set)
    # output slots that are bookkeeping (masks, saved statistics)
    nondiff_out_slots: Set[str] = field(default_factory=set)
    # hand-written gradient: fn(ins, outs, out_grads) -> (grad op type,
    # its inputs); None means autograd over the kernel
    grad_maker: Optional[Callable] = None
    # ops with no gradient at all (optimizer updates, comparisons, ...)
    no_grad: bool = False
    # input slots the auto grad op reads (None = all inputs)
    grad_inputs: Optional[Set[str]] = None
    # hand-written grad op outputs that rebind forward inputs' variables
    # (grad op output slot -> forward input slot): data_norm's statistics
    grad_rebinds: Dict[str, str] = field(default_factory=dict)
    # hand-written grad op outputs under another slot than ``<in>@GRAD``
    # (forward input slot -> grad op output slot): ``c_allreduce_sum``'s
    # grad op is a ``c_identity`` whose ``Out`` is ``X@GRAD``
    grad_out_slots: Dict[str, str] = field(default_factory=dict)
    # a one-off op, weakly registered (see register_ephemeral)
    ephemeral: bool = False


_REGISTRY: Dict[str, OpDef] = {}
# one-off ops, held weakly: each dies with the Operators that run it
_EPHEMERAL: "weakref.WeakValueDictionary[str, OpDef]" = \
    weakref.WeakValueDictionary()


def register_op(type: str, *, needs_rng: bool = False,
                list_slots: Sequence[str] = (),
                nondiff_slots: Sequence[str] = (),
                nondiff_out_slots: Sequence[str] = (),
                grad_maker: Optional[Callable] = None,
                no_grad: bool = False,
                grad_rebinds: Optional[Dict[str, str]] = None,
                grad_out_slots: Optional[Dict[str, str]] = None):
    """Decorator registering a kernel function under ``type``."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY[type] = OpDef(
            type=type, kernel=fn, needs_rng=needs_rng,
            list_slots=set(list_slots), nondiff_slots=set(nondiff_slots),
            nondiff_out_slots=set(nondiff_out_slots), grad_maker=grad_maker,
            no_grad=no_grad, grad_rebinds=dict(grad_rebinds or {}),
            grad_out_slots=dict(grad_out_slots or {}))
        return fn

    return deco


def register_ephemeral(op_def: OpDef) -> OpDef:
    """Register a one-off op weakly; its owner (an Operator) keeps it
    alive through ``_ephemeral_def``."""
    op_def.ephemeral = True
    _EPHEMERAL[op_def.type] = op_def
    return op_def


def get_op_def(type: str) -> OpDef:
    od = _REGISTRY.get(type)
    if od is None:
        od = _EPHEMERAL.get(type)
    if od is None:
        raise OpNotRegistered(f"Op {type!r} is not registered")
    return od


def is_registered(type: str) -> bool:
    return type in _REGISTRY or type in _EPHEMERAL


def all_ops() -> List[str]:
    return sorted(_REGISTRY)


def run_kernel(op_def: OpDef, ins: Dict[str, List[Any]],
               attrs: Dict[str, Any], rng=None) -> Dict[str, List[Any]]:
    """Run a kernel with normalized IO: ``ins`` maps slot -> list of
    tensors (singletons unwrapped unless the slot is variadic); returns
    slot -> list of tensors."""
    kin = {}
    for slot, vals in ins.items():
        if slot in op_def.list_slots:
            kin[slot] = list(vals)
        else:
            kin[slot] = vals[0] if len(vals) == 1 else list(vals)
    if op_def.needs_rng:
        outs = op_def.kernel(kin, dict(attrs), rng=rng)
    else:
        outs = op_def.kernel(kin, dict(attrs))
    return {slot: list(v) if isinstance(v, (list, tuple)) else [v]
            for slot, v in outs.items()}


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and (t.is_floating_point()
                                            or t.is_complex())


class _HandGrad(torch.autograd.Function):
    """An op whose backward is its hand-written grad op: the forward runs
    the kernel, the backward feeds the grad maker's inputs to the grad
    kernel."""

    @staticmethod
    def forward(ctx, spec, *flat):
        op_def, attrs, rng, layout = spec["op"], spec["attrs"], \
            spec["rng"], spec["layout"]
        ins = _unflatten(flat, layout)
        with torch.no_grad():
            outs = run_kernel(op_def, ins, attrs, rng)
        out_layout = [(s, len(v)) for s, v in outs.items()]
        spec["out_layout"] = out_layout
        flat_out = [t for _, v in outs.items() for t in v]
        ctx.spec = spec
        ctx.n_in = len(flat)
        ctx.save_for_backward(*flat, *flat_out)
        nondiff = [t for s, v in outs.items() if s in op_def.nondiff_out_slots
                   or not all(_is_float(x) for x in v) for t in v]
        if nondiff:
            ctx.mark_non_differentiable(*nondiff)
        return tuple(flat_out)

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        op_def = spec["op"]
        saved = ctx.saved_tensors
        ins = _unflatten(saved[:ctx.n_in], spec["layout"])
        outs = _unflatten(saved[ctx.n_in:], spec["out_layout"])
        ogs = _unflatten(grads, spec["out_layout"])
        ogs = {s: [torch.zeros_like(o) if g is None else g
                   for g, o in zip(gs, outs[s])]
               for s, gs in ogs.items() if s not in op_def.nondiff_out_slots}
        gtype, gins = op_def.grad_maker(ins, outs, ogs)
        res = run_kernel(get_op_def(gtype), gins, spec["attrs"])
        out = []
        for slot, n in spec["layout"]:
            gs = res.get(_grad_slot(op_def, slot))
            diff = slot not in op_def.nondiff_slots
            for i in range(n):
                out.append(gs[i] if (gs is not None and diff) else None)
        return (None, *out)


def _grad_slot(op_def: OpDef, slot: str) -> str:
    """The hand-written grad op's output slot of input ``slot``'s
    gradient."""
    return op_def.grad_out_slots.get(slot, slot + GRAD_SUFFIX)


def _unflatten(flat, layout):
    out, k = {}, 0
    for slot, n in layout:
        out[slot] = list(flat[k:k + n])
        k += n
    return out


def apply_hand_grad(op_def: OpDef, ins, attrs, rng=None):
    """Run ``op_def`` (which has a ``grad_maker``) so that autograd takes
    its hand-written grad op in the backward; returns slot -> list of
    tensors."""
    layout = [(s, len(v)) for s, v in ins.items()]
    flat = [t for v in ins.values() for t in v]
    spec = {"op": op_def, "attrs": dict(attrs), "rng": rng,
            "layout": layout}
    flat_out = _HandGrad.apply(spec, *flat)
    return _unflatten(flat_out, spec["out_layout"])


def _forward_for_grad(op_def: OpDef, ins, attrs, rng):
    """Run the forward with its float inputs as fresh leaves that need a
    gradient; returns (outputs, the leaves whose gradients are wanted)."""
    diff = {s: [t.detach().requires_grad_(_is_float(t)) if _is_float(t)
                else t for t in v]
            for s, v in ins.items()}
    with torch.enable_grad():
        if op_def.grad_maker is not None:
            outs = apply_hand_grad(op_def, diff, attrs, rng)
        else:
            outs = run_kernel(op_def, {
                s: [t.detach() if s in op_def.nondiff_slots and
                    isinstance(t, torch.Tensor) else t for t in v]
                for s, v in diff.items()}, attrs, rng)
    want = [(s, i, t) for s, v in diff.items()
            if s not in op_def.nondiff_slots
            for i, t in enumerate(v)
            if isinstance(t, torch.Tensor) and t.requires_grad]
    return outs, want, {s: len(v) for s, v in diff.items()}


def _grads_of(op_def: OpDef, outs, want, sizes, out_grads):
    pairs = [(o, g) for s, gs in out_grads.items()
             if s not in op_def.nondiff_out_slots
             for o, g in zip(outs.get(s, ()), gs)
             if isinstance(o, torch.Tensor) and o.requires_grad]
    if pairs:
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [t for _, _, t in want],
            [g.to(o.dtype) for o, g in pairs], allow_unused=True)
    else:
        grads = [None] * len(want)
    # one entry per input of each differentiable slot, None where the
    # input takes no gradient (an integer): a grad op's outputs line up
    # with its forward's inputs
    res: Dict[str, List[Any]] = {}
    for (s, i, t), g in zip(want, grads):
        slot = res.setdefault(s + GRAD_SUFFIX, [None] * sizes[s])
        slot[i] = torch.zeros_like(t) if g is None else g
    return res


def op_grad(type: str, ins: Dict[str, List[Any]], attrs: Dict[str, Any],
            out_grads: Dict[str, List[Any]], rng=None):
    """The input gradients of op ``type`` at ``ins`` for the output
    gradients ``out_grads`` (slot -> list; a missing output slot has zero
    gradient): ``{"<slot>@GRAD": [tensors]}`` for every differentiable
    float input slot, by the op's hand-written grad op or by autograd."""
    if get_op_def(type).no_grad:
        raise OpNotRegistered(f"Op {type!r} has no gradient")
    res = _aligned_op_grad(type, ins, attrs, out_grads, rng)
    return {s: [g for g in v if g is not None] for s, v in res.items()}


def _aligned_op_grad(type, ins, attrs, out_grads, rng=None):
    """:func:`op_grad` with each slot's list aligned to the slot's inputs
    (None where an input takes no gradient): a grad op's kernel."""
    op_def = get_op_def(type)
    return _grads_of(op_def, *_forward_for_grad(op_def, ins, attrs, rng),
                     out_grads)


class KeptForward:
    """A forward's autograd graph, kept until its grad op runs."""

    __slots__ = ("op_def", "outs", "want", "sizes")

    def __init__(self, op_def, outs, want, sizes):
        self.op_def, self.outs, self.want, self.sizes = (op_def, outs, want,
                                                         sizes)

    def grads(self, out_grads: Dict[str, List[Any]]):
        """What the grad op's kernel gives for ``out_grads``, from the
        kept graph (which it frees)."""
        res = _grads_of(self.op_def, self.outs, self.want, self.sizes,
                        out_grads)
        self.outs = self.want = None
        return res


def run_kept_forward(op_def: OpDef, ins: Dict[str, List[Any]],
                     attrs: Dict[str, Any], rng=None):
    """Run ``op_def`` recording its autograd graph: returns (the outputs,
    detached, and the :class:`KeptForward` its grad op reads)."""
    outs, want, sizes = _forward_for_grad(op_def, ins, attrs, rng)
    detached = {s: [t.detach() if isinstance(t, torch.Tensor) else t
                    for t in v] for s, v in outs.items()}
    return detached, KeptForward(op_def, outs, want, sizes)


# ---------------------------------------------------------------------------
# shape inference: the kernel on meta tensors
# ---------------------------------------------------------------------------

_PROBE_A = 17
_PROBE_B = 23


class ShapeDtype(NamedTuple):
    """An output's shape and dtype (a paddle dtype string)."""

    shape: tuple
    dtype: str


def _freeze(v):
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, set):
        return tuple(sorted(v))
    return v


_ABS_CACHE: Dict[Any, Any] = {}


class _MetaPlace(Place):
    """The place of shape inference: creation ops make meta tensors."""

    _kind = "meta"

    def torch_device(self):
        return torch.device("meta")


def _eval_on(op_def: OpDef, ins_structs, attrs, device: str):
    make = torch.empty if device == "meta" else torch.zeros
    ins = {s: [make(tuple(v.shape), dtype=to_torch_dtype(v.dtype),
                    device=device) for v in vals]
           for s, vals in ins_structs.items()}
    place = _MetaPlace() if device == "meta" else CPUPlace()
    with place_guard(place), torch.no_grad():
        outs = run_kernel(op_def, ins, attrs,
                          rng=0 if op_def.needs_rng else None)
    return {s: [ShapeDtype(tuple(t.shape), convert_dtype(t.dtype))
                for t in vals if isinstance(t, torch.Tensor)]
            for s, vals in outs.items()}


def _eval(op_def: OpDef, ins_structs, attrs):
    try:
        return _eval_on(op_def, ins_structs, attrs, "meta")
    except Exception:
        # a kernel that reads values (an index, a count) runs on CPU zeros
        return _eval_on(op_def, ins_structs, attrs, "cpu")


def abstract_eval(op_def: OpDef, ins_structs: Dict[str, List[Any]],
                  attrs: Dict[str, Any]):
    """The outputs' :class:`ShapeDtype` per slot for inputs of the given
    shapes and dtypes (``ins_structs``: slot -> list of objects with
    ``shape`` and ``dtype``), memoized: models repeat identical layers."""
    if op_def.ephemeral:
        # one-off types are unique per build: caching would only leak
        return _eval(op_def, ins_structs, attrs)
    key = (op_def.type,
           tuple(sorted((s, tuple((tuple(v.shape), str(v.dtype))
                                  for v in vals))
                        for s, vals in ins_structs.items())),
           _freeze(attrs))
    try:
        hit = _ABS_CACHE.get(key)
    except TypeError:  # an unhashable attribute: no caching
        key = hit = None
    if hit is None:
        hit = _eval(op_def, ins_structs, attrs)
        if key is not None:
            _ABS_CACHE[key] = hit
    return hit


def _probe_shapes(block, op, probe: int):
    op_def = get_op_def(op.type)
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            v = block._var_recursive(n)
            shape = tuple(probe if (s is None or s < 0) else s
                          for s in v.shape)
            vals.append(ShapeDtype(shape, v.dtype))
        ins[slot] = vals
    return abstract_eval(op_def, ins, op.attrs)


def infer_shape(block, op) -> None:
    """Set the output Variables' shapes and dtypes from the kernel."""
    op_def = get_op_def(op.type)  # raises OpNotRegistered for unknown ops
    if op_def.no_grad and not op.outputs:
        return
    has_dynamic = any(
        any(s is None or s < 0 for s in block._var_recursive(n).shape)
        for names in op.inputs.values() for n in names)
    outs_a = _probe_shapes(block, op, _PROBE_A)
    outs_b = _probe_shapes(block, op, _PROBE_B) if has_dynamic else outs_a
    for slot, names in op.outputs.items():
        if slot not in outs_a:
            continue
        vals_a, vals_b = outs_a[slot], outs_b[slot]
        for i, n in enumerate(names):
            if i >= len(vals_a) or not n:
                break
            sa, sb = vals_a[i], vals_b[i]
            shape = tuple(-1 if da != db else da
                          for da, db in zip(sa.shape, sb.shape))
            try:
                v = block._var_recursive(n)
            except ValueError:
                v = block.create_var(name=n)
            v.shape = shape
            v.dtype = sa.dtype


# ---------------------------------------------------------------------------
# grad ops for append_backward
# ---------------------------------------------------------------------------


def make_auto_grad_kernel(fwd_def: OpDef) -> Callable:
    """The kernel of ``<type>_grad``: inputs are the forward's (same
    slots) and ``<out_slot>@GRAD``; outputs ``<in_slot>@GRAD``, by
    :func:`op_grad`."""

    def grad_kernel(kin: Dict[str, Any], attrs: Dict[str, Any], rng=None):
        fwd_ins, out_grads = {}, {}
        for s, v in kin.items():
            vals = list(v) if isinstance(v, (list, tuple)) else [v]
            if s.endswith(GRAD_SUFFIX):
                out_grads[s[:-len(GRAD_SUFFIX)]] = vals
            elif s not in fwd_def.nondiff_out_slots:
                fwd_ins[s] = vals
        return _aligned_op_grad(fwd_def.type, fwd_ins, attrs, out_grads,
                                rng=rng)

    return grad_kernel


def get_grad_op_def(fwd_type: str) -> OpDef:
    """The OpDef of ``<fwd_type>_grad``, registered on first use (the
    registries double as the memo)."""
    grad_type = fwd_type + "_grad"
    od = _REGISTRY.get(grad_type) or _EPHEMERAL.get(grad_type)
    if od is not None:
        return od
    fwd = get_op_def(fwd_type)
    if fwd.no_grad:
        raise OpNotRegistered(f"Op {fwd_type!r} has no gradient")
    od = OpDef(type=grad_type, kernel=make_auto_grad_kernel(fwd),
               needs_rng=fwd.needs_rng,
               list_slots=set(fwd.list_slots)
               | {s + GRAD_SUFFIX for s in fwd.list_slots},
               no_grad=True)
    if fwd.ephemeral:
        # the grad def lives exactly as long as the forward def
        register_ephemeral(od)
        fwd._ephemeral_grad = od
    else:
        _REGISTRY[grad_type] = od
    return od


def _hand_grad_descs(op, fwd: OpDef, no_grad_set) -> List[dict]:
    """The desc of the hand-written grad op: its inputs are what the
    op's ``grad_maker`` routes (here over names instead of tensors)."""
    ins = {s: list(op.input(s)) for s in op.inputs}
    outs = {s: list(op.output(s)) for s in op.outputs}
    ogs = {s: [n + GRAD_SUFFIX for n in names]
           for s, names in outs.items() if s not in fwd.nondiff_out_slots}
    gtype, gins = fwd.grad_maker(ins, outs, ogs)
    outputs = {out_slot: list(op.input(in_slot))
               for out_slot, in_slot in fwd.grad_rebinds.items()}
    for slot in op.inputs:
        if slot in fwd.nondiff_slots:
            continue
        names = [n for n in op.input(slot) if n not in no_grad_set]
        if names:
            outputs[_grad_slot(fwd, slot)] = [n + GRAD_SUFFIX for n in names]
    return [{"type": gtype,
             "inputs": {s: list(v) for s, v in gins.items()},
             "outputs": outputs, "attrs": dict(op.attrs)}]


def make_grad_op_descs(op, no_grad_set: Optional[Set[str]] = None) -> List[dict]:
    """The grad op descs of ``op`` for ``append_backward``: a list of
    ``{type, inputs, outputs, attrs}``."""
    no_grad_set = no_grad_set or set()
    fwd = get_op_def(op.type)
    if fwd.no_grad:
        return []
    if fwd.grad_maker is not None:
        return _hand_grad_descs(op, fwd, no_grad_set)
    get_grad_op_def(op.type)  # registered before the desc names it
    inputs = {s: list(op.input(s)) for s in op.inputs}
    if fwd.grad_inputs is not None:
        inputs = {s: v for s, v in inputs.items() if s in fwd.grad_inputs}
    for slot in op.outputs:
        names = op.output(slot)
        if slot in fwd.nondiff_out_slots:
            # bookkeeping outputs feed the grad op as values
            inputs[slot] = list(names)
            continue
        inputs[slot + GRAD_SUFFIX] = [n + GRAD_SUFFIX for n in names]
    outputs = {}
    for slot in op.inputs:
        if slot in fwd.nondiff_slots:
            continue
        outs = [(n + GRAD_SUFFIX) if n not in no_grad_set else ""
                for n in op.input(slot)]
        if any(outs):
            outputs[slot + GRAD_SUFFIX] = outs
    return [{"type": op.type + "_grad", "inputs": inputs,
             "outputs": outputs, "attrs": dict(op.attrs)}]

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
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import torch

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


_REGISTRY: Dict[str, OpDef] = {}


def register_op(type: str, *, needs_rng: bool = False,
                list_slots: Sequence[str] = (),
                nondiff_slots: Sequence[str] = (),
                nondiff_out_slots: Sequence[str] = (),
                grad_maker: Optional[Callable] = None,
                no_grad: bool = False):
    """Decorator registering a kernel function under ``type``."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY[type] = OpDef(
            type=type, kernel=fn, needs_rng=needs_rng,
            list_slots=set(list_slots), nondiff_slots=set(nondiff_slots),
            nondiff_out_slots=set(nondiff_out_slots), grad_maker=grad_maker,
            no_grad=no_grad)
        return fn

    return deco


def get_op_def(type: str) -> OpDef:
    od = _REGISTRY.get(type)
    if od is None:
        raise OpNotRegistered(f"Op {type!r} is not registered")
    return od


def is_registered(type: str) -> bool:
    return type in _REGISTRY


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
            gs = res.get(slot + GRAD_SUFFIX)
            diff = slot not in op_def.nondiff_slots
            for i in range(n):
                out.append(gs[i] if (gs is not None and diff) else None)
        return (None, *out)


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


def op_grad(type: str, ins: Dict[str, List[Any]], attrs: Dict[str, Any],
            out_grads: Dict[str, List[Any]], rng=None):
    """The input gradients of op ``type`` at ``ins`` for the output
    gradients ``out_grads`` (slot -> list; a missing output slot has zero
    gradient): ``{"<slot>@GRAD": [tensors]}`` for every differentiable
    float input slot, by the op's hand-written grad op or by autograd."""
    op_def = get_op_def(type)
    if op_def.no_grad:
        raise OpNotRegistered(f"Op {type!r} has no gradient")
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
        pairs = [(o, g) for s, gs in out_grads.items()
                 if s not in op_def.nondiff_out_slots
                 for o, g in zip(outs[s], gs)
                 if isinstance(o, torch.Tensor) and o.requires_grad]
        want = [(s, i, t) for s, v in diff.items()
                if s not in op_def.nondiff_slots
                for i, t in enumerate(v)
                if isinstance(t, torch.Tensor) and t.requires_grad]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [t for _, _, t in want],
            [g.to(o.dtype) for o, g in pairs], allow_unused=True)
    res: Dict[str, List[Any]] = {}
    for (s, i, t), g in zip(want, grads):
        res.setdefault(s + GRAD_SUFFIX, []).append(
            torch.zeros_like(t) if g is None else g)
    return res

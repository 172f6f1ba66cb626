"""Static-graph reverse-mode autodiff: ``append_backward`` and
``gradients``.

Counterpart of ``paddle_tpu/static/backward.py``: walk the block's
forward ops in reverse, append each one's grad ops (from the registry's
:func:`~paddle_tpu_torch.ops.registry.make_grad_op_descs`), insert
``fill_zeros_like`` for outputs that receive no gradient, and accumulate
a gradient written twice (``<name>@GRAD@RENAME@N``, then a ``sum`` op
that rebinds the name).  The grad ops are ordinary ops of the same
block; the executor takes an auto grad op's gradients from its forward's
kept autograd graph, so no forward runs twice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from ..framework import program as fw
from ..framework.dtype import is_floating
from ..framework.program import GRAD_SUFFIX, grad_var_name
from ..ops import registry

__all__ = ["append_backward", "gradients"]


def _collect_no_grad(block: fw.Block, no_grad_set: Optional[Set[str]]) -> Set[str]:
    out = set(no_grad_set or ())
    blk = block
    while blk is not None:
        for var in blk.vars.values():
            if var.stop_gradient or not is_floating(var.dtype):
                out.add(var.name)
        blk = blk.parent_block
    return out


def _ensure_grad_var(block: fw.Block, fwd_name: str, grad_name: str):
    if block._has_var_recursive(grad_name):
        return block._var_recursive(grad_name)
    try:
        fwd = block._var_recursive(fwd_name)
        shape, dtype = fwd.shape, fwd.dtype
    except ValueError:
        shape, dtype = (), "float32"
    return block.create_var(name=grad_name, shape=shape, dtype=dtype,
                            stop_gradient=True)


def append_backward(
    loss: fw.Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[Set[str]] = None,
    callbacks=None,
):
    """Append the grad ops of ``loss`` to its block; returns
    ``[(param, grad)]``."""
    block = loss.block
    program = block.program
    no_grad = _collect_no_grad(block, no_grad_set)

    loss_grad_name = grad_var_name(loss.name)
    block.append_op(type="fill_any_like", inputs={"X": [loss.name]},
                    outputs={"Out": [loss_grad_name]},
                    attrs={"value": 1.0, "dtype": -1})
    _ensure_grad_var(block, loss.name, loss_grad_name)

    fwd_ops = [op for op in block.ops
               if not op.type.endswith("_grad") and op.type != "fill_any_like"]

    produced_grads: Set[str] = {loss_grad_name}
    rename_counter = 0

    for op in reversed(fwd_ops):
        if not registry.is_registered(op.type):
            continue
        op_def = registry.get_op_def(op.type)
        out_grad_names = [grad_var_name(n)
                          for slot, names in op.outputs.items()
                          if slot not in op_def.nondiff_out_slots
                          for n in names]
        if op_def.no_grad:
            # a dynamic while_loop on the gradient path fails loudly, with
            # the trip-count inference's reason
            reason = op.attrs.get("__no_fori_reason__")
            if reason is not None and any(
                    g in produced_grads for g in out_grad_names):
                raise RuntimeError(
                    f"append_backward: op {op.type!r} is a dynamic "
                    f"lax.while_loop, which cannot be reverse-differentiated "
                    f"under static memory. Trip-count inference failed "
                    f"because: {reason}. Rewrite the loop as a counted "
                    f"``i < N`` loop with fill_constant bounds, or compute "
                    f"the loss outside the loop.")
            continue
        if not any(g in produced_grads for g in out_grad_names):
            continue
        # outputs with no incoming gradient get explicit zeros
        for slot, names in op.outputs.items():
            if slot in op_def.nondiff_out_slots:
                continue
            for n in names:
                g = grad_var_name(n)
                if g not in produced_grads:
                    block.append_op(type="fill_zeros_like",
                                    inputs={"X": [n]}, outputs={"Out": [g]},
                                    attrs={})
                    _ensure_grad_var(block, n, g)
                    produced_grads.add(g)

        for gop in registry.make_grad_op_descs(op, no_grad):
            final_outputs: Dict[str, List[str]] = {}
            accumulations = []  # (existing name, temporary name)
            for slot, names in gop["outputs"].items():
                outs = []
                for n in names:
                    if not n:
                        outs.append("")
                        continue
                    if n in produced_grads:
                        rename_counter += 1
                        tmp = f"{n}@RENAME@{rename_counter}"
                        accumulations.append((n, tmp))
                        outs.append(tmp)
                    else:
                        outs.append(n)
                final_outputs[slot] = outs
            block.append_op(type=gop["type"], inputs=gop["inputs"],
                            outputs=final_outputs, attrs=gop["attrs"])
            for slot, names in final_outputs.items():
                for n in names:
                    if n:
                        base = n.split("@RENAME@")[0]
                        _ensure_grad_var(block, base[: -len(GRAD_SUFFIX)], n)
                        produced_grads.add(base)
            # a gradient written twice: old + new, rebinding the name
            for orig, tmp in accumulations:
                block.append_op(type="sum", inputs={"X": [orig, tmp]},
                                outputs={"Out": [orig]}, attrs={})

    if parameter_list is not None:
        params = [p if isinstance(p, fw.Variable)
                  else block._var_recursive(str(p)) for p in parameter_list]
    else:
        params = program.all_parameters()
    result = []
    for p in params:
        if not getattr(p, "trainable", True) or p.name in no_grad:
            continue
        gname = grad_var_name(p.name)
        if block._has_var_recursive(gname):
            result.append((p, block._var_recursive(gname)))
    return result


def gradients(targets, inputs, target_gradients=None,
              no_grad_set: Optional[Set[str]] = None) -> List[fw.Variable]:
    """``paddle.static.gradients``: the gradient Variables of ``inputs``
    (None where none flows) for one target."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    assert len(targets) == 1, "gradients() currently supports a single target"
    target = targets[0]
    append_backward(target, no_grad_set=no_grad_set)
    block = target.block
    outs = []
    for v in inputs:
        gname = grad_var_name(v.name)
        outs.append(block._var_recursive(gname)
                    if block._has_var_recursive(gname) else None)
    return outs

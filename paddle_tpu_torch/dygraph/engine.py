"""Backward: ``Tensor.backward`` and ``paddle.grad`` over torch autograd.

Counterpart of ``paddle_tpu/dygraph/engine.py`` (``run_backward``,
``calc_gradient``), which replays the reference's tape; here torch's
autograd engine does that work, and these functions keep the reference's
conventions around it: a root without a given gradient is seeded with
ones whatever its shape, a root that needs no gradient is skipped, and
``paddle.grad`` raises ValueError for an input the outputs do not reach
unless ``allow_unused``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _seed(t, g):
    from .tensor import Tensor

    if g is None:
        return torch.ones_like(t)
    g = g._t if isinstance(g, Tensor) else torch.as_tensor(g)
    return g.to(device=t.device, dtype=t.dtype)


def run_backward(tensors: Sequence, grad_tensors: Optional[Sequence] = None,
                 retain_graph: bool = False):
    """``Tensor.backward()``: accumulate into the leaves' ``.grad``."""
    roots, grads = [], []
    for i, t in enumerate(tensors):
        if not t._t.requires_grad:
            continue
        roots.append(t._t)
        grads.append(_seed(t._t, None if grad_tensors is None
                           else grad_tensors[i]))
    if roots:
        torch.autograd.backward(roots, grads, retain_graph=retain_graph)


def calc_gradient(outputs: Sequence, inputs: Sequence,
                  grad_outputs: Optional[Sequence] = None,
                  retain_graph: Optional[bool] = None,
                  create_graph: bool = False, allow_unused: bool = False,
                  no_grad_vars: Optional[Sequence] = None):
    """``paddle.grad``: gradients of ``outputs`` with respect to
    ``inputs``, without touching ``.grad``; ``create_graph`` keeps them
    differentiable (double grad).  An input listed in ``no_grad_vars``
    gets None."""
    from .tensor import Tensor

    outs, gos = [], []
    for i, t in enumerate(outputs):
        if t._t.requires_grad:
            outs.append(t._t)
            gos.append(_seed(t._t, None if grad_outputs is None
                             else grad_outputs[i]))
    skip = {id(t) for t in (no_grad_vars or ())}
    want = [i for i, t in enumerate(inputs)
            if t._t.requires_grad and id(t) not in skip]
    got = [None] * len(inputs)
    if outs and want:
        res = torch.autograd.grad(
            outs, [inputs[i]._t for i in want], gos,
            retain_graph=create_graph if retain_graph is None
            else retain_graph, create_graph=create_graph, allow_unused=True)
        for i, g in zip(want, res):
            got[i] = g
    result = []
    for t, g in zip(inputs, got):
        if g is None:
            if not allow_unused:
                raise ValueError(
                    f"Tensor {t.name} is unreachable from outputs; pass "
                    f"allow_unused=True to get None instead")
            result.append(None)
        else:
            result.append(Tensor._wrap(g))
    return result

"""``paddle.autograd``: ``PyLayer`` custom autograd, ``backward`` and
``grad``.

Counterpart of ``paddle_tpu/autograd/__init__.py``.  A :class:`PyLayer`
runs as a ``torch.autograd.Function``: its ``forward(ctx, *args)`` runs
with gradients off on the paddle Tensors of the inputs, and torch's
engine calls its ``backward(ctx, *output_grads)`` with the output
gradients as Tensors (with gradients on under ``create_graph``, so a
PyLayer's backward can itself be differentiated).  ``backward`` must
return one gradient (or None) per Tensor input of ``forward``.
"""

from __future__ import annotations

import torch

from ..dygraph.engine import calc_gradient, run_backward
from ..dygraph.tensor import Tensor

__all__ = ["PyLayer", "PyLayerContext", "backward", "grad"]


class PyLayerContext:
    """The ``ctx`` of forward and backward: ``save_for_backward`` /
    ``saved_tensor`` carry Tensors across; other attributes may be set
    freely."""

    def __init__(self):
        self.container = None

    def save_for_backward(self, *tensors):
        self.container = tensors

    def saved_tensor(self):
        return self.container


class LayerMeta(type):
    def __init__(cls, name, bases, attrs):
        super().__init__(name, bases, attrs)


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(fctx, cls, spec, *flat):
        args, kwargs, slots, box = spec
        pos = iter(flat)
        wrapped = [Tensor._wrap(next(pos)) if s else a
                   for a, s in zip(args, slots)]
        kw = {k: Tensor._wrap(next(pos)) if s else v
              for (k, v), s in zip(kwargs.items(), slots[len(args):])}
        ctx = PyLayerContext()
        outputs = cls.forward(ctx, *wrapped, **kw)
        single = not isinstance(outputs, (list, tuple))
        outs = [outputs] if single else list(outputs)
        fctx.pyctx, fctx.cls, fctx.n_in = ctx, cls, len(flat)
        box["single"], box["outs"] = single, outputs if single else outs
        return tuple(o._t for o in outs if isinstance(o, Tensor))

    @staticmethod
    def backward(fctx, *grads):
        gs = [Tensor._wrap(g) for g in grads]
        res = fctx.cls.backward(fctx.pyctx, *gs)
        if not isinstance(res, (list, tuple)):
            res = [res]
        if len(res) != fctx.n_in:
            raise ValueError(
                f"{fctx.cls.__name__}.backward returned {len(res)} "
                f"gradients for {fctx.n_in} tensor inputs")
        return (None, None, *[None if g is None else g._t for g in res])


class PyLayer(metaclass=LayerMeta):
    """Custom autograd: subclass with ``forward(ctx, *args)`` and
    ``backward(ctx, *output_grads)`` staticmethods, run by ``apply``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        vals = list(args) + list(kwargs.values())
        slots = [isinstance(a, Tensor) for a in vals]
        flat = [a._t for a in vals if isinstance(a, Tensor)]
        box = {}
        outs = _Apply.apply(cls, (list(args), dict(kwargs), slots, box),
                            *flat)
        # the forward's return value, with the recorded tensors in place
        # of the ones forward made
        it = iter(outs)
        if box["single"]:
            return Tensor._wrap(next(it))
        return [Tensor._wrap(next(it)) if isinstance(o, Tensor) else o
                for o in box["outs"]]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward``: accumulate the gradients of
    ``tensors`` into their leaves' ``.grad``."""
    if isinstance(tensors, Tensor):
        tensors = [tensors]
    tensors = list(tensors)
    if len({id(t) for t in tensors}) != len(tensors):
        raise ValueError("tensors must not contain the same tensor twice")
    if grad_tensors is not None:
        if isinstance(grad_tensors, Tensor):
            grad_tensors = [grad_tensors]
        grad_tensors = list(grad_tensors)
        if len(grad_tensors) != len(tensors):
            raise ValueError("grad_tensors must match tensors in length")
    run_backward(tensors, grad_tensors, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``."""
    outs = [outputs] if isinstance(outputs, Tensor) else list(outputs)
    ins = [inputs] if isinstance(inputs, Tensor) else list(inputs)
    if grad_outputs is not None and isinstance(grad_outputs, Tensor):
        grad_outputs = [grad_outputs]
    return calc_gradient(outs, ins, grad_outputs, retain_graph=retain_graph,
                         create_graph=create_graph, allow_unused=allow_unused,
                         no_grad_vars=no_grad_vars)

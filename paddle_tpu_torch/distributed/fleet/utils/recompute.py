"""Activation recompute on ``PyLayer``: a block's activations are
recomputed in the backward instead of being kept.

Counterpart of ``paddle_tpu/distributed/fleet/utils/recompute.py``
(``RecomputeFunction``, ``recompute``).  The forward runs the function
without gradients and keeps its inputs and where the seed chain stood
(:func:`paddle_tpu_torch.framework.random.get_chain_state`: the global
key and the open step scope's key) and the amp state; the backward puts
the chain back, runs the function again with gradients on, backpropagates
the output gradients through that graph (the parameters' gradients
accumulate there) and returns the inputs' gradients.  Dropout draws its
mask from the key it is handed, so the replay draws the forward's masks.
"""

from __future__ import annotations

import torch

from ....autograd import PyLayer
from ....dygraph import tracer
from ....dygraph.tensor import Tensor
from ....framework import random as _random

__all__ = ["RecomputeFunction", "recompute", "check_recompute_necessary"]


def check_recompute_necessary(inputs):
    if not any(isinstance(x, Tensor) and not x.stop_gradient
               for x in inputs):
        import warnings

        warnings.warn(
            "[Recompute]: None of the inputs to current recompute block need "
            "grad; there is NO need to recompute this block in backward")


class RecomputeFunction(PyLayer):
    @staticmethod
    def forward(ctx, run_function, preserve_rng_state, *args):
        check_recompute_necessary(args)
        ctx.run_function = run_function
        ctx.args = args
        ctx.rng = _random.get_chain_state() if preserve_rng_state else None
        ctx.amp = tracer.amp_state()
        return run_function(*args)

    @staticmethod
    def backward(ctx, *output_grads):
        args = [Tensor._wrap(a._t.detach().requires_grad_(
            a._t.requires_grad)) if isinstance(a, Tensor) else a
            for a in ctx.args]
        old_rng = _random.get_chain_state()
        old_amp = tracer.amp_state()
        if ctx.rng is not None:
            _random.set_chain_state(ctx.rng)
        tracer.set_amp_state(ctx.amp)
        try:
            with torch.enable_grad():
                outputs = ctx.run_function(*args)
        finally:
            tracer.set_amp_state(old_amp)
            _random.set_chain_state(old_rng)
        outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        pairs = [(o._t, g._t) for o, g in zip(
            [o for o in outs if isinstance(o, Tensor)], output_grads)
            if o._t.requires_grad]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return tuple(None if a._t.grad is None else Tensor._wrap(a._t.grad)
                     for a in args if isinstance(a, Tensor))


def recompute(function, *args, preserve_rng_state=True, **kwargs):
    """``fleet.utils.recompute(function, *args)``: ``function(*args)``
    whose activations are recomputed in the backward."""
    if kwargs:
        raise ValueError(f"Unexpected keyword arguments: {list(kwargs)}")
    return RecomputeFunction.apply(function, preserve_rng_state, *args)

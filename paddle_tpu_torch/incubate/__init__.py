"""``paddle.incubate``: the wrapper optimizers, ASP (:mod:`.asp`), the
fused softmax masks, imperative quantization (:mod:`.quant`) and the
automatic checkpoints of elastic jobs (:mod:`.auto_checkpoint`, also
``incubate.checkpoint``).

Counterpart of ``paddle_tpu/incubate/__init__.py``, after the reference's
``fluid/optimizer.py`` ExponentialMovingAverage, ModelAverage,
LookaheadOptimizer and GradientMergeOptimizer in their paddle 2.x
``incubate`` form: wrappers over an eager optimizer that hold their state
as tensors beside the parameters.  The EMA's shadows, ModelAverage's sums
and GradientMerge's accumulators are fp32 tensors on the parameters'
device; LookAhead's slow weights keep the parameters' dtype and are
updated in fp32.  A wrapper writes a parameter in place (``copy_`` under
``no_grad``), so the optimizer's and the Layer's references stay valid.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from . import asp  # noqa: F401
from . import auto_checkpoint  # noqa: F401
from . import quant  # noqa: F401

__all__ = [
    "ExponentialMovingAverage", "LookAhead", "ModelAverage",
    "GradientMergeOptimizer", "asp", "quant",
]


def _unique(params):
    seen, out = set(), []
    for p in params:
        if id(p) not in seen:
            seen.add(id(p))
            out.append(p)
    return out


def _swap_in(params, values):
    """Copy ``values[id(p)]`` into each parameter; returns copies of what
    was there."""
    backup = {}
    with torch.no_grad():
        for p in params:
            backup[id(p)] = p._t.detach().clone()
            p._t.copy_(values[id(p)].to(p._t.dtype))
    return backup


def _restore(params, backup):
    with torch.no_grad():
        for p in params:
            p._t.copy_(backup[id(p)])


class ExponentialMovingAverage:
    """shadow = decay * shadow + (1 - decay) * param after each update.

    ``update()`` after every optimizer step; the ``apply()`` context puts
    the averages in the parameters for evaluation and puts the weights
    back on exit (or call ``restore()``)."""

    def __init__(self, parameters, decay: float = 0.999,
                 thres_steps: Optional[int] = None, name=None):
        self._params = _unique(parameters)
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._step = 0
        self._shadow = {id(p): p._t.detach().float().clone()
                        for p in self._params}
        self._backup = None

    @torch.no_grad()
    def update(self):
        self._step += 1
        decay = self._decay
        if self._thres_steps is not None:
            # the warm-up of the decay: min(decay, (1 + t) / (10 + t))
            decay = min(decay, (1.0 + self._step) / (10.0 + self._step))
        for p in self._params:
            sh = self._shadow[id(p)]
            self._shadow[id(p)] = decay * sh + (1.0 - decay) * p._t.float()

    @contextlib.contextmanager
    def apply(self, need_restore: bool = True):
        self._backup = _swap_in(self._params, self._shadow)
        try:
            yield self
        finally:
            if need_restore:
                self.restore()

    def restore(self):
        if self._backup is None:
            return
        _restore(self._params, self._backup)
        self._backup = None


class LookAhead:
    """k fast steps of the inner optimizer, then slow += alpha * (fast -
    slow) in fp32 and fast = slow."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5,
                 name=None):
        assert inner_optimizer is not None
        assert 0.0 <= alpha <= 1.0
        assert k >= 1
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._params = _unique(inner_optimizer._parameter_list or [])
        self._slow = {id(p): p._t.detach().clone() for p in self._params}
        self._step = 0

    def step(self):
        self.inner_optimizer.step()
        self._step += 1
        if self._step % self.k:
            return
        with torch.no_grad():
            for p in self._params:
                slow = self._slow[id(p)].float()
                fast = p._t.float()
                new = (slow + self.alpha * (fast - slow)).to(p._t.dtype)
                self._slow[id(p)] = new
                p._t.copy_(new)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    clear_gradients = clear_grad

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        return self.inner_optimizer.state_dict()

    def __getattr__(self, name):
        return getattr(self.inner_optimizer, name)


class ModelAverage:
    """A running average of the parameters over a sliding window:
    ``step()`` adds them up, ``apply()`` puts the average in for
    evaluation, ``restore()`` puts the weights back."""

    def __init__(self, average_window_rate: float, parameters=None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, name=None):
        self._params = _unique(parameters or [])
        self._rate = average_window_rate
        self._min_w = min_average_window
        self._max_w = max_average_window
        self._sum = {id(p): torch.zeros_like(p._t, dtype=torch.float32)
                     for p in self._params}
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        self._count += 1
        window = max(self._min_w,
                     min(self._max_w, int(self._count * self._rate) or 1))
        for p in self._params:
            s = self._sum[id(p)] + p._t.float()
            # the sum kept to the window by exponential forgetting
            if self._count > window:
                s = s * (window / (window + 1.0))
            self._sum[id(p)] = s

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore: bool = True):
        n = max(min(self._count,
                    max(self._min_w, int(self._count * self._rate) or 1)), 1)
        self._backup = _swap_in(
            self._params, {k: s / n for k, s in self._sum.items()})
        try:
            yield self
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        if self._backup is None:
            return
        _restore(self._params, self._backup)
        self._backup = None


class GradientMergeOptimizer:
    """Adds up the gradients of ``k_steps`` micro-batches in fp32, then
    makes one real step of the inner optimizer with their mean (their sum
    when ``avg`` is False), cast back to the gradient's dtype.  The
    gradients are cleared after every micro-step."""

    def __init__(self, inner_optimizer, k_steps: int = 1, avg: bool = True):
        self.inner_optimizer = inner_optimizer
        self.k_steps = max(int(k_steps), 1)
        self.avg = avg
        self._params = _unique(inner_optimizer._parameter_list or [])
        self._acc = {}
        self._step = 0

    def step(self):
        self._step += 1
        with torch.no_grad():
            for p in self._params:
                g = p._leaf_t().grad
                if g is None:
                    continue
                acc = self._acc.get(id(p))
                self._acc[id(p)] = (g.float().clone() if acc is None
                                    else acc.add_(g.float()))
        if self._step % self.k_steps == 0:
            scale = 1.0 / self.k_steps if self.avg else 1.0
            with torch.no_grad():
                for p in self._params:
                    if id(p) in self._acc:
                        t = p._leaf_t()
                        t.grad = (self._acc[id(p)] * scale).to(t.grad.dtype)
            self.inner_optimizer.step()
            self._acc = {}
        # the gradients are in the accumulators now
        self.inner_optimizer.clear_grad()

    def clear_grad(self):
        pass  # step() clears them

    clear_gradients = clear_grad

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def __getattr__(self, name):
        return getattr(self.inner_optimizer, name)


# -- the fused softmax masks (the reference's incubate/operators) ----------


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask), the registered ``fused_softmax_mask`` op."""
    from ..ops.dispatch import dispatch

    return dispatch("fused_softmax_mask", {"X": [x], "Mask": [mask]},
                    {})["Out"][0]


def softmax_mask_fuse_upper_triangle(x, name=None):
    """The causal softmax (keys after the query's position masked), the
    registered ``fused_softmax_mask_upper_triangle`` op."""
    from ..ops.dispatch import dispatch

    return dispatch("fused_softmax_mask_upper_triangle", {"X": [x]},
                    {})["Out"][0]


# the reference exposes the auto-checkpoint package as incubate.checkpoint
from . import auto_checkpoint as checkpoint  # noqa: E402,F401

__all__ += ["softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
            "checkpoint", "auto_checkpoint"]

"""``GradScaler``: dynamic loss scaling.

Counterpart of ``paddle_tpu/amp/grad_scaler.py``: ``scale`` multiplies
the loss, ``unscale_`` (once a step) divides the gradients and records
whether any is not finite, ``step`` skips the update on an overflow, and
``update`` moves the scale: down by ``decr_ratio`` after
``decr_every_n_nan_or_inf`` bad steps, up by ``incr_ratio`` after
``incr_every_n_steps`` good ones.
"""

from __future__ import annotations

import torch


class GradScaler:
    def __init__(self, enable: bool = True, init_loss_scaling: float = 65536.0,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 2000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False
        self._already_unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        if not self._enable:
            return loss
        from .. import tensor_api as T

        return T.scale(loss, self._scale)

    def unscale_(self, optimizer):
        """Divide the gradients by the scale, once a step (the
        unscale_ -> clip -> step recipe does not divide twice)."""
        if not self._enable or self._already_unscaled:
            return
        inv = 1.0 / self._scale
        finite = None
        for p in optimizer._parameter_list or []:
            g = p._leaf_t().grad
            if g is None:
                continue
            gf = g.float() * inv
            ok = torch.isfinite(gf).all()
            finite = ok if finite is None else finite & ok
            g.copy_(gf.to(g.dtype))
        # one host sync for the whole gradient set
        self._found_inf = finite is not None and not bool(finite)
        self._already_unscaled = True

    def step(self, optimizer):
        """The update, skipped on an overflow; the scale moves in
        :meth:`update`."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        if not (self._enable and self._dynamic):
            self._already_unscaled = False
            return
        if not self._already_unscaled:
            return
        self._already_unscaled = False
        if self._found_inf:
            self._bad += 1
            self._good = 0
            if self._bad >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good = 0

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "incr_count": self._good,
                "decr_count": self._bad,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good = state.get("incr_count", 0)
        self._bad = state.get("decr_count", 0)


AmpScaler = GradScaler

"""Weight-decay regularizers.

Counterpart of ``paddle_tpu/regularizer.py``: a regularizer is a
callable ``(param, grad) -> grad`` built from dispatched ops.
"""

from __future__ import annotations

from . import tensor_api as T

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return T.add(grad, T.scale(T.sign(param), self.coeff))

    def __str__(self):
        return f"L1Decay({self.coeff})"


class L2Decay:
    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return T.add(grad, T.scale(param, self.coeff))

    def __str__(self):
        return f"L2Decay({self.coeff})"

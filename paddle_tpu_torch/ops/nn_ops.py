"""Dropout, the reference's ``dropout`` kernel (``paddle_tpu/ops/nn_ops.py``
``dropout_kernel``), decision for decision:

* ``p == 0`` in training is the identity, with NO draw;
* in eval (``training=False``) it is the identity (``upscale_in_train``,
  the mode the GPT uses; the other mode is not ported);
* otherwise keep = ``uniform(float32) < float32(1 - p)``; the kept
  values are multiplied by ``1 / (1 - p)`` rounded to x's dtype (0 when
  p >= 1) and the dropped ones are 0.

The uniforms come from :func:`paddle_tpu_torch.framework.random.uniform`
of the caller's key: the same key draws the same mask.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..framework import random as _random


def dropout(x, p: float, key: Optional[int], training: bool = True):
    """Dropout of ``x`` at rate ``p`` with the mask of ``key``
    (``upscale_in_train``)."""
    if p == 0.0 or not training:
        return x
    keep = _random.uniform(key, x.shape, x.device) < np.float32(1.0 - p)
    scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
    scale = torch.tensor(scale, dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros_like(x))

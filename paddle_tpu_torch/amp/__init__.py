"""``paddle.amp``: automatic mixed precision.

Counterpart of ``paddle_tpu/amp/``: :func:`auto_cast` (O1 / O2, bf16 by
default, with the reference's white and black lists), :func:`decorate`
(O2: low-precision parameters with fp32 master weights in the
optimizer) and :class:`GradScaler` (dynamic loss scaling, a passthrough
in effect for bf16, whose range is fp32's).
"""

from .auto_cast import amp_guard, auto_cast, black_list, decorate, white_list  # noqa: F401
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401

"""The dygraph (eager) engine: :class:`Tensor` over one ``torch.Tensor``,
the op tracer, and backward through torch autograd.

Counterpart of ``paddle_tpu/dygraph/``; ``dygraph/parallel.py`` holds
``DataParallel`` (imported on first use: it builds on
``distributed``).
"""

from .tensor import Tensor, to_tensor  # noqa: F401
from .base import (enable_grad, grad, is_grad_enabled, no_grad,  # noqa: F401
                   set_grad_enabled)
from . import tracer  # noqa: F401

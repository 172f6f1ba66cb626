"""``paddle.linalg``: ``cholesky``, ``norm`` and ``inv``.

Counterpart of ``paddle_tpu/linalg.py``: the reference's 2.1 surface
re-exports the three from its tensor functions, as the port does from
:mod:`paddle_tpu_torch.tensor_api`.
"""

from .tensor_api import cholesky  # noqa: F401
from .tensor_api import norm  # noqa: F401
from .tensor_api import inverse as inv  # noqa: F401

__all__ = ["cholesky", "norm", "inv"]

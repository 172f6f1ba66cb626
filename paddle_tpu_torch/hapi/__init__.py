"""``paddle.hapi``: the high-level API (``Model``, ``callbacks``,
``ProgressBar``, ``flops``).

Counterpart of ``paddle_tpu/hapi/__init__.py``.
"""

from .model import Model, InputSpec  # noqa: F401
from . import callbacks  # noqa: F401
from .progressbar import ProgressBar  # noqa: F401
from .dynamic_flops import flops  # noqa: F401

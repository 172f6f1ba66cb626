"""``fleet.utils``: activation recompute and the file systems.

Counterpart of ``paddle_tpu/distributed/fleet/utils/__init__.py``:
``recompute`` and ``fs`` (``LocalFS``, ``HDFSClient``).
"""

from . import recompute as recompute_mod  # noqa: F401
from .recompute import RecomputeFunction, recompute  # noqa: F401
from . import fs  # noqa: F401
from .fs import HDFSClient, LocalFS  # noqa: F401

__all__ = ["recompute", "RecomputeFunction", "fs", "LocalFS", "HDFSClient"]

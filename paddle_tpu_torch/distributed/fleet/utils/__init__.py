"""``fleet.utils``: activation recompute.

Counterpart of ``paddle_tpu/distributed/fleet/utils/__init__.py`` for
``recompute``; the file-system clients (``fs``, ``LocalFS``,
``HDFSClient``) come with the rest of ``distributed/`` (ROADMAP A.11).
"""

from . import recompute as recompute_mod  # noqa: F401
from .recompute import RecomputeFunction, recompute  # noqa: F401

__all__ = ["recompute", "RecomputeFunction"]

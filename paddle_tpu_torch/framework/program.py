"""The mode switch of ``paddle_tpu/framework/program.py``: dygraph
(eager) mode, the only mode of the port so far.

``in_dygraph_mode`` is always True here: :func:`enable_static` raises
NotImplementedError, since the ``Program`` / ``Block`` / ``Variable``
model, the static executor and every static branch below them wait for
graph mode (ROADMAP A.10).
"""

from __future__ import annotations

import contextlib

from . import unique_name

__all__ = ["in_dygraph_mode", "enable_static", "disable_static",
           "name_scope", "_dygraph_guard"]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


@contextlib.contextmanager
def name_scope(prefix: str):
    with unique_name.guard(prefix + "/"):
        yield


def in_dygraph_mode() -> bool:
    return True


def enable_static():
    raise NotImplementedError(
        "paddle_tpu_torch runs in dygraph mode only: static graphs "
        "(Program, Executor, append_backward) wait for graph mode, "
        "ROADMAP A.10")


def disable_static():
    """Dygraph mode is the only mode: nothing to switch."""


@contextlib.contextmanager
def _dygraph_guard(enabled: bool):
    if not enabled:
        enable_static()
    yield

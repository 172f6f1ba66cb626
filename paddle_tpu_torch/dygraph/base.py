"""Gradient switches and ``paddle.grad``.

Counterpart of ``paddle_tpu/dygraph/base.py``: ``no_grad`` and
``enable_grad`` (context managers and decorators), ``set_grad_enabled``
and ``is_grad_enabled`` switch torch's gradient mode, which the tracer
reads.
"""

from __future__ import annotations

import contextlib
import functools

from . import tracer
from .engine import calc_gradient


def is_grad_enabled() -> bool:
    return tracer.has_grad()


def set_grad_enabled(flag: bool):
    @contextlib.contextmanager
    def guard():
        old = tracer.set_grad_enabled(flag)
        try:
            yield
        finally:
            tracer.set_grad_enabled(old)

    return guard()


class _Switch:
    _flag = False

    def __enter__(self):
        self._old = tracer.set_grad_enabled(self._flag)
        return self

    def __exit__(self, *exc):
        tracer.set_grad_enabled(self._old)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with type(self)():
                return fn(*args, **kwargs)

        return wrapper


class no_grad(_Switch):
    """``paddle.no_grad``: a context manager or a decorator."""

    _flag = False


class enable_grad(_Switch):
    _flag = True


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``."""
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is not None and not isinstance(grad_outputs,
                                                   (list, tuple)):
        grad_outputs = [grad_outputs]
    return calc_gradient(outputs, inputs, grad_outputs=grad_outputs,
                         retain_graph=retain_graph, create_graph=create_graph,
                         allow_unused=allow_unused, no_grad_vars=no_grad_vars)

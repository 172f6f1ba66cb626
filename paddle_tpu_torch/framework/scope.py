"""Scope: a hierarchical name -> value store.

Counterpart of ``paddle_tpu/framework/scope.py`` (``Scope``,
``global_scope``, ``scope_guard``); values are torch tensors on the
device of the executor that made them.  The static executor reads a
program's persistables (parameters, optimizer state, BatchNorm
statistics) out of a scope and updates them there in place.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, object] = {}
        self._parent = parent
        self._kids = []

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def var(self, name: str):
        """Find or create (None until set)."""
        if name not in self._vars and (self._parent is None
                                       or not self._parent.has(name)):
            self._vars[name] = None
        return self.find_var(name)

    def set(self, name: str, value) -> None:
        self._vars[name] = value

    def find_var(self, name: str):
        if name in self._vars:
            return self._vars[name]
        if self._parent is not None:
            return self._parent.find_var(name)
        return None

    def has(self, name: str) -> bool:
        if name in self._vars:
            return True
        return self._parent.has(name) if self._parent is not None else False

    def local_names(self):
        return list(self._vars)

    def drop_kids(self):
        self._kids.clear()

    def erase(self, name: str) -> None:
        self._vars.pop(name, None)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old

"""import-guard and port-isolation: two import contracts, as passes.

Counterpart of ``paddle_tpu/analysis/import_guard.py``.

``import-guard`` is serving's no-new-deps contract:
``paddle_tpu_torch/serving/`` must stay importable (and auditable) with
only torch / numpy / stdlib — observability cannot drag in tensorboard /
prometheus / opentelemetry client deps — and the network stdlib is
scoped file by file, as the reference scopes it: a scheduler or engine
change that starts talking to the network fails here, not in a review.

``port-isolation`` is the port's own contract: no file of the port (nor
the chip smoke beside it) imports ``jax``, ``jaxlib`` or the JAX package
``paddle_tpu``; the port keeps its own copy of whatever it needs from
there.  ``tests/test_torch_isolation.py`` checks the same by importing.
"""

from __future__ import annotations

import ast
import sys
from typing import Dict, Iterable, Iterator, Set, Tuple

from .astlint import Finding, Rule, SourceModule, register

#: absolute import roots every guarded serving file may use
ALLOWED_ROOTS: Set[str] = {"torch", "numpy"}

#: stdlib roots SCOPED to specific serving files: the network surface
#: lives in frontend.py and only there; the routing tier (router.py) is
#: the only other file allowed to grow a transport.  json: the front end,
#: the Chrome trace writer (tracing.py) and the flight recorder's
#: canonical dump.  Keys are import roots, values the allowed basenames —
#: an empty set means banned everywhere in serving.
SCOPED_ROOTS: Dict[str, Set[str]] = {
    "asyncio": {"frontend.py", "router.py"},
    "http": {"frontend.py"},
    "socket": {"frontend.py", "router.py"},
    "socketserver": set(),
    "selectors": {"frontend.py", "router.py"},
    "ssl": set(),
    "json": {"frontend.py", "tracing.py", "flight_recorder.py"},
}

SERVING_PREFIX = "paddle_tpu_torch/serving/"

#: the roots no file of the port may import
FORBIDDEN_ROOTS: Set[str] = {"jax", "jaxlib", "paddle_tpu"}


def _stdlib(root: str) -> bool:
    return root in sys.stdlib_module_names


def _allowed(root: str, basename: str) -> bool:
    if root in SCOPED_ROOTS:
        return basename in SCOPED_ROOTS[root]
    return _stdlib(root) or root in ALLOWED_ROOTS


def absolute_imports(module: SourceModule) -> Iterator[Tuple[ast.AST, str,
                                                             str]]:
    """(node, root, full dotted name) of every absolute import in the
    module, at any scope."""
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name.split(".")[0], alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mod = node.module or ""
            yield node, mod.split(".")[0], mod


@register
class ImportGuardRule(Rule):
    name = "import-guard"
    description = ("serving/ imports only torch/numpy/stdlib, with network "
                   "stdlib scoped to the front end / router")
    scope = (SERVING_PREFIX,)

    def check_module(self, module: SourceModule) -> Iterable[Finding]:
        basename = module.relpath.rsplit("/", 1)[-1]
        for node, root, full in absolute_imports(module):
            if _allowed(root, basename):
                continue
            if root in SCOPED_ROOTS:
                ok_in = sorted(SCOPED_ROOTS[root]) or ["nowhere"]
                msg = (f"import of '{full}' is scoped to "
                       f"{'/'.join(ok_in)}, not {basename} — the serving "
                       f"network surface is confined by design")
            else:
                msg = (f"import of '{full}' pulls a non-torch/numpy/stdlib "
                       f"dependency into the serving-critical path")
            yield Finding(module.relpath, node.lineno, self.name, msg,
                          key=root)


@register
class PortIsolationRule(Rule):
    name = "port-isolation"
    description = ("no file of the port (or chip_smoke.py) imports jax, "
                   "jaxlib or the JAX package paddle_tpu")
    scope = ("paddle_tpu_torch/", "chip_smoke.py")

    def check_module(self, module: SourceModule) -> Iterable[Finding]:
        for node, root, full in absolute_imports(module):
            if root in FORBIDDEN_ROOTS:
                yield Finding(
                    module.relpath, node.lineno, self.name,
                    f"import of '{full}': the port imports nothing of JAX "
                    f"or the JAX package (keep a copy of what it needs)",
                    key=root)

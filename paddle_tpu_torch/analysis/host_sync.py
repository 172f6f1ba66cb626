"""host-sync: device-to-host syncs in code a CUDA graph would capture.

The torch counterpart of ``paddle_tpu/analysis/trace_safety.py``.  A jit
trace of the reference breaks on a host read of a traced value; a CUDA
graph capture of the port breaks the same way on a host read of a device
value (or, outside capture, silently stalls the dispatch pipeline that
the serving engine and the train step exist to keep full).  This pass
looks inside the functions that a capture would take — the serving
engine's decode, verify and prefill calls, the functional train step,
the flash and paged kernels' wrappers (``CAPTURED``) — and, transitively,
inside the same-module functions and same-class methods they call, for:

* ``x.item()``, ``x.tolist()``, ``x.cpu()``, ``x.numpy()`` — explicit
  device-to-host transfers;
* ``float(x)`` / ``int(x)`` / ``bool(x)`` on a value that is not
  statically known (shapes, ``len()``, literals and arithmetic over them
  are fine);
* ``torch.cuda.synchronize()``;
* ``np.asarray(x)`` / ``np.array(x)`` — a tensor materialised on host;
* bare ``assert`` — on a device boolean a host sync (and gone under
  ``python -O``).

The detection is static and conservative.  What the tree holds today is
recorded in the baseline by count: it can only shrink, so the work of
capturing these functions in CUDA graphs starts from that list.  A
flagged line that is host-only at runtime earns an inline ``#
graftlint: allow=host-sync`` with its justification.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional, Set

from .astlint import (Finding, Rule, SourceModule, collect_imports,
                      register, resolve_name)

#: the functions a CUDA graph would capture, by file (qualified names:
#: ``Class.method``, ``outer.inner``)
CAPTURED: Dict[str, Set[str]] = {
    "paddle_tpu_torch/serving/engine.py": {
        "ServingEngine._decode_call", "ServingEngine._verify_call",
        "ServingEngine._prefill_chunk"},
    "paddle_tpu_torch/models/gpt.py": {"build_functional_train_step.step"},
    "paddle_tpu_torch/kernels/flash.py": {
        "flash_fwd_cuda", "flash_bwd_dq_cuda", "flash_bwd_dkv_cuda",
        "attention", "attend"},
    "paddle_tpu_torch/kernels/paged_attention.py": {
        "paged_attention", "paged_attention_mq"},
    "paddle_tpu_torch/kernels/paged_prefill.py": {"paged_prefill"},
}

#: method calls that copy a device value to the host
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}


def _is_static(node: ast.AST) -> bool:
    """Conservatively true when the expression is known on the host:
    literals, shape / dtype metadata, len(), and arithmetic over those."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr in {"ndim", "dtype", "itemsize", "shape",
                             "nbytes", "is_cuda", "device"}
    if isinstance(node, ast.Subscript):
        return _is_static(node.value)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id in \
                {"len", "min", "max", "abs", "round", "sum", "ord"}:
            return all(_is_static(a) for a in node.args)
        if isinstance(node.func, ast.Attribute) and node.func.attr in \
                {"get", "prod", "bit_length", "numel", "dim", "size",
                 "element_size", "stride"}:
            return True
        return False
    if isinstance(node, ast.BinOp):
        return _is_static(node.left) and _is_static(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_static(node.operand)
    if isinstance(node, ast.IfExp):
        return _is_static(node.body) and _is_static(node.orelse)
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_static(e) for e in node.elts)
    return False


class _Index:
    """Every function of a module by qualified name, its enclosing class
    and scope, and its call edges: bare names resolved through the
    enclosing scopes (a closure, a module function) and ``self.name``
    resolved to a method of the enclosing class."""

    def __init__(self, tree: ast.AST):
        self.qual: Dict[ast.AST, str] = {}
        self.edges: Dict[ast.AST, Set[ast.AST]] = {}
        self._walk(tree, "", [], None)

    def _walk(self, node, prefix, scopes, cls):
        """``scopes``: the name -> def maps visible by bare name where
        ``node`` is defined; ``cls``: ``node``'s methods when it is a
        class body."""
        children = list(ast.iter_child_nodes(node))
        funcs = {c.name: c for c in children
                 if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef))}
        inner = scopes if cls is not None else scopes + [funcs]
        for child in children:
            if isinstance(child, ast.ClassDef):
                methods = {c.name: c for c in child.body
                           if isinstance(c, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))}
                self._walk(child, f"{prefix}{child.name}.", inner, methods)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.qual[child] = prefix + child.name
                self._calls(child, inner, cls)
                self._walk(child, f"{prefix}{child.name}.", inner, None)
            else:
                self._walk(child, prefix, scopes, cls)

    def _calls(self, fn, scopes, cls):
        local = {c.name: c for c in ast.walk(fn)
                 if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef))
                 and c is not fn}
        out = self.edges.setdefault(fn, set())
        for node in self._own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name):
                target = local.get(f.id)
                for sc in reversed(scopes):
                    if target is None:
                        target = sc.get(f.id)
                if target is not None:
                    out.add(target)
            elif isinstance(f, ast.Attribute) and cls is not None \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "self" and f.attr in cls:
                out.add(cls[f.attr])

    @staticmethod
    def _own_nodes(fn):
        """The nodes of ``fn``'s body, not those of the functions it
        defines (they are checked when they are called)."""
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))


@register
class HostSyncRule(Rule):
    name = "host-sync"
    description = ("flag .item() / .tolist() / .cpu() / .numpy() / "
                   "float()/int()/bool() / torch.cuda.synchronize / "
                   "np.asarray / bare assert in the functions a CUDA graph "
                   "would capture and their same-module callees")
    scope = tuple(CAPTURED)

    def marked(self, module: SourceModule, seeds: Optional[Set[str]] = None):
        """The functions of ``module`` reachable from its captured ones
        (``seeds``: qualified names; default ``CAPTURED``'s entry)."""
        seeds = CAPTURED.get(module.relpath, set()) if seeds is None \
            else seeds
        index = _Index(module.tree)
        marked = {fn for fn, q in index.qual.items() if q in seeds}
        frontier = list(marked)
        while frontier:
            for callee in index.edges.get(frontier.pop(), ()):
                if callee not in marked:
                    marked.add(callee)
                    frontier.append(callee)
        return marked, index

    def check_module(self, module: SourceModule,
                     seeds: Optional[Set[str]] = None
                     ) -> Iterable[Finding]:
        imports = collect_imports(module.tree)
        marked, index = self.marked(module, seeds)
        for fn in sorted(marked, key=lambda f: f.lineno):
            yield from self._check_body(module, fn, index.qual[fn], imports)

    def _check_body(self, module, fn, qual, imports) -> Iterable[Finding]:
        where = f"captured `{qual}`"
        for node in _Index._own_nodes(fn):
            if isinstance(node, ast.Assert):
                yield Finding(
                    module.relpath, node.lineno, self.name,
                    f"bare assert in {where} — a device boolean syncs the "
                    f"host (and vanishes under -O); check on the host "
                    f"before the capture", key="assert")
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in HOST_METHODS \
                        and not node.args:
                    yield Finding(
                        module.relpath, node.lineno, self.name,
                        f".{f.attr}() in {where} copies a device value to "
                        f"the host (a sync; a capture breaks on it)",
                        key=f.attr)
                    continue
                name = resolve_name(f, imports)
                if name in {"numpy.asarray", "numpy.array"}:
                    yield Finding(
                        module.relpath, node.lineno, self.name,
                        f"{name}() in {where} materialises a tensor on the "
                        f"host", key=name)
                elif name == "torch.cuda.synchronize":
                    yield Finding(
                        module.relpath, node.lineno, self.name,
                        f"torch.cuda.synchronize() in {where} waits for the "
                        f"device", key=name)
                elif isinstance(f, ast.Name) \
                        and f.id in {"float", "int", "bool"} \
                        and node.args and not _is_static(node.args[0]):
                    yield Finding(
                        module.relpath, node.lineno, self.name,
                        f"{f.id}() on a possibly-device value in {where} — "
                        f"a host sync; keep it a tensor or compute it on "
                        f"the host", key=f.id)

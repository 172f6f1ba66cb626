"""graftlint core for the port: rule registry, suppression/baseline
machinery, runner.

Counterpart of ``paddle_tpu/analysis/astlint.py`` (the port keeps its own
copy: it imports nothing of the JAX package).  The pass suite reads
Python ASTs (:mod:`paddle_tpu_torch.analysis` rules, this module is the
pass manager); the recorder of the aten ops a call dispatches is
:mod:`paddle_tpu_torch.analysis.op_audit`.

Vocabulary
----------
* **Rule** — one named invariant over source modules (an "IR pass" that
  only reads).  Rules register themselves in :data:`REGISTRY` via
  :func:`register` and declare a ``scope`` of repo-relative path
  prefixes they apply to; project-level rules (``check_project``) see
  every module at once plus non-Python files like README.md.
* **Finding** — one violation, rendered ``file:line rule message``.
* **Suppression** — an inline ``# graftlint: allow=<rule>[,<rule>]``
  comment on the flagged line (or alone on the line above) acknowledges
  a finding; suppressed findings are reported but do not fail the run.
  A suppression should carry a justification comment next to it.
* **Baseline** — code that predates a rule's discipline (the launcher's
  deadline polling, the global-RNG data shufflers, the host syncs that a
  CUDA graph capture will have to remove) is carried by
  :mod:`paddle_tpu_torch.analysis.baseline` as per-(file, rule, symbol)
  allowances; findings beyond the recorded count — i.e. NEW code
  repeating the old pattern — still fail.

Everything here is stdlib-only (``ast`` + ``re``): the analyzer must be
importable where torch itself is broken, because it is exactly then that
you want to lint.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding", "Rule", "SourceModule", "Project", "REGISTRY",
    "register", "all_rules", "run", "load_project",
    "collect_imports", "resolve_name",
]

# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


class Finding:
    """One rule violation at one source location.

    ``key`` is the rule-specific symbol the finding is about (e.g. the
    dotted call target ``"time.time"`` or the import root ``"requests"``)
    — it is what baseline entries match on, so it must be stable under
    unrelated edits (line numbers are not).
    """

    __slots__ = ("path", "line", "rule", "message", "key",
                 "suppressed", "baselined")

    def __init__(self, path: str, line: int, rule: str, message: str,
                 key: str = ""):
        self.path = path
        self.line = int(line)
        self.rule = rule
        self.message = message
        self.key = key or message
        self.suppressed = False
        self.baselined = False

    @property
    def active(self) -> bool:
        """True when the finding should fail the run."""
        return not (self.suppressed or self.baselined)

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message, "key": self.key,
                "suppressed": self.suppressed, "baselined": self.baselined}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        tag = "" if self.active else (" [suppressed]" if self.suppressed
                                      else " [baselined]")
        return f"<Finding {self.format()}{tag}>"


# ---------------------------------------------------------------------------
# suppression comments
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*allow=([A-Za-z0-9_,\-]+)")


def _parse_suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """Map 1-based line number -> set of rule names allowed there.

    A comment on a code line covers that line; a comment alone on its
    line covers the NEXT line too (for flagged lines too long to share
    with a justification).
    """
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        if text.lstrip().startswith("#"):      # standalone comment line
            out.setdefault(i + 1, set()).update(rules)
    return out


# ---------------------------------------------------------------------------
# source modules / project
# ---------------------------------------------------------------------------


class SourceModule:
    """One parsed Python file plus its graftlint suppression table."""

    def __init__(self, abspath: str, relpath: str):
        self.abspath = abspath
        self.relpath = relpath.replace(os.sep, "/")
        with open(abspath, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=relpath)
        self.suppressions = _parse_suppressions(self.lines)

    def allows(self, line: int, rule: str) -> bool:
        return rule in self.suppressions.get(line, ())


class Project:
    """The unit a run sees: parsed modules under one repo root."""

    def __init__(self, root: str, modules: List[SourceModule]):
        self.root = root
        self.modules = modules

    def module(self, relpath: str) -> Optional[SourceModule]:
        for m in self.modules:
            if m.relpath == relpath:
                return m
        return None

    def read_text(self, relpath: str) -> Optional[str]:
        """Non-Python project file (README.md, …); None if absent."""
        p = os.path.join(self.root, relpath)
        if not os.path.exists(p):
            return None
        with open(p, "r", encoding="utf-8") as f:
            return f.read()


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


class Rule:
    """Base class for one analysis pass.

    Subclasses set ``name``/``description``, optionally ``scope`` (repo-
    relative path prefixes; a prefix ending in ``.py`` matches exactly,
    otherwise it matches the subtree), and implement ``check_module``
    and/or ``check_project``.
    """

    name: str = ""
    description: str = ""
    scope: Tuple[str, ...] = ()

    def applies_to(self, relpath: str) -> bool:
        if not self.scope:
            return True
        for prefix in self.scope:
            if prefix.endswith(".py"):
                if relpath == prefix:
                    return True
            elif relpath.startswith(prefix.rstrip("/") + "/"):
                return True
        return False

    def check_module(self, module: SourceModule) -> Iterable[Finding]:
        return ()

    def check_project(self, project: Project) -> Iterable[Finding]:
        return ()


REGISTRY: Dict[str, type] = {}


def register(cls):
    """Class decorator: add a Rule subclass to the global registry."""
    if not cls.name:
        raise ValueError(f"rule {cls!r} must set a name")
    if cls.name in REGISTRY and REGISTRY[cls.name] is not cls:
        raise ValueError(f"duplicate rule name {cls.name!r}")
    REGISTRY[cls.name] = cls
    return cls


def all_rules() -> Dict[str, type]:
    """Import the shipped pass modules (self-registering) and return the
    registry.  Kept lazy so ``analysis.op_audit`` users never pay for the
    linter and vice versa."""
    from . import determinism, host_sync, import_guard, metrics_docs  # noqa: F401
    return dict(REGISTRY)


# ---------------------------------------------------------------------------
# shared AST utilities (used by several rules)
# ---------------------------------------------------------------------------


def collect_imports(tree: ast.AST) -> Dict[str, str]:
    """Map local name -> absolute dotted module path for every import in
    the module (all scopes).  Relative imports map to ``"<rel>"`` — they
    stay inside the package and are never an external hazard."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                target = alias.name if alias.asname else alias.name.split(".")[0]
                out[local] = target
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            for alias in node.names:
                local = alias.asname or alias.name
                if node.level > 0:
                    out[local] = "<rel>"
                else:
                    out[local] = f"{base}.{alias.name}" if base else alias.name
    return out


def resolve_name(node: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """Resolve a Name/Attribute chain to an absolute dotted path using the
    module's import map; None when the chain roots at a local variable."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    base = imports.get(node.id)
    if base is None:
        return None
    parts.append(base)
    return ".".join(reversed(parts))


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

_SKIP_DIRS = {"__pycache__", ".git", ".claude"}


#: the tree a run reads by default, below the repo root
DEFAULT_PATHS = ("paddle_tpu_torch",)


def default_root() -> str:
    """Repo root = the directory containing the ``paddle_tpu_torch``
    package."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg_dir)


def iter_python_files(root: str, paths: Optional[Sequence[str]] = None
                      ) -> List[Tuple[str, str]]:
    """(abspath, relpath) for every .py under ``paths`` (default: the
    ``paddle_tpu_torch`` package below ``root``), sorted for stable
    output."""
    roots = [os.path.join(root, p) for p in (paths or DEFAULT_PATHS)]
    found: List[Tuple[str, str]] = []
    for r in roots:
        if os.path.isfile(r):
            found.append((r, os.path.relpath(r, root)))
            continue
        for dirpath, dirnames, filenames in os.walk(r):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    ap = os.path.join(dirpath, fn)
                    found.append((ap, os.path.relpath(ap, root)))
    return found


def load_project(root: Optional[str] = None,
                 paths: Optional[Sequence[str]] = None) -> Project:
    root = os.path.abspath(root or default_root())
    modules = [SourceModule(ap, rp) for ap, rp in iter_python_files(root, paths)]
    return Project(root, modules)


def _apply_baseline(findings: List[Finding], baseline: Dict) -> None:
    """Mark findings covered by the recorded legacy allowances.

    ``baseline`` maps rule name -> {(relpath, key): allowed_count}.
    Within one (file, rule, key) group the first N findings are
    baselined; the N+1-th — new code repeating the legacy pattern —
    stays active.  Suppressed findings never consume an allowance.
    """
    used: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        if f.suppressed:
            continue
        allowed = baseline.get(f.rule, {}).get((f.path, f.key), 0)
        if not allowed:
            continue
        k = (f.path, f.rule, f.key)
        if used.get(k, 0) < allowed:
            used[k] = used.get(k, 0) + 1
            f.baselined = True


def run(root: Optional[str] = None,
        paths: Optional[Sequence[str]] = None,
        rules: Optional[Sequence[str]] = None,
        with_baseline: bool = True,
        project: Optional[Project] = None) -> List[Finding]:
    """Run the pass suite; return ALL findings (callers filter on
    ``.active``).  ``rules`` selects a subset by name."""
    registry = all_rules()
    if rules is not None:
        unknown = sorted(set(rules) - set(registry))
        if unknown:
            raise ValueError(f"unknown rule(s): {unknown}; "
                             f"known: {sorted(registry)}")
        registry = {k: v for k, v in registry.items() if k in rules}
    if project is None:
        project = load_project(root, paths)

    findings: List[Finding] = []
    instances = [cls() for _, cls in sorted(registry.items())]
    for rule in instances:
        for mod in project.modules:
            if rule.applies_to(mod.relpath):
                findings.extend(rule.check_module(mod))
        findings.extend(rule.check_project(project))

    # suppressions (only meaningful for findings inside parsed modules)
    mods = {m.relpath: m for m in project.modules}
    for f in findings:
        m = mods.get(f.path)
        if m is not None and m.allows(f.line, f.rule):
            f.suppressed = True

    if with_baseline:
        from .baseline import BASELINE
        _apply_baseline(findings, BASELINE)

    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings

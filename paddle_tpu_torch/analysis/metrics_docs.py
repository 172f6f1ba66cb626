"""metrics-docs: the README metric table and the port's registry cannot
drift.

Counterpart of ``paddle_tpu/analysis/metrics_docs.py``, over the port's
serving package, whose metric families are the reference's by name (one
README table documents both).  ``paddle_tpu_torch/serving`` registers
every time series through exactly three
factory methods — ``registry.counter/gauge/histogram(name, help, …)`` —
and the README documents them in the observability metric table.  Both
sides are static text, so drift is statically checkable:

* every ``serving_*`` family named in the README **metric table** must
  be registered somewhere in ``serving/`` (a stale table row fails);
* every family registered in ``serving/`` must appear somewhere in the
  README (an undocumented metric fails at its registration site, where
  an inline suppression can record why it is intentionally internal).

Name extraction understands the two registration idioms in the tree:
string literals (including local aliases ``c = self.metrics.counter``)
and f-strings (``f"serving_requests_terminal_{r}"``), which become
``*`` patterns — such a pattern is "documented" when at least one
documented name matches it, and a documented name is "registered" when
any literal or pattern matches.  README tokens expand the table's
``{a,b,c}`` shorthand and drop ``{label=...}`` groups.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from typing import Dict, Iterable, List, Set, Tuple

from .astlint import Finding, Project, Rule, register

SERVING_PREFIX = "paddle_tpu_torch/serving/"
KINDS = {"counter", "gauge", "histogram"}

#: metric families must look like prometheus names from our namespace,
#: optionally carrying `{a,b}` expansion or `{label=...}` selector syntax
_NAME_RE = re.compile(r"serving_[A-Za-z0-9_{},=|]*")
_TICK_RE = re.compile(r"`([^`\n]*)`")
_LABEL_GROUP_RE = re.compile(r"\{[^{}]*=[^{}]*\}")


# ---------------------------------------------------------------------------
# registration extraction (python side)
# ---------------------------------------------------------------------------


def _local_aliases(tree: ast.AST) -> Set[str]:
    """Names bound to a registry factory (``c = self.metrics.counter``)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Attribute) \
                and node.value.attr in KINDS:
            out.add(node.targets[0].id)
    return out


def _first_arg_name(call: ast.Call) -> Tuple[str, bool]:
    """(name-or-pattern, is_pattern) from the call's first argument;
    ("", False) when it is not a string-ish literal."""
    if not call.args:
        return "", False
    arg = call.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, False
    if isinstance(arg, ast.JoinedStr):
        parts: List[str] = []
        for v in arg.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("*")
        return "".join(parts), True
    return "", False


def registered_metrics(project: Project
                       ) -> List[Tuple[str, bool, str, int]]:
    """Every statically-visible registration in serving/:
    (name_or_pattern, is_pattern, relpath, line)."""
    out: List[Tuple[str, bool, str, int]] = []
    for mod in project.modules:
        if not mod.relpath.startswith(SERVING_PREFIX):
            continue
        aliases = _local_aliases(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            tail = f.attr if isinstance(f, ast.Attribute) else \
                (f.id if isinstance(f, ast.Name) else "")
            # registry factories, local aliases (c = self.metrics.counter),
            # and kind-named wrappers (_tenant_counter, …)
            is_factory = tail in KINDS or tail in aliases \
                or any(k in tail.lower() for k in KINDS)
            if not is_factory:
                continue
            name, is_pattern = _first_arg_name(node)
            if name.startswith("serving_"):
                out.append((name, is_pattern, mod.relpath, node.lineno))
    return out


# ---------------------------------------------------------------------------
# documentation extraction (README side)
# ---------------------------------------------------------------------------


def _expand(token: str) -> List[str]:
    """``serving_step_{admit,prefill,decode}_s`` -> three names;
    ``{label=...}`` groups are selector syntax, not part of the name."""
    token = _LABEL_GROUP_RE.sub("", token)
    m = re.search(r"\{([^{}=]*)\}", token)
    if m is None:
        # leftover unbalanced braces (e.g. a label selector the regex
        # truncated mid-way): keep the name up to the brace
        token = token.split("{")[0].split("}")[0]
        return [token] if token else []
    head, tail = token[:m.start()], token[m.end():]
    out: List[str] = []
    for alt in m.group(1).split(","):
        out.extend(_expand(head + alt.strip() + tail))
    return out


def documented_metrics(readme: str) -> Tuple[Set[str], Dict[str, int]]:
    """(all documented names anywhere, table_name -> line) — the table
    is any markdown row whose cells declare a metric kind."""
    documented: Set[str] = set()
    table: Dict[str, int] = {}
    for lineno, line in enumerate(readme.splitlines(), start=1):
        names_here: List[str] = []
        for span in _TICK_RE.findall(line):
            for tok in _NAME_RE.findall(span):
                names_here.extend(_expand(tok))
        documented.update(names_here)
        stripped = line.strip()
        if stripped.startswith("|") and any(
                f"| {k}" in line for k in KINDS):
            for n in names_here:
                table.setdefault(n, lineno)
    return documented, table


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


@register
class MetricsDocsRule(Rule):
    name = "metrics-docs"
    description = ("README metric table rows must be registered in "
                   "serving/, and every registered serving_* family "
                   "must be documented in the README")
    scope = (SERVING_PREFIX,)

    readme_path = "README.md"

    def check_project(self, project: Project) -> Iterable[Finding]:
        readme = project.read_text(self.readme_path)
        if readme is None:
            return      # fixture trees without docs have nothing to drift
        registered = registered_metrics(project)
        documented, table = documented_metrics(readme)

        literals = {name for name, is_pat, _, _ in registered if not is_pat}
        patterns = [name for name, is_pat, _, _ in registered if is_pat]

        for name, lineno in sorted(table.items()):
            if name in literals:
                continue
            if any(fnmatch.fnmatchcase(name, p) for p in patterns):
                continue
            yield Finding(
                self.readme_path, lineno, self.name,
                f"metric `{name}` is documented in the README table but "
                f"never registered in {SERVING_PREFIX} — stale docs",
                key=name)

        for name, is_pat, relpath, lineno in registered:
            if is_pat:
                ok = any(fnmatch.fnmatchcase(d, name) for d in documented)
            else:
                ok = name in documented
            if not ok:
                yield Finding(
                    relpath, lineno, self.name,
                    f"metric `{name}` is registered here but undocumented "
                    f"in {self.readme_path} — add it to the metric table",
                    key=name)

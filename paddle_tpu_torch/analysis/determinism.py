"""determinism-discipline: no ambient wall clocks, no unseeded RNG.

Counterpart of ``paddle_tpu/analysis/determinism.py``, with the torch
sources of randomness added.  The port's chaos-replay, flight-recorder
and snapshot-restore guarantees rest on two conventions:

* **Time** flows from an injectable clock (``ServingEngine(clock=)``,
  ``FaultPlan.now``, ``TraceRecorder(clock=)``) — never read directly
  from ``time.time()`` / ``time.monotonic()`` / ``datetime.now()`` at a
  decision site.  ``time.perf_counter`` stays sanctioned: it feeds the
  wall-time observability histograms, which measure the host, never
  steer it.
* **Randomness** flows from seeded generators — ``torch.Generator``
  objects handed over as ``generator=``, ``np.random.RandomState(seed)``
  / ``default_rng(seed)``, the seeded ``FaultPlan`` — never the
  process-global ``random.*`` / ``np.random.*`` / torch state: a
  ``torch.manual_seed`` call (which reseeds everyone's ambient stream),
  or ``torch.rand*`` / ``randint`` / ``randperm`` / ``normal`` /
  ``bernoulli`` / ``multinomial`` without ``generator=``.

This pass flags raw call sites of the ambient sources, plus bare
references to the wall clocks (binding ``time.monotonic`` as a fallback
is the one sanctioned idiom, carried by inline suppressions).  Code that
predates the discipline is carried by the baseline — new code in it is
still checked.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional

from .astlint import (Finding, Rule, SourceModule, collect_imports,
                      register, resolve_name)

#: ambient wall-clock reads (decision-site hazards).  perf_counter is
#: deliberately absent — see the module docstring.
BANNED_CLOCKS = {
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

#: numpy.random constructors that are fine WHEN GIVEN A SEED
SEEDED_NP_CTORS = {"RandomState", "default_rng", "Generator",
                   "SeedSequence", "PCG64", "Philox"}

#: torch draws that read the ambient generator unless given generator=
TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
               "randint_like", "randperm", "normal", "bernoulli",
               "multinomial", "poisson"}

#: calls that reseed the process-global torch generators
TORCH_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
               "torch.cuda.manual_seed_all", "torch.cuda.seed",
               "torch.cuda.seed_all", "torch.random.manual_seed",
               "torch.random.seed"}

_CLOCK_HINT = ("inject the engine clock (ServingEngine(clock=) / "
               "FaultPlan.now) instead — chaos replays and "
               "flight-recorder dumps must be bit-identical")
_RNG_HINT = ("use a seeded generator (a torch.Generator passed as "
             "generator=, np.random.RandomState(seed), default_rng(seed)) "
             "— process-global RNG state breaks replay determinism")


def _dotted(node: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    return resolve_name(node, imports)


@register
class DeterminismRule(Rule):
    name = "determinism"
    description = ("flag ambient wall-clock reads and unseeded global "
                   "RNG (random, np.random, torch's ambient generator); "
                   "the injectable clock and seeded generators are the "
                   "only sanctioned sources")
    # port-wide: legacy code is carried by the baseline, not exempted
    scope = ()

    def check_module(self, module: SourceModule) -> Iterable[Finding]:
        imports = collect_imports(module.tree)
        call_funcs = set()          # Attribute/Name nodes used as callees
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                call_funcs.add(id(node.func))
                yield from self._check_call(module, node, imports)
        # bare references to clocks (bound/passed, not called)
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.Attribute, ast.Name)) \
                    and id(node) not in call_funcs:
                name = _dotted(node, imports)
                if name in BANNED_CLOCKS:
                    yield Finding(
                        module.relpath, node.lineno, self.name,
                        f"binds ambient clock {name} as a value — "
                        f"{_CLOCK_HINT}", key=name)

    def _check_call(self, module: SourceModule, node: ast.Call,
                    imports: Dict[str, str]) -> Iterable[Finding]:
        name = _dotted(node.func, imports)
        if name is None:
            return
        if name in BANNED_CLOCKS:
            yield Finding(module.relpath, node.lineno, self.name,
                          f"raw {name}() call — {_CLOCK_HINT}", key=name)
            return
        parts = name.split(".")
        if parts[0] == "random" and len(parts) >= 2:
            # stdlib random module: everything is global-state except a
            # seeded private generator instance
            if parts[1] == "Random" and (node.args or node.keywords):
                return
            yield Finding(module.relpath, node.lineno, self.name,
                          f"global-state {name}() call — {_RNG_HINT}",
                          key=name)
        elif name.startswith("numpy.random.") and len(parts) >= 3:
            if parts[2] in SEEDED_NP_CTORS and (node.args or node.keywords):
                return
            yield Finding(module.relpath, node.lineno, self.name,
                          f"global-state {name}() call — {_RNG_HINT}",
                          key=name)
        elif name in TORCH_SEEDS:
            yield Finding(module.relpath, node.lineno, self.name,
                          f"{name}() reseeds the process-global torch "
                          f"generator — {_RNG_HINT}", key=name)
        elif parts[0] == "torch" and parts[-1] in TORCH_DRAWS \
                and len(parts) == 2 \
                and not any(kw.arg == "generator" for kw in node.keywords):
            yield Finding(module.relpath, node.lineno, self.name,
                          f"{name}() without generator= draws from the "
                          f"ambient torch generator — {_RNG_HINT}",
                          key=name)

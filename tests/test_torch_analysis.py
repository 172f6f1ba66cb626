"""graftlint for the port (paddle_tpu_torch.analysis): rule units,
suppressions, the port's gate, the CLI and the op recorder.

Mirrors ``tests/test_analysis.py`` case for case where the port has the
rule (``trace-safety``'s cases become ``host-sync``'s: a step function a
CUDA graph would capture where the reference has a jitted one), on
snippets under ``tmp_path``: the violating pattern fires, the sanctioned
idiom stays silent.  Then the port's own rules (``port-isolation``, the
torch sources of ``determinism``, ``host-sync``'s transitive callees),
``op_audit``'s recording, and the gate: the port's tree with zero
unsuppressed findings.  Everything here is CPU-only and cheap.
"""

import json
import subprocess
import sys
import textwrap

import pytest
import torch

from paddle_tpu_torch.analysis import run
from paddle_tpu_torch.analysis.astlint import (Project, SourceModule,
                                               _apply_baseline, all_rules,
                                               default_root)
from paddle_tpu_torch.analysis.determinism import DeterminismRule
from paddle_tpu_torch.analysis.host_sync import HostSyncRule
from paddle_tpu_torch.analysis.import_guard import (ImportGuardRule,
                                                    PortIsolationRule)
from paddle_tpu_torch.analysis.metrics_docs import MetricsDocsRule

pytestmark = pytest.mark.analysis


def _mod(tmp_path, relpath, src):
    """A snippet as a SourceModule at a chosen repo-relative path (the
    path drives rule scoping)."""
    p = tmp_path / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return SourceModule(str(p), relpath)


def _check(rule, module, **kw):
    """One rule over one module with suppressions applied, as the runner
    does."""
    findings = list(rule.check_module(module, **kw))
    for f in findings:
        if module.allows(f.line, f.rule):
            f.suppressed = True
    return findings


def _active(rule, module, **kw):
    return [f for f in _check(rule, module, **kw) if f.active]


# ---------------------------------------------------------------------------
# import-guard and port-isolation
# ---------------------------------------------------------------------------


def test_import_guard_flags_third_party_dep(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/serving/engine.py", """\
        import requests
        import numpy as np
        import torch
    """)
    fs = _active(ImportGuardRule(), m)
    assert [f.key for f in fs] == ["requests"]
    assert fs[0].line == 1 and "non-torch/numpy/stdlib" in fs[0].message


def test_import_guard_network_stdlib_is_scoped(tmp_path):
    bad = _mod(tmp_path, "paddle_tpu_torch/serving/scheduler.py",
               "import asyncio\n")
    fs = _active(ImportGuardRule(), bad)
    assert [f.key for f in fs] == ["asyncio"]
    assert "scoped to" in fs[0].message
    ok = _mod(tmp_path, "paddle_tpu_torch/serving/frontend.py",
              "import asyncio\nimport json\n")
    assert _active(ImportGuardRule(), ok) == []


def test_import_guard_relative_and_stdlib_silent(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/serving/kv_pool.py", """\
        import math
        from dataclasses import dataclass
        from .metrics import MetricsRegistry
        from . import faults
    """)
    assert _active(ImportGuardRule(), m) == []


def test_import_guard_flags_absolute_self_and_jax_imports(tmp_path):
    # serving/ imports the port relatively only, and never jax
    s = _mod(tmp_path, "paddle_tpu_torch/serving/router.py",
             "from paddle_tpu_torch.framework import core\nimport jax\n")
    assert sorted(f.key for f in _active(ImportGuardRule(), s)) == \
        ["jax", "paddle_tpu_torch"]


def test_import_guard_out_of_scope_files_ignored():
    rule = ImportGuardRule()
    assert not rule.applies_to("paddle_tpu_torch/vision/models.py")
    assert not rule.applies_to("paddle_tpu/serving/engine.py")
    assert rule.applies_to("paddle_tpu_torch/serving/engine.py")


def test_port_isolation_flags_jax_and_the_reference(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/models/x.py", """\
        import torch
        import jax.numpy as jnp
        from jaxlib import xla_client
        from paddle_tpu.kernels import flash
        import paddle_tpu_torch

        def late():
            import paddle_tpu
    """)
    fs = _active(PortIsolationRule(), m)
    assert [(f.key, f.line) for f in fs] == [
        ("jax", 2), ("jaxlib", 3), ("paddle_tpu", 4), ("paddle_tpu", 8)]
    rule = PortIsolationRule()
    assert rule.applies_to("chip_smoke.py")
    assert not rule.applies_to("tests/test_torch_flash.py")


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------


def test_determinism_flags_ambient_clock_calls(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/serving/x.py", """\
        import time
        import datetime

        def decide():
            t0 = time.time()
            d = datetime.datetime.now()
            return t0, d
    """)
    assert sorted(f.key for f in _active(DeterminismRule(), m)) == \
        ["datetime.datetime.now", "time.time"]


def test_determinism_flags_bare_clock_binding(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/serving/x.py", """\
        import time

        class E:
            def __init__(self, clock=None):
                self._clock = clock or time.monotonic
    """)
    fs = _active(DeterminismRule(), m)
    assert [f.key for f in fs] == ["time.monotonic"]
    assert "binds ambient clock" in fs[0].message


def test_determinism_perf_counter_and_injected_clock_silent(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/serving/x.py", """\
        import time

        def observe(h):
            t0 = time.perf_counter()
            h.observe(time.perf_counter() - t0)

        def decide(clock):
            return clock()
    """)
    assert _active(DeterminismRule(), m) == []


def test_determinism_flags_global_rng_allows_seeded(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/serving/x.py", """\
        import random
        import numpy as np

        def bad():
            return random.random(), np.random.rand(3), random.shuffle([])

        def good(seed):
            rs = np.random.RandomState(seed)
            rng = np.random.default_rng(seed)
            r = random.Random(seed)
            return rs.rand(3), rng.random(), r.random()
    """)
    fs = _active(DeterminismRule(), m)
    assert sorted(f.key for f in fs) == \
        ["numpy.random.rand", "random.random", "random.shuffle"]
    assert all(f.line <= 6 for f in fs)


def test_determinism_resolves_aliases(tmp_path):
    # `from time import time as now` resolves to time.time; a method
    # named like a draw on a generator object is not torch's
    m = _mod(tmp_path, "paddle_tpu_torch/serving/x.py", """\
        from time import time as now
        import torch

        def f(g, x):
            return now(), g.normal(x), x.random_()
    """)
    assert [f.key for f in _active(DeterminismRule(), m)] == ["time.time"]


def test_determinism_flags_torch_ambient_generator(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/models/x.py", """\
        import torch
        from torch import randn

        def bad(shape):
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(0)
            return (torch.rand(shape), randn(shape),
                    torch.randint(0, 9, shape), torch.randperm(9),
                    torch.bernoulli(torch.ones(3)))

        def good(shape, g):
            return (torch.rand(shape, generator=g),
                    torch.randint(0, 9, shape, generator=g),
                    torch.normal(0.0, 1.0, shape, generator=g),
                    torch.zeros(shape))
    """)
    fs = _active(DeterminismRule(), m)
    assert sorted(f.key for f in fs) == [
        "torch.bernoulli", "torch.cuda.manual_seed_all", "torch.manual_seed",
        "torch.rand", "torch.randint", "torch.randn", "torch.randperm"]
    assert all(f.line <= 9 for f in fs)
    assert "generator=" in fs[0].message or "reseeds" in fs[0].message


# ---------------------------------------------------------------------------
# host-sync (the torch analogue of trace-safety)
# ---------------------------------------------------------------------------


def test_host_sync_flags_hazards_in_a_step_function(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/models/x.py", """\
        import numpy as np
        import torch

        def step(x):
            assert x.sum() > 0
            v = float(x[0])
            host = np.asarray(x)
            torch.cuda.synchronize()
            return x.item(), v, host, x.tolist(), x.cpu(), x.numpy()
    """)
    keys = sorted(f.key for f in _active(HostSyncRule(), m, seeds={"step"}))
    assert keys == ["assert", "cpu", "float", "item", "numpy",
                    "numpy.asarray", "tolist", "torch.cuda.synchronize"]


def test_host_sync_host_only_fn_silent(tmp_path):
    # the same hazards in a function no capture reaches are host idiom
    m = _mod(tmp_path, "paddle_tpu_torch/models/x.py", """\
        import numpy as np

        def summarize(x):
            assert x.numel() > 0
            return float(np.asarray(x).mean()), x.item()

        def step(x):
            return x * 2
    """)
    assert _active(HostSyncRule(), m, seeds={"step"}) == []


def test_host_sync_static_conversions_silent(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/models/x.py", """\
        def step(x, scale):
            n = int(x.shape[0])
            k = float(len(x.shape) * 2)
            d = int(x.size(-1)) + int(x.dim())
            return x * n * k * d
    """)
    assert _active(HostSyncRule(), m, seeds={"step"}) == []


def test_host_sync_nested_step_and_methods_are_marked(tmp_path):
    # a step built by a closure factory, and an engine method that calls
    # another method of its class
    m = _mod(tmp_path, "paddle_tpu_torch/serving/x.py", """\
        def build():
            def step(x):
                return x.item()
            return step

        class Engine:
            def _decode_call(self, x):
                return self._read(x)

            def _read(self, x):
                return x.tolist()

            def other(self, x):
                return x.numpy()
    """)
    fs = _active(HostSyncRule(), m,
                 seeds={"build.step", "Engine._decode_call"})
    assert sorted((f.key, f.line) for f in fs) == [("item", 3),
                                                   ("tolist", 11)]
    assert "Engine._read" in fs[1].message or "Engine._read" in \
        fs[0].message


def test_host_sync_transitive_callee_is_marked(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/models/x.py", """\
        def helper(x):
            return x.item()

        def step(x):
            return helper(x)
    """)
    fs = _active(HostSyncRule(), m, seeds={"step"})
    assert [f.key for f in fs] == ["item"]
    assert "helper" in fs[0].message


def test_host_sync_captured_functions_name_real_code():
    """Every function the rule treats as captured exists in the port."""
    from paddle_tpu_torch.analysis.host_sync import CAPTURED, _Index

    root = default_root()
    for relpath, names in CAPTURED.items():
        mod = SourceModule(f"{root}/{relpath}", relpath)
        quals = set(_Index(mod.tree).qual.values())
        assert names <= quals, (relpath, names - quals)


# ---------------------------------------------------------------------------
# metrics-docs
# ---------------------------------------------------------------------------


def _metrics_project(tmp_path, serving_src, readme):
    m = _mod(tmp_path, "paddle_tpu_torch/serving/metrics_user.py",
             serving_src)
    (tmp_path / "README.md").write_text(textwrap.dedent(readme))
    return Project(str(tmp_path), [m])


def test_metrics_docs_undocumented_registration_fires(tmp_path):
    project = _metrics_project(tmp_path, """\
        def setup(reg):
            reg.counter("serving_widgets", "widget count")
    """, """\
        | name | kind |
        |------|------|
        | `serving_steps` | counter |
    """)
    fs = list(MetricsDocsRule().check_project(project))
    assert sorted(f.key for f in fs) == ["serving_steps", "serving_widgets"]
    by_key = {f.key: f for f in fs}
    assert by_key["serving_steps"].path == "README.md"
    assert by_key["serving_widgets"].path.endswith("metrics_user.py")


def test_metrics_docs_brace_expansion_and_patterns(tmp_path):
    project = _metrics_project(tmp_path, """\
        def setup(reg, reason):
            reg.counter("serving_admit_total", "...")
            reg.counter(f"serving_requests_{reason}", "...")
    """, """\
        | `serving_{admit,evict}_total` | counter | ... |
        | `serving_requests_ok{tenant=...}` | counter | ... |
    """)
    fs = list(MetricsDocsRule().check_project(project))
    assert [f.key for f in fs] == ["serving_evict_total"]


# ---------------------------------------------------------------------------
# suppressions + baseline machinery
# ---------------------------------------------------------------------------


def test_inline_suppression_same_line_and_preceding_line(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/serving/x.py", """\
        import time

        def f():
            a = time.time()  # graftlint: allow=determinism
            # graftlint: allow=determinism
            b = time.time()
            c = time.time()
            return a, b, c
    """)
    fs = _check(DeterminismRule(), m)
    assert len(fs) == 3
    assert [f.suppressed for f in sorted(fs, key=lambda f: f.line)] == \
        [True, True, False]
    assert sum(f.active for f in fs) == 1


def test_suppression_is_rule_specific(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/serving/x.py", """\
        import time

        def f():
            return time.time()  # graftlint: allow=host-sync
    """)
    fs = _check(DeterminismRule(), m)
    assert len(fs) == 1 and fs[0].active


def test_baseline_counts_cap_legacy_findings(tmp_path):
    m = _mod(tmp_path, "paddle_tpu_torch/legacy/x.py", """\
        import time

        def f():
            return time.time(), time.time(), time.time()
    """)
    fs = _check(DeterminismRule(), m)
    assert len(fs) == 3
    _apply_baseline(fs, {"determinism":
                         {("paddle_tpu_torch/legacy/x.py", "time.time"): 2}})
    fs.sort(key=lambda f: (f.line, f.message))
    assert [f.baselined for f in fs] == [True, True, False]
    assert sum(f.active for f in fs) == 1


def test_registry_exposes_all_five_rules():
    assert {"import-guard", "port-isolation", "determinism", "host-sync",
            "metrics-docs"} <= set(all_rules())


# ---------------------------------------------------------------------------
# the port's gate + CLI
# ---------------------------------------------------------------------------


def test_port_has_zero_unsuppressed_findings():
    """The gate: the pass suite over the port's tree.  A failure names
    the file:line — fix the code, or (justified) suppress inline, or
    shrink the baseline when legacy code is cleaned up."""
    findings = run()
    active = [f for f in findings if f.active]
    assert not active, "unsuppressed graftlint findings:\n" + \
        "\n".join(f.format() for f in active)
    assert sum(f.suppressed for f in findings) >= 2   # the clock fallbacks
    assert sum(f.baselined for f in findings) >= 1
    # the chip smoke imports nothing of JAX either
    assert not [f for f in run(paths=["chip_smoke.py"],
                               rules=["port-isolation"]) if f.active]


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.analysis", *argv],
        capture_output=True, text=True, cwd=default_root())


def test_cli_text_format_clean_exit():
    r = _cli("--format=text")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "graftlint: 0 finding(s)" in r.stdout


def test_cli_json_format_and_rule_selection():
    r = _cli("--format=json", "--rule", "import-guard",
             "paddle_tpu_torch/serving")
    assert r.returncode == 0, r.stdout + r.stderr
    payload = json.loads(r.stdout)
    assert payload["counts"]["active"] == 0
    assert isinstance(payload["findings"], list)


def test_cli_list_rules_and_unknown_rule():
    r = _cli("--list-rules")
    assert r.returncode == 0
    for name in ("import-guard", "port-isolation", "determinism",
                 "host-sync", "metrics-docs"):
        assert name in r.stdout
    bad = _cli("--rule", "no-such-rule")
    assert bad.returncode == 2 and "unknown rule" in bad.stderr


def test_cli_nonzero_on_findings(tmp_path):
    (tmp_path / "paddle_tpu_torch" / "serving").mkdir(parents=True)
    (tmp_path / "paddle_tpu_torch" / "serving" / "bad.py").write_text(
        "import requests\n")
    r = _cli("--root", str(tmp_path), "--rule", "import-guard",
             "paddle_tpu_torch/serving")
    assert r.returncode == 1
    assert "bad.py:1 import-guard" in r.stdout


# ---------------------------------------------------------------------------
# op_audit
# ---------------------------------------------------------------------------


def test_op_audit_walk_and_counts():
    from paddle_tpu_torch.analysis.op_audit import (assert_no_transpose,
                                                    count_op, count_ops,
                                                    record)
    from paddle_tpu_torch.kernels import flash

    q = torch.randn(2, 16, 4, 16)             # bsnd
    with record() as ev:
        flash.attention(q, q, q, causal=True, layout="bsnd")
    # the flash forward is one event: the plain version's einsums and
    # permutes inside it are the kernel's own, not recorded
    assert ev.names() == ["flash_fwd"] and ev[0].kind == "kernel"
    assert ev[0].in_dtypes[:3] == ("float32",) * 3
    assert_no_transpose(ev, "bsnd attention")
    with record() as ev:
        x = q.transpose(1, 2).contiguous()    # bnsd by a copy
        flash.attention(x, x, x, causal=True)
    assert count_op(ev, "aten.clone") == 1 and count_op(ev, "flash_fwd") == 1
    assert count_ops(ev)["aten.transpose"] == 1
    with pytest.raises(AssertionError, match="transpose"):
        assert_no_transpose(ev, "transposed in")


def test_op_audit_identity_and_f64():
    from paddle_tpu_torch.analysis.op_audit import (assert_no_op,
                                                    assert_ops_identical,
                                                    find_f64, record)

    x = torch.ones(3)

    def f(x):
        return x * 2.0

    with record() as a:
        f(x)
    with record() as b:
        f(x)
    assert_ops_identical(a, b)
    with record() as c:
        x * 3.0 + 1.0
    with pytest.raises(AssertionError, match="differ"):
        assert_ops_identical(a, c)
    with record() as d:
        x.double().sum()
    assert find_f64(d) == ["aten._to_copy", "aten.sum"] and find_f64(a) == []
    assert_no_op(a, "aten.add")
    with pytest.raises(AssertionError, match="aten.add"):
        assert_no_op(c, "aten.add")

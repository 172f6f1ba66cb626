"""Fault injection and the flight recorder of the port, held against the
reference (``paddle_tpu/serving/{faults,flight_recorder}.py``):

* the same ``FaultPlan`` seed gives the same schedule and the same virtual
  clock in both packages;
* under the same seeded chaos plan and the same load (staggered arrivals,
  deadlines, a cancel, a bounded queue), a reference engine and a port
  engine give the same terminals — arrival index, reason and tokens, all
  exact (greedy, fp32 on the CPU) — under FCFS, WFQ over two tenants and
  ``spec_k``; every port step is audited by ``check_invariants`` and the
  drain leaks nothing;
* their flight-recorder dumps are byte-equal under the plan's clock, once
  the rids (minted by each package's own counter) are mapped to arrival
  indices; no other field is left out;
* a real fault escaping mid-step re-parks the terminals already recorded
  that step and dumps the flight ring before re-raising.
"""

import json

import numpy as np
import pytest

from paddle_tpu.serving import FaultPlan as JFaultPlan
from paddle_tpu.serving import FlightRecorder as JFlightRecorder
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.serving import (TERMINAL_REASONS, FaultPlan,
                                      FlightRecorder, InjectedFault,
                                      ServingEngine)
from torch_parity import pair

TENANTS = {"a": 1.0, "b": 3.0}


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (7, {"n_steps": 50}),
    (3, {"n_steps": 30, "p_alloc": 0.2, "p_raise": 0.12, "p_latency": 0.15,
         "max_latency_s": 0.01}),
])
def test_fault_plan_schedule_matches_reference(seed, kw):
    """Same seed, same schedule and clock, bit for bit (exact)."""
    a, b = FaultPlan.random(seed, **kw), JFaultPlan.random(seed, **kw)
    assert a.alloc_fail_steps == b.alloc_fail_steps
    assert a.raise_steps == b.raise_steps
    assert a.latency_s == b.latency_s
    for step in range(1, 40):
        a.begin_step(step)
        b.begin_step(step)
        assert a.now() == b.now() and a.fail_alloc() == b.fail_alloc()
        for phase in ("admit", "prefill", "handoff", "verify", "decode"):
            raised = []
            for plan in (a, b):
                try:
                    plan.check_raise(phase)
                    raised.append(False)
                except Exception as e:          # noqa: BLE001
                    raised.append(type(e).__name__)
            assert raised[0] == raised[1]
    assert a.injected == b.injected
    with pytest.raises(ValueError):
        FaultPlan(raise_steps={1: "nonsense"})


def test_flight_recorder_dump_matches_reference():
    """The same records on the same clock dump to the same bytes, ring
    overflow included (exact)."""
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    def fill(rec):
        t[0] = 0.0
        rec._t0 = 0.0
        for i in range(7):
            rec.record("admit", i, rid=i, slot=i % 2, tenant=None,
                       matched=3 * i, recompute=bool(i % 3))
        rec.record("terminal", 9, rid=2, reason="length", tokens=4,
                   tenant="a")
        return rec

    ours, theirs = fill(FlightRecorder(5, clock)), fill(JFlightRecorder(5,
                                                                        clock))
    assert ours.dumps() == theirs.dumps()
    assert ours.dropped == theirs.dropped == 3 and len(ours) == 5
    with pytest.raises(ValueError):
        FlightRecorder(0)


def _chaos(eng, seed, tenants):
    """The chaos load: 3 upfront requests (one with a tight deadline),
    staggered arrivals by step, a cancel of the first request at step 5.
    Returns the terminals in arrival order as (reason, tokens) and the
    rids."""
    rng = np.random.RandomState(100 + seed)
    rids = []

    def make(deadline=None):
        plen = int(rng.randint(3, 20))
        new = int(rng.randint(3, 10))
        tenant = ("a", "b")[len(rids) % 2] if tenants else None
        rids.append(eng.add_request(rng.randint(0, 512, (plen,)), new,
                                    deadline_s=deadline, tenant=tenant))

    make(), make(0.015), make()
    arrivals = {2: None, 4: 0.01, 6: None, 8: None, 10: 0.02}
    terminals = {}
    steps = 0
    while eng.has_work or steps < 12:
        steps += 1
        assert steps < 500, "chaos run failed to converge"
        if steps in arrivals:
            make(arrivals[steps])
        if steps == 5:
            eng.cancel(rids[0])
        for fin in eng.step():
            assert fin.rid not in terminals, "two terminals for one rid"
            terminals[fin.rid] = fin
        if isinstance(eng, ServingEngine):
            eng.check_invariants()
    assert set(terminals) == set(rids)
    assert eng.scheduler.n_active == 0 and eng.pool.pages_in_use == 0
    return [(terminals[r].reason, terminals[r].tokens) for r in rids], rids


def _flight_by_arrival(eng, rids):
    """The flight dump with every rid replaced by its arrival index."""
    index = {r: i for i, r in enumerate(rids)}
    out = json.loads(eng.flight.dumps())
    for rec in out["records"]:
        for key in ("rid", "victim"):
            if key in rec:
                rec[key] = index[rec[key]]
    return out


@pytest.mark.parametrize("mode,seed", [
    ("fcfs", 0), ("fcfs_int8", 1), ("wfq", 2), ("spec", 3),
])
def test_chaos_parity_with_reference(mode, seed):
    """Reference and port engine under the same seeded plan and load give
    the same terminals (reason and tokens, exact), the same stats counters
    and the same flight record, and both drain leak-free."""
    jm, tm = pair(num_layers=1)
    kw = dict(max_slots=2, page_size=8, num_pages=8, chunk_tokens=8,
              max_queue=3, int8=mode == "fcfs_int8",
              tenants=TENANTS if mode == "wfq" else None,
              spec_k=3 if mode == "spec" else 0, flight=True)
    plan_kw = dict(n_steps=30, p_alloc=0.2, p_raise=0.12, p_latency=0.15,
                   max_latency_s=0.01, step_tick_s=1e-3)
    eng = ServingEngine(tm, device="cpu", faults=FaultPlan.random(seed,
                                                                  **plan_kw),
                        **kw)
    jeng = JEngine(jm, use_paged_kernel=False,
                   faults=JFaultPlan.random(seed, **plan_kw), **kw)
    got, rids = _chaos(eng, seed, mode == "wfq")
    want, jrids = _chaos(jeng, seed, mode == "wfq")
    for (r1, t1), (r2, t2) in zip(got, want):
        assert r1 == r2 and r1 in TERMINAL_REASONS
        np.testing.assert_array_equal(t1, t2)
    counters = [k for k, v in jeng.stats.items()
                if isinstance(v, int) and not k.endswith("_traces")]
    assert {k: eng.stats[k] for k in counters} == \
        {k: jeng.stats[k] for k in counters}
    assert eng.faults.injected == jeng.faults.injected
    assert eng.faults.injected["alloc_fail"] + eng.faults.injected["raise"]
    assert _flight_by_arrival(eng, rids) == _flight_by_arrival(jeng, jrids)
    if mode == "wfq":
        assert eng.scheduler.policy.vt == jeng.scheduler.policy.vt


def test_real_fault_reparks_terminals_and_dumps_flight(tmp_path):
    """A real exception escaping step() re-parks the terminals already
    recorded that step (a retrying host loop still delivers each exactly
    once), records a crash and dumps the flight ring before re-raising."""
    _, tm = pair(num_layers=1)
    eng = ServingEngine(tm, device="cpu", max_slots=2, page_size=8,
                        flight=True)
    rng = np.random.RandomState(0)
    r0 = eng.add_request(rng.randint(0, 512, (9,)), 6)
    r1 = eng.add_request(rng.randint(0, 512, (5,)), 6)
    eng.step()
    assert eng.cancel(r1)
    eng._crash_dump_dir = str(tmp_path)
    real = eng._decode_step

    def boom(finished):
        raise RuntimeError("device lost")

    eng._decode_step = boom
    with pytest.raises(RuntimeError, match="device lost"):
        eng.step()
    assert [f.rid for f in eng._pending] == [r1]
    dump = json.loads((tmp_path / "flight_crash.json").read_text())
    assert dump["records"][-1]["kind"] == "crash"
    assert "RuntimeError: device lost" in dump["records"][-1]["error"]
    eng._decode_step = real
    done = {}
    while eng.has_work:
        for fin in eng.step():
            assert fin.rid not in done
            done[fin.rid] = fin
        eng.check_invariants()
    assert done[r1].reason == "cancelled" and done[r0].reason == "length"
    assert eng.pool.pages_in_use == 0


def test_injected_fault_aborts_the_step_and_resumes():
    """A scripted alloc failure defers admission, a scripted exception
    skips the rest of its step (counted in step_faults), and the run
    completes leak-free."""
    _, tm = pair(num_layers=1)
    plan = FaultPlan(alloc_fail_steps={1, 2}, raise_steps={3: "admit"})
    eng = ServingEngine(tm, device="cpu", max_slots=2, page_size=8,
                        faults=plan)
    rid = eng.add_request(np.arange(6), 4)
    eng.step()
    assert eng.scheduler.n_waiting == 1 and eng.scheduler.n_active == 0
    eng.step()
    eng.step()
    assert eng.stats["step_faults"] == 1 and eng.scheduler.n_active == 1
    out = eng.run()
    assert out[rid].reason == "length" and len(out[rid].tokens) == 4
    assert plan.injected["alloc_fail"] >= 2 and plan.injected["raise"] == 1
    assert eng.pool.alloc_failures >= 2
    assert isinstance(InjectedFault("x"), RuntimeError)

"""Weighted fair queueing of the port, held against the reference
(``paddle_tpu/serving/tenancy.py`` and the tenant accounting of its
scheduler and engine).  Host decisions only, so every comparison is an
equality:

* the policies alone, driven by one seeded script of arrivals, charges,
  admissions, releases, requeues, cancels and expiries, pop the same
  requests, hold the same virtual counters and reject the same arrivals;
* engines with the same tenants (weights, a priority tier, slot and queue
  quotas, SLO budgets) under pool pressure admit in the same order (the
  flight recorder's admissions), reject the same requests, finish with the
  same tokens and the same virtual counters — including the
  ``uncharged_tokens`` rule that bills a preempted request's recompute
  nothing and a speculative engine's accepted tokens only;
* a shared ``ClusterWFQState`` ledger behaves the same.
"""

import numpy as np
import pytest

from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import tenancy as jten
from paddle_tpu_torch.serving import Request, ServingEngine
from paddle_tpu_torch.serving import tenancy as tten
from torch_parity import pair, prompts_of

TENANTS = {"a": 1.0, "b": {"weight": 3.0, "max_resident": 1},
           "c": {"weight": 2.0, "max_waiting": 2},
           "hi": {"priority": 1, "weight": 0.5}}


def _script(mod, req_cls, state=False):
    """One seeded policy workload; returns the observable trace (popped
    arrival indices, quota verdicts, counters after every op)."""
    rng = np.random.RandomState(11)
    if state:
        shared = mod.ClusterWFQState(TENANTS)
        pols = [mod.WFQPolicy(state=shared), mod.WFQPolicy(state=shared)]
    else:
        pols = [mod.WFQPolicy(TENANTS)]
    reqs, resident, log = [], [], []
    for step in range(120):
        pol = pols[step % len(pols)]
        op = rng.randint(6)
        tenant = ("a", "b", "c", "hi", "new")[rng.randint(5)]
        if op <= 1:
            verdict = pol.quota_reject(tenant)
            log.append(("quota", tenant, verdict))
            if not verdict:
                r = req_cls(prompt=np.arange(1, 4), max_new_tokens=2,
                            tenant=None if tenant == "new" else tenant,
                            deadline_s=float(rng.rand()))
                r.t_enqueue = step * 0.1
                r.idx = len(reqs)
                reqs.append(r)
                pol.push(r)
        elif op == 2 and pol.peek() is not None:
            head = pol.peek()
            got = pol.pop()
            assert got is head
            pol.on_admit(got)
            resident.append((pol, got))
            log.append(("pop", got.idx))
        elif op == 3 and resident:
            p2, r = resident.pop(int(rng.randint(len(resident))))
            p2.on_release(r)
            if rng.rand() < 0.3:
                p2.requeue_head(r)
            log.append(("release", r.idx))
        elif op == 4 and resident:
            p2, r = resident[int(rng.randint(len(resident)))]
            n = int(rng.randint(1, 20))
            p2.charge(r, n)
            log.append(("charge", r.idx, n))
        elif op == 5:
            for p2 in pols:
                gone = p2.pop_expired(step * 0.1 - 3.0)
                log.append(("expired", sorted(r.idx for r in gone)))
                if reqs and rng.rand() < 0.3:
                    hit = p2.remove(reqs[int(rng.randint(len(reqs)))].rid)
                    log.append(("removed", None if hit is None else hit.idx))
        log.append(("vt", sorted(pols[0].vt.items()), len(pols[0])))
        for p2 in pols:
            p2.check([r for q, r in resident if q is p2])
    log.append(("state", pols[0].to_state()))
    return log


@pytest.mark.parametrize("state", [False, True])
def test_wfq_policy_trace_matches_reference(state):
    """The same policy script gives the same pops, quota verdicts and
    virtual counters (exact), standalone and on a shared cluster
    ledger."""
    assert _script(tten, Request, state) == _script(jten, JRequest, state)


def test_policy_resolution_and_validation_match_reference():
    for mod in (tten, jten):
        assert isinstance(mod.make_policy(None), mod.FCFSPolicy)
        assert isinstance(mod.make_policy(None, {"a": 2.0}), mod.WFQPolicy)
        with pytest.raises(ValueError):
            mod.make_policy("fcfs", {"a": 1.0})
        with pytest.raises(ValueError):
            mod.make_policy("lottery")
        for bad in ({"weight": 0}, {"max_resident": 0}, {"max_waiting": -1},
                    {"ttft_slo_s": 0}, {"slo_objective": 1.0}):
            with pytest.raises(ValueError):
                mod.TenantConfig(**bad)
        with pytest.raises(ValueError):
            mod.WFQPolicy({"a": 1.0}, state=mod.ClusterWFQState())
    assert tten.DEFAULT_TENANT == jten.DEFAULT_TENANT
    assert tten.normalize_tenants(TENANTS) == {
        k: tten.TenantConfig(**vars(v))
        for k, v in jten.normalize_tenants(TENANTS).items()}


def _serve(eng, prompts, tenants, news):
    rids = [eng.add_request(p, n, tenant=t)
            for p, t, n in zip(prompts, tenants, news)]
    done = {}
    while eng.has_work:
        for fin in eng.step():
            done[fin.rid] = fin
        if isinstance(eng, ServingEngine):
            eng.check_invariants()
    admits = [r["rid"] for r in eng.flight.to_json()["records"]
              if r["kind"] == "admit"]
    index = {r: i for i, r in enumerate(rids)}
    return ([(done[r].reason, list(done[r].tokens)) for r in rids],
            [index[r] for r in admits])


@pytest.mark.parametrize("over", [
    {"num_pages": 9},                    # pool pressure: preemptions
    {"spec_k": 2},                       # bills accepted tokens only
])
def test_engine_wfq_matches_reference(over):
    """Same tenants and arrivals: the same admission order, rejections,
    tokens and virtual counters in both engines (exact)."""
    jm, tm = pair(num_layers=1)
    rng = np.random.RandomState(9)
    n = 14
    prompts = prompts_of(rng, rng.randint(3, 20, n))
    tenants = [("a", "b", "c", "hi", None)[i % 5] for i in range(n)]
    news = [int(k) for k in rng.randint(3, 9, n)]
    kw = dict(max_slots=3, page_size=8, chunk_tokens=8, tenants=TENANTS,
              flight=True, **over)
    got = _serve(ServingEngine(tm, device="cpu", **kw), prompts, tenants,
                 news)
    jeng = JEngine(jm, use_paged_kernel=False, **kw)
    want = _serve(jeng, prompts, tenants, news)
    assert got == want
    reasons = {r for r, _ in got[0]}
    assert "rejected" in reasons and "length" in reasons


def test_engine_wfq_counters_and_recompute_billing_match_reference():
    """Weights 3:1 under preemption: both engines end with the same
    counters, equal to first-time-served tokens over weight, with
    recompute billed nothing."""
    jm, tm = pair(num_layers=1)
    rng = np.random.RandomState(51)
    prompts = prompts_of(rng, [8, 16, 12, 6])
    tenants = ["a", "b", "a", "b"]
    kw = dict(max_slots=2, page_size=8, num_pages=6, chunk_tokens=8,
              tenants={"a": 3.0, "b": 1.0}, flight=True)
    eng = ServingEngine(tm, device="cpu", **kw)
    jeng = JEngine(jm, use_paged_kernel=False, **kw)
    news = [20, 20, 10, 10]
    assert _serve(eng, prompts, tenants, news) == \
        _serve(jeng, prompts, tenants, news)
    assert eng.stats["preemptions"] > 0
    assert eng.stats["recompute_tokens"] == jeng.stats["recompute_tokens"]
    vt = eng.scheduler.policy.vt
    assert vt == jeng.scheduler.policy.vt
    served = {t: sum(len(p) + k for p, k, u in zip(prompts, news, tenants)
                     if u == t) for t in ("a", "b")}
    assert vt == pytest.approx({"a": served["a"] / 3.0,
                                "b": served["b"] / 1.0})

"""Disaggregated serving of the port — page handoffs, the router, the
cluster's shared WFQ ledger and double-buffered dispatch — held against
the reference (``paddle_tpu/serving/{kv_pool,snapshot,router,engine}.py``).
Greedy and fp32 on the CPU, so every token comparison is exact:

* the handoff round trip (export -> host numpy -> ingest into other pages)
  is bit-exact for float, int8 and int4 pages and their scales; a foreign
  layout is refused with the per-key diff;
* handoff records cross between packages both ways (the wire format and
  the layout dict are the reference's), and the result is the reference
  monolithic engine's, token for token;
* a port cluster equals the reference cluster — tokens and router stats —
  also under pool pressure; its WFQ counters are cluster-global;
* ``double_buffer`` changes no token, and a cancel while a decode is in
  flight drops the dead tokens;
* routing by prefix affinity, load balance and the cluster ``max_queue``;
* a handoff fault degrades to recompute with exact output.
"""

import inspect

import numpy as np
import pytest

from paddle_tpu.serving import FaultPlan as JFaultPlan
from paddle_tpu.serving import Router as JRouter
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import make_cluster as jmake_cluster
from paddle_tpu_torch.serving import (FaultPlan, Request, Router,
                                      ServingEngine, make_cluster,
                                      validate_trace)
from torch_parity import pair, prompts_of


def _run(router_or_eng, prompts, news, tenants=None):
    tenants = tenants or [None] * len(prompts)
    rids = [router_or_eng.add_request(p, n, tenant=t)
            for p, n, t in zip(prompts, news, tenants)]
    done = {}
    while router_or_eng.has_work:
        for fin in router_or_eng.step():
            assert fin.rid not in done
            done[fin.rid] = fin
        router_or_eng.check_invariants()
    return [done[r] for r in rids]


def _tokens(fins):
    return [(f.reason, list(f.tokens)) for f in fins]


def test_engine_signature_is_the_references():
    """The port's ServingEngine takes every constructor argument of the
    reference's, with the same defaults, except ``use_paged_kernel`` (the
    port has no path around its kernels), plus ``device``."""
    ours = dict(inspect.signature(ServingEngine.__init__).parameters)
    theirs = dict(inspect.signature(JEngine.__init__).parameters)
    assert set(ours) == (set(theirs) - {"use_paged_kernel"}) | {"device"}
    for name, p in theirs.items():
        if name in ours and name != "self":
            assert ours[name].default == p.default, name
            assert ours[name].kind == p.kind, name


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_handoff_roundtrip_bitexact(kv_bits):
    """Prefill replica -> record -> decode replica: the adopted full pages
    equal the payload byte for byte (scales included), the sender ends
    holding no page, and the continuation is the reference monolithic
    engine's."""
    jm, tm = pair(num_layers=1)
    kw = dict(max_slots=2, page_size=8, num_pages=32, kv_bits=kv_bits)
    prompt = prompts_of(np.random.RandomState(5), [21])[0]
    want = JEngine(jm, use_paged_kernel=False, **kw).run([(prompt, 8)])
    (want,) = want.values()

    pre = ServingEngine(tm, device="cpu", role="prefill", **kw)
    dec = ServingEngine(tm, device="cpu", role="decode", **kw)
    rid = pre.add_request(prompt, 8)
    while not pre._handoff_out:
        pre.step()
        pre.check_invariants()
    assert not pre.has_work and pre.pool.pages_in_use == 0
    (h,) = pre.drain_handoffs()
    bufs = h["payload"]["buffers"]
    assert h["version"] == 5 and h["n_pages"] == 3
    assert set(bufs) == ({"k", "v", "ks", "vs"} if kv_bits else {"k", "v"})
    assert h["nbytes"] == sum(a.nbytes for a in bufs.values()) > 0
    assert pre.stats["handoff_bytes"] == h["nbytes"]
    assert dec.ingest_handoff(h) == rid
    dec.step()
    (st,) = [s for s in dec._slots if s is not None]
    nfull = int(h["base_len"]) // 8
    for name, arr in bufs.items():
        got = dec.pool.buffers[name][:, st.pages[:nfull]].numpy()
        np.testing.assert_array_equal(got, arr[:, :nfull])
    done = {}
    while dec.has_work:
        for f in dec.step():
            done[f.rid] = f
        dec.check_invariants()
    np.testing.assert_array_equal(done[rid].tokens, want.tokens)
    assert dec.stats["recompute_tokens"] == 0 and dec.pool.pages_in_use == 0


def test_handoff_layout_mismatch_refused():
    _, tm = pair(num_layers=1)
    pre = ServingEngine(tm, device="cpu", role="prefill", max_slots=2,
                        page_size=8, num_pages=32, kv_bits=8)
    dec = ServingEngine(tm, device="cpu", role="decode", max_slots=2,
                        page_size=8, num_pages=32)
    pre.add_request(np.arange(12), 4)
    while not pre._handoff_out:
        pre.step()
    (h,) = pre.drain_handoffs()
    with pytest.raises(ValueError, match="kv_bits|page_dtype"):
        dec.ingest_handoff(h)
    assert not dec._handoff_in and dec.pool.pages_in_use == 0
    with pytest.raises(ValueError, match="prefill"):
        pre.ingest_handoff({"payload": None})
    with pytest.raises(ValueError, match="role"):
        ServingEngine(tm, device="cpu", role="bogus")
    with pytest.raises(ValueError, match="decode"):
        Router([pre])
    with pytest.raises(ValueError, match="spec_k|speculative"):
        ServingEngine(tm, device="cpu", double_buffer=True, spec_k=2)
    pre.check_invariants()
    dec.check_invariants()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("kv_bits", [None, 8])
def test_handoffs_cross_packages(direction, kv_bits):
    """A reference prefill replica's records go into a port decode engine,
    and the reverse: the output is the reference monolithic engine's."""
    jm, tm = pair(num_layers=1)
    kw = dict(max_slots=2, page_size=8, num_pages=32, kv_bits=kv_bits)
    prompts = prompts_of(np.random.RandomState(12), [13, 22])
    news = [7, 9]
    mono = JEngine(jm, use_paged_kernel=False, **kw)
    want = _tokens(_run(mono, prompts, news))
    port = dict(device="cpu", **kw)
    ref = dict(use_paged_kernel=False, **kw)
    if direction == "ref_to_port":
        pre = JEngine(jm, role="prefill", **ref)
        dec = ServingEngine(tm, role="decode", **port)
    else:
        pre = ServingEngine(tm, role="prefill", **port)
        dec = JEngine(jm, role="decode", **ref)
    rids = [pre.add_request(p, n) for p, n in zip(prompts, news)]
    done = {}
    while pre.has_work or dec.has_work or pre._handoff_out:
        if pre.has_work:
            pre.step()
        for h in pre.drain_handoffs():
            dec.ingest_handoff(h)
        if dec.has_work:
            for f in dec.step():
                done[f.rid] = f
    assert _tokens([done[r] for r in rids]) == want
    assert dec.stats["handoffs_in"] == 2 and dec.stats["recompute_tokens"] == 0


@pytest.mark.parametrize("over", [
    {},
    {"num_pages": 8},                        # pool pressure on decode
    {"int8": True},
])
def test_cluster_matches_reference_cluster(over):
    """make_cluster(model, 2, disaggregate=True) in both packages: the
    same tokens, the same router stats and the same per-replica counters
    (exact); and the monolithic engine's tokens."""
    jm, tm = pair(num_layers=1)
    kw = dict(max_slots=3, page_size=8, chunk_tokens=8, **over)
    kw.setdefault("num_pages", 48)
    rng = np.random.RandomState(1)
    prompts = prompts_of(rng, [7, 19, 12, 25, 4])
    news = [8, 5, 10, 12, 6]
    router = make_cluster(tm, 2, disaggregate=True, device="cpu", **kw)
    jrouter = jmake_cluster(jm, 2, disaggregate=True,
                            use_paged_kernel=False, **kw)
    got = _tokens(_run(router, prompts, news))
    assert got == _tokens(_run(jrouter, prompts, news))
    mono = ServingEngine(tm, device="cpu", **dict(kw, num_pages=48))
    assert got == _tokens(_run(mono, prompts, news))
    assert router.stats_snapshot() == jrouter.stats_snapshot()
    assert router.stats["handoffs"] == len(prompts)
    assert router.replicas[1].params is router.replicas[0].params
    for eng, jeng in zip(router.replicas, jrouter.replicas):
        for key, v in jeng.stats.items():
            if isinstance(v, int) and not key.endswith("_traces"):
                assert eng.stats[key] == v, key
    if "num_pages" in over:
        assert router.replicas[1].stats["preemptions"] > 0


def test_cluster_wfq_counters_are_global():
    """Three weighted tenants over a disaggregated pair sharing one
    ledger: every member aliases one counter table, which ends at each
    tenant's served tokens over its weight, equal to the reference's."""
    jm, tm = pair(num_layers=1)
    weights = {"a": 1.0, "b": 2.0, "c": 4.0}
    kw = dict(max_slots=2, page_size=8, num_pages=12, chunk_tokens=8,
              prefix_cache=False, tenants=weights)
    rng = np.random.RandomState(6)
    prompts = prompts_of(rng, rng.randint(5, 18, 9))
    news = [int(k) for k in rng.randint(4, 10, 9)]
    tenants = ["abc"[i % 3] for i in range(9)]
    router = make_cluster(tm, 2, disaggregate=True, device="cpu", **kw)
    jrouter = jmake_cluster(jm, 2, disaggregate=True,
                            use_paged_kernel=False, **kw)
    pols = [e.scheduler.policy for e in router.replicas]
    assert pols[0].vt is pols[1].vt and pols[0].tenants is pols[1].tenants
    fins = _run(router, prompts, news, tenants)
    assert _tokens(fins) == _tokens(_run(jrouter, prompts, news, tenants))
    vt = pols[0].vt
    assert vt == jrouter.replicas[0].scheduler.policy.vt
    for t, w in weights.items():
        served = sum(len(p) + len(f.tokens)
                     for p, f, u in zip(prompts, fins, tenants) if u == t)
        assert vt[t] == pytest.approx(served / w)


@pytest.mark.parametrize("over", [{}, {"num_pages": 10},
                                  {"decode_block": 3}])
def test_double_buffer_changes_no_token(over):
    """double_buffer=True gives the plain engine's tokens (and the
    reference's double-buffered engine's), with the retire one step
    late and nothing left in flight at drain."""
    jm, tm = pair(num_layers=1)
    kw = dict(max_slots=2, page_size=8, **over)
    prompts = prompts_of(np.random.RandomState(3), [9, 14, 22])
    news = [14, 10, 8]
    plain = _tokens(_run(ServingEngine(tm, device="cpu", **kw),
                         prompts, news))
    eng = ServingEngine(tm, device="cpu", double_buffer=True, **kw)
    assert _tokens(_run(eng, prompts, news)) == plain
    jeng = JEngine(jm, use_paged_kernel=False, double_buffer=True, **kw)
    assert _tokens(_run(jeng, prompts, news)) == plain
    assert eng.stats["decode_calls"] == jeng.stats["decode_calls"]
    assert eng._inflight is None and eng.pool.pages_in_use == 0
    assert eng.retires_in_flight == 0          # the CPU never defers


def test_double_buffer_cancel_in_flight_drops_dead_tokens():
    _, tm = pair(num_layers=1)
    eng = ServingEngine(tm, device="cpu", max_slots=2, page_size=8,
                        num_pages=32, double_buffer=True)
    ra = eng.add_request(np.arange(6), 20)
    rb = eng.add_request(np.arange(3, 12), 20)
    eng.step()                       # admit, prefill, dispatch; no retire
    assert eng._inflight is not None
    assert eng.cancel(ra)
    done = {}
    while eng.has_work:
        for f in eng.step():
            assert f.rid not in done
            done[f.rid] = f
        eng.check_invariants()
    assert done[ra].reason == "cancelled" and done[rb].reason == "length"
    assert len(done[rb].tokens) == 20 and eng.pool.pages_in_use == 0


def test_router_prefix_affinity_and_tracing():
    """After the first request lands, every later one sharing its system
    prefix follows it to the same replica; the routing decisions and the
    merged cluster trace match the reference's."""
    jm, tm = pair(num_layers=1)
    sys_prefix = np.arange(100, 132, dtype=np.int32)        # 4 full pages
    results = []
    for make, kw in ((make_cluster, {"device": "cpu"}),
                     (jmake_cluster, {"use_paged_kernel": False})):
        router = make(tm if make is make_cluster else jm, 2, max_slots=2,
                      page_size=8, num_pages=64, **kw)
        router.attach_tracers()
        rng = np.random.RandomState(9)
        for i in range(4):
            tail = rng.randint(0, 512, (5 + i,))
            router.run([(np.concatenate([sys_prefix, tail]), 4)])
        results.append(router)
    router, jrouter = results
    first = int(np.argmax(router.stats["routed"]))
    assert router.stats["routed"][first] == 4
    assert router.stats["prefix_match_tokens"] >= 3 * 32
    assert router.stats_snapshot() == jrouter.stats_snapshot()
    names = [[(e["name"], e["ph"], e["pid"]) for e in r.merged_trace()[
        "traceEvents"]] for r in (router, jrouter)]
    assert names[0] == names[1]
    validate_trace(router.merged_trace())


def test_disagg_trace_flows_and_artifacts(tmp_path):
    """A disaggregated run with metrics_dir writes the reference's
    artifact files; the merged trace stitches every handoff with one flow
    (start, router step, finish) across three lanes."""
    jm, tm = pair(num_layers=1)
    prompts = prompts_of(np.random.RandomState(2), [5, 9, 14])
    files = []
    for make, kw, name in ((make_cluster, {"device": "cpu"}, "port"),
                           (jmake_cluster, {"use_paged_kernel": False},
                            "ref")):
        router = make(tm if name == "port" else jm, 2, disaggregate=True,
                      max_slots=2, page_size=8, num_pages=32, **kw)
        out = tmp_path / name
        router.run([(p, 5) for p in prompts], metrics_dir=str(out))
        files.append(sorted(f.name for f in out.iterdir()))
        if name == "port":
            counts = validate_trace(router.merged_trace())
            assert counts["flows"] == 3 and counts["t"] == 3
            assert "replica0" in router.to_prometheus()
    assert files[0] == files[1]


def test_router_load_balance_and_cluster_max_queue():
    _, tm = pair(num_layers=1)
    router = make_cluster(tm, 2, device="cpu", max_slots=1, page_size=8,
                          num_pages=16, router_max_queue=2,
                          prefix_cache=False)
    rng = np.random.RandomState(4)
    fins = _run(router, prompts_of(rng, [6, 7, 8, 9, 10, 11]), [30] * 6)
    rejected = [f for f in fins if f.reason == "rejected"]
    assert len(rejected) == router.stats["rejected"] >= 1
    assert all(f.tokens.size == 0 and f.n_steps == 0 for f in rejected)
    assert all(n > 0 for n in router.stats["routed"])
    assert sum(e.stats["rejected"] for e in router.replicas) == 0
    seen = {}
    router.on_token = lambda rid, tok: seen.setdefault(rid, []).append(tok)
    rids = [router.add_request(p, 6) for p in prompts_of(rng, [5, 9])]
    done = router.run()
    for rid in rids:
        np.testing.assert_array_equal(seen[rid], done[rid].tokens)


def test_handoff_fault_degrades_to_recompute_with_exact_output():
    jm, tm = pair(num_layers=1)
    kw = dict(max_slots=2, page_size=8, num_pages=48)
    prompts = prompts_of(np.random.RandomState(8), [10, 17])
    news = [9, 7]
    want = _tokens(_run(JEngine(jm, use_paged_kernel=False, **kw), prompts,
                        news))
    out = []
    for pkg in ("port", "ref"):
        plan = {1: "handoff", 2: "handoff", 3: "handoff"}
        if pkg == "port":
            pre = ServingEngine(tm, device="cpu", role="prefill",
                                faults=FaultPlan(raise_steps=plan), **kw)
            router = Router([pre, ServingEngine(tm, device="cpu",
                                                role="decode", **kw)])
        else:
            pre = JEngine(jm, role="prefill", use_paged_kernel=False,
                          faults=JFaultPlan(raise_steps=plan), **kw)
            router = JRouter([pre, JEngine(jm, role="decode",
                                           use_paged_kernel=False, **kw)])
        assert _tokens(_run(router, prompts, news)) == want
        out.append((router.stats_snapshot(), pre.stats["handoff_faults"],
                    router.replicas[1].stats["recompute_tokens"]))
    assert out[0] == out[1]
    assert out[0][0]["degraded_handoffs"] >= 1 and out[0][2] > 0


def test_make_cluster_runs_on_the_given_device():
    """make_cluster hands ``device`` to every replica (without one, it
    raises on a host without a card: tests/test_torch_isolation.py)."""
    _, tm = pair(num_layers=1)
    router = make_cluster(tm, 2, disaggregate=True, device="cpu")
    assert [e.role for e in router.replicas] == ["prefill", "decode"]
    assert all(e.device.type == "cpu" for e in router.replicas)
    req = Request(prompt=np.arange(5), max_new_tokens=3)
    assert router.run([req])[req.rid].reason == "length"

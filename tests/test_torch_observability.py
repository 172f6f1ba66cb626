"""Metrics, tracing and the TensorBoard / Prometheus exporters of the port,
held against the reference (``paddle_tpu/serving/{metrics,tracing}.py``,
``paddle_tpu/utils/tensorboard.py``):

* the same observations give the same ``scalars()``, ``to_prometheus()``
  text and ``to_state()`` (exact: both are the same float arithmetic), for
  counters, gauges, labeled series and histograms, through
  ``merge_registries`` / ``aggregate_scalars`` / ``cluster_prometheus``
  and the ``SLOTracker``;
* ``validate_trace`` and ``merge_traces`` give the same results;
* an engine-fed registry under a fault plan's virtual clock equals the
  reference engine's: every counter and gauge, and every histogram fed
  from the engine clock; the histograms fed from ``time.perf_counter``
  (``WALL_CLOCK``, named below) are compared by count only;
* the engine's trace events have the same names, phases, lanes and args
  (timestamps and durations left out: they are wall-clock);
* ``run(metrics_dir=...)`` writes the same artifact files, and each
  package's TensorBoard reader reads the other's event files.
"""

import json
import os

import numpy as np
import pytest

from paddle_tpu.serving import FaultPlan as JFaultPlan
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import metrics as jmetrics
from paddle_tpu.serving import tracing as jtracing
from paddle_tpu.utils import tensorboard as jtb
from paddle_tpu_torch.serving import FaultPlan, ServingEngine
from paddle_tpu_torch.serving import metrics as tmetrics
from paddle_tpu_torch.serving import tracing as ttracing
from paddle_tpu_torch.utils import tensorboard as ttb
from torch_parity import pair, prompts_of

# histograms the engine feeds from time.perf_counter: wall-clock, so only
# their observation counts compare across packages
WALL_CLOCK = ("serving_step_s", "serving_step_admit_s",
              "serving_step_prefill_s", "serving_step_decode_s",
              "serving_step_handoff_s", "serving_prefill_chunk_s",
              "serving_decode_call_s", "serving_decode_sync_s")


def _feed(mod, rng):
    """One seeded stream of observations into a fresh registry of module
    ``mod`` (the reference's or the port's)."""
    reg = mod.MetricsRegistry()
    c = reg.counter("reqs", "requests")
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_s", "latency")
    hn = reg.histogram("narrow", "narrow buckets", start=1e-3, factor=1.5,
                       n_buckets=8)
    for i in range(200):
        c.inc(int(rng.randint(1, 4)))
        g.set(float(rng.randint(0, 50)))
        h.observe(float(rng.exponential(0.05)))
        hn.observe(float(rng.exponential(0.01)))
        t = ("a", "b", 'q"x')[i % 3]
        reg.counter("tenant_tokens", "per tenant", labels={"tenant": t}).inc()
        reg.histogram("tenant_ttft", "per tenant",
                      labels={"tenant": t}).observe(float(rng.rand()))
    g.dec(2.5)
    return reg


def test_registry_matches_reference():
    """Same observations: same scalars, Prometheus text and state (exact);
    the state round-trips."""
    ours = _feed(tmetrics, np.random.RandomState(0))
    theirs = _feed(jmetrics, np.random.RandomState(0))
    assert ours.scalars() == theirs.scalars()
    assert ours.to_prometheus() == theirs.to_prometheus()
    assert ours.to_state() == theirs.to_state()
    back = tmetrics.MetricsRegistry.from_state(theirs.to_state())
    assert back.to_prometheus() == theirs.to_prometheus()
    with pytest.raises(ValueError):
        ours.gauge("reqs")
    with pytest.raises(ValueError):
        tmetrics.Histogram("x", factor=1.0)


def test_cluster_merge_and_slo_match_reference():
    """merge_registries, aggregate_scalars and cluster_prometheus over
    three replicas' registries, and an SLOTracker fed the same verdicts on
    the same clock, equal the reference's (exact)."""
    def parts(mod):
        return {f"replica{i}": _feed(mod, np.random.RandomState(i))
                for i in range(3)}

    ours, theirs = parts(tmetrics), parts(jmetrics)
    assert tmetrics.merge_registries(ours).to_state() == \
        jmetrics.merge_registries(theirs).to_state()
    assert tmetrics.aggregate_scalars(ours) == \
        jmetrics.aggregate_scalars(theirs)
    assert tmetrics.cluster_prometheus(ours) == \
        jmetrics.cluster_prometheus(theirs)

    def slo(mod):
        reg = mod.MetricsRegistry()
        tr = mod.SLOTracker(reg)
        rng = np.random.RandomState(5)
        now = 0.0
        for i in range(300):
            now += float(rng.exponential(2.0))
            tr.observe(("a", "b")[i % 2], ("ttft", "e2e")[i % 3 == 0],
                       bool(rng.rand() < 0.9), now, 0.95)
            if i % 17 == 0:
                tr.sync(now)
        tr.sync(now + 120.0)
        return reg

    assert slo(tmetrics).to_prometheus() == slo(jmetrics).to_prometheus()


def _trace(mod):
    clk = [0.0]
    rec = mod.TraceRecorder(clock=lambda: clk[0])
    rec.set_replica(1)
    rec.process_name(rec.pid(mod.PID_REQUESTS), rec.lane_label("requests"))
    rec.begin("queued", rec.pid(2), 7, {"prompt_len": 5})
    clk[0] = 0.5
    rec.flow_start("handoff", rec.pid(2), 7, mod.flow_id(7, 1))
    rec.end(rec.pid(2), 7)
    rec.instant("eos", rec.pid(2), 7, {"rid": 7})
    rec.complete("decode", 0.25, 0.125, rec.pid(1), 0, {"step": 3})
    other = mod.TraceRecorder(clock=lambda: clk[0])
    clk[0] = 1.0
    other.flow_finish("handoff", 2, 7, mod.flow_id(7, 1))
    return rec, other


def test_trace_validate_and_merge_match_reference():
    """Same events: same merged trace and validation counts (exact); both
    reject the same malformed traces."""
    ours, theirs = _trace(ttracing), _trace(jtracing)
    m1, m2 = ttracing.merge_traces(ours), jtracing.merge_traces(theirs)
    assert m1 == m2
    assert ttracing.validate_trace(m1) == jtracing.validate_trace(m2)
    assert ttracing.flow_id(3, 5) == jtracing.flow_id(3, 5)
    for bad in ([{"name": "x", "ph": "E", "ts": 0.0, "pid": 1, "tid": 1}],
                [{"name": "x", "ph": "B", "ts": 0.0, "pid": 1, "tid": 1}],
                [{"name": "h", "ph": "s", "ts": 0.0, "pid": 1, "tid": 1,
                  "cat": "handoff", "id": 4}]):
        for mod in (ttracing, jtracing):
            with pytest.raises(ValueError):
                mod.validate_trace(bad)


def _events(tracer, rids):
    """Trace events with rids mapped to arrival indices and the
    wall-clock fields (ts, dur) left out."""
    index = {r: i for i, r in enumerate(rids)}
    out = []
    for ev in tracer.events:
        ev = {k: v for k, v in ev.items() if k not in ("ts", "dur")}
        if ev["pid"] == tracer.pid(ttracing.PID_REQUESTS) and ev["ph"] != "M":
            ev["tid"] = index[ev["tid"]]
        args = dict(ev.get("args", {}))
        if "rid" in args:
            args["rid"] = index[args["rid"]]
        if args:
            ev["args"] = args
        out.append(ev)
    return out


@pytest.mark.parametrize("over", [
    {},
    {"tenants": {"a": 1.0, "b": {"weight": 2.0, "ttft_slo_s": 0.004,
                                 "e2e_slo_s": 0.02}}},
    {"spec_k": 3, "num_pages": 9},
])
def test_engine_metrics_and_trace_match_reference(over):
    """Reference and port engine on one fault plan's virtual clock (plus
    pool pressure in the last case): every counter and gauge, every
    engine-clock histogram and the trace events equal (exact); the
    wall-clock histograms match by count."""
    jm, tm = pair(num_layers=1)
    kw = dict(max_slots=2, page_size=8, chunk_tokens=8, metrics=True,
              trace=True, **over)
    rng = np.random.RandomState(4)
    prompts = prompts_of(rng, [5, 19, 12, 9, 3])
    tenants = [("a", "b")[i % 2] if "tenants" in over else None
               for i in range(len(prompts))]
    engines = []
    for eng in (ServingEngine(tm, device="cpu",
                              faults=FaultPlan(step_tick_s=1e-3), **kw),
                JEngine(jm, use_paged_kernel=False,
                        faults=JFaultPlan(step_tick_s=1e-3), **kw)):
        rids = [eng.add_request(p, 7, tenant=t)
                for p, t in zip(prompts, tenants)]
        eng.run()
        engines.append((eng, rids))
    (eng, rids), (jeng, jrids) = engines
    ours, theirs = eng.metrics.to_state(), jeng.metrics.to_state()
    assert set(ours) == set(theirs)
    for key, st in theirs.items():
        if st["name"] in WALL_CLOCK:
            assert ours[key]["count"] == st["count"], key
        else:
            assert ours[key] == st, key
    assert _events(eng.tracer, rids) == _events(jeng.tracer, jrids)
    assert ttracing.validate_trace(eng.tracer)


def test_run_metrics_dir_writes_the_same_artifacts(tmp_path):
    """run(metrics_dir=...) in both packages: the same files, the same
    Prometheus families and series, the same TensorBoard tags at the same
    steps, the same flight dump; each reader reads the other's events."""
    jm, tm = pair(num_layers=1)
    prompts = prompts_of(np.random.RandomState(6), [11, 4, 17])
    dirs = {}
    for name, eng in (("port", ServingEngine(tm, device="cpu", max_slots=2,
                                             page_size=8,
                                             faults=FaultPlan())),
                      ("ref", JEngine(jm, max_slots=2, page_size=8,
                                      use_paged_kernel=False,
                                      faults=JFaultPlan()))):
        out = str(tmp_path / name)
        eng.run([(p, 5) for p in prompts], metrics_dir=out, flush_every=2)
        dirs[name] = out

    def files(d):
        return sorted("events" if f.startswith("events.out.tfevents.")
                      else f for f in os.listdir(d))

    assert files(dirs["port"]) == files(dirs["ref"]) == [
        "events", "flight.json", "metrics.prom", "trace.json"]

    def series(d):
        lines = open(os.path.join(d, "metrics.prom")).read().splitlines()
        return [ln.rsplit(" ", 1)[0] for ln in lines]

    assert series(dirs["port"]) == series(dirs["ref"])
    for d in dirs.values():
        ttracing.validate_trace(json.load(open(os.path.join(d,
                                                            "trace.json"))))
    ours, theirs = (ttb.read_scalars(dirs["port"]),
                    jtb.read_scalars(dirs["ref"]))
    assert ours.keys() == theirs.keys()
    for tag in ours:
        assert [s for s, _ in ours[tag]] == [s for s, _ in theirs[tag]]
        if not tag.startswith(WALL_CLOCK):
            assert ours[tag] == theirs[tag], tag
    assert jtb.read_scalars(dirs["port"]) == ours
    assert ttb.read_scalars(dirs["ref"]) == theirs
    f1, f2 = (json.load(open(os.path.join(d, "flight.json")))
              for d in (dirs["port"], dirs["ref"]))
    assert [r["kind"] for r in f1["records"]] == \
        [r["kind"] for r in f2["records"]]
    assert [r["t"] for r in f1["records"]] == [r["t"] for r in f2["records"]]


def test_summary_writer_matches_reference_bytes(tmp_path):
    """The port's event records are the reference's, byte for byte, at a
    fixed wall time (exact)."""
    assert ttb._record(ttb._event(12.5, step=3, summary=ttb._scalar_summary(
        "loss", 0.25))) == jtb._record(jtb._event(
            12.5, step=3, summary=jtb._scalar_summary("loss", 0.25)))
    w = ttb.SummaryWriter(str(tmp_path))
    w.add_scalar("x", np.float32(1.5), step=2)
    w.close()
    assert jtb.read_scalars(str(tmp_path)) == {"x": [(2, 1.5)]}

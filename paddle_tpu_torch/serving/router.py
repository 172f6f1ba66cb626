"""Multi-replica serving router: disaggregated prefill/decode.

Counterpart of ``paddle_tpu/serving/router.py``.  On one card every
replica of a cluster shares the one model, so the weights are held once.

One :class:`~paddle_tpu_torch.serving.engine.ServingEngine` is one replica —
its own KV pool, prefix index, scheduler and jitted programs.  This
module is the tier ABOVE them: a :class:`Router` that owns admission for
a fleet of replicas and the three decisions a fleet adds over a single
engine:

  * **cache-affinity routing** — each replica exposes its prefix-index
    keys through the read-only ``prefix_match_len`` probe; a request
    routes to the prefill replica holding its LONGEST cached prefix
    (DistServe/Mooncake-style KV-aware dispatch), tie-broken by
    ``load_score`` (resident slots + queue depth + pool pressure), then
    by index for determinism.  Affinity concentrates shared prefixes on
    the replica that already has their pages, so the hit rate of the
    FLEET approaches the hit rate of one big pool without sharing
    memory;
  * **prefill/decode separation** — ``role="prefill"`` replicas run
    chunked prefill to completion and export ``(request, page payloads,
    scales)`` records (snapshot v5 wire format); the router pumps each
    record to the least-loaded ``role="decode"`` replica, whose pool
    adopts the pages bit-exactly (layout-guarded) with zero recompute.
    Decode steps never contend with prompt chunks for the token budget,
    which is the whole point of disaggregation (DistServe, OSDI '24);
  * **router-global fairness** — with a
    :class:`~paddle_tpu_torch.serving.tenancy.ClusterWFQState`, every member
    policy shares ONE virtual-token-counter table, so ``vt ==
    served/weight`` holds across the cluster, not per replica, and a
    tenant cannot dodge its weight by landing on an idle replica.

The router is deliberately in-process and synchronous — ``step()``
steps every replica then pumps handoffs, exactly like the single-engine
host loop.  It is plain host code over numpy records.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .engine import FinishedRequest, ServingEngine
from .scheduler import Request
from .tenancy import ClusterWFQState, WFQPolicy
from .tracing import (PID_ROUTER, TraceRecorder, flow_id, merge_traces)

__all__ = ["Router", "make_cluster"]


class Router:
    """Admission + routing tier over a fleet of serving replicas.

    ``replicas`` is the fleet in index order; roles partition it into
    PREFILL targets (``role`` in ``both``/``prefill`` — they can admit
    fresh prompts) and DECODE targets (``both``/``decode`` — they can
    ingest handoffs).  A monolithic fleet (all ``both``) routes and
    balances but never hands off; a disaggregated fleet moves every
    request across the wire exactly once, after its prompt is paid for.

    ``max_queue`` bounds the CLUSTER's total waiting count — overflow
    requests get a ``rejected`` terminal from the router itself (no
    replica ever sees them).  Per-tenant quotas stay inside the engines
    (cluster-wide when the fleet shares a ClusterWFQState).
    """

    def __init__(self, replicas: Sequence[ServingEngine], *,
                 max_queue: Optional[int] = None):
        self.replicas: List[ServingEngine] = list(replicas)
        if not self.replicas:
            raise ValueError("a Router needs at least one replica")
        self.prefill_targets = [e for e in self.replicas
                                if e.role in ("both", "prefill")]
        self.decode_targets = [e for e in self.replicas
                               if e.role in ("both", "decode")]
        if not self.prefill_targets:
            raise ValueError("no replica can admit prompts "
                             "(need role 'both' or 'prefill')")
        if not self.decode_targets:
            raise ValueError("no replica can decode "
                             "(need role 'both' or 'decode')")
        self.max_queue = max_queue
        # router-owned terminals (cluster-queue rejects) awaiting delivery
        self._pending: List[FinishedRequest] = []
        self._on_token: Optional[Callable[[int, int], None]] = None
        self.stats: Dict[str, object] = {
            "routed": [0] * len(self.prefill_targets),
            "prefix_routed": 0,        # requests routed BY a prefix match
            "prefix_match_tokens": 0,  # tokens already cached at routing
            "rejected": 0,             # cluster-queue overflow terminals
            "handoffs": 0,             # records pumped prefill -> decode
            "handoff_bytes": 0,        # payload bytes moved
            "degraded_handoffs": 0,    # records pumped WITHOUT payload
        }
        self._parts: Optional[Dict[str, object]] = None
        # cluster tracing (attach_tracers): the router's own recorder
        # plus one per replica, all on ONE shared clock so merge_traces
        # can rebase them onto a single timeline
        self.tracer: Optional[TraceRecorder] = None
        self._tracers: List[TraceRecorder] = []

    # -- streaming --------------------------------------------------------

    @property
    def on_token(self) -> Optional[Callable[[int, int], None]]:
        """Fleet-wide token observer: assigning it installs the same
        callback on every replica (rids are globally unique, so one
        ``(rid, token)`` stream is unambiguous across the fleet)."""
        return self._on_token

    @on_token.setter
    def on_token(self, cb: Optional[Callable[[int, int], None]]) -> None:
        self._on_token = cb
        for eng in self.replicas:
            eng.on_token = cb

    @property
    def max_seq_len(self) -> int:
        """Longest prompt+continuation the FLEET can take: the smallest
        replica bound (a handoff must fit its decode replica too)."""
        return min(e.max_seq_len for e in self.replicas)

    # -- admission + routing ----------------------------------------------

    def add_request(self, prompt, max_new_tokens: int,
                    arrival: float = 0.0,
                    deadline_s: Optional[float] = None,
                    tenant: Optional[str] = None) -> int:
        """Route one request into the fleet; returns its rid (globally
        unique across replicas).  Same signature as the engine's."""
        return self.submit(Request(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens, arrival=arrival,
            deadline_s=deadline_s, tenant=tenant))

    def submit(self, req: Request) -> int:
        """Admission for an already-built Request: cluster queue bound
        first (overflow is a router-owned ``rejected`` terminal — no
        replica billed, no engine metrics), then cache-affinity routing
        into the best prefill target's own admission gate (which still
        applies per-engine backpressure and tenant quotas)."""
        if req.total_len > self.max_seq_len:
            # fleet-level bound: the request must also fit whatever
            # decode replica its handoff lands on, not just the replica
            # that prefills it
            raise ValueError(
                f"request needs {req.total_len} positions; the fleet's "
                f"max_seq_len is {self.max_seq_len}")
        if self.max_queue is not None and self.queue_depth >= self.max_queue:
            self.stats["rejected"] += 1
            self._pending.append(FinishedRequest(
                rid=req.rid, prompt=req.prompt,
                tokens=np.asarray(req.generated, np.int32),
                finish_reason="rejected", n_steps=0))
            return req.rid
        t_pick = self.tracer._clock() if self.tracer is not None else 0.0
        i, matched = self._pick_replica(req)
        self.stats["routed"][i] += 1
        if matched:
            self.stats["prefix_routed"] += 1
            self.stats["prefix_match_tokens"] += matched
        if self.tracer is not None:
            # the routing decision as an X span on the router lane:
            # WHY this replica won (cache affinity vs. load) is visible
            # right next to the request's lifecycle in the merged trace
            self.tracer.complete(
                "route", t_pick, self.tracer._clock() - t_pick,
                PID_ROUTER, 0,
                args={"rid": int(req.rid), "replica": int(i),
                      "prefix_match_len": int(matched),
                      "load_score": float(
                          self.prefill_targets[i].load_score())})
        return self.prefill_targets[i]._enqueue(req)

    def _pick_replica(self, req: Request):
        """(index into prefill_targets, matched tokens): longest cached
        prefix wins; ties (usually 0-vs-0 on cold caches) fall to the
        lowest load score, then the lowest index — fully deterministic
        for a given fleet state."""
        best_i, best_key = 0, None
        for i, eng in enumerate(self.prefill_targets):
            key = (-eng.prefix_match_len(req.prompt), eng.load_score(), i)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        return best_i, -best_key[0]

    def cancel(self, rid: int) -> bool:
        """Cancel wherever the request currently lives (waiting,
        resident, or parked in a handoff inbox on any replica)."""
        return any(eng.cancel(rid) for eng in self.replicas)

    # -- the cluster step -------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Total waiting requests across the fleet (handoff inboxes
        excluded — those requests were already admitted once)."""
        return sum(e.scheduler.n_waiting for e in self.replicas)

    @property
    def has_work(self) -> bool:
        return (bool(self._pending)
                or any(e.has_work for e in self.replicas)
                or any(e._handoff_out for e in self.replicas))

    def step(self) -> List[FinishedRequest]:
        """One cluster iteration: step every replica that has work, then
        pump handoff outboxes to decode targets.  Pumping AFTER the
        sweep means a record produced by replica i this step reaches its
        decode replica's inbox before that replica's NEXT admit phase —
        one router hop of latency, same as a real transfer fabric."""
        finished: List[FinishedRequest] = list(self._pending)
        self._pending.clear()
        for eng in self.replicas:
            if eng.has_work:
                finished.extend(eng.step())
        self._pump_handoffs()
        return finished

    def _pump_handoffs(self) -> None:
        """Deliver every outbox record to the least-loaded decode
        target.  Degraded records (payload dropped by an injected
        transfer fault) still deliver — the decode replica re-prefills
        them — so a fabric fault costs recompute, never a request."""
        for eng in self.replicas:
            if not eng._handoff_out:
                continue
            for h in eng.drain_handoffs():
                j = min(range(len(self.decode_targets)),
                        key=lambda j: (self.decode_targets[j].load_score(),
                                       j))
                self.stats["handoffs"] += 1
                if h["payload"] is None:
                    self.stats["degraded_handoffs"] += 1
                else:
                    self.stats["handoff_bytes"] += h["nbytes"]
                tr = h.get("trace")
                if self.tracer is not None:
                    self.tracer.begin(
                        "pump_handoff", PID_ROUTER, 0,
                        args={"rid": int(h["request"]["rid"]),
                              "to_replica": int(j),
                              "nbytes": int(h["nbytes"]),
                              "degraded": h["payload"] is None})
                    if tr is not None:
                        # the "t" hop of the handoff arrow: binds to
                        # this pump span, between the prefill export
                        # ("s") and the decode ingest ("f")
                        self.tracer.flow_step(
                            "handoff", PID_ROUTER, 0,
                            flow_id(tr["rid"], tr["seq"]))
                self.decode_targets[j].ingest_handoff(h)
                if self.tracer is not None:
                    self.tracer.end(PID_ROUTER, 0)

    def run(self, requests: Optional[Sequence] = None,
            metrics_dir: Optional[str] = None
            ) -> Dict[int, FinishedRequest]:
        """Drive the cluster to drain; returns {rid: FinishedRequest}
        with degraded terminals included — the fleet-level mirror of
        ``ServingEngine.run``.  Asserts every replica drained leak-free.

        ``metrics_dir`` turns the drain into an observed run
        (auto-attaching metrics, shared-clock tracers and flight
        recorders if none are set); at drain the dir holds
        ``metrics_r{i}.prom`` per replica, ``cluster.prom`` (one scrape
        page for the fleet), ``trace.json`` (the MERGED cluster trace —
        open in Perfetto to see handoff arrows cross replicas) and
        ``flight_r{i}.json`` black-box dumps.  A crash escaping any
        replica's step loop dumps ``flight_crash_r{i}.json`` before
        re-raising."""
        for r in requests or ():
            if isinstance(r, Request):
                self.submit(r)
            else:
                prompt, max_new = r
                self.add_request(prompt, max_new)
        if metrics_dir is not None:
            if self._parts is None:
                self.attach_metrics()
            if self.tracer is None:
                self.attach_tracers()
            self.attach_flight()
            os.makedirs(metrics_dir, exist_ok=True)
            for i, eng in enumerate(self.replicas):
                eng._crash_dump_dir = metrics_dir
                eng._crash_dump_name = f"flight_crash_r{i}.json"
        done: Dict[int, FinishedRequest] = {}
        try:
            while self.has_work:
                for fin in self.step():
                    done[fin.rid] = fin
        finally:
            if metrics_dir is not None:
                self._dump_artifacts(metrics_dir)
        for i, eng in enumerate(self.replicas):
            if eng.scheduler.n_active or eng.pool.pages_in_use:
                raise AssertionError(
                    f"replica {i} did not drain: "
                    f"{eng.scheduler.n_active} active slots, "
                    f"{eng.pool.pages_in_use} pages in use")
        return done

    def _dump_artifacts(self, metrics_dir: str) -> None:
        from .metrics import cluster_prometheus
        from .tracing import save_trace

        for i, eng in enumerate(self.replicas):
            if eng.metrics is not None:
                with open(os.path.join(metrics_dir,
                                       f"metrics_r{i}.prom"), "w") as f:
                    f.write(eng.metrics.to_prometheus())
            if eng.flight is not None:
                eng.flight.dump(os.path.join(metrics_dir,
                                             f"flight_r{i}.json"))
        if self._parts is not None:
            with open(os.path.join(metrics_dir, "cluster.prom"),
                      "w") as f:
                f.write(cluster_prometheus(self._parts))
        if self.tracer is not None:
            save_trace(self.merged_trace(),
                       os.path.join(metrics_dir, "trace.json"))

    # -- audits + observability -------------------------------------------

    def check_invariants(self) -> None:
        """Every replica's page-leak/refcount/scheduler audit."""
        for eng in self.replicas:
            eng.check_invariants()

    def attach_tracers(self, clock: Optional[Callable[[], float]] = None
                       ) -> TraceRecorder:
        """Cluster tracing: one recorder per replica (lanes namespaced
        ``replica * PID_STRIDE + base``, labels prefixed ``r{i}:``) plus
        the router's own PID_ROUTER lane, ALL on one shared clock —
        the precondition for :func:`~paddle_tpu_torch.serving.tracing.
        merge_traces` rebasing them onto a single timeline.  Returns
        the router's recorder."""
        clk = clock or time.perf_counter
        self.tracer = TraceRecorder(clock=clk)
        self.tracer.process_name(
            PID_ROUTER, "router (routing + handoff pump)")
        self._tracers = []
        for i, eng in enumerate(self.replicas):
            rec = TraceRecorder(clock=clk)
            eng.attach_tracer(rec, replica=i)
            self._tracers.append(rec)
        return self.tracer

    def attach_flight(self, capacity: int = 1024) -> None:
        """A flight recorder on every replica that lacks one (each on
        its OWN engine clock — the black box must replay
        bit-identically under that replica's fault plan)."""
        for eng in self.replicas:
            if eng.flight is None:
                eng.attach_flight(capacity=capacity)

    def merged_trace(self) -> dict:
        """The fleet's recorders merged into ONE Perfetto-loadable
        trace: router lane + every replica's lanes, handoff flow
        arrows intact.  Requires :meth:`attach_tracers`."""
        if self.tracer is None:
            raise RuntimeError("call attach_tracers() first")
        return merge_traces([self.tracer] + self._tracers)

    def dump_debug(self) -> Dict[str, object]:
        """Fleet-wide debug snapshot (the /debug/state payload): the
        router's ledger plus every replica's
        :meth:`~paddle_tpu_torch.serving.engine.ServingEngine.dump_debug`
        (invariant verdicts, stats, flight rings)."""
        return {"router": self.stats_snapshot(),
                "queue_depth": self.queue_depth,
                "replicas": [eng.dump_debug() for eng in self.replicas]}

    def attach_metrics(self) -> Dict[str, object]:
        """One FRESH registry per replica (the engine's one-registry
        rule), keyed ``"replica0"``... — aggregate with
        :func:`~paddle_tpu_torch.serving.metrics.aggregate_scalars` or render
        one scrape page with
        :func:`~paddle_tpu_torch.serving.metrics.cluster_prometheus`."""
        self._parts = {f"replica{i}": eng.attach_metrics()
                       for i, eng in enumerate(self.replicas)}
        return self._parts

    def scalars(self) -> Dict[str, float]:
        """Cluster-rollup scalars: counters sum, gauges min/max-combine,
        and histogram BUCKETS merge before re-quantizing, so the
        ``*_p50``/``*_p99`` here are true cluster quantiles —
        identical to what one union registry would have reported."""
        from .metrics import aggregate_scalars

        if self._parts is None:
            raise RuntimeError("call attach_metrics() first")
        return aggregate_scalars(self._parts)

    def to_prometheus(self) -> str:
        """One scrape page for the fleet: every series labeled
        ``replica="replicaN"``, one HELP/TYPE per family."""
        from .metrics import cluster_prometheus

        if self._parts is None:
            raise RuntimeError("call attach_metrics() first")
        return cluster_prometheus(self._parts)

    def stats_snapshot(self) -> Dict[str, object]:
        out = dict(self.stats, routed=list(self.stats["routed"]))
        return out


def make_cluster(model, n_replicas: int = 2, *, disaggregate: bool = False,
                 tenants=None, router_max_queue: Optional[int] = None,
                 **engine_kw) -> Router:
    """Build a routed fleet over one model.

    ``disaggregate=False``: ``n_replicas`` monolithic (``role="both"``)
    engines — pure routing/balancing.  ``disaggregate=True`` (needs >= 2
    replicas): the first ``n_replicas // 2`` (at least one) become
    prefill workers, the rest decode workers.  ``tenants`` installs
    router-global WFQ: one shared
    :class:`~paddle_tpu_torch.serving.tenancy.ClusterWFQState` with every
    member policy aliasing its virtual-token table.  Remaining keyword
    arguments go to every :class:`ServingEngine` verbatim (``device``
    among them); the replicas share one set of decode weights.
    """
    if n_replicas < 1:
        raise ValueError("n_replicas must be >= 1")
    if disaggregate and n_replicas < 2:
        raise ValueError("disaggregation needs >= 2 replicas "
                         "(one prefill + one decode)")
    if disaggregate:
        n_pre = max(1, n_replicas // 2)
        roles = ["prefill"] * n_pre + ["decode"] * (n_replicas - n_pre)
    else:
        roles = ["both"] * n_replicas
    state = ClusterWFQState(tenants) if tenants is not None else None
    replicas = []
    for role in roles:
        kw = dict(engine_kw)
        if state is not None:
            kw["policy"] = WFQPolicy(state=state)
        eng = ServingEngine(model, role=role, **kw)
        if replicas:
            # one model on one card: every replica decodes with the first
            # one's weights (its int8 ones too), held once
            eng.params = replicas[0].params
        replicas.append(eng)
    return Router(replicas, max_queue=router_max_queue)

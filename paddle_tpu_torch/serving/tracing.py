"""Request-lifecycle tracing: Chrome trace-event JSON from the engine.

Counterpart of ``paddle_tpu/serving/tracing.py``: the same event names,
phases, lanes and args.  A request's life — queued, admitted,
chunk-prefilled, decoding, preempted, recomputed, terminal — is recorded
as Chrome trace-event JSON (the ``{"traceEvents": [...]}`` format),
openable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``:

  * **one track per request** (pid ``PID_REQUESTS``, tid = rid):
    ``queued`` and ``resident`` B/E spans, ``prefill_chunk`` spans per
    chunk, instants for ``first_token`` / ``preempt`` / ``cow_clone`` /
    the terminal reason — a preempted request visibly bounces back to a
    ``queued`` span and re-prefills;
  * **one engine track** (pid ``PID_ENGINE``): per-step ``admit`` /
    ``prefill`` / ``decode`` phase X (complete) events, so slow steps
    and fault-aborted phases line up against request state;
  * **host spans** (pid ``PID_HOST``): :func:`attach_profiler` bridges
    ``paddle_tpu_torch.profiler.RecordEvent`` — every host span recorded
    anywhere in-process lands on the SAME timeline as the engine phases.

B/E discipline: :meth:`TraceRecorder.end` pops the recorder's own
per-track stack and names the E event from it, so emitted B/E pairs are
balanced BY CONSTRUCTION inside a track (asserted over chaos runs in
tests/test_torch_observability.py).  Engine phases deliberately use X
events — an injected mid-phase fault can abort a phase, and an X event
written after the fact cannot dangle.

Timestamps are microseconds on one monotonic base (``time.perf_counter``
by default; injectable for tests).  Dump with :meth:`save` and load the
file straight into Perfetto.

Cluster tracing: every recorder can carry a **replica identity**
(:meth:`TraceRecorder.set_replica`) that namespaces its pid lanes
(``replica * PID_STRIDE + base``) and prefixes lane names, so N
replicas merge into one timeline without colliding.  The Router gets
its own ``PID_ROUTER`` lane.  Cross-replica handoffs are stitched with
Chrome **flow events** (``ph: "s"/"t"/"f"`` sharing an ``id`` + ``cat``)
— Perfetto draws one arrow from the prefill replica's export through
the router pump into the decode replica's ingest.  :func:`merge_traces`
rebases N recorders sharing one clock onto the earliest ``_t0`` and
returns a single Perfetto-loadable dict; :func:`validate_trace` asserts
well-formedness (balanced B/E per track, every flow start terminated).
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

__all__ = ["TraceRecorder", "PID_ENGINE", "PID_REQUESTS", "PID_HOST",
           "PID_ROUTER", "PID_STRIDE", "FLOW_CAT_HANDOFF", "flow_id",
           "merge_traces", "validate_trace", "save_trace",
           "attach_profiler", "detach_profiler"]

#: Process lanes of the unified timeline.
PID_ENGINE = 1      # engine step phases (admit/prefill/decode X events)
PID_REQUESTS = 2    # one thread per request (tid = rid)
PID_HOST = 3        # host profiler spans
PID_ROUTER = 4      # router decisions + handoff pump (cluster runs)

#: Replica pid namespace: replica ``i``'s lanes live at
#: ``i * PID_STRIDE + base`` so merged cluster traces never collide.
PID_STRIDE = 10

#: Category tag shared by handoff flow events (s/t/f bind on (cat, id)).
FLOW_CAT_HANDOFF = "handoff"


def flow_id(rid: int, seq: int) -> int:
    """Globally unique flow id for one handoff: rids are fleet-unique
    (one shared allocator) and ``seq`` is the exporting engine's
    monotonic span sequence, so re-exports of one rid (degraded handoff
    then re-handoff) get distinct arrows."""
    return (int(rid) << 20) | (int(seq) & 0xFFFFF)


class TraceRecorder:
    """Append-only Chrome trace-event recorder.

    ``clock`` is a zero-arg seconds source (default
    ``time.perf_counter``); every event stamps ``ts`` in microseconds
    relative to the recorder's construction, so traces start at t=0.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self.events: List[dict] = []
        # open-span stack per (pid, tid): end() pops, so B/E pairs are
        # balanced by construction within a track
        self._open: Dict[tuple, List[str]] = {}
        self._named_pids = set()
        self.replica: Optional[int] = None
        self.replica_name: Optional[str] = None

    # -- replica identity --------------------------------------------------

    def set_replica(self, index: int, name: Optional[str] = None) -> None:
        """Namespace this recorder's lanes under replica ``index``.

        After this, :meth:`pid` maps base lanes into the replica's pid
        block and lane labels gain an ``r{index}`` (or ``name``) prefix.
        Must be called before any lane is named."""
        if self._named_pids:
            raise ValueError("set_replica must precede process_name")
        self.replica = int(index)
        self.replica_name = name or f"r{index}"

    def pid(self, base: int) -> int:
        """Map a base lane (PID_ENGINE, ...) into this recorder's
        replica namespace; identity when no replica is set."""
        if self.replica is None:
            return base
        return self.replica * PID_STRIDE + base

    def lane_label(self, label: str) -> str:
        if self.replica is None:
            return label
        return f"{self.replica_name}: {label}"

    # -- time -------------------------------------------------------------

    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _ev(self, name: str, ph: str, ts: float, pid: int, tid: int,
            args: Optional[dict] = None, **extra) -> dict:
        ev = {"name": name, "ph": ph, "ts": round(ts, 3),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        ev.update(extra)
        self.events.append(ev)
        return ev

    def process_name(self, pid: int, name: str) -> None:
        """Label a pid lane (idempotent) — Perfetto shows the name."""
        if pid not in self._named_pids:
            self._named_pids.add(pid)
            self._ev("process_name", "M", 0.0, pid, 0,
                     args={"name": name})

    # -- spans ------------------------------------------------------------

    def begin(self, name: str, pid: int, tid: int,
              args: Optional[dict] = None) -> None:
        self._open.setdefault((pid, tid), []).append(name)
        self._ev(name, "B", self.now_us(), pid, tid, args)

    def end(self, pid: int, tid: int, args: Optional[dict] = None) -> str:
        """Close the innermost open span on (pid, tid); returns its name.
        A track with nothing open raises — the engine's lifecycle logic
        is the state machine, and an unmatched end means it broke."""
        stack = self._open.get((pid, tid))
        if not stack:
            raise ValueError(f"no open span on track ({pid}, {tid})")
        name = stack.pop()
        self._ev(name, "E", self.now_us(), pid, tid, args)
        return name

    def open_span(self, pid: int, tid: int) -> Optional[str]:
        """Name of the innermost open span on the track, or None."""
        stack = self._open.get((pid, tid))
        return stack[-1] if stack else None

    def instant(self, name: str, pid: int, tid: int,
                args: Optional[dict] = None) -> None:
        self._ev(name, "i", self.now_us(), pid, tid, args, s="t")

    def complete(self, name: str, start_s: float, dur_s: float, pid: int,
                 tid: int, args: Optional[dict] = None) -> None:
        """An X event from absolute clock seconds (same base as
        ``clock``) — used for engine phases and bridged host spans."""
        self._ev(name, "X", (start_s - self._t0) * 1e6, pid, tid, args,
                 dur=round(dur_s * 1e6, 3))

    # -- flow events -------------------------------------------------------
    #
    # s/t/f events sharing (cat, id) draw one arrow across lanes in
    # Perfetto.  "s"/"t" bind to the NEXT slice on their track by
    # timestamp; "f" with bp="e" binds to the enclosing slice.  The
    # engine emits "s" inside the exporting request's resident span,
    # the router "t" inside its pump span, the ingesting engine "f"
    # inside the request's new queued span.

    def flow_start(self, name: str, pid: int, tid: int, flow_id: int,
                   cat: str = FLOW_CAT_HANDOFF) -> None:
        self._ev(name, "s", self.now_us(), pid, tid, cat=cat,
                 id=int(flow_id))

    def flow_step(self, name: str, pid: int, tid: int, flow_id: int,
                  cat: str = FLOW_CAT_HANDOFF) -> None:
        self._ev(name, "t", self.now_us(), pid, tid, cat=cat,
                 id=int(flow_id))

    def flow_finish(self, name: str, pid: int, tid: int, flow_id: int,
                    cat: str = FLOW_CAT_HANDOFF) -> None:
        self._ev(name, "f", self.now_us(), pid, tid, cat=cat,
                 id=int(flow_id), bp="e")

    # -- output -----------------------------------------------------------

    def to_json(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path


# -- cluster merge + validation ----------------------------------------------

def merge_traces(recorders) -> dict:
    """Merge N recorders into one Perfetto-loadable trace dict.

    All recorders must share one clock (the Router constructs them that
    way); each recorder's events are rebased onto the EARLIEST ``_t0``
    — the same delta idiom snapshot restore uses for the engine clock —
    so spans keep their true relative offsets.  Metadata ("M") events
    stay at ts 0 and are deduplicated per (pid, name)."""
    recorders = [r for r in recorders if r is not None]
    if not recorders:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(r._t0 for r in recorders)
    events: List[dict] = []
    seen_meta = set()
    for r in recorders:
        shift_us = (r._t0 - base) * 1e6
        for ev in r.events:
            if ev["ph"] == "M":
                key = (ev["pid"], ev["name"],
                       ev.get("args", {}).get("name"))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
                events.append(dict(ev))
            else:
                out = dict(ev)
                out["ts"] = round(out["ts"] + shift_us, 3)
                events.append(out)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def save_trace(trace: dict, path: str) -> str:
    """Write a trace dict (e.g. from :func:`merge_traces`) to ``path``
    — kept here so callers outside the scoped-import set (router.py)
    never touch ``json`` directly."""
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def validate_trace(trace) -> dict:
    """Assert Chrome-trace well-formedness; returns summary counts.

    Checks: every "B" has a matching "E" per (pid, tid) in stack order,
    every flow "s" has exactly ONE "f" per (cat, id) (with optional "t"
    steps in between), "X" events carry a non-negative ``dur``, and all
    timestamps are non-negative.  Raises ``ValueError`` on violation.
    Accepts a trace dict (``{"traceEvents": ...}``), a recorder, or a
    raw event list."""
    if hasattr(trace, "events"):
        events = trace.events
    elif isinstance(trace, dict):
        events = trace["traceEvents"]
    else:
        events = trace
    depth: Dict[tuple, int] = {}
    flows: Dict[tuple, List[str]] = {}
    counts = {"B": 0, "E": 0, "X": 0, "i": 0, "M": 0,
              "s": 0, "t": 0, "f": 0}
    for ev in events:
        ph = ev["ph"]
        counts[ph] = counts.get(ph, 0) + 1
        if ph != "M" and ev["ts"] < 0:
            raise ValueError(f"negative ts on {ev}")
        track = (ev["pid"], ev["tid"])
        if ph == "B":
            depth[track] = depth.get(track, 0) + 1
        elif ph == "E":
            d = depth.get(track, 0) - 1
            if d < 0:
                raise ValueError(f"unmatched E on track {track}: {ev}")
            depth[track] = d
        elif ph == "X":
            if ev.get("dur", 0) < 0:
                raise ValueError(f"negative dur on {ev}")
        elif ph in ("s", "t", "f"):
            flows.setdefault((ev.get("cat"), ev["id"]), []).append(ph)
    for track, d in depth.items():
        if d != 0:
            raise ValueError(f"{d} unclosed span(s) on track {track}")
    for key, phs in flows.items():
        # merged lists concatenate per-recorder, so don't rely on list
        # order — require exactly one start and one finish per flow id
        if phs.count("s") != 1 or phs.count("f") != 1:
            raise ValueError(
                f"flow {key} must have exactly one s and one f, "
                f"got {phs}")
    counts["flows"] = len(flows)
    return counts


# -- profiler bridge ---------------------------------------------------------

def attach_profiler(tracer: TraceRecorder, pid: int = PID_HOST,
                    tid: int = 0):
    """Mirror every ``profiler.RecordEvent`` span into ``tracer`` as an X
    event on the host lane — engine phases, request lifecycle and host
    spans land on ONE Perfetto timeline.  Returns the sink handle for
    :func:`detach_profiler`; callers who outlive the tracer should
    detach, or the module-global sink list keeps feeding (and growing)
    a dead trace.  Idempotent per tracer: re-attaching an
    already-bridged tracer returns the existing sink instead of
    doubling every span.  RecordEvent measures on
    ``time.perf_counter``; the recorder maps those stamps through its
    own t0, so alignment with engine phases is exact when the tracer
    runs on the default clock (and merely monotonic under a virtual
    test clock)."""
    from .. import profiler as _prof

    existing = getattr(tracer, "_profiler_sink", None)
    if existing is not None:
        return existing
    tracer.process_name(pid, "host (profiler.RecordEvent)")

    def sink(name: str, t0: float, t1: float) -> None:
        tracer.complete(name, t0, t1 - t0, pid, tid)

    sink.tracer = tracer
    tracer._profiler_sink = sink
    _prof.add_span_sink(sink)
    return sink


def detach_profiler(sink) -> None:
    from .. import profiler as _prof

    _prof.remove_span_sink(sink)
    tracer = getattr(sink, "tracer", None)
    if tracer is not None and \
            getattr(tracer, "_profiler_sink", None) is sink:
        tracer._profiler_sink = None

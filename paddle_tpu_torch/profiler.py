"""Profiler: host event tables and ``torch.profiler`` device traces.

Counterpart of ``paddle_tpu/profiler.py``, which is the role of the
reference's ``RecordEvent`` / ``EnableProfiler`` (``platform/profiler.h``)
and of its ``with profiler.profiler(state, sorted_key, profile_path)``
surface, whose report is a Calls / Total / Min / Max / Ave table.

Host events: :class:`RecordEvent` spans are collected into a process-wide
table while profiling is on, and every span, profiling or not, is handed
to the registered span sinks (:func:`add_span_sink`; the serving tracer's
``attach_profiler`` registers one).  Where the reference mirrors a span
into a live ``jax.profiler`` trace as a ``TraceAnnotation``, here a span
inside a live device trace is a ``torch.profiler.record_function``, and
the trace (CPU activity, and the card's where there is one) is written as
Chrome trace-event JSON, ``<logdir>/trace.json``, when profiling stops.
With ``FLAGS_benchmark`` a span synchronizes the card before it closes,
so it measures the card's work rather than its enqueue.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from .framework import flags as _flags

_state = {
    "enabled": False,
    "trace": None,        # the live torch.profiler.profile, if any
    "logdir": None,
    "events": {},         # name -> [calls, total, min, max]
    "order": [],          # first-end-time ordering (the reference's default)
}

# span sinks: callables (name, t0, t1) invoked at every RecordEvent exit
# (perf_counter seconds), whether or not table profiling is on
_span_sinks: list = []

_DEFAULT_PROFILE_PATH = os.path.join(tempfile.gettempdir(), "profile")


def add_span_sink(sink) -> None:
    """Register a ``(name, t0_s, t1_s)`` observer of RecordEvent spans."""
    if sink not in _span_sinks:
        _span_sinks.append(sink)


def remove_span_sink(sink) -> None:
    if sink in _span_sinks:
        _span_sinks.remove(sink)


def _card_busy() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class RecordEvent:
    """A host-event span (the reference's ``RecordEvent``), as a context
    manager.  Inside a live device trace it is also a
    ``torch.profiler.record_function`` range of the same name."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0
        self._ann = None

    def __enter__(self):
        if _state["trace"] is not None:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _flags.flag("FLAGS_benchmark") and _card_busy():
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        dt = (t1 - self._t0) * 1e3  # ms
        for sink in list(_span_sinks):
            sink(self.name, self._t0, t1)
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        if _state["enabled"]:
            ev = _state["events"].get(self.name)
            if ev is None:
                _state["events"][self.name] = [1, dt, dt, dt]
                _state["order"].append(self.name)
            else:
                ev[0] += 1
                ev[1] += dt
                ev[2] = min(ev[2], dt)
                ev[3] = max(ev[3], dt)
        return False


def is_profiling() -> bool:
    """True while spans are collected (a table or a device trace): the
    eager tracer then opens one span per op."""
    return bool(_state["enabled"]) or _state["trace"] is not None


@contextlib.contextmanager
def record_event(name: str):
    with RecordEvent(name):
        yield


def reset_profiler() -> None:
    """Clear the collected host events."""
    _state["events"] = {}
    _state["order"] = []


def start_profiler(state: str = "All", tracer_option: str = "Default",
                   logdir: Optional[str] = None) -> None:
    """Begin collection.  ``state``: 'CPU' = host events only; 'GPU',
    'TPU' or 'All' = host events and a ``torch.profiler`` trace of the
    host and, where there is one, the CUDA card."""
    if state not in ("CPU", "GPU", "TPU", "All"):
        raise ValueError(
            "state should be 'CPU', 'GPU', 'TPU' or 'All', got %r" % (state,))
    if _state["enabled"]:
        return
    reset_profiler()
    _state["enabled"] = True
    if state != "CPU":
        _state["logdir"] = logdir or _flags.flag("FLAGS_profiler_logdir")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        try:
            prof.start()
        except RuntimeError:    # no trace backend here: host events only
            return
        _state["trace"] = prof


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: str = _DEFAULT_PROFILE_PATH) -> None:
    """End collection: stop the device trace and write it as Chrome JSON
    to ``<logdir>/trace.json``, print the host event table and dump it as
    JSON to ``profile_path``."""
    if sorted_key not in _SORTERS:  # validate BEFORE tearing down state
        raise ValueError("sorted_key should be None, 'calls', 'total', "
                         "'max', 'min' or 'ave', got %r" % (sorted_key,))
    if not _state["enabled"]:
        return
    _state["enabled"] = False
    trace_path = None
    prof, _state["trace"] = _state["trace"], None
    if prof is not None:
        prof.stop()
        os.makedirs(_state["logdir"], exist_ok=True)
        trace_path = os.path.join(_state["logdir"], "trace.json")
        prof.export_chrome_trace(trace_path)
    try:
        _print_report(sorted_key, profile_path, trace_path)
    finally:
        # a later CPU-only session must not report this session's trace
        _state["logdir"] = None


_SORTERS = {
    None: None,
    "default": None,
    "calls": lambda kv: -kv[1][0],
    "total": lambda kv: -kv[1][1],
    "min": lambda kv: -kv[1][2],
    "max": lambda kv: -kv[1][3],
    "ave": lambda kv: -(kv[1][1] / kv[1][0]),
}


def _print_report(sorted_key, profile_path, trace_path=None) -> None:
    events = _state["events"]
    rows = [(n, events[n]) for n in _state["order"]]
    keyf = _SORTERS[sorted_key]
    if keyf is not None:
        rows.sort(key=keyf)
    grand = sum(ev[1] for _, ev in rows) or 1.0
    print("------------------------->     Profiling Report     "
          "<-------------------------")
    place = "GPU" if torch.cuda.is_available() else "CPU"
    print(f"Place: {place}\nTime unit: ms")
    print(f"{'Event':<32}{'Calls':<10}{'Total':<12}{'Min.':<12}"
          f"{'Max.':<12}{'Ave.':<12}{'Ratio.':<10}")
    payload: Dict[str, Dict[str, float]] = {}
    for name, (calls, total, mn, mx) in rows:
        ave = total / calls
        print(f"{name:<32}{calls:<10}{total:<12.5g}{mn:<12.5g}"
              f"{mx:<12.5g}{ave:<12.5g}{total / grand:<10.5g}")
        payload[name] = {"calls": calls, "total_ms": total, "min_ms": mn,
                         "max_ms": mx, "ave_ms": ave}
    if trace_path is not None:
        print(f"Device trace: {trace_path} (Chrome trace JSON: open at "
              f"https://ui.perfetto.dev)")
    try:
        with open(profile_path, "w") as f:
            json.dump(payload, f, indent=1)
    except OSError:
        pass


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: str = _DEFAULT_PROFILE_PATH,
             tracer_option: str = "Default"):
    """``with profiler.profiler('All', 'total'):`` — the fluid-style
    context."""
    start_profiler(state, tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def start(logdir: Optional[str] = None) -> None:
    """The 2.x-style alias of ``start_profiler("All", logdir=logdir)``."""
    start_profiler("All", logdir=logdir)


def stop(sorted_key: Optional[str] = None,
         profile_path: str = _DEFAULT_PROFILE_PATH) -> None:
    """The 2.x-style alias of ``stop_profiler``."""
    stop_profiler(sorted_key, profile_path)


# ---------------------------------------------------------------------------
# the utils.profiler surface (the reference's python/paddle/utils/profiler.py)
# ---------------------------------------------------------------------------


class ProfilerOptions:
    """Option bag for :class:`Profiler`."""

    DEFAULTS = {
        "state": "All",
        "sorted_key": "total",
        "tracer_level": "Default",
        "batch_range": [0, 100],
        "output_thread_detail": False,
        "profile_path": "none",
        "timeline_path": "none",
        "op_summary_path": "none",
    }

    def __init__(self, options=None):
        self._options = dict(self.DEFAULTS)
        if options is not None:
            self._options.update(options)

    def with_state(self, state):
        self._options["state"] = state
        return self

    def __getitem__(self, name):
        if name not in self._options:
            raise ValueError(f"ProfilerOptions does not have an option "
                             f"named {name}")
        return self._options[name]


_profiler_singleton = None


class Profiler:
    """Batch-windowed profiler driver: profiles the batches inside
    ``batch_range`` between start and stop."""

    def __init__(self, enabled: bool = True, options=None):
        self._enabled = enabled
        self._options = (options if isinstance(options, ProfilerOptions)
                         else ProfilerOptions(options))
        self._batch = 0
        self._running = False

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def start(self):
        if self._enabled and not self._running:
            lo = self._options["batch_range"][0]
            if self._batch >= lo:
                start_profiler(state=self._options["state"],
                               tracer_option=self._options["tracer_level"])
                self._running = True

    def stop(self):
        if self._running:
            path = self._options["profile_path"]
            kw = {} if path == "none" else {"profile_path": path}
            stop_profiler(sorted_key=self._options["sorted_key"], **kw)
            self._running = False

    def reset(self):
        reset_profiler()
        self._batch = 0

    def record_step(self, change_profiler_status: bool = True):
        self._batch += 1
        if not (self._enabled and change_profiler_status):
            return
        lo, hi = self._options["batch_range"]
        if self._batch == lo and not self._running:
            self.start()
        elif self._batch == hi and self._running:
            self.stop()


def get_profiler(options=None) -> Profiler:
    global _profiler_singleton
    if _profiler_singleton is None:
        _profiler_singleton = Profiler(options=options)
    return _profiler_singleton

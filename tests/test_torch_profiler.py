"""The port's profiler (``paddle_tpu_torch.profiler``) and its bridge into
the serving tracer (``attach_profiler`` / ``detach_profiler``), as
``tests/test_flags_profiler.py`` and ``tests/test_metrics.py`` hold the
reference's.

The host table (calls, total, min, max per span name, in first-end
order, sorted by the report's key, dumped as JSON to ``profile_path``),
the span sinks fed at every ``RecordEvent`` exit whether or not the table
is on, a bridged span landing as an X event on ``PID_HOST`` of a trace
that ``validate_trace`` passes, and a ``torch.profiler`` trace written as
Chrome JSON to the log directory.  Span times are the host's clock: these
tests check structure, never a duration.
"""

import json

import pytest

from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.serving import (PID_HOST, TraceRecorder,
                                      attach_profiler, detach_profiler,
                                      validate_trace)


def test_host_event_table_and_report(tmp_path, capsys):
    path = str(tmp_path / "profile.json")
    with profiler.profiler("CPU", "calls", path):
        for _ in range(3):
            with profiler.RecordEvent("matmul"):
                pass
        with profiler.record_event("softmax"):
            pass
    out = capsys.readouterr().out
    assert "Profiling Report" in out and "matmul" in out
    table = json.load(open(path))
    assert table["matmul"]["calls"] == 3 and table["softmax"]["calls"] == 1
    for ev in table.values():
        assert ev["min_ms"] <= ev["ave_ms"] <= ev["max_ms"]
    with profiler.RecordEvent("after"):          # table off: no entry
        pass
    assert "after" not in profiler._state["events"]
    with pytest.raises(ValueError):
        profiler.stop_profiler("bogus")
    with pytest.raises(ValueError):
        profiler.start_profiler("XPU")


def test_span_sinks_see_every_span_nested_in_order():
    spans = []

    def sink(name, t0, t1):
        spans.append((name, t0, t1))

    profiler.add_span_sink(sink)
    profiler.add_span_sink(sink)                # idempotent
    try:
        with profiler.RecordEvent("outer"):
            with profiler.RecordEvent("inner"):
                pass
    finally:
        profiler.remove_span_sink(sink)
    with profiler.RecordEvent("gone"):
        pass
    assert [s[0] for s in spans] == ["inner", "outer"]
    (_, i0, i1), (_, o0, o1) = spans
    assert o0 <= i0 <= i1 <= o1


def test_profiler_record_event_bridge():
    tr = TraceRecorder()
    sink = attach_profiler(tr)
    try:
        assert attach_profiler(tr) is sink       # no doubled spans
        with profiler.RecordEvent("host_span"):
            pass
    finally:
        detach_profiler(sink)
    spans = [e for e in tr.events
             if e["ph"] == "X" and e["name"] == "host_span"]
    assert len(spans) == 1 and spans[0]["pid"] == PID_HOST
    assert validate_trace(tr.to_json())["X"] == 1
    with profiler.RecordEvent("after_detach"):
        pass
    assert not any(e["name"] == "after_detach" for e in tr.events)
    sink2 = attach_profiler(tr)
    assert sink2 is not sink
    detach_profiler(sink2)


def test_device_trace_is_written_as_chrome_json(tmp_path, capsys):
    """State 'All' on the CPU: a torch.profiler trace of the host, with the
    RecordEvent spans in it as record_function ranges."""
    profiler.start_profiler("All", logdir=str(tmp_path / "trace"))
    with profiler.RecordEvent("traced_span"):
        sum(range(1000))
    profiler.stop_profiler("total", str(tmp_path / "table.json"))
    assert "Device trace:" in capsys.readouterr().out
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "traced_span" in names
    assert json.load(open(tmp_path / "table.json"))["traced_span"][
        "calls"] == 1


def test_batch_window_profiler_and_flags(tmp_path):
    path = str(tmp_path / "p.json")
    prof = profiler.Profiler(options={"state": "CPU", "batch_range": [1, 3],
                                      "profile_path": path})
    for _ in range(4):
        prof.record_step()
        with profiler.RecordEvent("step"):
            pass
    assert json.load(open(path))["step"]["calls"] == 2
    assert profiler.get_profiler() is profiler.get_profiler()
    assert flags.flag("FLAGS_benchmark") is False
    flags.set_flags({"FLAGS_benchmark": "1"})
    try:
        assert flags.flag("FLAGS_benchmark") is True
        with profiler.RecordEvent("synced"):    # no card: nothing to wait
            pass
    finally:
        flags.set_flags({"FLAGS_benchmark": False})
    with pytest.raises(ValueError):
        flags.set_flags({"FLAGS_nope": 1})

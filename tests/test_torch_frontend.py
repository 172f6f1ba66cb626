"""The port's streaming HTTP front end (``paddle_tpu_torch.serving.
frontend``) over real loopback sockets, against the reference's engine.

The six scenarios of ``tests/test_frontend.py`` run against the port's
engine: SSE streaming (and ``stream: false``), disconnect -> cancel with
the pages freed, 429 at a full global or tenant queue without enqueuing,
408 at a deadline that passes in the queue with the ``/metrics`` scrape,
``/healthz`` and every malformed request answered 400, and the driver's
death aborting the stream and flipping ``/healthz`` to 503.  Then a
``Router`` behind the front end (aggregated health, the replica-labelled
scrape page), the ``/debug`` surface, and the serve CLI
(``python -m paddle_tpu_torch.examples.serve_gpt --device cpu``) in a
subprocess, one ``--http`` request included.

Streamed tokens are held exactly (fp32 greedy on the CPU) against the
port engine's own ``FinishedRequest.tokens`` and against the reference's
engine fed the same prompts, compared by arrival index: each package
mints its own rids, and the port's rids follow arrival order.

Model: ``torch_parity.py``'s (vocab 512, hidden 64, 2 layers, 2 heads).
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np

from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.serving import (ServingEngine, ServingFrontend,
                                      TenantConfig, make_cluster)
from torch_parity import pair

ROOT = Path(__file__).resolve().parent.parent


def _engine(**kw):
    jm, tm = pair(seed=3)
    eng = ServingEngine(tm, device="cpu", max_slots=2, page_size=8,
                        chunk_tokens=8, **kw)
    # a warm-up request, as the reference's test does
    eng.add_request(np.arange(4, dtype=np.int32), 2)
    eng.run()
    return jm, tm, eng


def _reference_tokens(jm, prompts, news):
    """The reference engine's greedy tokens, in submission order."""
    jeng = JEngine(jm, max_slots=2, page_size=8, chunk_tokens=8,
                   use_paged_kernel=False)
    rids = [jeng.add_request(np.asarray(p, np.int32), n)
            for p, n in zip(prompts, news)]
    done = jeng.run()
    return [np.asarray(done[r].tokens) for r in rids]


# ---------------------------------------------------------------------------
# tiny stdlib test client
# ---------------------------------------------------------------------------


def _http_bytes(method, path, payload=None):
    body = json.dumps(payload).encode() if payload is not None else b""
    return (f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


async def _call(port, method, path, payload=None, timeout=60.0):
    """One request/response over a fresh connection: (status, headers,
    body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(_http_bytes(method, path, payload))
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), timeout)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers, body


def _sse_events(body: bytes):
    out = []
    for block in body.decode().split("\n\n"):
        block = block.strip()
        if block.startswith("data: "):
            out.append(block[len("data: "):])
    return out


def _stream_doc(body):
    """(streamed tokens, final event) of one SSE body; checks the chunk
    indices and the [DONE] terminator."""
    events = _sse_events(body)
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    final = chunks[-1]
    streamed = [c["token"] for c in chunks[:-1]]
    assert [c["index"] for c in chunks[:-1]] == list(range(len(streamed)))
    return streamed, final


async def _drain(eng, timeout=30.0):
    async def _wait():
        while eng.has_work:
            await asyncio.sleep(0.01)
    await asyncio.wait_for(_wait(), timeout)


# ---------------------------------------------------------------------------
# the six scenarios of the reference's front-end tests
# ---------------------------------------------------------------------------


def test_streamed_sse_tokens_are_exactly_the_engine_tokens():
    """Three concurrent streams and one ``stream: false`` request: each
    stream's chunks equal its final event's tokens, the port engine's
    FinishedRequest tokens (a direct run of the same prompts) and the
    reference engine's, by arrival index."""
    jm, tm, eng = _engine()
    prompts = [[7, 3, 9, 11, 2, 5], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
               [40, 41, 42]]
    news = [8, 6, 10]
    finished = {}
    orig_step = eng.step

    def step():
        fins = orig_step()
        finished.update((f.rid, f) for f in fins)
        return fins

    eng.step = step

    async def main():
        fe = await ServingFrontend(eng).start()
        try:
            streams = await asyncio.gather(*(
                _call(fe.port, "POST", "/v1/completions",
                      {"prompt": p, "max_tokens": n, "tenant": "a"})
                for p, n in zip(prompts, news)))
            plain = await _call(fe.port, "POST", "/v1/completions",
                                {"prompt": [1, 2, 3], "max_tokens": 4,
                                 "stream": False})
        finally:
            await fe.stop()
        return streams, plain

    streams, (pstatus, _, pbody) = asyncio.run(main())
    by_rid = {}
    for (status, headers, body), p, n in zip(streams, prompts, news):
        assert status == 200
        assert headers["content-type"].startswith("text/event-stream")
        streamed, final = _stream_doc(body)
        assert streamed == final["tokens"]
        assert final["finish_reason"] == "length"
        assert final["usage"] == {"prompt_tokens": len(p),
                                  "completion_tokens": n}
        np.testing.assert_array_equal(finished[final["id"]].tokens, streamed)
        by_rid[final["id"]] = (p, n, streamed)
    # arrival order: the port mints rids as requests arrive
    order = [by_rid[r] for r in sorted(by_rid)]
    want = _reference_tokens(jm, [p for p, _, _ in order],
                             [n for _, n, _ in order])
    direct = ServingEngine(tm, device="cpu", max_slots=2, page_size=8,
                           chunk_tokens=8)
    rids = [direct.add_request(np.asarray(p, np.int32), n)
            for p, n, _ in order]
    done = direct.run()
    for (_, _, streamed), w, r in zip(order, want, rids):
        np.testing.assert_array_equal(np.asarray(streamed), w)
        np.testing.assert_array_equal(done[r].tokens, w)
    assert pstatus == 200
    doc = json.loads(pbody)
    assert doc["finish_reason"] == "length" and len(doc["tokens"]) == 4


def test_mid_stream_disconnect_cancels_and_frees_pages():
    """A client that hangs up mid-stream: the engine cancels, the request
    reaches its ``cancelled`` terminal and every page it held is freed
    within a step."""
    _, _, eng = _engine()
    in_use = []

    async def main():
        fe = await ServingFrontend(eng).start()
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", fe.port)
            writer.write(_http_bytes(
                "POST", "/v1/completions",
                {"prompt": [5, 6, 7, 8], "max_tokens": 48}))
            await writer.drain()
            buf = b""
            while b'"token"' not in buf:
                chunk = await asyncio.wait_for(reader.read(256), 30.0)
                assert chunk, "server closed before the first token"
                buf += chunk
            in_use.append(eng.pool.pages_in_use)
            writer.close()
            await _drain(eng)
        finally:
            await fe.stop()

    asyncio.run(main())
    assert in_use[0] > 0
    assert eng.stats["cancelled"] == 1
    assert eng.stats["tokens_generated"] < 48 + 2
    assert eng.scheduler.n_active == 0 and eng.pool.pages_in_use == 0
    eng.check_invariants()


def test_queue_overflow_maps_to_429():
    """The global max_queue and a tenant's max_waiting quota both answer
    429 with Retry-After, and the engine never enqueues the request."""
    _, _, eng = _engine(max_queue=0, policy="wfq",
                        tenants={"cap": TenantConfig(max_waiting=0)})
    rejected0 = eng.stats["rejected"]

    async def main():
        fe = await ServingFrontend(eng).start()
        try:
            r1 = await _call(fe.port, "POST", "/v1/completions",
                             {"prompt": [1, 2], "max_tokens": 4})
            r2 = await _call(fe.port, "POST", "/v1/completions",
                             {"prompt": [1, 2], "max_tokens": 4,
                              "tenant": "cap"})
        finally:
            await fe.stop()
        return r1, r2

    (s1, h1, b1), (s2, _, _) = asyncio.run(main())
    assert s1 == 429 and s2 == 429
    assert h1.get("retry-after") == "1" and b"retry" in b1
    assert eng.stats["rejected"] == rejected0
    sc = eng.metrics.scalars()
    assert sc["serving_http_requests.code=429.route=/v1/completions"] == 2


def test_deadline_408_and_metrics_scrape():
    """A request whose deadline passes in the queue answers 408; a tenant
    completion follows; /metrics parses as Prometheus exposition with the
    per-route and per-tenant series."""
    _, _, eng = _engine()

    async def main():
        fe = await ServingFrontend(eng).start()
        try:
            expired = await _call(fe.port, "POST", "/v1/completions",
                                  {"prompt": [4, 4, 4], "max_tokens": 4,
                                   "deadline_ms": 1e-4})
            await _call(fe.port, "POST", "/v1/completions",
                        {"prompt": [9, 9], "max_tokens": 3,
                         "tenant": "acme"})
            scrape = await _call(fe.port, "GET", "/metrics")
        finally:
            await fe.stop()
        return expired, scrape

    (status, _, body), (mstatus, mheaders, mbody) = asyncio.run(main())
    assert status == 408 and b"deadline" in body
    assert eng.stats["expired"] == 1 and eng.pool.pages_in_use == 0
    assert mstatus == 200
    assert mheaders["content-type"].startswith("text/plain")
    lines = mbody.decode().splitlines()
    samples = [ln for ln in lines if ln and not ln.startswith("#")]
    for ln in samples:
        name_part, _, value = ln.rpartition(" ")
        assert name_part and float(value) is not None
    assert ('serving_http_requests'
            '{code="200",route="/v1/completions"} 1') in lines
    assert ('serving_http_requests'
            '{code="408",route="/v1/completions"} 1') in lines
    assert 'serving_tenant_tokens_generated{tenant="acme"} 3' in lines
    assert any(ln.startswith("serving_ttft_s_bucket") for ln in samples)


def test_healthz_and_malformed_requests():
    """/healthz's shape, a 404 that mints no per-path series, and every
    malformed request answered 400, never a bare hangup."""
    _, _, eng = _engine()

    async def main():
        fe = await ServingFrontend(eng, max_tenants=1).start()
        try:
            ok = await _call(fe.port, "GET", "/healthz")
            missing = await _call(fe.port, "GET", "/nope")
            bad = await _call(fe.port, "POST", "/v1/completions",
                              {"prompt": "not ids", "max_tokens": 4})
            huge = await _call(fe.port, "POST", "/v1/completions",
                               {"prompt": [1] * 90, "max_tokens": 90})
            nondict = await _call(fe.port, "POST", "/v1/completions",
                                  [1, 2, 3])
            bools = await _call(fe.port, "POST", "/v1/completions",
                                {"prompt": [True, False], "max_tokens": 2})
            overflow = await _call(fe.port, "POST", "/v1/completions",
                                   {"prompt": [2 ** 31], "max_tokens": 2})
            badname = await _call(fe.port, "POST", "/v1/completions",
                                  {"prompt": [1], "max_tokens": 2,
                                   "tenant": "a b\nc"})
            first = await _call(fe.port, "POST", "/v1/completions",
                                {"prompt": [1], "max_tokens": 2,
                                 "tenant": "t1"})
            second = await _call(fe.port, "POST", "/v1/completions",
                                 {"prompt": [1], "max_tokens": 2,
                                  "tenant": "t2"})
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", fe.port)
            writer.write(b"POST /v1/completions HTTP/1.1\r\n"
                         b"Content-Length: abc\r\n\r\n")
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(), 10.0)
            writer.close()
        finally:
            await fe.stop()
        assert eng.on_token is None      # stop() restored the token path
        return (ok, missing, bad, huge, nondict, bools, overflow, badname,
                first, second, raw)

    (ok, missing, bad, huge, nondict, bools, overflow, badname, first,
     second, raw) = asyncio.run(main())
    doc = json.loads(ok[2])
    assert ok[0] == 200 and doc["status"] == "ok"
    assert doc["slots_total"] == 2 and doc["policy"] == "fcfs"
    assert doc["pages_in_use"] == 0 and doc["last_step_age_s"] >= 0
    assert missing[0] == 404
    assert bad[0] == 400 and b"token ids" in bad[2]
    assert huge[0] == 400 and b"max_seq_len" in huge[2]
    assert nondict[0] == 400 and b"JSON object" in nondict[2]
    assert bools[0] == 400 and b"token ids" in bools[2]
    assert overflow[0] == 400 and b"int32" in overflow[2]
    assert badname[0] == 400 and b"tenant" in badname[2]
    assert first[0] == 200
    assert second[0] == 400 and b"distinct tenants" in second[2]
    assert raw.startswith(b"HTTP/1.1 400") and b"Content-Length" in raw
    assert not any("/nope" in k for k in eng.metrics.scalars())


def test_driver_death_aborts_streams_and_fails_healthz():
    """An exception escaping ``step()`` ends the open stream without
    [DONE], refuses new completions with 503 and turns /healthz to 503."""
    _, _, eng = _engine()

    async def main():
        fe = await ServingFrontend(eng).start()
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", fe.port)
            writer.write(_http_bytes("POST", "/v1/completions",
                                     {"prompt": [2, 3], "max_tokens": 40}))
            await writer.drain()
            buf = b""
            while b'"token"' not in buf:
                buf += await asyncio.wait_for(reader.read(256), 30.0)

            def boom():
                raise RuntimeError("device fell over")

            eng.step = boom
            rest = await asyncio.wait_for(reader.read(), 10.0)
            writer.close()
            health = await _call(fe.port, "GET", "/healthz")
            refused = await _call(fe.port, "POST", "/v1/completions",
                                  {"prompt": [1], "max_tokens": 2})
        finally:
            await fe.stop()
        return buf + rest, health, refused

    stream, health, refused = asyncio.run(main())
    assert b"[DONE]" not in stream
    assert health[0] == 503
    assert json.loads(health[2])["status"] == "driver dead"
    assert refused[0] == 503


# ---------------------------------------------------------------------------
# a Router behind the front end, and the /debug surface
# ---------------------------------------------------------------------------


def test_router_streams_aggregates_health_and_labels_the_scrape():
    """``make_cluster(model, 2, disaggregate=True)`` behind the front end:
    streamed tokens equal the reference engine's, /healthz aggregates the
    two replicas, /metrics is the replica-labelled page plus the HTTP
    series."""
    jm, tm = pair(seed=3)
    router = make_cluster(tm, 2, disaggregate=True, device="cpu",
                          max_slots=2, page_size=8, chunk_tokens=8)
    prompts, news = [[7, 3, 9, 11, 2, 5], [30, 31, 32, 33]], [6, 5]

    async def main():
        fe = await ServingFrontend(router).start()
        try:
            streams = await asyncio.gather(*(
                _call(fe.port, "POST", "/v1/completions",
                      {"prompt": p, "max_tokens": n})
                for p, n in zip(prompts, news)))
            health = await _call(fe.port, "GET", "/healthz")
            scrape = await _call(fe.port, "GET", "/metrics")
        finally:
            await fe.stop()
        return streams, health, scrape

    streams, health, scrape = asyncio.run(main())
    by_rid = {}
    for status, _, body in streams:
        assert status == 200
        streamed, final = _stream_doc(body)
        assert streamed == final["tokens"]
        # the prompts' lengths differ: usage names the prompt
        p = next(p for p in prompts
                 if len(p) == final["usage"]["prompt_tokens"])
        by_rid[final["id"]] = (p, streamed)
    arrivals = [by_rid[r] for r in sorted(by_rid)]
    want = _reference_tokens(jm, [p for p, _ in arrivals],
                             [len(t) for _, t in arrivals])
    for (_, t), w in zip(arrivals, want):
        np.testing.assert_array_equal(np.asarray(t), w)
    doc = json.loads(health[2])
    assert health[0] == 200 and doc["status"] == "ok"
    assert doc["replicas"] == 2 and doc["roles"] == ["prefill", "decode"]
    assert doc["slots_total"] == 4 and doc["pages_in_use"] == 0
    assert len(doc["last_step_age_s"]) == 2
    text = scrape[2].decode()
    assert 'replica="replica0"' in text and 'replica="replica1"' in text
    assert ('serving_http_requests{code="200",route="/v1/completions"} 2'
            in text.splitlines())
    assert router.stats["handoffs"] == 2


def test_debug_surface_is_off_by_default_and_reads_state():
    """``debug=False`` answers 404 on /debug/*; ``debug=True`` serves the
    state with its invariant verdict, the flight ring and the trace."""
    _, _, eng = _engine()
    eng.attach_tracer()
    eng.attach_flight()

    async def main():
        fe = await ServingFrontend(eng).start()
        try:
            off = await _call(fe.port, "GET", "/debug/state")
        finally:
            await fe.stop()
        fe = await ServingFrontend(eng, debug=True).start()
        try:
            await _call(fe.port, "POST", "/v1/completions",
                        {"prompt": [3, 4, 5], "max_tokens": 3})
            state = await _call(fe.port, "GET", "/debug/state")
            flight = await _call(fe.port, "GET", "/debug/flight?replica=0")
            badrep = await _call(fe.port, "GET", "/debug/flight?replica=4")
            trace = await _call(fe.port, "GET", "/debug/trace")
        finally:
            await fe.stop()
        return off, state, flight, badrep, trace

    off, state, flight, badrep, trace = asyncio.run(main())
    assert off[0] == 404
    doc = json.loads(state[2])
    assert state[0] == 200 and doc["invariants"] == "ok"
    assert set(doc["flight"]) == {"capacity", "recorded", "dropped"}
    assert flight[0] == 200 and json.loads(flight[2])["recorded"] > 0
    assert badrep[0] == 400
    assert trace[0] == 200 and json.loads(trace[2])["traceEvents"]


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return [sys.executable, "-m", "paddle_tpu_torch.examples.serve_gpt",
            *args], env


def test_serve_cli_runs_the_demo_load_on_the_cpu(tmp_path):
    """The demo load with chaos and the metrics artifacts, the pool
    drained leak-free."""
    cmd, env = _cli("--device", "cpu", "--requests", "4",
                    "--shared-prefix", "16", "--chunk-tokens", "16",
                    "--inject-faults", "7", "--metrics-dir", str(tmp_path))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "4 requests" in proc.stdout
    assert "pool drained leak-free: True" in proc.stdout
    assert {"metrics.prom", "trace.json"} <= set(os.listdir(tmp_path))


def test_serve_cli_http_answers_a_request(tmp_path):
    """``--http 0`` binds an ephemeral port, prints it, and streams one
    completion; SIGINT stops it and the metrics artifacts are written."""
    cmd, env = _cli("--device", "cpu", "--http", "0", "--tenants", "a:3,b:1",
                    "--metrics-dir", str(tmp_path))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for _ in range(50):
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("serving on http://"):
                port = int(line.split()[2].rsplit(":", 1)[1])
                break
        assert port is not None, proc.stderr.read()
        status, _, body = asyncio.run(_call(
            port, "POST", "/v1/completions",
            {"prompt": [1, 2, 3], "max_tokens": 5, "tenant": "a"}))
        assert status == 200
        streamed, final = _stream_doc(body)
        assert len(streamed) == 5 and streamed == final["tokens"]
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    assert "metrics ->" in out
    assert "metrics.prom" in os.listdir(tmp_path)

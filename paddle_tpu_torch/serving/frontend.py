"""Streaming HTTP front end for the serving engine.

Counterpart of ``paddle_tpu/serving/frontend.py``, line for line: the
same endpoints, status mapping, metrics and concurrency model, over the
port's :class:`~.engine.ServingEngine` or :class:`~.router.Router`.  Built
only on stdlib ``asyncio`` with hand-rolled HTTP/1.1.

Endpoints:

  * ``POST /v1/completions`` — OpenAI-style completion over TOKEN IDS
    (the repo ships no tokenizer; clients send ``{"prompt": [ids...],
    "max_tokens": n}``).  With ``"stream": true`` (default) the response
    is Server-Sent Events: one ``data:`` JSON per sampled token,
    delivered per ENGINE STEP through the engine's ``on_token`` observer
    — the streamed sequence is token-for-token the eventual
    ``FinishedRequest.tokens`` — then a final event carrying
    ``finish_reason``/usage and ``data: [DONE]``.  Optional fields:
    ``tenant`` (WFQ accounting/isolation), ``deadline_ms`` (SLO),
    ``stream: false`` (single JSON response).
  * ``GET /metrics`` — the registry's Prometheus text exposition
    (per-tenant labeled series included), scrapeable in place.
  * ``GET /healthz`` — liveness + queue/slot/pool gauges as JSON, plus
    per-replica ``last_step_age_s`` staleness.
  * ``GET /debug/{state,flight,trace}`` (``debug=True`` only) —
    read-only introspection: ledgers + invariant verdicts, one
    replica's flight-recorder ring (``?replica=N``), and the (merged,
    for a cluster) Chrome trace.

SLO semantics at the HTTP layer:

  * queue overflow (the engine's global ``max_queue`` OR the tenant's
    ``max_waiting`` quota) → **429 Too Many Requests** with
    ``Retry-After`` — the request is NEVER enqueued, matching the
    engine's explicit-``rejected``-terminal posture;
  * deadline expiry BEFORE the first token → **408 Request Timeout**
    (after streaming starts the status line is gone — expiry then ends
    the stream with ``finish_reason: "expired"``);
  * client disconnect mid-stream → ``engine.cancel(rid)`` the moment
    the broken pipe is seen, so an abandoned request frees its slot and
    KV pages instead of decoding to nobody.

Concurrency model: ONE event loop runs both the socket handlers and the
engine driver — a cooperative task stepping ``engine.step()`` whenever
there is work and yielding between steps.  ``step()`` blocks the loop
for one step; that is deliberate (the engine's host mirrors are not
thread-safe, and a blocked accept queue is exactly the backpressure a
saturated engine should present).  Handlers talk to the driver through
per-request ``asyncio.Queue`` channels fed by the ``on_token`` hook and
``step()``'s FinishedRequests.

On the card the loop may run on another thread than the one that built
the engine (``serve`` in a background thread, say), and PyTorch's current
device and stream are per thread.  :meth:`ServingEngine.step` enters the
engine's own device and stream (the ones current where it was built)
itself, so the driver's steps launch where the engine's earlier work did
and read their tokens back behind the engine's event, with no extra
synchronize.
"""

from __future__ import annotations

import asyncio
import json
from http import HTTPStatus
from typing import Callable, Dict, Optional, Tuple

import numpy as np

__all__ = ["ServingFrontend", "serve"]

#: Response cap on request bodies (token-id lists are small; anything
#: bigger is a client bug, not a workload).
MAX_BODY_BYTES = 1 << 20


class _BadRequest(Exception):
    """Malformed HTTP from the client — answered with a 400, never a
    bare connection drop."""


class ServingFrontend:
    """Asyncio HTTP server over one :class:`ServingEngine` — or over a
    :class:`~.router.Router`: anything with the
    engine's driving surface (``add_request`` / ``cancel`` / ``step`` /
    ``has_work`` / ``on_token``) serves; a Router is detected by its
    ``replicas`` attribute, ``/healthz`` then aggregates the fleet and
    ``/metrics`` renders the replica-labeled cluster scrape page.

    ``port=0`` binds an ephemeral port (read ``frontend.port`` after
    :meth:`start` — the test client does).  The ctor chains onto any
    existing ``engine.on_token`` observer and attaches a metrics
    registry when none is present (``/metrics`` needs one).
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 idle_sleep_s: float = 0.002, max_tenants: int = 256,
                 debug: bool = False):
        self.engine = engine
        # the read-only /debug surface (state, flight ring, trace) is
        # OFF by default: it exposes internals and full rings — opt in
        # per deployment (paddle_tpu_torch.examples.serve_gpt --debug)
        self.debug = debug
        # a Router drives like an engine; only observability and the
        # backpressure probe need to know there is a fleet behind it
        self._is_cluster = hasattr(engine, "replicas")
        self.host = host
        self.port = port
        self.idle_sleep_s = idle_sleep_s
        # clients name tenants freely (WFQ learns them lazily), but the
        # NETWORK surface must bound the distinct names it will relay —
        # every new tenant mints permanent labeled metric series and
        # policy state, the same unbounded-cardinality hole the 404
        # handler guards against for paths
        self.max_tenants = max_tenants
        self._seen_tenants: set = set()
        self._channels: Dict[int, asyncio.Queue] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._driver: Optional[asyncio.Task] = None
        self._driver_error: Optional[BaseException] = None
        if self._is_cluster:
            from .metrics import MetricsRegistry

            # per-replica registries stay per-replica (the engine's
            # one-registry rule); HTTP-surface series live in their own
            # registry, concatenated onto the cluster scrape page
            if engine._parts is None:
                engine.attach_metrics()
            self._http_registry = MetricsRegistry()
        else:
            if engine.metrics is None:
                engine.attach_metrics()
            self._http_registry = engine.metrics
        self._http_requests = \
            lambda route, code: self._http_registry.counter(
                "serving_http_requests",
                "front-end requests by route/status",
                labels={"route": route, "code": str(code)})
        self._streams_open = self._http_registry.gauge(
            "serving_http_streams_open", "SSE streams currently open")
        self._prev_on_token = engine.on_token

        def _chained(rid, tok, _prev=self._prev_on_token):
            if _prev is not None:
                _prev(rid, tok)
            ch = self._channels.get(rid)
            if ch is not None:
                ch.put_nowait(("token", tok))

        self._chained_on_token = _chained
        engine.on_token = _chained

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> "ServingFrontend":
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._driver = asyncio.ensure_future(self._drive())
        return self

    async def stop(self) -> None:
        if self._driver is not None:
            self._driver.cancel()
            try:
                await self._driver
            except asyncio.CancelledError:
                pass
            except Exception:
                pass    # a dead driver already recorded _driver_error
            self._driver = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        # leave the token path the way we found it — but only if we are
        # still the installed observer (someone chaining after us keeps
        # their hook, and our closure forwards to the original anyway)
        if self.engine.on_token is self._chained_on_token:
            self.engine.on_token = self._prev_on_token

    async def _drive(self) -> None:
        """The engine host loop as a cooperative task: step while there
        is work (yielding between steps so handlers run), deliver every
        terminal to its channel, idle-sleep when drained.  A real
        exception escaping ``step()`` must not strand the server in a
        half-alive state: every open stream is aborted (clients see an
        error instead of hanging forever) and ``/healthz`` flips to 503
        until the process is restarted."""
        try:
            while True:
                if self.engine.has_work:
                    for fin in self.engine.step():
                        ch = self._channels.get(fin.rid)
                        if ch is not None:
                            ch.put_nowait(("done", fin))
                    await asyncio.sleep(0)
                else:
                    await asyncio.sleep(self.idle_sleep_s)
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            self._driver_error = e
            raise
        finally:
            # EVERY driver exit — death or clean stop() cancellation —
            # must wake the open handlers, or they block on channel.get()
            # forever with nobody left to feed them (their requests would
            # never cancel and stop()'s wait_closed would deadlock on
            # 3.12+, which waits for active connection handlers)
            for ch in self._channels.values():
                ch.put_nowait(("abort", None))

    # -- HTTP plumbing ----------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            try:
                req = await self._read_request(reader)
            except _BadRequest as e:
                await self._send(writer, "bad-request", 400, json.dumps(
                    {"error": str(e)}).encode())
                return
            if req is None:
                return
            method, path, headers, body = req
            await self._route(method, path, headers, body, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    @staticmethod
    async def _read_request(reader) -> Optional[Tuple[str, str, dict, bytes]]:
        try:
            line = await reader.readline()
        except ValueError:
            # a request line over the StreamReader limit (64 KiB) —
            # answer 400, don't die with an unhandled LimitOverrun
            raise _BadRequest("request line too long")
        if not line:
            return None
        try:
            method, path, _version = line.decode("latin-1").split()
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        while True:
            try:
                h = await reader.readline()
            except ValueError:
                raise _BadRequest("header line too long")
            if h in (b"\r\n", b"\n", b""):
                break
            if len(headers) >= 100:
                raise _BadRequest("too many headers")
            key, _, val = h.decode("latin-1").partition(":")
            headers[key.strip().lower()] = val.strip()
        try:
            n = int(headers.get("content-length", "0") or 0)
        except ValueError:
            raise _BadRequest("Content-Length is not an integer")
        if not 0 <= n <= MAX_BODY_BYTES:
            raise _BadRequest(f"Content-Length must be 0..{MAX_BODY_BYTES}")
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    @staticmethod
    def _response(status: int, body: bytes,
                  ctype: str = "application/json",
                  extra_headers: str = "") -> bytes:
        phrase = HTTPStatus(status).phrase
        return (f"HTTP/1.1 {status} {phrase}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n{extra_headers}\r\n"
                ).encode("latin-1") + body

    async def _send(self, writer, route: str, status: int, body: bytes,
                    ctype: str = "application/json",
                    extra_headers: str = "") -> None:
        self._http_requests(route, status).inc()
        writer.write(self._response(status, body, ctype, extra_headers))
        await writer.drain()

    async def _route(self, method, path, headers, body, reader, writer):
        if method == "GET" and path == "/healthz":
            eng = self.engine
            dead = self._driver_error is not None
            if self._is_cluster:
                reps = eng.replicas
                payload = json.dumps({
                    "status": "driver dead" if dead else "ok",
                    "error": repr(self._driver_error) if dead else None,
                    "replicas": len(reps),
                    "roles": [r.role for r in reps],
                    "step": max(r._step_idx for r in reps),
                    "queue_depth": eng.queue_depth,
                    "slots_active": sum(r.scheduler.n_active
                                        for r in reps),
                    "slots_total": sum(r.max_slots for r in reps),
                    "pages_in_use": sum(r.pool.pages_in_use
                                        for r in reps),
                    "pages_free": sum(r.pool.num_free for r in reps),
                    "policy": reps[0].scheduler.policy.name,
                    # staleness per replica: seconds (engine clock)
                    # since its last completed step — a wedged replica
                    # shows a growing age while the fleet looks alive
                    "last_step_age_s": [
                        (r._now() - r._last_step_at)
                        if r._last_step_at is not None else None
                        for r in reps],
                }).encode()
            else:
                payload = json.dumps({
                    "status": "driver dead" if dead else "ok",
                    "error": repr(self._driver_error) if dead else None,
                    "step": eng._step_idx,
                    "queue_depth": eng.scheduler.n_waiting,
                    "slots_active": eng.scheduler.n_active,
                    "slots_total": eng.max_slots,
                    "pages_in_use": eng.pool.pages_in_use,
                    "pages_free": eng.pool.num_free,
                    "policy": eng.scheduler.policy.name,
                    "last_step_age_s": (
                        (eng._now() - eng._last_step_at)
                        if eng._last_step_at is not None else None),
                }).encode()
            await self._send(writer, "/healthz", 503 if dead else 200,
                             payload)
        elif method == "GET" and path == "/metrics":
            if self._is_cluster:
                # replica-labeled fleet page + the HTTP-surface series
                # (distinct families, so concatenation stays one valid
                # exposition page)
                text = (self.engine.to_prometheus()
                        + self._http_registry.to_prometheus()).encode()
            else:
                text = self.engine.metrics.to_prometheus().encode()
            await self._send(writer, "/metrics", 200, text,
                             ctype="text/plain; version=0.0.4")
        elif method == "GET" and \
                path.partition("?")[0].startswith("/debug/"):
            await self._debug(path, writer)
        elif method == "POST" and path == "/v1/completions":
            await self._completions(body, reader, writer)
        else:
            # FIXED label, not the client-supplied path: arbitrary paths
            # must not mint unbounded counter series in the registry
            await self._send(writer, "unknown", 404,
                             b'{"error": "not found"}')

    # -- /debug -----------------------------------------------------------

    @staticmethod
    def _flight_summary(dump: dict) -> dict:
        """Strip a dump_debug payload's flight ring to its counters —
        /debug/state stays light; the full ring is /debug/flight."""
        fl = dump.get("flight")
        if fl is not None:
            dump["flight"] = {k: fl[k]
                              for k in ("capacity", "recorded", "dropped")}
        return dump

    async def _debug(self, path: str, writer) -> None:
        """Read-only introspection (``debug=True`` only — 404 when off,
        indistinguishable from absent): ``/debug/state`` (ledgers +
        invariant verdicts), ``/debug/flight?replica=N`` (one black-box
        ring, full), ``/debug/trace`` (Chrome trace JSON — merged
        across the fleet for a cluster)."""
        base, _, query = path.partition("?")
        eng = self.engine
        if not self.debug:
            await self._send(writer, "unknown", 404,
                             b'{"error": "not found"}')
            return
        if base == "/debug/state":
            if self._is_cluster:
                payload = eng.dump_debug()
                payload["replicas"] = [self._flight_summary(d)
                                       for d in payload["replicas"]]
            else:
                payload = self._flight_summary(eng.dump_debug())
            await self._send(writer, "/debug/state", 200,
                             json.dumps(payload, default=float).encode())
        elif base == "/debug/flight":
            replica = 0
            for part in query.split("&"):
                if part.startswith("replica="):
                    try:
                        replica = int(part[len("replica="):])
                    except ValueError:
                        await self._send(
                            writer, "/debug/flight", 400,
                            b'{"error": "replica must be an integer"}')
                        return
            engines = eng.replicas if self._is_cluster else [eng]
            if not 0 <= replica < len(engines):
                await self._send(
                    writer, "/debug/flight", 400, json.dumps(
                        {"error": f"replica must be in "
                                  f"0..{len(engines) - 1}"}).encode())
                return
            fl = engines[replica].flight
            if fl is None:
                await self._send(
                    writer, "/debug/flight", 404,
                    b'{"error": "flight recorder not attached"}')
                return
            await self._send(writer, "/debug/flight", 200,
                             json.dumps(fl.to_json(),
                                        default=float).encode())
        elif base == "/debug/trace":
            tracer = eng.tracer
            if tracer is None:
                await self._send(writer, "/debug/trace", 404,
                                 b'{"error": "tracer not attached"}')
                return
            trace = (eng.merged_trace() if self._is_cluster
                     else tracer.to_json())
            await self._send(writer, "/debug/trace", 200,
                             json.dumps(trace).encode())
        else:
            await self._send(writer, "unknown", 404,
                             b'{"error": "not found"}')

    # -- /v1/completions --------------------------------------------------

    def _parse_completion(self, body: bytes) -> Tuple[Optional[dict], str]:
        try:
            req = json.loads(body.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None, "body is not JSON"
        if not isinstance(req, dict):
            return None, "body must be a JSON object"
        prompt = req.get("prompt")
        # type(t) is int, NOT isinstance: JSON true/false are bools,
        # which subclass int and would silently decode as 1/0
        if (not isinstance(prompt, list) or not prompt
                or not all(type(t) is int and 0 <= t < 2 ** 31
                           for t in prompt)):
            return None, ("prompt must be a non-empty list of token ids "
                          "(int32 range)")
        max_tokens = req.get("max_tokens", 16)
        if type(max_tokens) is not int or max_tokens < 1:
            return None, "max_tokens must be a positive integer"
        if len(prompt) + max_tokens > self.engine.max_seq_len:
            return None, (f"prompt+max_tokens exceeds engine max_seq_len "
                          f"{self.engine.max_seq_len}")
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is not None and not (
                isinstance(deadline_ms, (int, float)) and deadline_ms > 0):
            return None, "deadline_ms must be a positive number"
        tenant = req.get("tenant")
        if tenant is not None:
            if not isinstance(tenant, str) or not tenant or \
                    len(tenant) > 64 or not all(
                        c.isalnum() or c in "-_.:" for c in tenant):
                return None, ("tenant must be 1-64 chars of "
                              "[alnum - _ . :]")
        return {"prompt": prompt, "max_tokens": max_tokens,
                "tenant": tenant, "deadline_ms": deadline_ms,
                "stream": bool(req.get("stream", True))}, ""

    def _overloaded(self, tenant: Optional[str]) -> bool:
        eng = self.engine
        if self._is_cluster:
            if (eng.max_queue is not None
                    and eng.queue_depth >= eng.max_queue):
                return True
            # with a shared ClusterWFQState any member answers for the
            # whole fleet; without one, quotas are per-replica and the
            # first prefill target is where this request would land-ish
            return eng.prefill_targets[0].scheduler.quota_reject(tenant)
        if (eng.max_queue is not None
                and eng.scheduler.n_waiting >= eng.max_queue):
            return True
        return eng.scheduler.quota_reject(tenant)

    async def _completions(self, body, reader, writer):
        route = "/v1/completions"
        parsed, err = self._parse_completion(body)
        if parsed is None:
            await self._send(writer, route, 400,
                             json.dumps({"error": err}).encode())
            return
        if self._driver_error is not None:
            await self._send(writer, route, 503,
                             b'{"error": "engine driver died"}')
            return
        if self._overloaded(parsed["tenant"]):
            # backpressure maps to HTTP BEFORE the engine ever sees the
            # request — the 429 is the network face of the engine's
            # "rejected" terminal, with a hint to come back later
            await self._send(writer, route, 429,
                             b'{"error": "queue full, retry later"}',
                             extra_headers="Retry-After: 1\r\n")
            return
        tenant = parsed["tenant"]
        if tenant is not None and tenant not in self._seen_tenants:
            # cardinality gate AFTER the overload check: names on
            # requests that were shed never burn a slot, so a 429 storm
            # cannot exhaust the tenant budget for real accounts
            if len(self._seen_tenants) >= self.max_tenants:
                await self._send(writer, route, 400, json.dumps(
                    {"error": f"over {self.max_tenants} distinct tenants "
                              "— tenant names are accounts, not request "
                              "ids"}).encode())
                return
            self._seen_tenants.add(tenant)
        eng = self.engine
        rid = eng.add_request(
            np.asarray(parsed["prompt"], np.int32),
            parsed["max_tokens"], tenant=parsed["tenant"],
            deadline_s=(parsed["deadline_ms"] / 1e3
                        if parsed["deadline_ms"] is not None else None))
        channel: asyncio.Queue = asyncio.Queue()
        self._channels[rid] = channel
        watcher = asyncio.ensure_future(
            self._watch_disconnect(reader, channel))
        finished = False
        try:
            if parsed["stream"]:
                finished = await self._stream_sse(rid, channel, writer,
                                                  parsed)
            else:
                finished = await self._respond_json(rid, channel, writer,
                                                    parsed)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            watcher.cancel()
            self._channels.pop(rid, None)
            if not finished:
                # broken pipe / handler death with the request still
                # live: release its slot and pages NOW
                eng.cancel(rid)

    @staticmethod
    async def _watch_disconnect(reader, channel: asyncio.Queue) -> None:
        """Drain the (finished) request side of the socket and wake the
        handler on a connection RESET.  A clean EOF alone is NOT a
        disconnect — a conforming client may half-close its write side
        (shutdown(SHUT_WR)) while still reading the response; a client
        that fully went away surfaces as a reset here or as a write
        failure on the next SSE event, both of which cancel."""
        try:
            while True:
                data = await reader.read(4096)
                if not data:
                    return                  # half-close: keep serving
        except asyncio.CancelledError:
            return
        except ConnectionError:
            channel.put_nowait(("disconnect", None))

    async def _first_event(self, channel) -> Tuple[str, object]:
        """The earliest thing that happens to the request decides the
        status line: a token → 200 (stream on), a degraded terminal →
        429/408, disconnect → nothing to send."""
        kind, payload = await channel.get()
        return kind, payload

    @staticmethod
    def _sse(obj: dict) -> bytes:
        return f"data: {json.dumps(obj)}\n\n".encode()

    def _final_event(self, rid: int, fin, parsed: dict) -> dict:
        return {"id": rid, "object": "completion",
                "finish_reason": fin.finish_reason,
                "tokens": [int(t) for t in fin.tokens],
                "usage": {"prompt_tokens": len(parsed["prompt"]),
                          "completion_tokens": int(fin.tokens.size)}}

    async def _stream_sse(self, rid, channel, writer, parsed) -> bool:
        """SSE delivery; returns True once the request is terminal (the
        caller cancels otherwise)."""
        route = "/v1/completions"
        kind, payload = await self._first_event(channel)
        if kind == "disconnect":
            return False
        if kind == "abort":
            await self._send(writer, route, 503,
                             b'{"error": "engine stopped"}')
            return False
        if kind == "done" and payload.finish_reason == "rejected":
            await self._send(writer, route, 429,
                             b'{"error": "queue full, retry later"}',
                             extra_headers="Retry-After: 1\r\n")
            return True
        if kind == "done" and payload.finish_reason == "expired" \
                and payload.tokens.size == 0:
            await self._send(writer, route, 408,
                             b'{"error": "deadline expired in queue"}')
            return True
        self._http_requests(route, 200).inc()
        self._streams_open.inc()
        try:
            writer.write((
                "HTTP/1.1 200 OK\r\n"
                "Content-Type: text/event-stream\r\n"
                "Cache-Control: no-cache\r\n"
                "Connection: close\r\n\r\n").encode("latin-1"))
            index = 0
            while True:
                if kind in ("disconnect", "abort"):
                    # abort mid-stream: headers are gone; ending the
                    # stream without [DONE] is the error signal
                    return False
                if kind == "token":
                    writer.write(self._sse(
                        {"id": rid, "object": "completion.chunk",
                         "index": index, "token": int(payload)}))
                    index += 1
                    await writer.drain()
                elif kind == "done":
                    writer.write(self._sse(
                        self._final_event(rid, payload, parsed)))
                    writer.write(b"data: [DONE]\n\n")
                    await writer.drain()
                    return True
                kind, payload = await channel.get()
        finally:
            self._streams_open.dec()

    async def _respond_json(self, rid, channel, writer, parsed) -> bool:
        """Non-streaming mode: buffer until terminal, one JSON body."""
        route = "/v1/completions"
        while True:
            kind, payload = await channel.get()
            if kind == "disconnect":
                return False
            if kind == "abort":
                await self._send(writer, route, 503,
                                 b'{"error": "engine stopped"}')
                return False
            if kind == "done":
                fin = payload
                if fin.finish_reason == "rejected":
                    status = 429
                elif fin.finish_reason == "expired" and fin.tokens.size == 0:
                    status = 408
                else:
                    status = 200
                await self._send(writer, route, status, json.dumps(
                    self._final_event(rid, fin, parsed)).encode())
                return True
            # tokens accumulate on the FinishedRequest; nothing to do


def serve(engine, host: str = "127.0.0.1", port: int = 8000,
          banner: bool = True, debug: bool = False,
          on_start: Optional[Callable[["ServingFrontend", Callable[[], None]],
                                      None]] = None) -> None:
    """Blocking convenience: run the front end until interrupted
    (``python -m paddle_tpu_torch.examples.serve_gpt --http``).

    ``on_start(frontend, shutdown)``, when given, is called once the
    socket is bound (``frontend.port`` is the bound port); ``shutdown()``
    may be called from any thread and makes ``serve`` stop the front end
    and return — what a caller running ``serve`` in a background thread
    needs."""
    async def _main():
        fe = await ServingFrontend(engine, host, port,
                                   debug=debug).start()
        stopped = asyncio.Event()
        loop = asyncio.get_running_loop()
        if banner:
            print(f"serving on http://{fe.host}:{fe.port}  "
                  f"(POST /v1/completions, GET /metrics, GET /healthz)")
            print(f"  curl -N http://{fe.host}:{fe.port}/v1/completions "
                  f"-d '{{\"prompt\": [1, 2, 3], \"max_tokens\": 8, "
                  f"\"tenant\": \"a\"}}'")
        try:
            if on_start is not None:
                on_start(fe, lambda: loop.call_soon_threadsafe(stopped.set))
            await stopped.wait()
        finally:
            await fe.stop()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        pass

"""Engine snapshot / restore — resume a killed host loop exactly.

Counterpart of ``paddle_tpu/serving/snapshot.py``, in the same v5 format.
The engine's device state is small and mirrored on the host: the pool's
page buffers, the block tables, the per-slot carry token/length and the
sampling generator.  ``snapshot_engine`` captures

  * the ctor config echo (slots, page size, sampling knobs, ...),
  * the scheduler's waiting queue, free-slot list and policy state (WFQ
    virtual token counters survive a restart),
  * every occupied slot's metadata (request, pages, prefill progress),
  * the pool: refcounts, free list, page buffers (host numpy in the wire
    format of :mod:`.kv_pool`: a bf16 buffer as its ``uint16`` bit
    patterns) and the whole prefix-index radix tree,
  * the host mirrors, the generator state, step and admission counters,
    stats, undelivered terminals and the handoff inbox / outbox,
  * the metrics registry, when one is attached,

all as plain numpy/python.  ``restore_engine(model, snap)`` rebuilds an
engine around ``model`` — which must carry the SAME WEIGHTS — on the
model's device and resumes with token-for-token identical output.  A
decode still in flight under double buffering is retired first, so a
snapshot never holds a pending device read.

One deliberate difference from the reference: its ``engine.key`` is a
JAX PRNG key, the port's is its ``torch.Generator``'s state
(``get_state()``, a numpy ``uint8`` array).  Greedy output never reads
it; a sampled port engine, once restored, continues its own random
stream exactly.

Not captured: a ``FaultPlan`` and the clock.  The snapshot records the
engine clock's reading at capture time, and restore rebases every request
timestamp onto the new clock, so relative intervals (deadline budgets,
latency observations) carry over.
"""

from __future__ import annotations

import numpy as np
import torch

from .kv_pool import from_wire, to_wire
from .prefix_cache import PrefixIndex
from . import scheduler as _sched
from .scheduler import Request

#: v5: the snapshot records the pool's KV page LAYOUT (kv heads, page
#: dtype, kv_bits, window, page geometry) and restore refuses an engine
#: whose rebuilt pool lays pages out differently; slots carry
#: ``hw_pages``.  Older versions load with their missing fields defaulted
#: (requests without tenant or charge marks, no policy section, no
#: speculative counters, hw_pages = the live page count).
SNAPSHOT_VERSION = 5
_READABLE_VERSIONS = (2, 3, 4, 5)


def _request_state(req: Request) -> dict:
    return dict(prompt=np.asarray(req.prompt, np.int32).copy(),
                max_new_tokens=int(req.max_new_tokens), rid=int(req.rid),
                arrival=float(req.arrival), deadline_s=req.deadline_s,
                tenant=req.tenant,
                t_enqueue=float(req.t_enqueue),
                generated=list(req.generated),
                n_preempted=int(req.n_preempted), seq=req.seq,
                t_admitted=req.t_admitted,
                t_first_token=req.t_first_token,
                t_last_token=req.t_last_token,
                vt_charged=int(req.vt_charged),
                max_prompt_prefilled=int(req.max_prompt_prefilled),
                spec_drafted=int(req.spec_drafted),
                spec_accepted=int(req.spec_accepted))


def _request_from_state(st: dict) -> Request:
    req = Request(prompt=st["prompt"], max_new_tokens=st["max_new_tokens"],
                  rid=st["rid"], arrival=st["arrival"],
                  deadline_s=st["deadline_s"], tenant=st.get("tenant"))
    req.t_enqueue = st["t_enqueue"]
    req.generated = list(st["generated"])
    req.n_preempted = st["n_preempted"]
    req.seq = st["seq"]
    req.t_admitted = st.get("t_admitted")
    req.t_first_token = st.get("t_first_token")
    req.t_last_token = st.get("t_last_token")
    req.vt_charged = int(st.get("vt_charged", 0))
    req.max_prompt_prefilled = int(st.get("max_prompt_prefilled", 0))
    req.spec_drafted = int(st.get("spec_drafted", 0))
    req.spec_accepted = int(st.get("spec_accepted", 0))
    return req


def _finished_state(fin) -> dict:
    return dict(rid=fin.rid, prompt=np.asarray(fin.prompt, np.int32).copy(),
                tokens=np.asarray(fin.tokens, np.int32).copy(),
                finish_reason=fin.finish_reason, n_steps=fin.n_steps)


def handoff_state(eng, idx: int, with_payload: bool = True) -> dict:
    """The disaggregated prefill→decode handoff record for slot ``idx``
    of a prefill-role engine: the request's full lifecycle state
    (generated already includes the first sampled token — the decode
    replica's carry), the slot's page payload in block-table order via
    ``KVPool.export_pages`` (snapshot-v5 pool serialization; layout
    embedded, enforced on ingest), and the source engine clock so the
    receiver rebases timestamps exactly like a snapshot restore does.
    ``with_payload=False`` is the DEGRADED form (handoff-phase fault):
    the request ships without KV and re-prefills on the decode replica —
    greedy output is unchanged, only the recompute is paid again.

    The record also carries a TRACE CONTEXT: the rid plus the
    exporting engine's monotonic span sequence.  The pair keys the
    Chrome-trace flow arrow (``tracing.flow_id``) that stitches the
    prefill span, the router pump and the decode ingest into one line
    on the merged cluster timeline."""
    st = eng._slots[idx]
    payload = eng.pool.export_pages(st.pages) if with_payload else None
    eng._span_seq += 1
    return {
        "version": SNAPSHOT_VERSION,
        "request": _request_state(st.request),
        "base_len": int(st.base_len),
        "n_pages": len(st.pages),
        "payload": payload,
        "nbytes": (eng.pool.payload_nbytes(payload)
                   if payload is not None else 0),
        "clock_now": float(eng._now()),
        "trace": {"rid": int(st.request.rid), "seq": int(eng._span_seq)},
    }


def snapshot_engine(eng) -> dict:
    """Capture ``eng`` (a
    :class:`~paddle_tpu_torch.serving.engine.ServingEngine`) as a
    plain-python dict; see the module docstring for the contract."""
    # double-buffered dispatch: an un-retired decode is device state a
    # snapshot cannot carry — wait for it and apply it first (its
    # finishes land in _pending, delivered by the restored engine)
    if eng._inflight is not None:
        eng._retire_decode(eng._pending)
    slots = []
    for st in eng._slots:
        if st is None:
            slots.append(None)
        else:
            slots.append(dict(request=_request_state(st.request),
                              pages=list(st.pages),
                              prefilled=int(st.prefilled),
                              started=bool(st.started), seq=int(st.seq),
                              base_len=int(st.base_len),
                              born_step=int(st.born_step),
                              hw_pages=int(st.hw_pages)))
    pool = eng.pool
    return {
        "version": SNAPSHOT_VERSION,
        "config": dict(eng._config),
        "kv_layout": pool.layout(),
        "engine": dict(
            step_idx=int(eng._step_idx), admit_seq=int(eng._admit_seq),
            key=eng._generator.get_state().numpy().copy(),
            tok=eng._tok.copy(),
            len=eng._len.copy(), table=eng._table.copy(),
            stats=dict(eng.stats),
            # the engine clock's reading AT SNAPSHOT: restore rebases
            # every request timestamp onto the new process's clock, so
            # deadline budgets and latency observations carry relative
            # intervals over — raw time.monotonic values are meaningless
            # across a process boundary (per-boot base)
            clock_now=float(eng._now()),
            # handoff trace-context sequence: restored engines keep
            # minting unique flow ids instead of restarting at 0
            span_seq=int(eng._span_seq),
            pending=[_finished_state(f) for f in eng._pending],
            # handoff queues: inbox records re-serialize their live
            # Request; outbox entries are already wire dicts (numpy
            # payloads) — both restore with clock rebasing
            handoff_in=[dict(request=_request_state(r["request"]),
                             base_len=int(r["base_len"]),
                             n_pages=int(r["n_pages"]),
                             payload=r["payload"],
                             nbytes=int(r["nbytes"]))
                        for r in eng._handoff_in],
            handoff_out=[dict(h) for h in eng._handoff_out]),
        "scheduler": dict(
            waiting=[_request_state(r) for r in eng.scheduler.waiting],
            free_slots=list(eng.scheduler._free_slots),
            policy=eng.scheduler.policy.to_state()),
        "pool": dict(
            refcount=list(pool.refcount), free=list(pool._free),
            alloc_calls=int(pool.alloc_calls),
            alloc_failures=int(pool.alloc_failures),
            buffers={k: to_wire(v) for k, v in pool.buffers.items()},
            prefix=(pool.prefix.to_state()
                    if pool.prefix is not None else None)),
        "slots": slots,
        "rid_next": _sched._next_rid.n,
        # metrics ride along: a restored engine's registry resumes
        # counting where the snapshot left off — counters stay monotonic
        # and histograms keep their observations across a restart
        "metrics": (eng.metrics.to_state()
                    if eng.metrics is not None else None),
    }


def restore_engine(model, snap: dict, **overrides):
    """Rebuild a ServingEngine around ``model`` from a
    :func:`snapshot_engine` capture, on the model's device.  ``overrides``
    patch ctor knobs (e.g. ``clock=``); state-bearing knobs (slots, page
    size, pool size) must match the snapshot or the mirrors won't fit."""
    from .engine import FinishedRequest, ServingEngine, _Slot

    if snap.get("version") not in _READABLE_VERSIONS:
        raise ValueError(f"unknown snapshot version {snap.get('version')!r}")
    cfg = dict(snap["config"])
    cfg.update(overrides)
    cfg.setdefault("device", model.device)
    eng = ServingEngine(model, **cfg)

    # the captured page bytes are only meaningful under the layout
    # that wrote them — a rebuilt pool with different KV heads, page
    # dtype, quantization width or window would reinterpret them
    # silently, so refuse loudly instead (v<5 snapshots predate every
    # non-default layout and skip the check)
    if snap.get("kv_layout") is not None:
        eng.pool.check_layout(snap["kv_layout"], what="snapshot")

    # rids must keep minting above anything the snapshot ever issued
    _sched._next_rid.n = max(_sched._next_rid.n, int(snap["rid_next"]))

    pool, ps = eng.pool, snap["pool"]
    pool.refcount = list(ps["refcount"])
    pool._free = list(ps["free"])
    pool._free_set = set(pool._free)
    pool.alloc_calls = int(ps.get("alloc_calls", 0))
    pool.alloc_failures = int(ps.get("alloc_failures", 0))
    for k, v in ps["buffers"].items():
        buf = pool.buffers[k]
        buf.copy_(from_wire(v, buf.dtype, buf.device))
    if ps["prefix"] is not None:
        pool.prefix = PrefixIndex.from_state(ps["prefix"])

    eng.scheduler.load_waiting(
        [_request_from_state(r) for r in snap["scheduler"]["waiting"]])
    eng.scheduler._free_slots = list(snap["scheduler"]["free_slots"])
    # policy counters load AFTER the queue refill (load_waiting performs
    # no arrival-time lifts, so the snapshotted counters land verbatim);
    # v2 snapshots carry no policy section — fresh counters
    pol_state = snap["scheduler"].get("policy")
    if pol_state is not None:
        eng.scheduler.policy.load_state(pol_state)

    # rebase request timestamps from the snapshotted clock onto this
    # engine's clock: shifted values preserve every relative interval
    # (elapsed-before-snapshot + elapsed-after-restore), so deadlines
    # keep their remaining budget and the latency histograms never see
    # a cross-process monotonic base jump (possibly negative durations)
    delta = eng._now() - float(snap["engine"]["clock_now"])

    def _rebase(req: Request) -> None:
        req.t_enqueue += delta
        for attr in ("t_admitted", "t_first_token", "t_last_token"):
            v = getattr(req, attr)
            if v is not None:
                setattr(req, attr, v + delta)

    for req in eng.scheduler.waiting:
        _rebase(req)

    for idx, sstate in enumerate(snap["slots"]):
        if sstate is None:
            eng._slots[idx] = None
            continue
        req = _request_from_state(sstate["request"])
        st = _Slot(req, list(sstate["pages"]),
                   prefilled=sstate["prefilled"], seq=sstate["seq"],
                   base_len=sstate["base_len"])
        st.started = sstate["started"]
        st.born_step = sstate["born_step"]
        # pre-v5 snapshots predate windowed recycling: hw == live pages
        st.hw_pages = int(sstate.get("hw_pages", len(st.pages)))
        _rebase(req)
        eng._slots[idx] = st
        eng.scheduler.note_restored_slot(req)

    es = snap["engine"]
    eng._step_idx = es["step_idx"]
    eng._admit_seq = es["admit_seq"]
    eng._generator.set_state(torch.from_numpy(
        np.asarray(es["key"], np.uint8).copy()))
    eng._tok = np.asarray(es["tok"], np.int32).copy()
    eng._len = np.asarray(es["len"], np.int32).copy()
    eng._table = np.asarray(es["table"], np.int32).copy()
    eng.stats.update(es["stats"])
    eng._span_seq = int(es.get("span_seq", 0))
    eng._pending = [FinishedRequest(**f) for f in es["pending"]]
    # handoff queues (absent in older snapshots = empty): inbox
    # requests rebase like waiting ones; outbox wire dicts rebase their
    # embedded request timestamps AND their source-clock reading, so a
    # later ingest on another replica computes the same relative delta
    eng._handoff_in = []
    for rec in es.get("handoff_in", ()):
        req = _request_from_state(rec["request"])
        _rebase(req)
        eng._handoff_in.append(dict(
            request=req, base_len=int(rec["base_len"]),
            n_pages=int(rec["n_pages"]), payload=rec["payload"],
            nbytes=int(rec["nbytes"])))
    eng._handoff_out = []
    for h in es.get("handoff_out", ()):
        h = dict(h)
        rq = dict(h["request"])
        rq["t_enqueue"] = float(rq["t_enqueue"]) + delta
        for key in ("t_admitted", "t_first_token", "t_last_token"):
            if rq.get(key) is not None:
                rq[key] = float(rq[key]) + delta
        h["request"] = rq
        h["clock_now"] = float(h["clock_now"]) + delta
        eng._handoff_out.append(h)
    if snap.get("metrics") is not None and "metrics" not in overrides:
        from .metrics import MetricsRegistry

        eng.attach_metrics(MetricsRegistry.from_state(snap["metrics"]))
    eng.check_invariants()
    return eng

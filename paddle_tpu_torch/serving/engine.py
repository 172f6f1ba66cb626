"""Continuous-batching serving engine over the paged KV pool.

Counterpart of ``paddle_tpu/serving/engine.py``.  Every host-loop
iteration (:meth:`ServingEngine.step`)
expires deadlines, admits waiting requests (and ingested handoffs) into
freed slots, spends the step's chunk budget on prompt prefill, grows
decode pages (preempting the youngest slot under pressure) and runs one
decode step over every started slot:

* **chunk prefill**: up to ``chunk_tokens`` of ONE request's prompt per
  call — embeddings, ``_block_qkv``, the chunk's K/V scattered into the
  slot's pool pages, then paged attention of the chunk against everything
  already written (cached prefix pages, earlier chunks, itself) through
  the block table (:func:`~paddle_tpu_torch.kernels.paged_prefill`).
  Chunk widths pad to power-of-two buckets capped at ``chunk_tokens``.
* **decode**: one token for every started slot — per-slot K/V write at
  each slot's own position, paged attention through the block table
  (:func:`~paddle_tpu_torch.kernels.paged_attention`), sampling.
  ``decode_block=k`` runs k such steps before the host looks at the
  tokens.
* **speculative verify** (``spec_k > 0``): an n-gram drafter proposes up
  to ``spec_k`` tokens per slot from its own history, one step scores
  ``[carry, drafts]`` for every slot through the multi-query kernel
  (:func:`~paddle_tpu_torch.kernels.paged_attention_mq`), and the greedy
  rejection rule keeps the longest agreeing prefix plus one corrected
  token: the output is token for token that of plain greedy decoding.

``int8`` serves W8A8 projections (the ``w8a8_gemm`` kernel) over int8 KV
pages; ``kv_bits`` 8 or 4 picks int8 or nibble-packed int4 pages, which
the scatter quantizes per position and every attention kernel
dequantizes right after its page loads.

Prefix caching shares full prompt pages across requests through the pool's
radix index, with a copy-on-write clone for a partial tail page.
Sliding-window attention recycles the pages that fell behind the window.

Around that core, as in the reference: deterministic fault injection
(:class:`~.faults.FaultPlan`), a metrics registry, Chrome-trace request
lifecycles, the flight recorder, weighted fair queueing over tenants,
snapshots (:mod:`.snapshot`), the prefill / decode roles whose handoffs
the :class:`~.router.Router` pumps between replicas, and double-buffered
dispatch.

The reference jits its programs and donates the pool buffers to them;
here the step functions run eagerly and update the pool tensors IN PLACE,
which is what donation buys there: one copy of the pool, never two.

Double-buffered dispatch (``double_buffer=True``) defers the decode's one
host sync by a step, as the reference defers ``block_until_ready``: on the
card every operand goes up from pinned host staging with
``non_blocking=True``, the sampled tokens come back the same way into a
pinned buffer behind a ``torch.cuda.Event``, and the next step's retire
waits on that event (``stats["decode_sync_s"]``).  A pageable upload would
wait for the work already queued, and the overlap would be nil.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels import paged_attention, paged_attention_mq, paged_prefill
from ..models.generation import (_block_finish, _block_qkv, _decoder_setup,
                                 _lm_head, _make_sampler, _resolve_int8,
                                 _resolve_kv_bits, spec_accept_greedy)
from ..ops.quant_ops import quantize_int4_per_token, quantize_per_token
from ..weights import gpt_params
from .drafter import NGramDrafter
from .faults import FaultPlan, InjectedFault
from .flight_recorder import FlightRecorder
from .kv_pool import KVPool
from .metrics import MetricsRegistry, SLOTracker
from .scheduler import FCFSScheduler, Request
from .tenancy import normalize_tenants
from .tracing import PID_ENGINE, PID_REQUESTS, TraceRecorder, flow_id

#: Reasons a request leaves the engine: "eos" and "length" complete it,
#: the others are the degraded terminals.
TERMINAL_REASONS = ("eos", "length", "rejected", "expired", "cancelled")


@dataclasses.dataclass
class FinishedRequest:
    """One terminal request: the continuation produced (prompt excluded).
    ``finish_reason`` is one of :data:`TERMINAL_REASONS`; for a degraded
    terminal ``tokens`` holds whatever was generated before the request
    left (possibly nothing)."""

    rid: int
    prompt: np.ndarray
    tokens: np.ndarray            # generated continuation, EOS included
    finish_reason: str
    n_steps: int                  # engine steps it was resident

    @property
    def reason(self) -> str:
        return self.finish_reason

    @property
    def ok(self) -> bool:
        """True when the request ran to completion (eos/length)."""
        return self.finish_reason in ("eos", "length")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _Slot:
    """Host-side state of one occupied engine slot."""

    def __init__(self, request: Request, pages: List[int], prefilled: int,
                 seq: int, base_len: int):
        self.request = request
        self.pages = pages            # table order: shared prefix + owned
        # generated tokens live ON THE REQUEST so they survive preemption
        self.tokens: List[int] = request.generated
        self.born_step = 0
        self.seq = seq                # admission order, kept across
        #                               preemption (oldest never a victim)
        self.base_len = base_len      # work-prompt length at admission
        self.prefilled = prefilled    # work positions with K/V in pages
        # high-water LOGICAL page count: windowed recycling frees dead
        # leading pages (their table entries become the null page), so
        # len(pages) shrinks while hw_pages marks where growth appends
        self.hw_pages = len(pages)
        self.started = False          # first token sampled; decoding
        # speculative draft of this step: host-only, rebuilt from the
        # request's history by every speculative step (never snapshotted)
        self.draft: List[int] = []


class _HostIO:
    """Host <-> device transfers of the step functions.

    On the card every upload goes through a pinned staging tensor with
    ``non_blocking=True``, so it never waits for the work already queued;
    each staging tensor is guarded by the event recorded after its copy,
    and is refilled only once that event has completed (a busy ring
    grows instead of waiting).  :meth:`down` starts a non-blocking copy
    into pinned memory and records an event; :meth:`wait` synchronizes
    that event and reads the tokens.  On the CPU both are plain reads."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._rings: Dict[tuple, List[list]] = {}
        # whether the last wait() found its copy still in flight
        self.last_wait_pending = False

    def _staging(self, key: tuple, shape, dtype: torch.dtype) -> list:
        ring = self._rings.setdefault(key, [])
        for entry in ring:
            if entry[1] is None or entry[1].query():
                return entry
        entry = [torch.empty(shape, dtype=dtype, pin_memory=True), None]
        ring.append(entry)
        return entry

    def up(self, name: str, arr: np.ndarray) -> torch.Tensor:
        if not self.cuda:
            return torch.from_numpy(arr).to(self.device)
        src = torch.from_numpy(np.ascontiguousarray(arr))
        entry = self._staging(("up", name, src.shape, src.dtype),
                              src.shape, src.dtype)
        entry[0].copy_(src)
        out = entry[0].to(self.device, non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record()
        return out

    def down(self, t: torch.Tensor):
        """Start reading ``t`` back; :meth:`wait` finishes it."""
        if not self.cuda:
            return t.numpy()
        entry = self._staging(("down", t.shape, t.dtype), t.shape, t.dtype)
        entry[0].copy_(t, non_blocking=True)
        entry[1] = torch.cuda.Event()
        entry[1].record()
        return entry

    def wait(self, fut) -> np.ndarray:
        if not self.cuda:
            self.last_wait_pending = False
            return fut
        host, event = fut
        self.last_wait_pending = not event.query()
        event.synchronize()
        return host.numpy().copy()


class ServingEngine:
    """Continuous-batching generation over a paged KV cache.

    ``device`` is where the engine runs: the CUDA card unless the caller
    passes another (the model must live there too).  ``max_slots`` bounds
    the decode batch; ``page_size`` the pool granularity; ``num_pages``
    the pool size (default: every slot at ``max_seq_len``, +1 null page);
    ``token_budget`` the per-step token budget (decode tokens + prefill);
    ``chunk_tokens`` the widest prefill chunk; ``prefix_cache`` reuses KV
    pages across requests sharing a page-aligned prefix.  Sampling knobs
    mirror :func:`~paddle_tpu_torch.models.generation.build_generate_fn`;
    ``seed`` seeds the sampling generator.  ``attn_window`` overrides
    ``cfg.attn_window``.

    ``int8`` (default ``cfg.int8``) serves W8A8 projections and, unless
    ``kv_bits`` says otherwise, int8 KV pages; ``kv_bits`` (default
    ``cfg.kv_bits``) picks 8 (int8) or 4 (nibble-packed int4) pages with
    fp32 per-position scales.  ``spec_k`` > 0 drafts up to that many
    tokens per slot and step (an :class:`~.drafter.NGramDrafter` matching
    n-grams up to ``spec_ngram`` long, or any ``drafter`` with
    ``draft(history, max_tokens)``) and verifies them in one step; it
    needs greedy sampling and replaces ``decode_block``.

    Lifecycle: ``max_queue`` bounds the waiting queue (overflow becomes a
    ``rejected`` terminal); ``faults`` installs a
    :class:`~.faults.FaultPlan`; ``clock`` (zero-argument callable,
    seconds) drives deadlines and the request-time metrics — the fault
    plan's virtual clock when one is set, else ``time.monotonic``.

    Observability (all off by default): ``metrics`` feeds a
    :class:`~.metrics.MetricsRegistry` every step (a registry, or True
    for a fresh one); ``trace`` records Chrome trace events
    (:class:`~.tracing.TraceRecorder` or True); ``flight`` keeps a
    :class:`~.flight_recorder.FlightRecorder` ring of decisions.
    ``run(metrics_dir=...)`` exports them.

    Tenancy: ``policy`` orders the waiting queue (``"fcfs"``, ``"wfq"``
    or a :class:`~.tenancy.SchedulerPolicy`); ``tenants`` maps tenant
    name to weight or :class:`~.tenancy.TenantConfig` (naming tenants
    implies WFQ).  ``on_token(rid, token)`` observes every sampled token
    in delivery order.

    Disaggregation: ``role="prefill"`` engines prefill to completion and
    export every started slot as a handoff record (:meth:`drain_handoffs`);
    ``"decode"``/``"both"`` engines adopt records bit-exactly through
    :meth:`ingest_handoff`.  ``double_buffer=True`` defers the decode
    sync one step so the host schedules step N+1 while step N runs on the
    card (incompatible with ``spec_k``).
    """

    def __init__(self, model, *, device: DeviceLike = None,
                 max_slots: int = 8, page_size: int = 32,
                 max_seq_len: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 int8: Optional[bool] = None, seed: int = 0,
                 decode_block: int = 1,
                 chunk_tokens: int = 128, prefix_cache: bool = True,
                 max_queue: Optional[int] = None,
                 faults: Optional[FaultPlan] = None,
                 clock: Optional[Callable[[], float]] = None,
                 metrics=None, trace=None, flight=None,
                 policy=None, tenants=None,
                 on_token: Optional[Callable[[int, int], None]] = None,
                 spec_k: int = 0, spec_ngram: int = 3, drafter=None,
                 kv_bits: Optional[int] = None,
                 attn_window: Optional[int] = None,
                 role: str = "both", double_buffer: bool = False):
        model = gpt_params(model)   # a paddle GPTForPretraining: its holder
        cfg = model.cfg
        if getattr(model, "tp", None) is not None:
            # the reference's engine has no tensor parallelism either
            raise ValueError("the serving engine takes a whole model; a "
                             "tensor-parallel model decodes through "
                             "build_generate_fn / build_beam_search_fn")
        self.cfg = cfg
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"runs on {self.device}")
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role must be 'prefill', 'decode' or 'both', got {role!r}")
        self.role = role
        self.double_buffer = bool(double_buffer)
        if self.double_buffer and spec_k:
            raise ValueError(
                "double_buffer is incompatible with speculative decoding "
                "(spec_k > 0): drafting reads the retired token history "
                "the deferred sync has not produced yet")
        self.decode_block = max(1, int(decode_block))
        self.spec_k = max(0, int(spec_k))
        if self.spec_k:
            if not greedy:
                raise ValueError(
                    "speculative decoding (spec_k > 0) requires greedy "
                    "sampling: the longest-agreeing-prefix rule is the "
                    "greedy case of rejection sampling")
            if self.decode_block > 1:
                raise ValueError(
                    "spec_k > 0 replaces decode_block fusion: the verify "
                    "step already scores spec_k + 1 positions")
        self._drafter = drafter if drafter is not None else (
            NGramDrafter(self.spec_k, max_ngram=spec_ngram)
            if self.spec_k else None)
        self.int8 = _resolve_int8(cfg, int8)
        self.kv_bits = _resolve_kv_bits(cfg, self.int8, kv_bits)
        self.params, _ = _decoder_setup(model, int8=self.int8)
        self.n_heads = cfg.num_heads
        self.n_kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.head_dim
        self.eps = cfg.layer_norm_eps
        win = attn_window if attn_window is not None else cfg.attn_window
        if win is not None and int(win) < 1:
            raise ValueError(f"attn_window must be >= 1, got {win}")
        self.window = None if win is None else int(win)
        self.max_slots = max_slots
        self.page_size = page_size
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        if self.max_seq_len > cfg.max_seq_len:
            raise ValueError("max_seq_len exceeds the model's position table")
        self.max_pages = -(-self.max_seq_len // page_size)
        self.eos_token_id = eos_token_id
        self.chunk_tokens = max(1, min(int(chunk_tokens), self.max_seq_len))
        self.max_queue = max_queue
        self.faults = faults
        if clock is not None:
            self._clock = clock
        elif faults is not None:
            self._clock = faults.now
        else:
            # sanctioned fallback: no injected clock and no fault plan
            self._clock = time.monotonic  # graftlint: allow=determinism
        n_pages = num_pages or (1 + max_slots * self.max_pages)
        self.pool = KVPool(cfg.num_layers, cfg.num_heads, self.head_dim,
                           n_pages, page_size, dtype=model.dtype,
                           device=self.device, prefix_cache=prefix_cache,
                           num_kv_heads=self.n_kv_heads, kv_bits=self.kv_bits,
                           window=self.window)
        self.pool.faults = faults
        self.scheduler = FCFSScheduler(max_slots, self.pool,
                                       token_budget=token_budget,
                                       policy=policy, tenants=tenants)
        self.on_token = on_token
        self._sample = _make_sampler(greedy, temperature, top_k, top_p)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._io = _HostIO(self.device)
        # the stream current where the engine was built: step() enters it
        # (and the engine's device) whichever thread calls it, since
        # PyTorch's current device and stream are per thread
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)

        # ctor echo for snapshot/restore: enough to rebuild an equivalent
        # engine around the captured state.  faults, clock and the device
        # are deliberately NOT part of a snapshot
        self._config = dict(
            max_slots=max_slots, page_size=page_size,
            max_seq_len=self.max_seq_len, num_pages=n_pages,
            token_budget=self.scheduler.token_budget, greedy=greedy,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, int8=self.int8, seed=seed,
            decode_block=decode_block,
            chunk_tokens=chunk_tokens, prefix_cache=prefix_cache,
            max_queue=max_queue,
            kv_bits=self.kv_bits, attn_window=self.window,
            spec_k=self.spec_k, spec_ngram=spec_ngram,
            policy=self.scheduler.policy.name,
            tenants=({t: dataclasses.asdict(c)
                      for t, c in normalize_tenants(tenants).items()}
                     if tenants else None),
            role=role, double_buffer=self.double_buffer)

        # host mirrors of the decode step's device operands
        self._tokens_this_step = 0
        self._phase_s: Dict[str, tuple] = {}
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        self._tok = np.zeros((max_slots,), np.int32)
        self._len = np.zeros((max_slots,), np.int32)
        self._table = np.zeros((max_slots, self.max_pages), np.int32)
        self._step_idx = 0
        self._admit_seq = 0
        # terminals produced OUTSIDE step() (reject at enqueue, cancel)
        # park here and are delivered by the next step()
        self._pending: List[FinishedRequest] = []
        # disaggregation queues: a prefill-role engine parks handoff
        # records in the OUTBOX (the router pumps them away); a
        # decode/both engine queues ingested records in the INBOX until a
        # slot and pages free up.  Inbox payloads are host numpy.
        self._handoff_out: List[dict] = []
        self._handoff_in: List[dict] = []
        # the un-retired decode: ((slot, _Slot) pairs, remaining mirror,
        # token future, t_dispatch)
        self._inflight: Optional[tuple] = None
        # program shapes this engine has run (the reference counts its
        # jit traces in prefill_traces / decode_traces)
        self._shapes = set()
        # full-device syncs the engine made, and the retires that found
        # their decode still running on the card
        self.device_syncs = 0
        self.retires_in_flight = 0
        self.stats = {"prefill_calls": 0, "decode_calls": 0,
                      "prefill_traces": 0, "decode_traces": 0,
                      "tokens_generated": 0, "decode_tokens": 0,
                      "prefix_hit_tokens": 0, "prompt_tokens": 0,
                      "pages_in_use": 0, "queue_depth": 0,
                      "step_wall_s": 0.0, "last_step_s": 0.0,
                      # per-phase wall time: cumulative + last step
                      "admit_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
                      "handoff_s": 0.0,
                      "last_admit_s": 0.0, "last_prefill_s": 0.0,
                      "last_decode_s": 0.0, "last_handoff_s": 0.0,
                      # host time blocked on the decode's token read-back
                      "decode_sync_s": 0.0, "last_decode_sync_s": 0.0,
                      "handoffs_out": 0, "handoffs_in": 0,
                      "handoff_bytes": 0, "handoff_faults": 0,
                      "preemptions": 0, "recompute_tokens": 0,
                      "rejected": 0, "expired": 0, "cancelled": 0,
                      "step_faults": 0,
                      # speculative decoding: drafted = proposals scored
                      # by verify = accepted + rejected; the bonus or
                      # correction token is ordinary decode output
                      "spec_drafted": 0, "spec_accepted": 0,
                      "spec_rejected": 0}
        self.metrics: Optional[MetricsRegistry] = None
        self._m = None
        self.tracer: Optional[TraceRecorder] = None
        self.flight: Optional[FlightRecorder] = None
        self._pid_eng = PID_ENGINE
        self._pid_req = PID_REQUESTS
        # handoff trace context: per-export sequence for flow ids
        self._span_seq = 0
        self._tenant_cfg = normalize_tenants(tenants)
        self._slo: Optional[SLOTracker] = None
        self._last_step_at: Optional[float] = None
        # run(metrics_dir=) arms the crash dump
        self._crash_dump_dir: Optional[str] = None
        self._crash_dump_name = "flight_crash.json"
        if metrics is not None and metrics is not False:
            self.attach_metrics(
                metrics if isinstance(metrics, MetricsRegistry) else None)
        if trace is not None and trace is not False:
            self.attach_tracer(
                trace if isinstance(trace, TraceRecorder) else None)
        if flight is not None and flight is not False:
            self.attach_flight(
                flight if isinstance(flight, FlightRecorder) else None)

    # -- device work ------------------------------------------------------

    def _note_shape(self, key: tuple, stat: str) -> None:
        if key not in self._shapes:
            self._shapes.add(key)
            self.stats[stat] += 1

    def _scatter_kv(self, li, rows, offs, k1, v1):
        """Write per-token K/V rows (..., Hkv, D) into layer ``li`` of the
        pool at (page ``rows``, offset ``offs``), in place — quantized to
        int8 (or packed int4) values plus fp32 per-position scales when the
        pool is quantized.  The one scatter of the decode, verify and
        prefill steps.  Padded and inactive rows all target the null page
        0: a scatter with duplicate indices lands in no defined order,
        which is harmless only because page 0 is never read unmasked."""
        bufs = self.pool.buffers
        if self.kv_bits is None:
            bufs["k"][li][rows, :, offs] = k1
            bufs["v"][li][rows, :, offs] = v1
            return
        quant = (quantize_int4_per_token if self.kv_bits == 4
                 else quantize_per_token)
        for side, blk in (("k", k1), ("v", v1)):
            vals, scales = quant(blk)
            bufs[side][li][rows, :, offs] = vals
            bufs[side + "s"][li][rows, :, offs] = scales

    def _pages(self, li):
        """Layer ``li``'s pages and, for a quantized pool, their scales, as
        the paged kernels take them."""
        bufs = self.pool.buffers
        kw = {}
        if self.kv_bits is not None:
            kw = dict(k_scales=bufs["ks"][li], v_scales=bufs["vs"][li])
        return bufs["k"][li], bufs["v"][li], kw

    def _decode_once(self, toks, lengths, active, table):
        """One decode step for every slot lane: returns the sampled tokens
        (S,) int32.  Inactive lanes compute into the null page and their
        tokens are ignored."""
        p, ps, eps = self.params, self.page_size, self.eps
        s = toks.shape[0]
        # an out-of-range gather raises here where JAX clamps silently; an
        # inactive lane's length is not a real position, so clamp its read
        pe = p["wpe"][lengths.clamp(max=p["wpe"].shape[0] - 1)]
        x = (p["wte"][toks] + pe)[:, None, :]                  # (S, 1, h)
        page_idx = (lengths // ps).clamp(max=self.max_pages - 1)
        lanes = torch.arange(s, device=self.device)
        rows = torch.where(active, table[lanes, page_idx], 0)
        offs = lengths % ps
        for li, bp in enumerate(p["blocks"]):
            q, kb, vb = _block_qkv(bp, x, self.n_heads, eps,
                                   n_kv_heads=self.n_kv_heads)
            self._scatter_kv(li, rows, offs, kb[:, :, 0], vb[:, :, 0])
            kp, vp, kw = self._pages(li)
            out = paged_attention(q[:, :, 0].contiguous(), kp, vp, table,
                                  lengths + 1, window=self.window, **kw)
            x = _block_finish(bp, x, out.reshape(s, 1, -1).to(x.dtype), eps)
        logits = _lm_head(p, x[:, 0], eps)                     # (S, V)
        return self._sample(logits, self._generator).to(torch.int32)

    @torch.no_grad()
    def _decode_call(self, remaining: np.ndarray):
        """Dispatch ``decode_block`` decode steps over every lane; lanes
        whose ``remaining`` budget runs out stop advancing.  Returns the
        future of the sampled tokens (decode_block, S): :meth:`_HostIO.wait`
        reads them (no sync happens here)."""
        self._note_shape(("decode",), "decode_traces")
        up = self._io.up
        toks = up("tok", self._tok)
        lengths = up("len", self._len)
        table = up("table", self._table)
        rem = up("rem", remaining)
        steps = []
        for _ in range(self.decode_block):
            active = rem > 0
            nxt = self._decode_once(toks, lengths, active, table)
            toks = torch.where(active, nxt, toks)
            lengths = torch.where(active, lengths + 1, lengths)
            rem = (rem - 1).clamp(min=0)
            steps.append(nxt)
        return self._io.down(torch.stack(steps))

    @torch.no_grad()
    def _verify_call(self, draft: np.ndarray, n_draft: np.ndarray
                     ) -> np.ndarray:
        """The speculative verify step: every slot lane embeds its
        ``[carry, draft_0 .. draft_{k-1}]`` block at positions ``len ..
        len + k``, scatters the rows' K/V into its pages, attends each row
        to the history and the block's earlier rows (multi-query kernel),
        and predicts greedily after every row.  Rows past the lane's
        ``n_draft`` and every row of a lane not decoding this step
        (``n_draft == -1``) write to the null page.  Returns the
        predictions (S, k + 1) on the host — the one sync of the step.

        Rejected rows leave stale K/V past the accepted prefix; the next
        step's scatter rewrites those positions before any row attends to
        them, and no row attends past its own position."""
        p, ps, eps, dev = self.params, self.page_size, self.eps, self.device
        self._note_shape(("verify",), "decode_traces")
        t = self.spec_k + 1
        up = self._io.up
        toks = up("tok", self._tok)
        lengths = up("len", self._len)
        table = up("table", self._table)
        n_d = up("n_draft", n_draft)
        block = torch.cat([toks[:, None], up("draft", draft)], dim=1)
        s = block.shape[0]
        pos = lengths[:, None] + torch.arange(t, device=dev,
                                              dtype=torch.int32)[None, :]
        # rows of short drafts can run past the position table: clamp
        # their embedding gather (their outputs are unused)
        pe = p["wpe"][pos.clamp(max=p["wpe"].shape[0] - 1)]
        x = p["wte"][block] + pe                                 # (S, T, h)
        row_ok = torch.arange(t, device=dev)[None, :] <= n_d[:, None]
        page_idx = (pos // ps).clamp(max=self.max_pages - 1).long()
        rows = torch.where(row_ok, torch.gather(table, 1, page_idx), 0)
        offs = pos % ps
        for li, bp in enumerate(p["blocks"]):
            q, kb, vb = _block_qkv(bp, x, self.n_heads, eps,
                                   n_kv_heads=self.n_kv_heads)  # (S,H,T,D)
            self._scatter_kv(li, rows, offs, kb.transpose(1, 2),
                             vb.transpose(1, 2))
            kp, vp, kw = self._pages(li)
            out = paged_attention_mq(q.transpose(1, 2).contiguous(), kp, vp,
                                     table, lengths, window=self.window, **kw)
            x = _block_finish(bp, x, out.reshape(s, t, -1).to(x.dtype), eps)
        logits = _lm_head(p, x, eps)                             # (S, T, V)
        pred = self._sample(logits.reshape(s * t, -1), self._generator)
        return pred.reshape(s, t).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def _prefill_chunk(self, toks: np.ndarray, start: int, n_valid: int,
                       table_row: np.ndarray, sample_row: Optional[int]):
        """One chunk of one prompt: rows ``[start, start + n_valid)`` of the
        sequence (the rest of ``toks`` is padding).  Writes the chunk's K/V
        into the slot's pages, then attends the chunk against every
        written position through the block table.  With ``sample_row``
        (the chunk row of the LAST prompt token) returns the sampled next
        token as a device scalar, else None."""
        p, ps, eps, dev = self.params, self.page_size, self.eps, self.device
        c = toks.size
        self._note_shape(("prefill", c), "prefill_traces")
        toks_d = self._io.up("prefill_tok", toks)
        row = self._io.up("prefill_row", table_row)
        pos = start + torch.arange(c, device=dev, dtype=torch.int32)
        # the padded rows of a prompt's last chunk run past the position
        # table: clamp their gather (JAX clamps silently, torch raises);
        # their K/V land on the null page and their outputs are dropped
        pe = p["wpe"][pos.clamp(max=p["wpe"].shape[0] - 1)]
        x = (p["wte"][toks_d] + pe)[None]                       # (1, C, h)
        valid = torch.arange(c, device=dev) < n_valid
        page_idx = (pos // ps).clamp(max=self.max_pages - 1)
        rows = torch.where(valid, row[page_idx], 0)
        offs = pos % ps
        for li, bp in enumerate(p["blocks"]):
            q, kb, vb = _block_qkv(bp, x, self.n_heads, eps,
                                   n_kv_heads=self.n_kv_heads)
            # (1, H, C, D) -> (C, H, D): the page-scatter layout
            self._scatter_kv(li, rows, offs, kb[0].transpose(0, 1),
                             vb[0].transpose(0, 1))
            kp, vp, kw = self._pages(li)
            out = paged_prefill(q[0].transpose(0, 1).contiguous(), kp, vp,
                                row, start, window=self.window, **kw)
            x = _block_finish(bp, x, out.reshape(1, c, -1).to(x.dtype), eps)
        if sample_row is None:
            return None
        # LN and the head are row-wise: project only the sampled row
        last = _lm_head(p, x[0, sample_row][None], eps)          # (1, V)
        return self._sample(last, self._generator)[0]

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write clone of one pool page across all layers."""
        for buf in self.pool.buffers.values():
            buf[:, dst] = buf[:, src]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.device_syncs += 1
            torch.cuda.synchronize(self.device)

    # -- public API -------------------------------------------------------

    def add_request(self, prompt, max_new_tokens: int,
                    arrival: float = 0.0,
                    deadline_s: Optional[float] = None,
                    tenant: Optional[str] = None) -> int:
        """Queue one request; returns its rid.  The prompt + continuation
        must fit ``max_seq_len``.  ``deadline_s`` expires the request that
        many engine-clock seconds after enqueue, whatever state it is in.
        ``tenant`` names the account the request schedules and bills
        under (WFQ; FCFS uses it only for metric labels)."""
        return self._enqueue(
            Request(prompt=np.asarray(prompt, np.int32).reshape(-1),
                    max_new_tokens=max_new_tokens, arrival=arrival,
                    deadline_s=deadline_s, tenant=tenant))

    def _enqueue(self, req: Request) -> int:
        """Single admission gate: every request must fit the model's
        position table; a full waiting queue (or the tenant's own
        ``max_waiting``) REJECTS it — it still gets a rid and a
        ``rejected`` terminal from the next step()."""
        if req.total_len > self.max_seq_len:
            raise ValueError(
                f"request needs {req.total_len} positions; engine "
                f"max_seq_len is {self.max_seq_len}")
        req.t_enqueue = self._now()
        if self.metrics is not None:
            self._m["enqueued"].inc()
        if ((self.max_queue is not None
             and self.scheduler.n_waiting >= self.max_queue)
                or self.scheduler.quota_reject(req.tenant)):
            if self.tracer is not None:
                self.tracer.begin("queued", self._pid_req, req.rid)
            self.stats["rejected"] += 1
            self._pending.append(self._terminal(req, "rejected"))
            return req.rid
        rid = self.scheduler.add(req)
        if self.tracer is not None:
            self.tracer.begin("queued", self._pid_req, req.rid,
                              {"prompt_len": req.prompt_len,
                               "max_new": req.max_new_tokens})
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a request in ANY live state — waiting, mid-prefill,
        decoding or parked in the handoff inbox.  Pages are released at
        once; the ``cancelled`` terminal arrives with the next step().
        False when the rid is unknown or already terminal."""
        req = self.scheduler.remove_waiting(rid)
        if req is not None:
            self.stats["cancelled"] += 1
            self._pending.append(self._terminal(req, "cancelled"))
            return True
        for idx, st in enumerate(self._slots):
            if st is not None and st.request.rid == rid:
                self.stats["cancelled"] += 1
                self._pending.append(self._finish(idx, "cancelled"))
                return True
        for i, rec in enumerate(self._handoff_in):
            if rec["request"].rid == rid:
                del self._handoff_in[i]
                self.stats["cancelled"] += 1
                self._pending.append(
                    self._terminal(rec["request"], "cancelled"))
                return True
        return False

    @property
    def has_work(self) -> bool:
        """Work THIS engine can advance by stepping: queue/slots,
        undelivered terminals, queued handoff ingests, or an un-retired
        decode.  The handoff OUTBOX is the router's to drain."""
        return (self.scheduler.has_work or bool(self._pending)
                or bool(self._handoff_in) or self._inflight is not None)

    def prefix_hit_rate(self) -> float:
        """Fraction of prompt tokens served from cached KV pages."""
        return self.stats["prefix_hit_tokens"] / max(
            self.stats["prompt_tokens"], 1)

    # -- router probes ----------------------------------------------------

    def prefix_match_len(self, prompt) -> int:
        """Tokens of ``prompt`` this replica's prefix index already holds
        K/V for — the router's cache-affinity key.  Probes the WORK
        prompt (``prompt[:-1]``, as admission does) and is read-only."""
        if self.pool.prefix is None:
            return 0
        work = np.asarray(prompt, np.int32).reshape(-1)[:-1]
        if work.size == 0:
            return 0
        return self.pool.prefix.probe_len(work)

    def load_score(self) -> float:
        """Scalar busyness for the router's tie-break: resident slots +
        queue depth (both per capacity) + pool pressure.  Lower is
        better."""
        cap = max(self.max_slots, 1)
        return (self.scheduler.n_active / cap
                + self.scheduler.n_waiting / cap
                + self.pool.utilization())

    def stats_snapshot(self) -> Dict[str, float]:
        """A COPY of the stats ledger at this instant."""
        return dict(self.stats)

    # -- observability ----------------------------------------------------

    def attach_metrics(self, registry: Optional[MetricsRegistry] = None
                       ) -> MetricsRegistry:
        """Start feeding ``registry`` (fresh one if None) every step.  The
        registry must belong to THIS engine alone: ``serving_*`` counters
        mirror this engine's stats ledger via set_total."""
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._tenant_metrics = {}   # (family, tenant[, reason]) -> metric
        c = self.metrics.counter
        g = self.metrics.gauge
        h = self.metrics.histogram
        self._m = {
            "enqueued": c("serving_requests_enqueued",
                          "requests that arrived (incl. later rejects)"),
            "terminal": {r: c(f"serving_requests_terminal_{r}",
                              f"requests that ended {r}")
                         for r in TERMINAL_REASONS},
            "steps": c("serving_steps", "engine host-loop iterations"),
            "tokens": c("serving_tokens_generated", "sampled tokens"),
            "prefill_calls": c("serving_prefill_calls",
                               "chunk-prefill dispatches"),
            "decode_calls": c("serving_decode_calls", "decode dispatches"),
            "preemptions": c("serving_preemptions",
                             "slots evicted for recompute"),
            "recompute": c("serving_recompute_tokens",
                           "work-prompt tokens re-prefilled"),
            "prefix_hit": c("serving_prefix_hit_tokens",
                            "prompt tokens served from cached pages"),
            "prompt_tokens": c("serving_prompt_tokens",
                               "admitted work-prompt tokens"),
            "cow": c("serving_cow_clones", "copy-on-write page clones"),
            "step_faults": c("serving_step_faults",
                             "injected mid-step exceptions absorbed"),
            "spec_drafted": c("serving_spec_drafted_tokens",
                              "draft tokens scored by verify dispatches"),
            "spec_accepted": c("serving_spec_accepted_tokens",
                               "draft tokens the verify pass accepted"),
            "spec_rejected": c("serving_spec_rejected_tokens",
                               "draft tokens the verify pass rejected"),
            "spec_accept_rate": h("serving_spec_acceptance_rate",
                                  "per-request accepted/drafted at "
                                  "terminal (requests that drafted)"),
            "alloc_calls": c("serving_alloc_calls",
                             "KVPool.alloc lease attempts"),
            "alloc_failures": c("serving_alloc_failures",
                                "KVPool.alloc calls that returned None"),
            "evictions": c("serving_prefix_evictions",
                           "cached pages LRU-evicted under pressure"),
            "pages_in_use": g("serving_pages_in_use",
                              "pages referenced by live requests"),
            "pages_free": g("serving_pages_free", "free-list pages"),
            "pages_reclaimable": g("serving_pages_reclaimable",
                                   "cached pages with no live reference"),
            "queue_depth": g("serving_queue_depth", "waiting requests"),
            "slots_active": g("serving_slots_active", "occupied slots"),
            "kv_bytes_per_token": g("serving_kv_bytes_per_token",
                                    "pool HBM bytes one token position "
                                    "costs across all layers"),
            "pages_per_slot_p50": g("serving_pages_per_slot_p50",
                                    "median live pages per occupied slot"),
            "hit_rate": g("serving_prefix_hit_rate",
                          "prefix_hit_tokens / prompt_tokens"),
            "budget_util": g("serving_token_budget_utilization",
                             "step tokens / token_budget"),
            "queue_wait": h("serving_queue_wait_s",
                            "enqueue -> first admission (engine clock)"),
            "ttft": h("serving_ttft_s",
                      "enqueue -> first token (engine clock)"),
            "tbt": h("serving_tbt_s",
                     "time between tokens per slot (engine clock)"),
            "e2e": h("serving_e2e_latency_s",
                     "enqueue -> terminal (engine clock)"),
            "step_s": h("serving_step_s", "full step wall time"),
            "admit_s": h("serving_step_admit_s",
                         "expire+admit phase wall time"),
            "prefill_s": h("serving_step_prefill_s",
                           "chunk-prefill phase wall time"),
            "decode_s": h("serving_step_decode_s",
                          "grow+decode phase wall time"),
            "chunk_s": h("serving_prefill_chunk_s",
                         "one chunk-prefill dispatch wall time"),
            "decode_call_s": h("serving_decode_call_s",
                               "one decode dispatch+sync wall time"),
            "handoffs_out": c("serving_handoffs_out",
                              "prefill-complete requests exported to the "
                              "router (prefill-role engines)"),
            "handoffs_in": c("serving_handoffs_in",
                             "handoff records accepted from the router"),
            "handoff_bytes": c("serving_handoff_bytes",
                               "KV payload bytes shipped out (degraded "
                               "transfers ship none)"),
            "handoff_faults": c("serving_handoff_faults",
                                "handoffs degraded by an injected "
                                "transfer fault (payload dropped)"),
            "handoff_inbox": g("serving_handoff_inbox",
                               "ingested records waiting for a slot"),
            "handoff_s": h("serving_step_handoff_s",
                           "handoff export phase wall time"),
            "decode_sync": h("serving_decode_sync_s",
                             "host time blocked on the decode device "
                             "sync (double buffering shrinks this)"),
        }
        # SLO series only for tenants that declare budgets
        if any(c.ttft_slo_s is not None or c.e2e_slo_s is not None
               for c in self._tenant_cfg.values()):
            self._slo = SLOTracker(self.metrics)
        return self.metrics

    def attach_tracer(self, tracer: Optional[TraceRecorder] = None,
                      replica: Optional[int] = None,
                      replica_name: Optional[str] = None) -> TraceRecorder:
        """Start recording the request lifecycle + engine phases as
        Chrome trace events (fresh recorder if None).  ``replica``
        namespaces this engine's lanes so N replicas' recorders merge
        into one cluster timeline (:func:`~.tracing.merge_traces`)."""
        self.tracer = tracer if tracer is not None else TraceRecorder()
        if replica is not None and self.tracer.replica is None:
            self.tracer.set_replica(replica, name=replica_name)
        self._pid_eng = self.tracer.pid(PID_ENGINE)
        self._pid_req = self.tracer.pid(PID_REQUESTS)
        role = "" if self.role == "both" else f" [{self.role}]"
        self.tracer.process_name(
            self._pid_eng,
            self.tracer.lane_label(f"serving engine{role} (step phases)"))
        self.tracer.process_name(
            self._pid_req,
            self.tracer.lane_label("requests (tid = rid)"))
        return self.tracer

    def attach_flight(self, recorder: Optional[FlightRecorder] = None,
                      capacity: int = 1024) -> FlightRecorder:
        """Start the flight recorder (fresh ring of ``capacity`` records
        if None), stamped on the ENGINE clock."""
        self.flight = (recorder if recorder is not None
                       else FlightRecorder(capacity, clock=self._clock))
        return self.flight

    def dump_debug(self) -> dict:
        """Debug snapshot: step counter, invariant verdict (the audit runs
        here and reports rather than raises), stats ledger and the
        flight-recorder ring (None when not attached)."""
        try:
            self.check_invariants()
            verdict = "ok"
        except AssertionError as e:
            verdict = f"violated: {e}"
        return {"step": self._step_idx, "role": self.role,
                "invariants": verdict, "stats": self.stats_snapshot(),
                "flight": (self.flight.to_json()
                           if self.flight is not None else None)}

    def _tr_end(self, rid: int, args: Optional[dict] = None) -> None:
        """Close the request's open span, tolerating a tracer attached
        mid-lifecycle (no span open yet)."""
        if self.tracer.open_span(self._pid_req, rid) is not None:
            self.tracer.end(self._pid_req, rid, args)

    def _tenant_counter(self, family: str, help: str, tenant: str,
                        reason: Optional[str] = None):
        """Lazily-created per-tenant labeled counter."""
        key = (family, tenant, reason)
        m = self._tenant_metrics.get(key)
        if m is None:
            labels = {"tenant": tenant}
            if reason is not None:
                labels["reason"] = reason
            m = self.metrics.counter(family, help, labels=labels)
            self._tenant_metrics[key] = m
        return m

    def _emit_token(self, req: Request, tok: int) -> None:
        """One sampled token just landed on ``req`` (the caller already
        appended it): feed the streaming observer and the per-tenant token
        counter, in delivery order."""
        if self.on_token is not None:
            self.on_token(req.rid, tok)
        if self.metrics is not None and req.tenant is not None:
            self._tenant_counter("serving_tenant_tokens_generated",
                                 "sampled tokens per tenant",
                                 req.tenant).inc()

    def _charge_service(self, req: Request) -> None:
        """Bill the request's first-time-served token delta to its
        tenant's virtual counter (WFQ; no-op under FCFS)."""
        delta = req.uncharged_tokens()
        if delta > 0:
            self.scheduler.charge(req, delta)

    def _observe_terminal(self, req: Request, reason: str) -> None:
        """Single funnel for EVERY FinishedRequest creation: one terminal
        counter increment, one SLO verdict, one flight record and one
        trace instant per terminal."""
        if self.metrics is not None:
            now = self._now()
            self._m["terminal"][reason].inc()
            self._m["e2e"].observe(now - req.t_enqueue)
            if req.spec_drafted > 0:
                self._m["spec_accept_rate"].observe(
                    req.spec_accepted / req.spec_drafted)
            if req.tenant is not None:
                self._tenant_counter("serving_tenant_requests_terminal",
                                     "per-tenant terminals by reason",
                                     req.tenant, reason).inc()
            if self._slo is not None and req.tenant is not None:
                cfg = self._tenant_cfg.get(req.tenant)
                if cfg is not None:
                    if cfg.ttft_slo_s is not None:
                        ok = (req.t_first_token is not None
                              and req.t_first_token - req.t_enqueue
                              <= cfg.ttft_slo_s)
                        self._slo.observe(req.tenant, "ttft", ok, now,
                                          cfg.slo_objective)
                    if cfg.e2e_slo_s is not None:
                        ok = (reason in ("eos", "length")
                              and now - req.t_enqueue <= cfg.e2e_slo_s)
                        self._slo.observe(req.tenant, "e2e", ok, now,
                                          cfg.slo_objective)
        if self.flight is not None:
            self.flight.record("terminal", self._step_idx, rid=req.rid,
                               reason=reason, tokens=len(req.generated),
                               tenant=req.tenant)
        if self.tracer is not None:
            self._tr_end(req.rid)
            self.tracer.instant(reason, self._pid_req, req.rid,
                                {"rid": req.rid,
                                 "tokens": len(req.generated)})

    def snapshot(self) -> dict:
        """Capture the whole engine state as plain numpy/python — see
        :mod:`.snapshot`.  ``ServingEngine.restore(model, snap)`` resumes
        token for token."""
        from .snapshot import snapshot_engine

        return snapshot_engine(self)

    @classmethod
    def restore(cls, model, snap: dict, **overrides) -> "ServingEngine":
        """Rebuild an engine around ``model`` (same weights as the
        snapshotted one) and resume from ``snap``."""
        from .snapshot import restore_engine

        return restore_engine(model, snap, **overrides)

    # -- internals --------------------------------------------------------

    def _now(self) -> float:
        return self._clock()

    def _fault_point(self, phase: str) -> None:
        if self.faults is not None:
            self.faults.check_raise(phase)

    def _terminal(self, req: Request, reason: str) -> FinishedRequest:
        """Terminal record for a request that is NOT in a slot."""
        self._observe_terminal(req, reason)
        return FinishedRequest(
            rid=req.rid, prompt=req.prompt,
            tokens=np.asarray(req.generated, np.int32),
            finish_reason=reason, n_steps=0)

    def _vacate(self, idx: int) -> _Slot:
        st = self._slots[idx]
        self._slots[idx] = None
        self._table[idx] = 0
        self._tok[idx] = 0
        self._len[idx] = 0
        self.scheduler.release(idx, st.pages, st.request)
        return st

    def _finish(self, idx: int, reason: str) -> FinishedRequest:
        st = self._vacate(idx)
        self._observe_terminal(st.request, reason)
        return FinishedRequest(
            rid=st.request.rid, prompt=st.request.prompt,
            tokens=np.asarray(st.tokens, np.int32), finish_reason=reason,
            n_steps=self._step_idx - st.born_step + 1)

    def _preempt(self, idx: int) -> None:
        """Evict slot ``idx`` to recompute later: pages freed (cached
        prompt pages park reclaimable — the cheap part of the recompute),
        generated tokens kept on the request, request requeued at the
        HEAD of the waiting queue."""
        st = self._vacate(idx)
        st.request.n_preempted += 1
        self.scheduler.requeue(st.request)
        self.stats["preemptions"] += 1
        if self.flight is not None:
            self.flight.record("preempt", self._step_idx,
                               victim=st.request.rid, slot=idx,
                               reason="page_pressure",
                               generated=len(st.request.generated),
                               pages_freed=len(st.pages))
        if self.tracer is not None:
            rid = st.request.rid
            self._tr_end(rid)            # the "resident" span
            self.tracer.instant("preempt", self._pid_req, rid,
                                {"generated": len(st.request.generated)})
            self.tracer.begin("queued", self._pid_req, rid,
                              {"recompute": True})

    def _pick_victim(self) -> Optional[int]:
        """The youngest occupied slot — unless it is the only one: the
        oldest request is never preempted (no livelock)."""
        occ = [(st.seq, i) for i, st in enumerate(self._slots)
               if st is not None]
        if len(occ) <= 1:
            return None
        return max(occ)[1]

    def _expire(self, finished: List[FinishedRequest]) -> None:
        """Deadlines, all sides: overdue WAITING requests drop before this
        step's admissions, overdue SLOTS release their pages, overdue
        inbox records leave the inbox."""
        now = self._now()
        for req in self.scheduler.pop_expired(now):
            self.stats["expired"] += 1
            finished.append(self._terminal(req, "expired"))
        for idx, st in enumerate(self._slots):
            if st is not None and st.request.expired(now):
                self.stats["expired"] += 1
                finished.append(self._finish(idx, "expired"))
        if self._handoff_in:
            keep = []
            for rec in self._handoff_in:
                if rec["request"].expired(now):
                    self.stats["expired"] += 1
                    finished.append(
                        self._terminal(rec["request"], "expired"))
                else:
                    keep.append(rec)
            self._handoff_in = keep

    def _admit(self, adm) -> None:
        """Apply one scheduling decision: the slot's block table from
        shared-prefix + owned pages, the COW tail clone, and how much of
        the prompt needs no recompute."""
        req, idx = adm.request, adm.slot
        pages = list(adm.cached) + list(adm.pages)
        if adm.cow is not None:
            # the first owned page inherits the partial tail's K/V; the
            # source drops the reference the scheduler pinned for us
            self._copy_page(adm.cow[0], adm.pages[0])
            self.pool.release([adm.cow[0]])
        if req.seq is None:
            self._admit_seq += 1
            req.seq = self._admit_seq
        st = _Slot(req, pages, prefilled=adm.matched, seq=req.seq,
                   base_len=req.work_len)
        st.born_step = self._step_idx
        self._slots[idx] = st
        self._table[idx] = 0
        self._table[idx, :len(pages)] = pages
        self.stats["prefix_hit_tokens"] += adm.matched
        self.stats["prompt_tokens"] += req.work_len
        if req.n_preempted > 0:
            self.stats["recompute_tokens"] += req.work_len - adm.matched
        now = self._now()
        if self.metrics is not None:
            if req.t_admitted is None:        # first admission only
                self._m["queue_wait"].observe(now - req.t_enqueue)
            if adm.cow is not None:
                self._m["cow"].inc()
        if req.t_admitted is None:
            req.t_admitted = now
        if self.flight is not None:
            self.flight.record("admit", self._step_idx, rid=req.rid,
                               slot=idx, matched=adm.matched,
                               recompute=req.n_preempted > 0,
                               tenant=req.tenant)
        if self.tracer is not None:
            self._tr_end(req.rid)             # the "queued" span
            if adm.cow is not None:
                self.tracer.instant("cow_clone", self._pid_req, req.rid,
                                    {"matched_tokens": adm.cow[1]})
            self.tracer.begin("resident", self._pid_req, req.rid,
                              {"slot": idx, "matched": adm.matched,
                               "preempted": req.n_preempted})

    def _prefill_chunks(self, finished: List[FinishedRequest]) -> None:
        """Spend the step's chunk budget over partially-prefilled slots in
        admission order, one chunk of one slot per call.  A slot whose
        prompt completes samples its next token and joins this step's
        decode."""
        n_decoding = sum(1 for s in self._slots
                         if s is not None and s.started)
        budget = self.scheduler.prefill_budget(
            n_decoding, self.chunk_tokens, decode_cost=1 + self.spec_k)
        partial = sorted((i for i, s in enumerate(self._slots)
                          if s is not None and not s.started),
                         key=lambda i: self._slots[i].seq)
        for idx in partial:
            st = self._slots[idx]
            req = st.request
            work = req.work_prompt()
            while budget > 0 and not st.started:
                n = min(st.base_len - st.prefilled, budget,
                        self.chunk_tokens)
                c_pad = min(_next_pow2(max(n, 8)),
                            max(self.chunk_tokens, n))
                toks = np.zeros((c_pad,), np.int32)
                toks[:n] = work[st.prefilled:st.prefilled + n]
                completes = st.prefilled + n == st.base_len
                if self.tracer is not None:
                    self.tracer.begin("prefill_chunk", self._pid_req,
                                      req.rid, {"start": st.prefilled,
                                                "n": n})
                t_c = time.perf_counter()
                tok = self._prefill_chunk(toks, st.prefilled, n,
                                          self._table[idx],
                                          n - 1 if completes else None)
                if self.metrics is not None:
                    self._m["chunk_s"].observe(time.perf_counter() - t_c)
                if self.tracer is not None:
                    self.tracer.end(self._pid_req, req.rid)
                self.stats["prefill_calls"] += 1
                st.prefilled += n
                budget -= n
                self._tokens_this_step += n
                # WFQ accounting: bill first-time prompt positions (a
                # recomputed chunk below the high-water mark bills 0)
                req.note_prefill_progress(st.prefilled)
                self._charge_service(req)
                if not completes:
                    continue
                # prompt complete: its full pages become matchable
                st.started = True
                if self.pool.prefix is not None:
                    if (self.window is not None
                            and st.base_len > self.window):
                        # the leading pages are about to be recycled:
                        # indexing would pin dead pages, so refuse
                        self.pool.prefix.window_refusals += 1
                    else:
                        nfull = st.base_len // self.page_size
                        self.pool.prefix.insert(work, st.pages[:nfull])
                tok = int(tok)
                st.tokens.append(tok)
                self._emit_token(req, tok)
                self._charge_service(req)
                self.stats["tokens_generated"] += 1
                now = self._now()
                if req.t_first_token is None:
                    if self.metrics is not None:
                        self._m["ttft"].observe(now - req.t_enqueue)
                    if self.tracer is not None:
                        self.tracer.instant("first_token", self._pid_req,
                                            req.rid)
                    req.t_first_token = now
                elif self.metrics is not None and req.t_last_token is not None:
                    # a recomputed request's first post-readmission token
                    self._m["tbt"].observe(now - req.t_last_token)
                req.t_last_token = now
                self._tok[idx] = tok
                self._len[idx] = st.base_len
                if (self.eos_token_id is not None
                        and tok == self.eos_token_id):
                    finished.append(self._finish(idx, "eos"))
                elif len(st.tokens) >= req.max_new_tokens:
                    finished.append(self._finish(idx, "length"))
            if budget <= 0:
                break

    def _grow_pages(self, idx: int, consumed: int) -> bool:
        """Ensure slot ``idx`` owns every page its next ``consumed`` decode
        writes need.  On allocation failure, preempt the youngest occupied
        slot and retry; never the oldest.  True when the slot can decode
        this step."""
        st = self._slots[idx]
        # grow from the HIGH-WATER page count: logical page i always lives
        # at table column i, whatever windowed recycling freed
        need = self.pool.pages_for(int(self._len[idx]) + consumed) \
            - st.hw_pages
        while need > 0:
            got = self.pool.alloc(need)
            if got is not None:
                self._table[idx, st.hw_pages:st.hw_pages + len(got)] = got
                st.pages.extend(got)
                st.hw_pages += len(got)
                return True
            if self.flight is not None:
                self.flight.record(
                    "alloc_fail", self._step_idx, rid=st.request.rid,
                    need=need, free=self.pool.num_free,
                    reclaimable=self.pool.num_reclaimable)
            if self.pool.num_free + self.pool.num_reclaimable >= need:
                # the pool COULD satisfy the lease: a transient allocator
                # fault, not pressure — stall this step, evict nobody
                return False
            victim = self._pick_victim()
            if victim is None:
                return False          # stalled; the pool can't shrink
            self._preempt(victim)
            if victim == idx:
                return False          # the grower was the youngest itself
        return True

    def _recycle_window_pages(self, idx: int) -> None:
        """Sliding-window page recycling: leading logical page j is dead
        once ``(j+1) * page_size <= len + 1 - window`` (the next query at
        position ``len`` sees none of it); it goes back to the pool and
        its table entry becomes the null page, which the window mask
        already excludes.  A slot's live pages form a ring of about
        ceil(window / page_size) + 1."""
        st = self._slots[idx]
        if st is None or self.window is None or not st.started:
            return
        dead = (int(self._len[idx]) + 1 - self.window) // self.page_size
        done = st.hw_pages - len(st.pages)    # leading pages already freed
        if dead <= done:
            return
        victims = st.pages[:dead - done]
        del st.pages[:dead - done]
        self._table[idx, done:dead] = 0
        self.pool.free(victims)
        if self.flight is not None:
            self.flight.record("window_recycle", self._step_idx,
                               rid=st.request.rid, pages=len(victims))

    # -- disaggregated prefill/decode handoff -----------------------------

    def _handoff_started(self) -> None:
        """Prefill-role drain: every STARTED slot (prompt complete, first
        token sampled) serializes into a handoff record and leaves the
        engine.  A scripted "handoff" fault degrades the WHOLE step's
        transfers — records ship without page payloads and the decode
        replica re-prefills them."""
        from .snapshot import handoff_state

        started = sorted((i for i, s in enumerate(self._slots)
                          if s is not None and s.started),
                         key=lambda i: self._slots[i].seq)
        if not started:
            return
        degraded = False
        if self.faults is not None:
            try:
                self.faults.check_raise("handoff")
            except InjectedFault:
                degraded = True
        for idx in started:
            st = self._slots[idx]
            h = handoff_state(self, idx, with_payload=not degraded)
            self.stats["handoffs_out"] += 1
            if degraded:
                self.stats["handoff_faults"] += 1
            else:
                self.stats["handoff_bytes"] += h["nbytes"]
            if self.flight is not None:
                self.flight.record("handoff_out", self._step_idx,
                                   rid=st.request.rid,
                                   nbytes=h["nbytes"],
                                   n_pages=h["n_pages"],
                                   degraded=degraded)
            if self.tracer is not None:
                rid = st.request.rid
                tr = h.get("trace")
                if tr is not None:
                    # inside the resident span: the flow arrow leaves
                    # from the prefill slice
                    self.tracer.flow_start(
                        "handoff", self._pid_req, rid,
                        flow_id(tr["rid"], tr["seq"]))
                self._tr_end(rid)            # the "resident" span
                self.tracer.instant("handoff", self._pid_req, rid,
                                    {"n_pages": h["n_pages"],
                                     "nbytes": h["nbytes"],
                                     "degraded": degraded})
            # the request lives on elsewhere: no terminal
            self._vacate(idx)
            self._handoff_out.append(h)

    def drain_handoffs(self) -> List[dict]:
        """Hand the outbox to the caller (the router's pump)."""
        out, self._handoff_out = self._handoff_out, []
        return out

    def ingest_handoff(self, h: dict) -> int:
        """Accept one prefill-replica handoff record.  Layout-guarded
        EAGERLY; timestamps rebase onto this engine's clock as in snapshot
        restore.  A payload-bearing record queues in the inbox until a
        slot and pages free up; a DEGRADED record (payload None) re-enters
        the waiting queue at the head and re-prefills here.  Returns the
        rid."""
        from .snapshot import _request_from_state

        if self.role == "prefill":
            raise ValueError(
                "a prefill-role engine cannot ingest handoffs — route "
                "them to a decode/both replica")
        payload = h["payload"]
        if payload is not None:
            self.pool.check_layout(payload["layout"], what="handoff")
        req = _request_from_state(h["request"])
        delta = self._now() - float(h["clock_now"])
        req.t_enqueue += delta
        for attr in ("t_admitted", "t_first_token", "t_last_token"):
            v = getattr(req, attr)
            if v is not None:
                setattr(req, attr, v + delta)
        self.stats["handoffs_in"] += 1
        if self.flight is not None:
            self.flight.record("handoff_in", self._step_idx, rid=req.rid,
                               nbytes=int(h["nbytes"]),
                               n_pages=int(h["n_pages"]),
                               degraded=payload is None)
        if payload is None:
            # degraded transfer: already accepted and billed, so it skips
            # backpressure and requeues at the head; accounting-wise a
            # preemption (the work prompt is recomputed)
            req.n_preempted += 1
            self.scheduler.requeue(req)
            if self.tracer is not None:
                self.tracer.begin("queued", self._pid_req, req.rid,
                                  {"recompute": True, "handoff": True})
        else:
            self._handoff_in.append(dict(
                request=req, base_len=int(h["base_len"]),
                n_pages=int(h["n_pages"]), payload=payload,
                nbytes=int(h["nbytes"])))
            if self.tracer is not None:
                self.tracer.begin("queued", self._pid_req, req.rid,
                                  {"handoff": True})
        if self.tracer is not None:
            tr = h.get("trace")
            if tr is not None:
                self.tracer.flow_finish("handoff", self._pid_req,
                                        req.rid,
                                        flow_id(tr["rid"], tr["seq"]))
        return req.rid

    def _admit_handoffs(self, finished: List[FinishedRequest]) -> None:
        """Admit queued handoff records FIFO into free slots (head-of-line
        blocking on slot/page shortage, as the scheduler's admission)."""
        while self._handoff_in:
            rec = self._handoff_in[0]
            if not self._try_admit_handoff(rec):
                break
            self._handoff_in.pop(0)

    def _try_admit_handoff(self, rec: dict) -> bool:
        if not self.scheduler._free_slots:
            return False
        pages = self.pool.alloc(rec["n_pages"])
        if pages is None:
            return False
        req = rec["request"]
        base_len = rec["base_len"]
        self.pool.ingest_pages(rec["payload"], pages)
        if req.seq is None:
            self._admit_seq += 1
            req.seq = self._admit_seq
        st = _Slot(req, pages, prefilled=base_len, seq=req.seq,
                   base_len=base_len)
        st.born_step = self._step_idx
        st.started = True
        slot = self.scheduler._free_slots.pop()
        self.scheduler.note_restored_slot(req)
        self._slots[slot] = st
        self._table[slot] = 0
        self._table[slot, :len(pages)] = pages
        # mirrors as local prefill completion leaves them: the carry token
        # is the last sampled one, the length the work prompt's
        self._tok[slot] = req.generated[-1]
        self._len[slot] = base_len
        if self.pool.prefix is not None:
            if self.window is not None and base_len > self.window:
                self.pool.prefix.window_refusals += 1
            else:
                work = req.work_prompt()[:base_len]
                nfull = base_len // self.page_size
                self.pool.prefix.insert(work, st.pages[:nfull])
        if self.flight is not None:
            self.flight.record("admit", self._step_idx, rid=req.rid,
                               slot=slot, handoff=True,
                               adopted_pages=len(pages),
                               tenant=req.tenant)
        if self.tracer is not None:
            self._tr_end(req.rid)            # the "queued" span
            self.tracer.begin("resident", self._pid_req, req.rid,
                              {"slot": slot, "handoff": True,
                               "adopted_pages": len(pages)})
        return True

    @contextlib.contextmanager
    def _on_device(self):
        """The engine's device and stream, on any thread."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    def step(self) -> List[FinishedRequest]:
        """One engine iteration: expire deadlines, admit into freed slots,
        advance partial prefills by the chunk budget, grow decode pages
        (preempting under pressure), then decode every started slot (a
        prefill-role engine hands them off instead).  Returns every
        request that reached a terminal state this step (including
        rejects and cancels recorded since the last step).  An injected
        fault aborts the rest of the iteration at a phase boundary; a
        real one re-parks this step's terminals and re-raises.  Runs on
        the engine's device and stream, whichever thread calls it."""
        with self._on_device():
            return self._step()

    def _step(self) -> List[FinishedRequest]:
        t0 = time.perf_counter()
        self._step_idx += 1
        if self.faults is not None:
            self.faults.begin_step(self._step_idx)
        finished: List[FinishedRequest] = list(self._pending)
        self._pending.clear()
        self._tokens_this_step = 0
        # phase -> (start perf-seconds, duration), filled by _run_step's
        # finally blocks so an aborted phase still records its time
        phase = self._phase_s = {}
        try:
            self._run_step(finished)
        except InjectedFault as e:
            self.stats["step_faults"] += 1
            if self.flight is not None:
                self.flight.record("injected_fault", self._step_idx,
                                   error=str(e))
        except BaseException as e:
            # a REAL fault must not swallow terminals already recorded
            # this iteration (their pages are freed): re-park them
            self._pending = finished + self._pending
            if self.flight is not None:
                self.flight.record("crash", self._step_idx,
                                   error=f"{type(e).__name__}: {e}")
                if self._crash_dump_dir is not None:
                    try:
                        self.flight.dump(os.path.join(
                            self._crash_dump_dir, self._crash_dump_name))
                    except OSError:
                        pass          # the dump must never mask the fault
            raise
        dt = time.perf_counter() - t0
        self._last_step_at = self._now()
        self.stats["pages_in_use"] = self.pool.pages_in_use
        self.stats["queue_depth"] = self.scheduler.n_waiting
        self.stats["step_wall_s"] += dt
        self.stats["last_step_s"] = dt
        for ph in ("admit", "prefill", "handoff", "decode"):
            start_dur = phase.get(ph)
            v = start_dur[1] if start_dur is not None else 0.0
            self.stats[f"{ph}_s"] += v
            self.stats[f"last_{ph}_s"] = v
        if self.tracer is not None:
            for ph, (start, dur) in phase.items():
                self.tracer.complete(ph, start, dur, self._pid_eng, 0,
                                     {"step": self._step_idx})
        if self.metrics is not None:
            self._sync_metrics(dt, phase)
        return finished

    def _sync_metrics(self, dt: float, phase: Dict[str, tuple]) -> None:
        """End-of-step registry feed: counters sync from the stats ledger,
        gauges sample the pool/scheduler, histograms take this step's wall
        times."""
        m, s = self._m, self.stats
        m["steps"].inc()
        for stat_key, name in (("tokens_generated", "tokens"),
                               ("prefill_calls", "prefill_calls"),
                               ("decode_calls", "decode_calls"),
                               ("preemptions", "preemptions"),
                               ("recompute_tokens", "recompute"),
                               ("prefix_hit_tokens", "prefix_hit"),
                               ("prompt_tokens", "prompt_tokens"),
                               ("step_faults", "step_faults"),
                               ("spec_drafted", "spec_drafted"),
                               ("spec_accepted", "spec_accepted"),
                               ("spec_rejected", "spec_rejected"),
                               ("handoffs_out", "handoffs_out"),
                               ("handoffs_in", "handoffs_in"),
                               ("handoff_bytes", "handoff_bytes"),
                               ("handoff_faults", "handoff_faults")):
            m[name].set_total(s[stat_key])
        m["handoff_inbox"].set(len(self._handoff_in))
        m["alloc_calls"].set_total(self.pool.alloc_calls)
        m["alloc_failures"].set_total(self.pool.alloc_failures)
        if self.pool.prefix is not None:
            m["evictions"].set_total(self.pool.prefix.evictions)
        m["pages_in_use"].set(self.pool.pages_in_use)
        m["pages_free"].set(self.pool.num_free)
        m["pages_reclaimable"].set(self.pool.num_reclaimable)
        m["queue_depth"].set(self.scheduler.n_waiting)
        m["slots_active"].set(self.scheduler.n_active)
        m["kv_bytes_per_token"].set(self.pool.bytes_per_token())
        held = sorted(len(s.pages) for s in self._slots if s is not None)
        m["pages_per_slot_p50"].set(
            held[len(held) // 2] if held else 0)
        m["hit_rate"].set(self.prefix_hit_rate())
        m["budget_util"].set(self._tokens_this_step
                             / max(self.scheduler.token_budget, 1))
        m["step_s"].observe(dt)
        for ph in ("admit", "prefill", "handoff", "decode"):
            if ph in phase:
                m[f"{ph}_s"].observe(phase[ph][1])
        if self._slo is not None:
            self._slo.sync(self._now())

    def _run_step(self, finished: List[FinishedRequest]) -> None:
        phase = self._phase_s
        t_a = time.perf_counter()
        try:
            self._expire(finished)
            # handoff ingests admit FIRST: their prefill is paid for
            self._admit_handoffs(finished)
            for adm in self.scheduler.schedule_step():
                self._admit(adm)
            self._fault_point("admit")
        finally:
            phase["admit"] = (t_a, time.perf_counter() - t_a)
        t_p = time.perf_counter()
        try:
            calls = self.stats["prefill_calls"]
            self._prefill_chunks(finished)
            if self.stats["prefill_calls"] > calls and not self.double_buffer:
                # settle the chunks' device work so the phase clock
                # measures it rather than its enqueue; a double-buffered
                # engine leaves the card running
                self._sync()
            self._fault_point("prefill")
        finally:
            phase["prefill"] = (t_p, time.perf_counter() - t_p)

        if self.role == "prefill":
            # prefill workers never decode: completed prompts export
            t_h = time.perf_counter()
            try:
                self._handoff_started()
            finally:
                phase["handoff"] = (t_h, time.perf_counter() - t_h)
            return

        t_d = time.perf_counter()
        try:
            self._decode_step(finished)
            self._fault_point("decode")
        finally:
            phase["decode"] = (t_d, time.perf_counter() - t_d)

    def _decode_step(self, finished: List[FinishedRequest]) -> None:
        if self.spec_k:
            return self._spec_decode_step(finished)
        # retire LAST step's decode first (double buffering leaves it in
        # flight): its finishes free pages before this step's growth, so
        # growth never preempts an un-retired slot
        if self._inflight is not None:
            self._retire_decode(finished)
        # page growth oldest first, so preemption victims are always
        # younger than the grower
        order = sorted((i for i, s in enumerate(self._slots)
                        if s is not None and s.started),
                       key=lambda i: self._slots[i].seq)
        run: List[int] = []
        for idx in order:
            st = self._slots[idx]
            if st is None:                    # preempted by an earlier grow
                continue
            consumed = min(self.decode_block, st.request.remaining_new)
            if self._grow_pages(idx, consumed):
                run.append(idx)
        if not run:
            return
        remaining = np.zeros((self.max_slots,), np.int32)
        for idx in run:
            remaining[idx] = self._slots[idx].request.remaining_new
        t_c = time.perf_counter()
        fut = self._decode_call(remaining)
        self.stats["decode_calls"] += 1
        # the slot objects ride along so retirement can detect a cancel,
        # an expiry or a slot re-use in between
        self._inflight = ([(idx, self._slots[idx]) for idx in run],
                          remaining, fut, t_c)
        if not self.double_buffer:
            self._retire_decode(finished)

    def _retire_decode(self, finished: List[FinishedRequest]) -> None:
        """Wait for the stashed decode's tokens and apply them: append,
        bill tenants, finish eos/length, mirror the carry state.  Under
        double buffering this runs one step LATE."""
        entries, remaining, fut, t_c = self._inflight
        self._inflight = None
        t_s = time.perf_counter()
        toks_all = self._io.wait(fut)
        sync_s = time.perf_counter() - t_s
        self.retires_in_flight += self._io.last_wait_pending
        self.stats["decode_sync_s"] += sync_s
        self.stats["last_decode_sync_s"] = sync_s
        if self.metrics is not None:
            self._m["decode_call_s"].observe(time.perf_counter() - t_c)
            self._m["decode_sync"].observe(sync_s)
        now = self._now()
        for idx, st_dispatched in entries:
            st = self._slots[idx]
            if st is not st_dispatched:
                # cancelled/expired (or the slot re-used) between dispatch
                # and retirement: its sampled tokens are dead
                continue
            consumed = int(min(self.decode_block, remaining[idx]))
            reason = None
            n_new = 0
            req = st.request
            for i in range(consumed):
                tok = int(toks_all[i, idx])
                st.tokens.append(tok)
                self._emit_token(req, tok)
                n_new += 1
                self.stats["tokens_generated"] += 1
                self.stats["decode_tokens"] += 1
                if (self.eos_token_id is not None
                        and tok == self.eos_token_id):
                    reason = "eos"
                    break
            self._tokens_this_step += n_new
            self._charge_service(req)
            if (self.metrics is not None and n_new
                    and req.t_last_token is not None):
                self._m["tbt"].observe((now - req.t_last_token) / n_new)
            req.t_last_token = now
            if reason is None and len(st.tokens) >= req.max_new_tokens:
                reason = "length"
            if reason is not None:
                finished.append(self._finish(idx, reason))
            else:
                # mirror the device state: it advanced `consumed` steps and
                # its carry token is the last one sampled
                self._tok[idx] = int(toks_all[consumed - 1, idx])
                self._len[idx] += consumed
                self._recycle_window_pages(idx)

    def _spec_decode_step(self, finished: List[FinishedRequest]) -> None:
        """One speculative iteration over the started slots: draft from each
        request's history, grow pages for the whole verify block (carry +
        drafts, the same on-demand growth and preemption as decode), one
        verify step, then the greedy rejection rule advances each slot by
        ``accepted + 1`` tokens.  The draft is capped at ``remaining_new -
        1``, so even full acceptance plus the bonus token lands exactly on
        ``max_new_tokens``."""
        k = self.spec_k
        order = sorted((i for i, s in enumerate(self._slots)
                        if s is not None and s.started),
                       key=lambda i: self._slots[i].seq)
        # -1 marks a lane not decoding this step (empty, mid-prefill or
        # stalled): the verify step parks all its rows on the null page
        n_draft = np.full((self.max_slots,), -1, np.int32)
        draft = np.zeros((self.max_slots, k), np.int32)
        run: List[int] = []
        for idx in order:
            st = self._slots[idx]
            if st is None:                    # preempted by an earlier grow
                continue
            cap = min(k, st.request.remaining_new - 1)
            st.draft = []
            if cap > 0:
                prop = np.asarray(
                    self._drafter.draft(st.request.work_prompt(), cap),
                    np.int32).reshape(-1)
                st.draft = [int(v) for v in prop[:cap]]
            if self._grow_pages(idx, len(st.draft) + 1):
                run.append(idx)
                n_draft[idx] = len(st.draft)
                draft[idx, :len(st.draft)] = st.draft
        if not run:
            return
        # mid-verify fault point: drafts proposed and pages grown, verify
        # not yet issued; the next step's proposal overwrites the drafts
        self._fault_point("verify")
        t_c = time.perf_counter()
        pred = self._verify_call(draft, n_draft)
        self.stats["decode_calls"] += 1
        if self.metrics is not None:
            self._m["decode_call_s"].observe(time.perf_counter() - t_c)
        now = self._now()
        for idx in run:
            st = self._slots[idx]
            req = st.request
            nd = len(st.draft)
            n_acc, emitted = spec_accept_greedy(pred[idx], st.draft)
            st.draft = []
            self.stats["spec_drafted"] += nd
            self.stats["spec_accepted"] += n_acc
            self.stats["spec_rejected"] += nd - n_acc
            req.spec_drafted += nd
            req.spec_accepted += n_acc
            reason = None
            n_new = 0
            for tok in emitted:
                st.tokens.append(tok)
                self._emit_token(req, tok)
                n_new += 1
                self.stats["tokens_generated"] += 1
                self.stats["decode_tokens"] += 1
                if (self.eos_token_id is not None
                        and tok == self.eos_token_id):
                    reason = "eos"
                    break
            self._tokens_this_step += n_new
            self._charge_service(req)
            if (self.metrics is not None and n_new
                    and req.t_last_token is not None):
                self._m["tbt"].observe((now - req.t_last_token) / n_new)
            req.t_last_token = now
            if reason is None and len(st.tokens) >= req.max_new_tokens:
                reason = "length"
            if reason is not None:
                finished.append(self._finish(idx, reason))
            else:
                # positions len .. len + n_new - 1 now hold the K/V of the
                # carry and the accepted drafts; the new carry is the
                # bonus or correction token, whose K/V the next step writes
                self._tok[idx] = emitted[n_new - 1]
                self._len[idx] += n_new
                self._recycle_window_pages(idx)

    def check_invariants(self) -> None:
        """Page-leak / refcount / scheduler-consistency audit: the pool's
        bookkeeping balances, the refcount total equals the page
        references live slots hold (so waiting, preempted and inbox
        requests hold none), no rid is in two places at once, slot
        occupancy agrees with the scheduler, windowed slots keep a bounded
        ring of live pages, a speculative draft stays within ``spec_k``
        and the request's remaining budget on a decoding slot, and the
        policy's tenant accounting matches the slots."""
        self.pool.check()
        refs = sum(len(s.pages) for s in self._slots if s is not None)
        held = sum(self.pool.refcount)
        if held != refs:
            raise AssertionError(
                f"refcount sum {held} != {refs} page references held by "
                "live slots — a page reference leaked or double-freed")
        waiting_rids = [r.rid for r in self.scheduler.waiting]
        if len(waiting_rids) != len(set(waiting_rids)):
            raise AssertionError("duplicate rid in the waiting queue")
        slot_rids = {s.request.rid for s in self._slots if s is not None}
        both = set(waiting_rids) & slot_rids
        if both:
            raise AssertionError(
                f"rid(s) {sorted(both)} simultaneously waiting and "
                "resident in a slot")
        inbox_rids = [rec["request"].rid for rec in self._handoff_in]
        if len(inbox_rids) != len(set(inbox_rids)):
            raise AssertionError("duplicate rid in the handoff inbox")
        clash = set(inbox_rids) & (set(waiting_rids) | slot_rids)
        if clash:
            raise AssertionError(
                f"rid(s) {sorted(clash)} in the handoff inbox AND "
                "waiting/resident")
        free = set(self.scheduler._free_slots)
        for i, s in enumerate(self._slots):
            if (i in free) == (s is not None):
                raise AssertionError(
                    f"slot {i} occupancy disagrees with the scheduler's "
                    "free-slot list")
        cmax = max(self.decode_block, self.spec_k + 1)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if s.hw_pages < len(s.pages):
                raise AssertionError(
                    f"slot {i} high-water {s.hw_pages} below live page "
                    f"count {len(s.pages)}")
            if self.window is None:
                if s.hw_pages != len(s.pages):
                    raise AssertionError(
                        f"slot {i} recycled pages without a window "
                        f"(hw {s.hw_pages}, live {len(s.pages)})")
            elif s.started:
                length = int(self._len[i])
                cap = self.pool.pages_for(
                    min(length + cmax, self.window + cmax)) + 1
                if len(s.pages) > cap:
                    raise AssertionError(
                        f"slot {i} holds {len(s.pages)} pages at len "
                        f"{length} under window {self.window}; ring cap "
                        f"is {cap}")
            if s.draft and (len(s.draft) > self.spec_k or not s.started
                            or len(s.draft) >= s.request.remaining_new):
                raise AssertionError(
                    f"slot {i} holds a draft of {len(s.draft)} tokens "
                    f"(spec_k {self.spec_k}, started {s.started}, "
                    f"remaining {s.request.remaining_new})")
        self.scheduler.policy.check(
            [s.request for s in self._slots if s is not None])

    def run(self, requests: Optional[Sequence] = None,
            metrics_dir: Optional[str] = None, flush_every: int = 1
            ) -> Dict[int, FinishedRequest]:
        """Drive the host loop until every queued (and given) request is
        terminal; returns {rid: FinishedRequest}.  ``requests`` holds
        :class:`Request` objects or ``(prompt, max_new_tokens)`` pairs.

        ``metrics_dir`` turns the drain into an observed run: every
        ``flush_every`` steps the registry's scalars flush to a
        TensorBoard event file under the dir (attaching metrics, a tracer
        and a flight recorder where none is set), and at drain the dir
        also holds ``metrics.prom``, ``trace.json`` and ``flight.json``.
        Raises when a page is still referenced after the drain."""
        from .metrics import MetricsFileExporter

        for r in requests or ():
            if isinstance(r, Request):
                self._enqueue(r)
            else:
                prompt, max_new = r
                self.add_request(prompt, max_new)
        exporter = None
        if metrics_dir is not None:
            if self.metrics is None:
                self.attach_metrics()
            if self.tracer is None:
                self.attach_tracer()
            if self.flight is None:
                self.attach_flight()
            os.makedirs(metrics_dir, exist_ok=True)
            self._crash_dump_dir = metrics_dir
            exporter = MetricsFileExporter(self.metrics, metrics_dir)
        done: Dict[int, FinishedRequest] = {}
        try:
            while self.has_work:
                for fin in self.step():
                    done[fin.rid] = fin
                if exporter is not None and \
                        self._step_idx % flush_every == 0:
                    exporter.flush(self._step_idx)
        finally:
            if exporter is not None:
                if exporter.last_step != self._step_idx:
                    exporter.flush(self._step_idx)
                exporter.close()
                if self.tracer is not None:
                    self.tracer.save(
                        os.path.join(metrics_dir, "trace.json"))
                if self.flight is not None:
                    self.flight.dump(
                        os.path.join(metrics_dir, "flight.json"))
        if self.scheduler.n_active or self.pool.pages_in_use:
            raise AssertionError(
                f"page leak after drain: {self.scheduler.n_active} slots "
                f"active, {self.pool.pages_in_use} pages still referenced")
        return done

"""FCFS continuous-batching scheduler (Orca, OSDI '22 + Sarathi, OSDI '24).

Counterpart of ``paddle_tpu/serving/scheduler.py`` (host only).

The scheduler owns the WAITING queue, the slot occupancy map and the
per-step token budget; the engine owns the device programs.  Every engine
step asks :meth:`FCFSScheduler.schedule_step` which requests to admit
into freed slots, then runs at most ``chunk budget`` tokens of prefill
plus ONE decode step over all started slots — iteration-level scheduling
instead of run-to-completion batches.

Budget semantics (Sarathi-Serve's chunked prefill): admission costs
nothing up front — an admitted request's prompt is prefilled in CHUNKS
across subsequent steps, co-scheduled with decode.  Each step the engine
spends :meth:`prefill_budget` prompt tokens, i.e. ``token_budget`` minus
one token per active decode, so a burst of long prompts can no longer
stall every in-flight decode behind a monolithic prefill (the
failure mode that needed whole prompts force-admitted over budget).
Admission is gated only by free slots and pages.

Page accounting is ON-DEMAND (vLLM's preempt-by-recompute tier):
admission reserves only the pages the PROMPT needs — decode grows the
block table one page at a time as the sequence crosses page boundaries,
and when growth fails the engine preempts the youngest occupied slot
(its pages free, its generated tokens survive on the request, and
:meth:`requeue` puts it back at the HEAD of the waiting queue for
recompute-restart through the chunked-prefill path).  The older
whole-lifetime reservation (``pages_for(total_len)`` at admission) paid
``max_new_tokens`` worth of pages for every resident request whether
generated or not; on-demand growth lifts occupancy at the cost of the
preemption tier.  No-livelock: the OLDEST admitted request (smallest
admission seq, preserved across preemptions) is never chosen as a
victim, so it always progresses and the system always shrinks.
Prefix-cached pages (kv_pool.KVPool ``prefix_cache=True``) are matched
AT ADMISSION: shared full pages are retained instead of allocated, a
partial-tail match is handed to the engine as a copy-on-write candidate,
and only the uncached remainder allocates fresh pages — which is also
what makes a preempted request's recompute cheap: its already-computed
full prompt pages park reclaimable in the prefix index and are simply
re-adopted at re-admission.

Lifecycle: a request may carry a ``deadline_s`` (seconds from
enqueue, measured on the engine's clock) — :meth:`pop_expired` removes
overdue requests at queue-pop time, the engine expires overdue slots
per-step.  :meth:`remove_waiting` serves ``engine.cancel`` for queued
requests.  The BOUND (backpressure) lives in the engine, which converts
an over-limit enqueue into an explicit ``rejected`` terminal instead of
unbounded growth.

Queue ORDER is pluggable (serving/tenancy.py): the scheduler
delegates push/peek/pop/requeue-at-head to a
:class:`~paddle_tpu_torch.serving.tenancy.SchedulerPolicy` — FCFS by default
(the original deque, semantics unchanged), or weighted fair queueing over
per-tenant virtual token counters for multi-tenant isolation.  The
scheduler keeps owning slots, pages and the token budget; the policy
only decides WHOSE request admits next.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import numpy as np

from .kv_pool import KVPool
from .tenancy import SchedulerPolicy, make_policy


class _RidCounter:
    """Monotonic request-id source.  A plain mutable counter (not
    itertools.count) so snapshot/restore can capture and re-seed it —
    restored engines must keep minting rids unique w.r.t. the snapshot."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0

    def __call__(self) -> int:
        rid, self.n = self.n, self.n + 1
        return rid


_next_rid = _RidCounter()


@dataclass(eq=False)
class Request:
    """One generation request: token ids in, up to ``max_new_tokens`` out.
    Identity equality (``eq=False``): requests are stateful queue members
    — field-wise comparison over numpy prompts is meaningless (and
    ``deque.remove`` relies on ``==``).

    ``deadline_s`` (optional) expires the request ``deadline_s`` engine-
    clock seconds after enqueue, in ANY state.  ``generated`` holds every
    token produced so far and SURVIVES preemption — a preempted request
    re-enters the queue carrying its continuation, and the engine
    re-prefills ``work_prompt`` (prompt + generated) before decoding the
    remaining ``remaining_new`` tokens, so the final output is identical
    to an unpreempted run under greedy sampling.
    """

    prompt: np.ndarray
    max_new_tokens: int
    rid: int = field(default_factory=_next_rid)
    arrival: float = 0.0
    deadline_s: Optional[float] = None
    tenant: Optional[str] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # lifecycle state (not ctor args): tokens generated so far (kept
        # across preemption), preemption count, enqueue timestamp on the
        # engine's clock, and the admission seq — assigned at FIRST
        # admission and preserved so the globally oldest request is never
        # a preemption victim (the no-livelock guarantee).
        self.generated: List[int] = []
        self.n_preempted = 0
        self.t_enqueue = 0.0
        self.seq: Optional[int] = None
        # observability timestamps (engine clock): first admission,
        # first token ever sampled, last token delivered — the engine
        # derives queue-wait / TTFT / time-between-token histograms from
        # these; all survive preemption (a recomputed request keeps its
        # original TTFT) and snapshot/restore.
        self.t_admitted: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_last_token: Optional[float] = None
        # fair-queueing service accounting: ``vt_charged`` is the
        # total first-time-served tokens already charged to the tenant's
        # virtual counter; ``max_prompt_prefilled`` is the high-water
        # mark of ORIGINAL-prompt positions ever prefilled.  Both are
        # monotone across preemption, which is exactly what makes a
        # recompute free: re-prefilling positions below the high-water
        # mark raises neither, so ``uncharged_tokens`` stays 0 for them.
        self.vt_charged = 0
        self.max_prompt_prefilled = 0
        # speculative decoding observability: draft tokens this
        # request's verify dispatches scored / accepted.  Survive
        # preemption and snapshot (they are cumulative request history);
        # the engine observes accepted/drafted into the acceptance-rate
        # histogram at the terminal.  NOT service accounting: WFQ charges
        # through ``uncharged_tokens`` — only ACCEPTED tokens ever enter
        # ``generated``, so rejected drafts bill zero by construction.
        self.spec_drafted = 0
        self.spec_accepted = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def total_len(self) -> int:
        """Worst-case positions ever needed — invariant under preemption
        (``work_len + remaining_new`` is constant)."""
        return self.prompt_len + self.max_new_tokens

    @property
    def work_len(self) -> int:
        """Positions needing K/V before the next decode: the original
        prompt plus every token generated so far."""
        return self.prompt_len + len(self.generated)

    @property
    def remaining_new(self) -> int:
        return self.max_new_tokens - len(self.generated)

    def work_prompt(self) -> np.ndarray:
        """The token sequence to (re)prefill: prompt + generated."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    def expired(self, now: float) -> bool:
        return (self.deadline_s is not None
                and now - self.t_enqueue > self.deadline_s)

    # -- fair-queueing service accounting ---------------------------

    def note_prefill_progress(self, prefilled: int) -> None:
        """``prefilled`` counts WORK-prompt positions with K/V written.
        Only original-prompt positions past the high-water mark are
        first-time service — generated tokens re-prefilled after a
        preemption were already charged when they were decoded."""
        self.max_prompt_prefilled = max(
            self.max_prompt_prefilled, min(prefilled, self.prompt_len))

    def uncharged_tokens(self) -> int:
        """Tokens served for the first time since the last call: the
        delta of the monotone ``max_prompt_prefilled + len(generated)``.
        Recomputed (post-preemption) work never raises it, so the
        tenant's virtual counter is charged exactly once per token."""
        served = self.max_prompt_prefilled + len(self.generated)
        delta = served - self.vt_charged
        self.vt_charged = served
        return delta


@dataclass
class Admission:
    """One scheduling decision: request -> slot, with its pages.

    ``pages`` are freshly leased (refcount 1, this request's alone);
    ``cached`` are prefix-index pages shared read-only (already retained);
    ``cow`` is an optional ``(source_page, n_tokens)`` partial-tail match
    the engine must copy-on-write into ``pages[0]`` (the source is
    retained until the engine releases it after the copy); ``matched`` is
    the total prompt tokens whose K/V need no recompute."""

    slot: int
    request: Request
    pages: List[int]
    cached: List[int] = field(default_factory=list)
    cow: Optional[Tuple[int, int]] = None
    matched: int = 0


class FCFSScheduler:
    """Iteration-level admission over a fixed slot array.  Queue ORDER
    comes from ``policy`` (default: true FCFS); slots, pages and the
    token budget are policy-independent.  The name is historical —
    every call site and test builds this class."""

    def __init__(self, n_slots: int, pool: KVPool,
                 token_budget: Optional[int] = None,
                 policy: Union[None, str, SchedulerPolicy] = None,
                 tenants=None):
        self.n_slots = n_slots
        self.pool = pool
        # default budget: every slot decoding plus one flagship-sized
        # prefill chunk per step keeps step latency bounded without
        # starving admission
        self.token_budget = token_budget or (n_slots + 512)
        self.policy: SchedulerPolicy = make_policy(policy, tenants)
        self._free_slots: List[int] = list(range(n_slots - 1, -1, -1))

    # -- queue ------------------------------------------------------------

    @property
    def waiting(self) -> List[Request]:
        """Every waiting request, in the policy's deterministic
        iteration order (FCFS: arrival order).  A fresh list each call —
        mutate through the scheduler's methods, not this view."""
        return list(self.policy)

    def add(self, request: Request) -> int:
        max_tokens = (self.pool.num_pages - 1) * self.pool.page_size
        if request.total_len > max_tokens:
            raise ValueError(
                f"request {request.rid} needs {request.total_len} tokens; "
                f"the pool holds {max_tokens} — raise num_pages/max_seq_len")
        self.policy.push(request)
        return request.rid

    def requeue(self, request: Request) -> None:
        """Put a PREEMPTED request back at the head of the queue: it was
        admitted before anything still waiting, so FCFS order puts it in
        front (multiple preemptions in one step requeue youngest-first,
        each head-insert landing the older one ahead; under WFQ, the head
        of its tenant's queue).  Bypasses the engine's backpressure bound
        — the request was already accepted."""
        self.policy.requeue_head(request)

    def remove_waiting(self, rid: int) -> Optional[Request]:
        """Remove and return the waiting request with ``rid`` (cancel),
        or None if it is not queued."""
        return self.policy.remove(rid)

    def pop_expired(self, now: float) -> List[Request]:
        """Drop every waiting request whose deadline has passed (checked
        at queue-pop time, before this step's admissions)."""
        return self.policy.pop_expired(now)

    def quota_reject(self, tenant: Optional[str]) -> bool:
        """Per-tenant backpressure (engine consults at enqueue)."""
        return self.policy.quota_reject(tenant)

    def charge(self, request: Request, n_tokens: int) -> None:
        """Account ``n_tokens`` of first-time service to the request's
        tenant (WFQ virtual counters; FCFS ignores)."""
        self.policy.charge(request, n_tokens)

    def load_waiting(self, requests: List[Request]) -> None:
        """Snapshot-restore path: refill the queue without arrival side
        effects (policy counters load separately)."""
        self.policy.load_waiting(requests)

    def note_restored_slot(self, request: Request) -> None:
        """Snapshot-restore path: a slot came back occupied — give the
        policy its residency accounting without re-admitting."""
        self.policy.on_admit(request)

    @property
    def n_waiting(self) -> int:
        return len(self.policy)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free_slots)

    @property
    def has_work(self) -> bool:
        return len(self.policy) > 0 or self.n_active > 0

    # -- per-step decisions ----------------------------------------------

    def prefill_budget(self, n_decoding: int, chunk_tokens: int,
                       decode_cost: int = 1) -> int:
        """Sarathi chunk budget for one step: the token budget left after
        paying ``decode_cost`` tokens per active decode, capped at the
        engine's chunk program width and floored at 1 so prefill always
        progresses even when decodes alone exceed the budget.
        ``decode_cost`` is 1 for plain decode; a speculative engine
        reserves ``spec_k + 1`` per decoding slot — the verify dispatch
        scores that many positions whether or not they are accepted, so
        the step's compute reservation must not be distorted by
        speculation (WFQ SERVICE charging, by contrast, bills accepted
        tokens only, through ``Request.uncharged_tokens``)."""
        return max(1, min(chunk_tokens,
                          self.token_budget - n_decoding * decode_cost))

    def schedule_step(self) -> List[Admission]:
        """Admit from the policy's queue into free slots until slots or
        pages run out.  Head-of-line blocking is intentional (fairness):
        if the chosen head's pages don't fit we stop, we don't scan
        deeper for a smaller request — under WFQ "the head" is the
        lowest-virtual-counter eligible tenant's oldest request, FCFS
        within the tenant.  Page demand covers the WORK PROMPT only
        (prompt + any preemption-survived tokens) — decode pages are
        allocated on demand by the engine, which preempts under pressure.
        Prefix-cache matching happens here, while this step's page
        arithmetic is decided: matched full pages are retained (shared)
        instead of allocated, and a partial-tail match rides along as the
        COW candidate."""
        admissions: List[Admission] = []
        while self._free_slots:
            req = self.policy.peek()
            if req is None:
                break
            work = req.work_prompt()
            cached: List[int] = []
            cow: Optional[Tuple[int, int]] = None
            held: List[int] = []
            if self.pool.prefix is not None:
                # never match the whole prompt: the last token must be
                # prefilled so its logits exist to sample the first output
                cached, cow = self.pool.prefix.match(work[:-1])
                held = list(cached) + ([cow[0]] if cow else [])
                # pin matches BEFORE alloc — alloc may LRU-evict
                # reclaimable cached pages to satisfy the fresh lease
                self.pool.retain(held)
            need = self.pool.pages_for(req.work_len) - len(cached)
            pages = self.pool.alloc(need)
            if pages is None and cow is not None:
                # the pinned COW source inflates peak demand by one page
                # beyond the admission arithmetic (pages_for(work_len));
                # for a request sized to the remaining pool that ONE page
                # can make alloc fail forever — drop the partial match
                # (full-page matches only ever reduce demand) and retry
                self.pool.release([cow[0]])
                held, cow = list(cached), None
                pages = self.pool.alloc(need)
            if pages is None:
                if held:
                    self.pool.release(held)
                break
            matched = len(cached) * self.pool.page_size + \
                (cow[1] if cow else 0)
            popped = self.policy.pop()
            if popped is not req:           # peek/pop must agree
                raise AssertionError(
                    "scheduler policy popped a different request than it "
                    "peeked — admission page arithmetic is now wrong")
            self.policy.on_admit(req)
            slot = self._free_slots.pop()
            admissions.append(Admission(slot=slot, request=req, pages=pages,
                                        cached=cached, cow=cow,
                                        matched=matched))
        return admissions

    def release(self, slot: int, pages: List[int],
                request: Optional[Request] = None) -> None:
        """A request finished (or was preempted): its slot frees and
        every page reference it held drops (shared prefix pages simply
        lose one reference; pages reaching refcount 0 return to the free
        list unless the prefix index keeps them reclaimable).  ``request``
        lets the policy drop its residency accounting."""
        if slot in self._free_slots:
            raise ValueError(f"double release of slot {slot}")
        self.pool.release(pages)
        self._free_slots.append(slot)
        if request is not None:
            self.policy.on_release(request)

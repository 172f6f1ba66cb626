"""FCFS continuous-batching scheduler (Orca, OSDI '22 + Sarathi, OSDI '24).

Own copy of ``paddle_tpu/serving/scheduler.py`` for the PyTorch port,
without the tenant accounting of weighted fair queueing (not ported yet).

The scheduler owns the WAITING queue, the slot occupancy map and the
per-step token budget; the engine owns the device work.  Every engine
step asks :meth:`FCFSScheduler.schedule_step` which requests to admit
into freed slots, then runs at most ``prefill_budget`` tokens of prefill
plus one decode step over all started slots.

Admission costs only the pages the PROMPT needs (matched prefix pages are
retained instead of allocated, a partial-tail match becomes a
copy-on-write candidate); decode grows the block table on demand, and
the engine preempts the youngest slot when growth fails — the oldest
admitted request is never a victim, so the system always progresses.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import numpy as np

from .kv_pool import KVPool
from .tenancy import SchedulerPolicy, make_policy

_next_rid = itertools.count()


@dataclass(eq=False)
class Request:
    """One generation request: token ids in, up to ``max_new_tokens`` out.
    Identity equality: requests are stateful queue members.

    ``deadline_s`` (optional) expires the request ``deadline_s`` engine-
    clock seconds after enqueue, in ANY state.  ``generated`` holds every
    token produced so far and SURVIVES preemption — a preempted request
    re-enters the queue carrying its continuation, and the engine
    re-prefills ``work_prompt`` (prompt + generated) before decoding the
    remaining ``remaining_new`` tokens, so the final output is identical
    to an unpreempted run under greedy sampling."""

    prompt: np.ndarray
    max_new_tokens: int
    rid: int = field(default_factory=lambda: next(_next_rid))
    deadline_s: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # lifecycle state: tokens generated so far (kept across
        # preemption), preemption count, enqueue time on the engine's
        # clock, and the admission seq — set at FIRST admission and kept,
        # so the globally oldest request is never a preemption victim
        self.generated: List[int] = []
        self.n_preempted = 0
        self.t_enqueue = 0.0
        self.seq: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def total_len(self) -> int:
        """Worst-case positions ever needed — invariant under preemption."""
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
    """Iteration-level admission over a fixed slot array."""

    def __init__(self, n_slots: int, pool: KVPool,
                 token_budget: Optional[int] = None,
                 policy: Union[None, str, SchedulerPolicy] = None):
        self.n_slots = n_slots
        self.pool = pool
        # default budget: every slot decoding plus one flagship-sized
        # prefill chunk per step
        self.token_budget = token_budget or (n_slots + 512)
        self.policy: SchedulerPolicy = make_policy(policy)
        self._free_slots: List[int] = list(range(n_slots - 1, -1, -1))

    # -- queue ------------------------------------------------------------

    @property
    def waiting(self) -> List[Request]:
        """Every waiting request in queue order (a fresh list)."""
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
        admitted before anything still waiting."""
        self.policy.requeue_head(request)

    def remove_waiting(self, rid: int) -> Optional[Request]:
        """Remove and return the waiting request with ``rid`` (cancel),
        or None if it is not queued."""
        return self.policy.remove(rid)

    def pop_expired(self, now: float) -> List[Request]:
        """Drop every waiting request whose deadline has passed."""
        return self.policy.pop_expired(now)

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
        ``decode_cost`` tokens per active decode, capped at the engine's
        chunk width and floored at 1 so prefill always progresses.
        ``decode_cost`` is 1 for plain decode; a speculative engine
        reserves ``spec_k + 1`` per decoding slot, since its verify step
        scores that many positions whether or not they are accepted."""
        return max(1, min(chunk_tokens,
                          self.token_budget - n_decoding * decode_cost))

    def schedule_step(self) -> List[Admission]:
        """Admit from the queue into free slots until slots or pages run
        out.  Head-of-line blocking is intentional: if the head's pages
        don't fit we stop.  Page demand covers the WORK PROMPT only;
        prefix-cache matches are retained (shared) instead of allocated
        and a partial-tail match rides along as the COW candidate."""
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
                # the pinned COW source inflates peak demand by one page;
                # for a request sized to the remaining pool that page can
                # make alloc fail forever — drop the partial match, retry
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
            if popped is not req:
                raise AssertionError(
                    "scheduler policy popped a different request than it "
                    "peeked — admission page arithmetic is now wrong")
            slot = self._free_slots.pop()
            admissions.append(Admission(slot=slot, request=req, pages=pages,
                                        cached=cached, cow=cow,
                                        matched=matched))
        return admissions

    def release(self, slot: int, pages: List[int]) -> None:
        """A request finished (or was preempted): its slot frees and every
        page reference it held drops."""
        if slot in self._free_slots:
            raise ValueError(f"double release of slot {slot}")
        self.pool.release(pages)
        self._free_slots.append(slot)

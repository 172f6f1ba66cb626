"""Multi-tenant scheduling policies for the serving engine.

Counterpart of ``paddle_tpu/serving/tenancy.py``: the same tenants,
weights, quotas and arrivals give the same admission order, the same
virtual-token counters and the same quota rejections in both packages.

Without a policy the engine admits strictly FCFS: one deque, one
queue-head, head-of-line blocking by design.  That is the right default
for parity tests (admission order is trivially deterministic) but has no
notion of WHO a request belongs to — one tenant flooding the queue
starves everyone else, which is exactly the failure mode a multi-tenant
front end (serving/frontend.py) must not have.

This module extracts the waiting-queue half of the scheduler into a
pluggable :class:`SchedulerPolicy` (pop / peek / requeue-at-head — the
three operations ``FCFSScheduler`` and the engine's preempt-and-recompute
path actually use) and adds a weighted-fair-queueing policy on the
Virtual Token Counter shape (Sheng et al., "Fairness in Serving Large
Language Models", OSDI '24):

  * every tenant owns a FIFO queue (FCFS *within* a tenant) and a
    **virtual token counter** — total tokens served on the tenant's
    behalf divided by its weight;
  * admission picks the eligible tenant with the LOWEST counter (ties
    break deterministically), so over time served tokens converge to the
    weight ratio — the Sarathi/Orca per-step token budget is unchanged,
    WFQ only decides *whose* request the budget admits next;
  * both prefill and decode tokens charge the counter (the engine calls
    :meth:`SchedulerPolicy.charge` with first-time-served token deltas —
    a preempted request's recompute is NOT re-charged, see
    ``Request.uncharged_tokens``);
  * a tenant going idle and returning has its counter LIFTED to the
    minimum over active tenants, so banked idle time cannot be spent
    starving everyone later (the VTC no-starvation lift);
  * per-tenant quotas: ``max_resident`` caps concurrent slots (the
    tenant stays queued past it), ``max_waiting`` caps queue depth
    (overflow becomes an explicit ``rejected`` terminal — per-tenant
    backpressure, same shape as the engine's global ``max_queue``);
  * ``priority`` is a strict tier above the counters: a higher-priority
    tenant with waiting work always admits first (use sparingly — within
    a tier, weights share).

FCFS stays the DEFAULT policy (``FCFSPolicy`` reproduces the original
deque semantics operation-for-operation), so every existing parity /
preemption / snapshot / chaos test runs unmodified.
"""

from __future__ import annotations

from collections import Counter as _Tally
from collections import deque
from dataclasses import asdict, dataclass
from typing import Deque, Dict, Iterable, Iterator, List, Optional, Union

__all__ = ["DEFAULT_TENANT", "TenantConfig", "SchedulerPolicy",
           "FCFSPolicy", "WFQPolicy", "ClusterWFQState",
           "normalize_tenants", "make_policy"]

#: Requests carrying no tenant name account under this one.
DEFAULT_TENANT = "default"


@dataclass
class TenantConfig:
    """Per-tenant scheduling knobs.

    ``weight`` — share of served tokens relative to other tenants in the
    same priority tier (2.0 gets twice the tokens of 1.0 under
    contention); ``priority`` — strict admission tier, higher first;
    ``max_resident`` — max concurrently admitted requests (slot quota);
    ``max_waiting`` — max queued requests (per-tenant backpressure;
    overflow rejects at enqueue).

    SLO targets (all optional — a tenant without them costs no
    metric series): ``ttft_slo_s`` budgets time-to-first-token,
    ``e2e_slo_s`` budgets enqueue-to-terminal latency; each terminal is
    judged against the set budgets and feeds the per-tenant attainment
    gauge and fast/slow burn-rate windows
    (:class:`~paddle_tpu_torch.serving.metrics.SLOTracker`).
    ``slo_objective`` is the attainment target the error budget derives
    from (0.99 → a 1% budget)."""

    weight: float = 1.0
    priority: int = 0
    max_resident: Optional[int] = None
    max_waiting: Optional[int] = None
    ttft_slo_s: Optional[float] = None
    e2e_slo_s: Optional[float] = None
    slo_objective: float = 0.99

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.max_resident is not None and self.max_resident < 1:
            raise ValueError("max_resident must be >= 1")
        if self.max_waiting is not None and self.max_waiting < 0:
            raise ValueError("max_waiting must be >= 0")
        if self.ttft_slo_s is not None and self.ttft_slo_s <= 0:
            raise ValueError("ttft_slo_s must be > 0")
        if self.e2e_slo_s is not None and self.e2e_slo_s <= 0:
            raise ValueError("e2e_slo_s must be > 0")
        if not 0.0 < self.slo_objective < 1.0:
            raise ValueError(
                f"slo_objective must be in (0, 1), got {self.slo_objective}")


def normalize_tenants(tenants) -> Dict[str, TenantConfig]:
    """Accept ``{name: TenantConfig | dict | weight-number}`` (the shapes
    a ctor echo / CLI flag / snapshot produce) and return proper
    configs."""
    out: Dict[str, TenantConfig] = {}
    for name, cfg in (tenants or {}).items():
        if isinstance(cfg, TenantConfig):
            out[name] = cfg
        elif isinstance(cfg, dict):
            out[name] = TenantConfig(**cfg)
        else:
            out[name] = TenantConfig(weight=float(cfg))
    return out


class SchedulerPolicy:
    """Waiting-queue policy contract used by ``FCFSScheduler``.

    The scheduler owns slots/pages/budget arithmetic; the policy owns
    ONLY queue order and tenant accounting.  The operations mirror what
    the original deque supported: ``push`` (arrival), ``peek``/``pop``
    (admission — ``pop`` must return exactly the request the immediately
    preceding ``peek`` returned), ``requeue_head`` (a preempted request
    goes back in FRONT of its queue), ``remove`` (cancel),
    ``pop_expired`` (deadline sweep).  ``charge``/``on_admit``/
    ``on_release`` are accounting hooks that FCFS ignores."""

    name = "abstract"

    # -- queue order ------------------------------------------------------

    def push(self, req) -> None:
        raise NotImplementedError

    def requeue_head(self, req) -> None:
        raise NotImplementedError

    def peek(self):
        raise NotImplementedError

    def pop(self):
        raise NotImplementedError

    def remove(self, rid: int):
        raise NotImplementedError

    def pop_expired(self, now: float) -> List:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator:
        raise NotImplementedError

    def load_waiting(self, reqs: Iterable) -> None:
        """Restore path (serving/snapshot.py): re-enqueue in iteration
        order WITHOUT arrival side effects (idle lifts, quota checks) —
        counters load separately via :meth:`load_state`."""
        for req in reqs:
            self.push(req)

    # -- tenant accounting (no-ops for FCFS) ------------------------------

    def quota_reject(self, tenant: Optional[str]) -> bool:
        """True when an arriving request for ``tenant`` must be rejected
        (per-tenant backpressure).  Consulted by the engine BEFORE
        ``push``."""
        return False

    def on_admit(self, req) -> None:
        pass

    def on_release(self, req) -> None:
        """The request left its slot — terminal OR preemption."""
        pass

    def charge(self, req, n_tokens: int) -> None:
        """``n_tokens`` of first-time service (prefill positions + decode
        tokens) were delivered for ``req`` — charged against the Orca/
        Sarathi token budget already spent by the engine."""
        pass

    # -- snapshot ---------------------------------------------------------

    def to_state(self) -> dict:
        return {"name": self.name}

    def load_state(self, st: dict) -> None:
        pass

    def check(self, resident_requests: List) -> None:
        """Internal-consistency audit (engine.check_invariants)."""
        pass


class FCFSPolicy(SchedulerPolicy):
    """The original deque, verbatim: global arrival order, head-of-line
    blocking, preempted requests requeue at the head."""

    name = "fcfs"

    def __init__(self):
        self.queue: Deque = deque()

    def push(self, req) -> None:
        self.queue.append(req)

    def requeue_head(self, req) -> None:
        self.queue.appendleft(req)

    def peek(self):
        return self.queue[0] if self.queue else None

    def pop(self):
        return self.queue.popleft()

    def remove(self, rid: int):
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                return req
        return None

    def pop_expired(self, now: float) -> List:
        expired = [r for r in self.queue if r.expired(now)]
        for req in expired:
            self.queue.remove(req)
        return expired

    def __len__(self) -> int:
        return len(self.queue)

    def __iter__(self) -> Iterator:
        return iter(self.queue)


class ClusterWFQState(object):
    """Router-global WFQ ledger: ONE virtual-counter dict + tenant
    config map shared by every replica's :class:`WFQPolicy` in a
    multi-replica cluster, plus the member list that makes activity and
    quota checks cluster-wide.  Each member policy still owns its LOCAL
    queue and residency (a request waits/runs on exactly one replica),
    but ``charge`` lands on the shared counters — so
    ``vt[tenant] == total served tokens / weight`` ACROSS the cluster,
    and tenant fairness holds no matter which replica served the tokens.
    Build one state, pass ``WFQPolicy(state=...)`` per engine
    (``serving.router.make_cluster`` does this wiring)."""

    def __init__(self, tenants=None):
        self.tenants: Dict[str, TenantConfig] = normalize_tenants(tenants)
        self.vt: Dict[str, float] = {}
        self.members: List["WFQPolicy"] = []


class WFQPolicy(SchedulerPolicy):
    """Weighted fair queueing over per-tenant virtual token counters.

    ``tenants`` maps tenant name -> :class:`TenantConfig` (or a bare
    weight number); tenants not named get ``TenantConfig()`` lazily on
    first arrival, so the policy never rejects an unknown tenant — it
    just shares at weight 1.

    ``state`` plugs this policy into a shared
    :class:`ClusterWFQState`: counters and tenant configs ALIAS the
    shared dicts, and activity / idle-lift / quota checks consider every
    member replica — a tenant busy on replica A is not "idle" (no unfair
    counter lift) and not under-quota (no double admission) on replica
    B.  A standalone policy is just a one-member cluster, so the
    single-engine semantics are unchanged."""

    name = "wfq"

    def __init__(self, tenants=None, state: Optional[ClusterWFQState] = None):
        self._state = state
        if state is not None:
            if tenants:
                raise ValueError(
                    "pass tenants to the ClusterWFQState, not to member "
                    "policies — one config map per cluster")
            # alias, don't copy: every member reads/writes the ONE ledger
            self.tenants = state.tenants
            self.vt = state.vt
            state.members.append(self)
        else:
            self.tenants = normalize_tenants(tenants)
            self.vt = {}                     # served tokens / weight
        self.queues: Dict[str, Deque] = {}
        self.resident: Dict[str, int] = {}   # requests currently in slots

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def tenant_of(req) -> str:
        return getattr(req, "tenant", None) or DEFAULT_TENANT

    def config(self, tenant: str) -> TenantConfig:
        cfg = self.tenants.get(tenant)
        if cfg is None:
            cfg = self.tenants[tenant] = TenantConfig()
        return cfg

    def _queue(self, tenant: str) -> Deque:
        q = self.queues.get(tenant)
        if q is None:
            q = self.queues[tenant] = deque()
            self.vt.setdefault(tenant, 0.0)
            self.resident.setdefault(tenant, 0)
        return q

    def _peers(self) -> List["WFQPolicy"]:
        """Every policy sharing this ledger (just self when standalone):
        activity, lifts and quotas are judged over the whole cluster."""
        return self._state.members if self._state is not None else [self]

    def _active(self, tenant: str) -> bool:
        """Waiting or resident work ANYWHERE in the cluster — the tenant
        is consuming/contending."""
        return any(bool(p.queues.get(tenant))
                   or p.resident.get(tenant, 0) > 0
                   for p in self._peers())

    def _resident_total(self, tenant: str) -> int:
        """Cluster-wide slots the tenant holds (max_resident quota)."""
        return sum(p.resident.get(tenant, 0) for p in self._peers())

    def _waiting_total(self, tenant: str) -> int:
        """Cluster-wide queue depth for the tenant (max_waiting quota)."""
        return sum(len(p.queues.get(tenant, ())) for p in self._peers())

    def _eligible(self) -> Optional[str]:
        """The tenant whose queue head admits next: highest priority
        tier, then lowest virtual counter, then name (deterministic).
        Slot-quota-blocked tenants are skipped — their requests wait
        without blocking anyone else's admission."""
        best = None
        for t, q in self.queues.items():
            if not q:
                continue
            cfg = self.config(t)
            if cfg.max_resident is not None and \
                    self._resident_total(t) >= cfg.max_resident:
                continue
            key = (-cfg.priority, self.vt.get(t, 0.0), t)
            if best is None or key < best[0]:
                best = (key, t)
        return best[1] if best is not None else None

    # -- queue order ------------------------------------------------------

    def push(self, req) -> None:
        t = self.tenant_of(req)
        was_idle = not self._active(t)
        q = self._queue(t)
        if was_idle:
            # the VTC lift: an idle tenant's counter stopped moving while
            # active tenants' kept rising — raise it to the smallest
            # active counter so banked idle time is not a starvation
            # weapon.  (Never lowered: a tenant ahead of the pack stays
            # ahead by exactly its surplus.)  Active spans queued AND
            # resident-only tenants — after a snapshot restore a tenant
            # can be fully in slots with no queue entry yet.  Under a
            # shared cluster ledger "active" and the candidate set span
            # every member replica: a tenant mid-flight on another
            # replica both blocks the lift for itself and anchors it for
            # others.
            names = set()
            for p in self._peers():
                names |= set(p.queues) | set(p.resident)
            active = [self.vt.get(u, 0.0) for u in names
                      if u != t and self._active(u)]
            if active:
                self.vt[t] = max(self.vt.get(t, 0.0), min(active))
        q.append(req)

    def requeue_head(self, req) -> None:
        """A PREEMPTED request: front of its tenant's queue (it predates
        everything the tenant still has waiting).  No idle lift — the
        tenant was resident a moment ago, and its counter must carry
        over unchanged so recompute is not double-charged."""
        self._queue(self.tenant_of(req)).appendleft(req)

    def peek(self):
        t = self._eligible()
        return self.queues[t][0] if t is not None else None

    def pop(self):
        t = self._eligible()
        if t is None:
            raise IndexError("pop from an empty/blocked WFQ policy")
        return self.queues[t].popleft()

    def remove(self, rid: int):
        for q in self.queues.values():
            for req in q:
                if req.rid == rid:
                    q.remove(req)
                    return req
        return None

    def pop_expired(self, now: float) -> List:
        expired = []
        for q in self.queues.values():
            for req in [r for r in q if r.expired(now)]:
                q.remove(req)
                expired.append(req)
        return expired

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def __iter__(self) -> Iterator:
        """Deterministic order (snapshot / invariants): tenants by name,
        FIFO within each."""
        for t in sorted(self.queues):
            yield from self.queues[t]

    # -- tenant accounting ------------------------------------------------

    def quota_reject(self, tenant: Optional[str]) -> bool:
        t = tenant or DEFAULT_TENANT
        # read-only: a rejected arrival must not mint permanent tenant
        # state (unknown tenants have no quota to exceed anyway).  The
        # depth is CLUSTER-wide under a shared ledger — max_waiting is a
        # per-tenant promise, not a per-replica one.
        cfg = self.tenants.get(t)
        return cfg is not None and cfg.max_waiting is not None and \
            self._waiting_total(t) >= cfg.max_waiting

    def on_admit(self, req) -> None:
        t = self.tenant_of(req)
        self.resident[t] = self.resident.get(t, 0) + 1

    def on_release(self, req) -> None:
        t = self.tenant_of(req)
        n = self.resident.get(t, 0) - 1
        if n < 0:
            raise AssertionError(
                f"tenant {t!r} released more requests than admitted")
        self.resident[t] = n

    def charge(self, req, n_tokens: int) -> None:
        t = self.tenant_of(req)
        self.vt[t] = self.vt.get(t, 0.0) + n_tokens / self.config(t).weight

    # -- snapshot ---------------------------------------------------------

    def to_state(self) -> dict:
        return {"name": self.name,
                "vt": dict(self.vt),
                "tenants": {t: asdict(c) for t, c in self.tenants.items()}}

    def load_state(self, st: dict) -> None:
        if st.get("name") != self.name:
            raise ValueError(
                f"policy state is {st.get('name')!r}, engine runs {self.name}")
        for t, cfg in normalize_tenants(st.get("tenants")).items():
            self.tenants.setdefault(t, cfg)
        self.vt.update({t: float(v) for t, v in st.get("vt", {}).items()})

    def check(self, resident_requests: List) -> None:
        actual = _Tally(self.tenant_of(r) for r in resident_requests)
        for t, n in self.resident.items():
            if n != actual.get(t, 0):
                raise AssertionError(
                    f"tenant {t!r} resident count {n} != {actual.get(t, 0)} "
                    "requests actually in slots")
            if n < 0:
                raise AssertionError(f"negative resident count for {t!r}")
        for t, v in self.vt.items():
            if not (v >= 0.0):                 # catches NaN too
                raise AssertionError(f"tenant {t!r} virtual counter {v}")
        for t, cfg in self.tenants.items():
            if cfg.max_resident is not None and \
                    actual.get(t, 0) > cfg.max_resident:
                raise AssertionError(
                    f"tenant {t!r} holds {actual.get(t, 0)} slots over "
                    f"its quota {cfg.max_resident}")


def make_policy(policy: Union[None, str, SchedulerPolicy],
                tenants=None) -> SchedulerPolicy:
    """Resolve the engine's ``policy=``/``tenants=`` ctor knobs: None
    defaults to FCFS unless tenants are configured (then WFQ — naming
    tenants means wanting isolation); strings name the built-ins; an
    instance passes through (snapshot/restore cannot rebuild instances —
    prefer the names)."""
    if isinstance(policy, SchedulerPolicy):
        return policy
    if policy is None:
        policy = "wfq" if tenants else "fcfs"
    if policy == "fcfs":
        if tenants:
            raise ValueError(
                "tenants= requires the wfq policy (FCFS has no tenant "
                "accounting) — pass policy='wfq' or drop tenants")
        return FCFSPolicy()
    if policy == "wfq":
        return WFQPolicy(tenants)
    raise ValueError(f"unknown scheduler policy {policy!r}")

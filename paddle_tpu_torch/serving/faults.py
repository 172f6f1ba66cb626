"""Deterministic fault injection for the serving engine (chaos harness).

Counterpart of ``paddle_tpu/serving/faults.py``, numpy only: the same
seed draws the same schedule in both packages, bit for bit.

Production serving dies in ways unit tests never exercise: the allocator
comes up empty under a burst, a device step throws mid-flight, one step
stalls long enough for deadlines to blow.  This module scripts those
faults DETERMINISTICALLY — a :class:`FaultPlan` is a step-indexed
schedule derived from one RNG seed, so a chaos run that trips an
invariant replays bit-for-bit from its seed.

Wiring (chosen so no fault can land at an inconsistent point):

  * **alloc failures** — ``KVPool.alloc`` consults ``pool.faults`` FIRST
    and returns None for every call in a scripted step, exactly the
    signal real exhaustion produces.  Admission backs off (the request
    stays queued); decode page growth stalls the slot for the step when
    the pool could actually satisfy the lease (a transient fault must
    not cascade preemptions), and walks the preemption path only under
    real pressure.
  * **step exceptions** — ``ServingEngine.step`` calls
    ``plan.check_raise(phase)`` at its three phase boundaries
    (``admit`` / ``prefill`` / ``decode``), where host mirrors, slots and
    pool bookkeeping are consistent; :class:`InjectedFault` aborts the
    rest of the iteration and the engine resumes next step (counted in
    ``stats["step_faults"]``).
  * **step latency** — the plan owns a VIRTUAL clock advanced by
    ``step_tick_s`` plus any scripted per-step latency at
    ``begin_step``; an engine built with a plan reads deadlines off that
    clock, so expiry under slowdown is reproducible and test-fast (no
    real sleeping).  The same clock drives the engine's request-time
    METRICS (queue-wait / TTFT / TBT / e2e histograms,
    serving/metrics.py), so under a plan those readouts are
    bit-deterministic — asserted by the chaos suite.

The chaos acceptance contract (tests/test_torch_serving_faults.py): under ANY
seeded plan every request reaches exactly one terminal state
(finished / rejected / expired / cancelled), ``check_invariants`` holds
after every step, and drain leaves zero pages in use.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Set

import numpy as np

#: The engine's intra-step injection points, in execution order.
#: "verify" fires INSIDE a speculative decode step — after drafts
#: are proposed and pages grown, before the verify dispatch — so chaos
#: runs exercise the draft-buffers-populated-but-unverified state; a
#: non-speculative engine never reaches it (the fault stays silent).
#: "handoff" fires in a PREFILL-role engine's handoff phase and
#: models the transfer fabric dropping that step's page payloads: the
#: handoff DEGRADES (the request ships without KV and re-prefills on the
#: decode replica) instead of aborting the step, so disaggregated chaos
#: runs exercise the recompute fallback.  Engines that never hand off
#: (role "both"/"decode") never reach it — the fault stays silent, like
#: "verify" on a non-speculative engine.
PHASES = ("admit", "prefill", "handoff", "verify", "decode")


class InjectedFault(RuntimeError):
    """A scripted mid-step failure (stands in for a device fault).  The
    engine catches it at the phase boundary that raised it, abandons the
    rest of the iteration, and carries on next step."""


class FaultPlan:
    """A step-indexed, seed-reproducible fault schedule.

    ``alloc_fail_steps`` — steps in which every ``KVPool.alloc`` fails;
    ``raise_steps``      — ``{step: phase}`` injected step exceptions;
    ``latency_s``        — ``{step: seconds}`` extra virtual step time;
    ``step_tick_s``      — base virtual time every step advances.

    ``injected`` counts what actually fired, for test assertions.
    """

    def __init__(self, seed: int = 0,
                 alloc_fail_steps: Iterable[int] = (),
                 raise_steps: Optional[Dict[int, str]] = None,
                 latency_s: Optional[Dict[int, float]] = None,
                 step_tick_s: float = 1e-3):
        self.seed = seed
        self.alloc_fail_steps: Set[int] = set(alloc_fail_steps)
        self.raise_steps: Dict[int, str] = dict(raise_steps or {})
        for phase in self.raise_steps.values():
            if phase not in PHASES:
                raise ValueError(f"unknown fault phase {phase!r}")
        self.latency_s: Dict[int, float] = dict(latency_s or {})
        self.step_tick_s = float(step_tick_s)
        self.step = 0
        self.clock = 0.0
        self.injected = {"alloc_fail": 0, "raise": 0, "latency_s": 0.0}

    @classmethod
    def random(cls, seed: int, n_steps: int = 64, p_alloc: float = 0.12,
               p_raise: float = 0.06, p_latency: float = 0.10,
               max_latency_s: float = 0.05,
               step_tick_s: float = 1e-3) -> "FaultPlan":
        """Draw a schedule over steps ``1..n_steps`` from one seed.  The
        horizon is FINITE by design: past it the plan is silent, so a
        chaos run always converges once the scripted trouble ends."""
        rng = np.random.RandomState(seed)
        alloc: Set[int] = set()
        raises: Dict[int, str] = {}
        lat: Dict[int, float] = {}
        for i in range(1, n_steps + 1):
            if rng.rand() < p_alloc:
                alloc.add(i)
            if rng.rand() < p_raise:
                raises[i] = PHASES[rng.randint(len(PHASES))]
            if rng.rand() < p_latency:
                lat[i] = float(rng.rand() * max_latency_s)
        return cls(seed=seed, alloc_fail_steps=alloc, raise_steps=raises,
                   latency_s=lat, step_tick_s=step_tick_s)

    # -- engine hooks -----------------------------------------------------

    def begin_step(self, step_idx: int) -> None:
        """Advance the virtual clock into ``step_idx`` (base tick + any
        scripted latency) and arm this step's faults."""
        self.step = step_idx
        extra = self.latency_s.get(step_idx, 0.0)
        self.clock += self.step_tick_s + extra
        self.injected["latency_s"] += extra

    def now(self) -> float:
        """The virtual clock — engines built with a plan read deadlines
        off this instead of ``time.monotonic``."""
        return self.clock

    def fail_alloc(self) -> bool:
        """True when the current step scripts allocator exhaustion
        (consulted by ``KVPool.alloc`` before touching the free list)."""
        if self.step in self.alloc_fail_steps:
            self.injected["alloc_fail"] += 1
            return True
        return False

    def check_raise(self, phase: str) -> None:
        """Raise :class:`InjectedFault` if the current step scripts an
        exception at ``phase``."""
        if self.raise_steps.get(self.step) == phase:
            self.injected["raise"] += 1
            raise InjectedFault(
                f"injected fault at step {self.step} ({phase})")

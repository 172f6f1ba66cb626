"""Flight recorder: a bounded black box of per-step engine decisions.

Counterpart of ``paddle_tpu/serving/flight_recorder.py``: the same records
give the same canonical JSON dump, byte for byte.

Counters say HOW OFTEN the engine preempted; they cannot say WHICH
request was evicted at step 412, by whom, or why.  The flight recorder
keeps the last N structured decision records — admissions, preemptions
with victim + reason, handoffs in/out with byte counts, alloc failures,
window recycles, injected faults, terminals — in a ring buffer stamped
on the ENGINE clock (the FaultPlan virtual clock under chaos), so two
replays of the same seeded chaos plan produce byte-identical dumps.

``engine.dump_debug()`` returns the buffer as part of a debug snapshot;
a real exception escaping ``engine.step()`` (the re-park path)
dumps it to ``metrics_dir/flight_crash.json`` before re-raising, so
every postmortem starts with the black box, not a stack trace alone.

Dependency-free (stdlib ``collections`` + scoped ``json``), default-off
(``ServingEngine(flight=True)``), O(1) per record.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Callable, Optional

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring buffer of structured decision records.

    ``capacity`` bounds memory (oldest records drop first; ``dropped``
    counts them).  ``clock`` is the seconds source records are stamped
    with — the engine passes its own, so chaos replays under the
    virtual clock are bit-deterministic.
    """

    def __init__(self, capacity: int = 1024,
                 clock: Optional[Callable[[], float]] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        # sanctioned fallback binding: attach_flight always injects the
        # engine clock; a standalone recorder defaults to real time
        self._clock = clock or time.monotonic  # graftlint: allow=determinism
        self._t0 = self._clock()
        self._records = collections.deque(maxlen=self.capacity)
        self.recorded = 0

    @property
    def dropped(self) -> int:
        return self.recorded - len(self._records)

    def record(self, kind: str, step: int, **fields) -> None:
        """Append one decision record; O(1), oldest-first eviction."""
        rec = {"kind": kind, "step": int(step),
               "t": round(self._clock() - self._t0, 9)}
        rec.update(fields)
        self._records.append(rec)
        self.recorded += 1

    def __len__(self) -> int:
        return len(self._records)

    def to_json(self) -> dict:
        return {"capacity": self.capacity,
                "recorded": self.recorded,
                "dropped": self.dropped,
                "records": list(self._records)}

    def dumps(self) -> str:
        """Canonical JSON text: sorted keys, compact separators — two
        replays of one chaos seed compare byte-for-byte."""
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.dumps())
        return path

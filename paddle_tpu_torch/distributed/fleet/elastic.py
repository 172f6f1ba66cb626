"""Elastic training: membership and a heartbeat watchdog over a file
store.

Counterpart of ``paddle_tpu/distributed/fleet/elastic.py``.  The store is
a directory (shared by the nodes; local for one node): a rank heartbeats
by touching ``{store}/rank_{i}``, the launcher's watcher flags a rank
whose heartbeat is older than ``timeout`` seconds, and
:func:`~paddle_tpu_torch.distributed.launch_utils.run_elastic` restarts
the world.  ``PADDLE_ELASTIC_STORE`` / ``PADDLE_ELASTIC_TIMEOUT`` /
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` give the defaults.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import List, Optional

__all__ = ["ElasticStatus", "ElasticManager"]


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """File-store membership and heartbeat watchdog."""

    def __init__(self, store_dir: Optional[str] = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 timeout: float = 30.0):
        self.store = store_dir or os.environ.get(
            "PADDLE_ELASTIC_STORE",
            os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_elastic"))
        self.rank = rank if rank is not None else int(
            os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.world_size = world_size if world_size is not None else int(
            os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.timeout = float(
            os.environ.get("PADDLE_ELASTIC_TIMEOUT", timeout))
        os.makedirs(self.store, exist_ok=True)
        self._stop_beat = None

    @property
    def enabled(self) -> bool:
        """Elastic is on when the environment asks for it."""
        return bool(os.environ.get("PADDLE_ELASTIC_NP")
                    or os.environ.get("PADDLE_ELASTIC_STORE"))

    def _hb_path(self, rank: int) -> str:
        return os.path.join(self.store, f"rank_{rank}")

    def register(self) -> None:
        """Join the membership (the first heartbeat)."""
        self.beat()

    def beat(self) -> None:
        """One heartbeat: the rank file's mtime moved to now."""
        p = self._hb_path(self.rank)
        with open(p, "a"):
            os.utime(p, None)

    def exit(self) -> None:
        """Leave cleanly (no failure flagged for this rank)."""
        try:
            os.remove(self._hb_path(self.rank))
        except FileNotFoundError:
            pass

    def _ages(self):
        now = time.time()
        for r in range(self.world_size):
            try:
                yield r, now - os.path.getmtime(self._hb_path(r))
            except FileNotFoundError:
                continue        # never registered, or left cleanly

    def alive_ranks(self) -> List[int]:
        return [r for r, age in self._ages() if age <= self.timeout]

    def failed_ranks(self) -> List[int]:
        """Ranks that registered and stopped heartbeating."""
        return [r for r, age in self._ages() if age > self.timeout]

    def watch(self) -> str:
        """One watchdog poll: RESTART on a stale rank, COMPLETED when
        every rank left, else HOLD."""
        if self.failed_ranks():
            return ElasticStatus.RESTART
        if not os.listdir(self.store):
            return ElasticStatus.COMPLETED
        return ElasticStatus.HOLD

    def start_beat_thread(self, interval: Optional[float] = None):
        """Heartbeat from a daemon thread every ``interval`` seconds
        (default a fifth of the timeout); returns the thread."""
        iv = interval if interval is not None else max(self.timeout / 5, 0.2)
        self.register()
        self._stop_beat = threading.Event()

        def loop(stop=self._stop_beat):
            while not stop.is_set():
                self.beat()
                stop.wait(iv)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return t

    def stop_beat_thread(self):
        if self._stop_beat is not None:
            self._stop_beat.set()

    def clear(self):
        """Empty the store (the launcher does so before each round, so a
        stale heartbeat of the last round starts no restart)."""
        for name in os.listdir(self.store):
            try:
                os.remove(os.path.join(self.store, name))
            except OSError:
                pass

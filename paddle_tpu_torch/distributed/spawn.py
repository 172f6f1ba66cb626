"""``spawn``: run ``func(*args)`` in ``nprocs`` fresh processes, one rank
each.

Counterpart of ``paddle_tpu/distributed/spawn.py``.  Each child gets the
environment of :func:`~.launch_utils.rank_env` (plus ``options["env"]``),
then runs ``func(*args)``; ``func`` must be importable by name, since the
children start from a fresh interpreter (``spawn`` start method) and
import the module that defines it.  :meth:`MultiprocessContext.join`
waits for all ranks at once and terminates the pool when the first one
fails, so a rank blocked in a collective with a dead peer cannot hang the
caller; ``options["timeout"]`` bounds the wait.  ``nprocs=-1`` (the
default, as the reference's) starts one rank per local device: one per
CUDA card, or one without a card.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback
from typing import Optional, Sequence

from .launch_utils import Cluster, find_free_port, rank_env


class MultiprocessContext:
    """The spawned ranks: :meth:`join` them, or :meth:`terminate` them."""

    def __init__(self, processes, error_queues):
        self.processes = processes
        self.error_queues = error_queues

    def terminate(self):
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        for p in self.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for every rank at once.  Returns True when all exited 0,
        False when ``timeout`` seconds passed first (the ranks keep
        running); a rank that exits non-zero terminates the others and
        raises RuntimeError with each failed rank's traceback."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            failed = [(i, p.exitcode) for i, p in enumerate(self.processes)
                      if p.exitcode not in (0, None)]
            if failed or all(p.exitcode == 0 for p in self.processes):
                break
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.05)
        if not failed:
            return True
        self.terminate()
        msgs = []
        for i, code in failed:
            err = ""
            if not self.error_queues[i].empty():
                err = self.error_queues[i].get()
            msgs.append(f"rank {i} exited with code {code}\n{err}")
        raise RuntimeError("spawn: trainer failure:\n" + "\n".join(msgs))


def _worker(func, args, env, error_queue):
    os.environ.update(env)
    try:
        func(*args)
    except KeyboardInterrupt:
        pass
    except Exception:
        error_queue.put(traceback.format_exc())
        raise


def spawn(func, args: Sequence = (), nprocs: int = -1, join: bool = True,
          daemon: bool = False, **options):
    """Start ``nprocs`` ranks of ``func(*args)`` (-1: one per local
    device, ``torch.cuda.device_count()`` or 1 without a card); returns
    the :class:`MultiprocessContext`.  With ``join`` it waits for them: at
    most ``options["timeout"]`` seconds (None: no limit), after which it
    terminates every rank and raises TimeoutError.  ``options`` also
    take ``master_port`` (default a free port), ``env`` (more environment
    for every rank) and ``start_method`` (default "spawn")."""
    if nprocs == -1:
        import torch

        nprocs = max(torch.cuda.device_count(), 1)
    if nprocs < 1:
        raise ValueError(f"spawn needs nprocs >= 1 or -1, got {nprocs}")
    timeout: Optional[float] = options.get("timeout")
    cluster = Cluster(ips=["127.0.0.1"], nproc_per_node=nprocs,
                      master="127.0.0.1",
                      master_port=int(options.get("master_port")
                                      or find_free_port()))
    ctx = mp.get_context(options.get("start_method", "spawn"))
    processes, error_queues = [], []
    for rank in range(nprocs):
        env = rank_env(cluster, rank)
        env.update(options.get("env", {}))
        q = ctx.SimpleQueue()
        p = ctx.Process(target=_worker, args=(func, tuple(args), env, q),
                        daemon=daemon)
        p.start()
        processes.append(p)
        error_queues.append(q)
    context = MultiprocessContext(processes, error_queues)
    if join:
        try:
            done = context.join(timeout)
        except BaseException:
            context.terminate()
            raise
        if not done:
            context.terminate()
            raise TimeoutError(f"spawn: {nprocs} ranks did not finish in "
                               f"{timeout} s")
    return context

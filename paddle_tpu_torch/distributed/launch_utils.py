"""Launcher plumbing: the cluster of one node's trainers, each rank's
environment, and the processes that run them.

Counterpart of ``paddle_tpu/distributed/launch_utils.py``: ``Cluster``,
``rank_env``, ``TrainerProc``, ``start_local_trainers``,
``watch_local_trainers`` (the first failure ends the rest; rc 124 on the
timeout), ``watch_local_trainers_elastic`` (a stale heartbeat also ends
the round, rc 99) and ``run_elastic`` (restart the world until a round
succeeds or the restarts run out).  The environment carries the
reference's ``PADDLE_*`` protocol, torchrun's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, which
:func:`~paddle_tpu_torch.distributed.parallel.init_parallel_env` reads,
and ``FLAGS_selected_gpus``, the card the rank drives.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


def find_free_port() -> int:
    """A TCP port on 127.0.0.1 that was free when asked (``bind(0)``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class Cluster:
    """One node's worth of trainers; ``ips`` orders the global ranks."""

    ips: List[str]
    nproc_per_node: int
    master: str
    master_port: int
    node_rank: int = 0

    @property
    def world_size(self) -> int:
        return len(self.ips) * self.nproc_per_node

    def endpoints(self) -> List[str]:
        base = self.master_port + 1
        return [f"{ip}:{base + i}" for ip in self.ips
                for i in range(self.nproc_per_node)]

    def local_ranks(self) -> List[int]:
        start = self.node_rank * self.nproc_per_node
        return list(range(start, start + self.nproc_per_node))


def rank_env(cluster: Cluster, rank: int, devices: Optional[str] = None
             ) -> Dict[str, str]:
    """The environment of global rank ``rank``."""
    eps = cluster.endpoints()
    local = rank % cluster.nproc_per_node
    dev = devices if devices is not None else str(local)
    return {
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_CURRENT_ENDPOINT": eps[rank],
        "PADDLE_TRAINERS_NUM": str(cluster.world_size),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
        "PADDLE_RANK_IN_NODE": str(local),
        "PADDLE_LOCAL_DEVICE_IDS": dev,
        "PADDLE_MASTER": cluster.master,
        "MASTER_ADDR": cluster.master,
        "MASTER_PORT": str(cluster.master_port),
        "RANK": str(rank),
        "WORLD_SIZE": str(cluster.world_size),
        "LOCAL_RANK": str(local),
        "POD_IP": cluster.ips[cluster.node_rank],
        "FLAGS_selected_gpus": dev,
    }


@dataclass
class TrainerProc:
    rank: int
    proc: subprocess.Popen
    log_path: Optional[str] = None
    log_file: Optional[object] = None


def start_local_trainers(cluster: Cluster, cmd: List[str],
                         base_env: Optional[Dict[str, str]] = None,
                         log_dir: Optional[str] = None,
                         devices: Optional[List[str]] = None
                         ) -> List[TrainerProc]:
    """Start this node's ranks of ``cmd``, each with its environment;
    with ``log_dir`` each writes ``workerlog.<rank>`` there, else into
    the launcher's own output.  ``devices``: one card id a local rank."""
    if devices and len(devices) < cluster.nproc_per_node:
        raise ValueError(
            f"--devices lists {len(devices)} device id(s) but "
            f"nproc_per_node={cluster.nproc_per_node}; provide one id per "
            f"local trainer")
    procs = []
    for rank in cluster.local_ranks():
        env = dict(base_env if base_env is not None else os.environ)
        dev = devices[rank % cluster.nproc_per_node] if devices else None
        env.update(rank_env(cluster, rank, dev))
        log_file = log_path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            log_path = os.path.join(log_dir, f"workerlog.{rank}")
            log_file = open(log_path, "w")
        p = subprocess.Popen(cmd, env=env, stdout=log_file, stderr=log_file)
        procs.append(TrainerProc(rank=rank, proc=p, log_path=log_path,
                                 log_file=log_file))
    return procs


def _poll(alive, rc, what):
    """Reap the trainers that ended; the first non-zero code is kept."""
    for rank, t in list(alive.items()):
        code = t.proc.poll()
        if code is None:
            continue
        del alive[rank]
        if code != 0:
            sys.stderr.write(
                f"{what}trainer {rank} exited with code {code}"
                + (f" (log: {t.log_path})" if t.log_path else "") + "\n")
            rc = rc or code
    return rc


def _stop(procs, alive, grace):
    """SIGTERM the trainers still alive, SIGKILL those that outlast
    ``grace`` seconds; close the logs."""
    for t in alive.values():
        try:
            t.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass
    for t in alive.values():
        try:
            t.proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            t.proc.kill()
            t.proc.wait()
    for t in procs:
        if t.log_file:
            t.log_file.close()


def watch_local_trainers(procs: List[TrainerProc],
                         timeout: Optional[float] = None) -> int:
    """Wait for every trainer; on the first failure stop the rest.  The
    first non-zero exit code, 124 when ``timeout`` seconds pass first,
    else 0."""
    deadline = time.time() + timeout if timeout else None
    alive = {t.rank: t for t in procs}
    rc = 0
    try:
        while alive:
            rc = _poll(alive, rc, "")
            if alive and rc:
                break
            if deadline and time.time() > deadline:
                sys.stderr.write("launch: timeout waiting for trainers\n")
                rc = rc or 124
                break
            time.sleep(0.2)
    finally:
        _stop(procs, alive, 10)
    return rc


def watch_local_trainers_elastic(procs: List[TrainerProc], manager,
                                 timeout: Optional[float] = None) -> int:
    """:func:`watch_local_trainers` with the ElasticManager's watchdog: a
    rank whose heartbeat went stale (hung, not crashed) also ends the
    round, with rc 99.  The caller decides whether to restart."""
    from .fleet.elastic import ElasticStatus

    deadline = time.time() + timeout if timeout else None
    alive = {t.rank: t for t in procs}
    rc = 0
    try:
        while alive:
            rc = _poll(alive, rc, "elastic: ")
            if alive and rc:
                break
            if manager.watch() == ElasticStatus.RESTART and alive:
                sys.stderr.write(
                    f"elastic: stale heartbeat from rank(s) "
                    f"{manager.failed_ranks()}, restarting the world\n")
                rc = rc or 99
                break
            if deadline and time.time() > deadline:
                sys.stderr.write("elastic: round timeout\n")
                rc = rc or 124
                break
            time.sleep(0.2)
    finally:
        # a short grace: restarting the world wants the round gone
        _stop(procs, alive, 3)
    return rc


def run_elastic(cluster: Cluster, cmd: List[str],
                base_env: Optional[Dict[str, str]] = None,
                log_dir: Optional[str] = None,
                devices: Optional[List[str]] = None,
                max_restarts: int = 3,
                timeout: Optional[float] = None) -> int:
    """Restart the world until a round succeeds: any rank failing ends
    the round, and the whole job starts again under the same environment
    (``PADDLE_JOB_ID``), resuming from its auto_checkpoint state.  After
    ``max_restarts`` restarts the last round's code is returned."""
    from .fleet.elastic import ElasticManager

    env = dict(base_env if base_env is not None else os.environ)
    store = env.setdefault(
        "PADDLE_ELASTIC_STORE",
        os.path.join(log_dir or tempfile.gettempdir(),
                     "paddle_tpu_torch_elastic_store"))
    manager = ElasticManager(store_dir=store, rank=-1,
                             world_size=cluster.world_size)
    restarts = 0
    while True:
        manager.clear()
        attempt_log = (os.path.join(log_dir, f"attempt_{restarts}")
                       if log_dir else None)
        procs = start_local_trainers(cluster, cmd, base_env=env,
                                     log_dir=attempt_log, devices=devices)
        rc = watch_local_trainers_elastic(procs, manager, timeout=timeout)
        if rc == 0:
            return 0
        restarts += 1
        if restarts > max_restarts:
            sys.stderr.write(f"elastic: giving up after {max_restarts} "
                             f"restart(s), rc={rc}\n")
            return rc
        sys.stderr.write(f"elastic: restarting the world (attempt "
                         f"{restarts}/{max_restarts})\n")
        time.sleep(1.0)

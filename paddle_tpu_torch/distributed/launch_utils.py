"""What :func:`~paddle_tpu_torch.distributed.spawn.spawn` needs of the
launcher: a free port, the cluster of one node's ranks, and each rank's
environment.

Counterpart of the parts of ``paddle_tpu/distributed/launch_utils.py``
that its ``spawn`` uses (``find_free_port``, ``Cluster``, ``rank_env``);
the launcher CLI and its process watching are not ported.  The env carries
the reference's ``PADDLE_*`` protocol and torchrun's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, which
:func:`~paddle_tpu_torch.distributed.parallel.init_parallel_env` reads.
"""

from __future__ import annotations

import socket
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

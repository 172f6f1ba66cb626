"""``paddle.distributed.utils``: the launcher's helpers under the
reference's module path.

Counterpart of ``paddle_tpu/distributed/utils.py``: the names of
:mod:`.launch_utils`, and ``get_cluster``, the reference-shaped
constructor of a :class:`Cluster`.
"""

from .launch_utils import (  # noqa: F401
    Cluster, TrainerProc, find_free_port, rank_env, start_local_trainers,
    watch_local_trainers,
)

__all__ = ["Cluster", "TrainerProc", "find_free_port", "rank_env",
           "start_local_trainers", "watch_local_trainers", "get_cluster"]


def get_cluster(node_ips, node_ip=None, trainer_endpoints=None,
                device_mode=None, devices_per_proc=None):
    """A :class:`Cluster` of ``node_ips`` (a list or a comma string), one
    trainer a node or one a ``devices_per_proc`` entry, this node the
    index of ``node_ip`` (0 when absent); the master is the first node on
    a free port."""
    ips = (node_ips.split(",") if isinstance(node_ips, str)
           else list(node_ips))
    nproc = len(devices_per_proc) if devices_per_proc is not None else 1
    return Cluster(ips=ips, nproc_per_node=nproc, master=ips[0],
                   master_port=find_free_port(),
                   node_rank=ips.index(node_ip) if node_ip in ips else 0)

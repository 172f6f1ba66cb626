"""``paddle.distributed.cloud_utils``: the cluster from a cloud job's
environment.

Counterpart of ``paddle_tpu/distributed/cloud_utils.py``: the nodes from
``PADDLE_TRAINERS``, the trainers a node from ``PADDLE_TRAINER_PROCS``,
this trainer's id from ``PADDLE_TRAINER_ID``, the master port from
``PADDLE_MASTER_PORT`` (a free one when unset).
"""

import os

from .launch_utils import Cluster, find_free_port

__all__ = ["get_cluster_and_pod", "get_trainers_num"]


def get_trainers_num():
    return int(os.environ.get("PADDLE_TRAINERS_NUM", 1))


def get_cluster_and_pod(args=None):
    """(the :class:`Cluster`, this node's global ranks)."""
    ips = os.environ.get("PADDLE_TRAINERS", "127.0.0.1").split(",")
    nproc = int(os.environ.get("PADDLE_TRAINER_PROCS", 1))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    port = os.environ.get("PADDLE_MASTER_PORT")
    cluster = Cluster(ips=ips, nproc_per_node=nproc, master=ips[0],
                      master_port=int(port) if port else find_free_port(),
                      node_rank=min(rank, len(ips) - 1))
    return cluster, cluster.local_ranks()

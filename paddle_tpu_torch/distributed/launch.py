"""``python -m paddle_tpu_torch.distributed.launch``: the launcher CLI.

Counterpart of ``paddle_tpu/distributed/launch.py``, with its flags:
``--ips``, ``--nproc_per_node``, ``--devices`` (also ``--gpus`` and
``--tpus``: one flag, the card ids, one a local trainer), ``--master``,
``--node_rank``, ``--log_dir``, ``--timeout``, ``--elastic``,
``--max_restarts``, ``--job_id``, then the training script and its
arguments.  Each trainer gets the ``PADDLE_*`` / torchrun environment of
:func:`~paddle_tpu_torch.distributed.launch_utils.rank_env`, which
:func:`~paddle_tpu_torch.distributed.parallel.init_parallel_env` reads:
its rendezvous is ``tcp://<master>:<port>`` (NCCL on the card, gloo
when the script asks for it).

Usage::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        train.py --lr 0.1
    python -m paddle_tpu_torch.distributed.launch --ips 10.0.0.1,10.0.0.2 \\
        train.py
"""

from __future__ import annotations

import argparse
import os
import socket
import sys

from .launch_utils import (Cluster, find_free_port, run_elastic,
                           start_local_trainers, watch_local_trainers)

# the master port every node agrees on when --master names no port
DEFAULT_MASTER_PORT = 8476


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch distributed trainers (fleet launch)")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma list of node IPs; this node must appear in it")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="trainers per node (default: one, or one per entry "
                        "in --devices)")
    p.add_argument("--devices", "--gpus", "--tpus", dest="devices", type=str,
                   default=None,
                   help="comma list of card ids to bind, one trainer each")
    p.add_argument("--master", type=str, default=None,
                   help="coordinator host[:port] (default: the first ip)")
    p.add_argument("--node_rank", type=int, default=None,
                   help="this node's index in --ips (default: inferred)")
    p.add_argument("--log_dir", type=str, default=None,
                   help="write per-rank workerlog.N files here")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds to wait before stopping the trainers "
                        "(exit code 124)")
    p.add_argument("--elastic", action="store_true",
                   help="restart the world on a rank's failure or stale "
                        "heartbeat, resuming through auto_checkpoint")
    p.add_argument("--max_restarts", type=int, default=3,
                   help="elastic: restarts before giving up")
    p.add_argument("--job_id", type=str, default=None,
                   help="elastic: the job id checkpoints resume under "
                        "(exported as PADDLE_JOB_ID)")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def get_cluster_from_args(args) -> tuple:
    """(the :class:`Cluster` of this node, the ``--devices`` list or
    None)."""
    ips = [ip.strip() for ip in args.ips.split(",") if ip.strip()]
    devices = ([d.strip() for d in args.devices.split(",")]
               if args.devices else None)
    nproc = args.nproc_per_node or (len(devices) if devices else 1)
    if args.master:
        host, _, port = args.master.partition(":")
        # a bare host: every node must agree on the port, so the default
        master, master_port = host, int(port or DEFAULT_MASTER_PORT)
    else:
        master = ips[0]
        master_port = (find_free_port() if ips == ["127.0.0.1"]
                       else DEFAULT_MASTER_PORT)
    node_rank = args.node_rank
    if node_rank is None:
        names = {"127.0.0.1", "localhost", socket.gethostname()}
        try:
            names.add(socket.gethostbyname(socket.gethostname()))
        except OSError:
            pass
        node_rank = next((i for i, ip in enumerate(ips) if ip in names), 0)
    cluster = Cluster(ips=ips, nproc_per_node=nproc, master=master,
                      master_port=master_port, node_rank=node_rank)
    return cluster, devices


def launch(argv=None) -> int:
    """Run the CLI on ``argv``; returns the trainers' exit code."""
    args = _parse_args(argv)
    cluster, devices = get_cluster_from_args(args)
    cmd = [sys.executable, args.training_script] + args.training_script_args
    base_env = dict(os.environ)
    if args.job_id:
        base_env["PADDLE_JOB_ID"] = args.job_id
    print(f"launch: {cluster.nproc_per_node} local trainer(s), world size "
          f"{cluster.world_size}, master {cluster.master}:{cluster.master_port}"
          + (" [elastic]" if args.elastic else ""), flush=True)
    if args.elastic or os.environ.get("PADDLE_ELASTIC_STORE"):
        return run_elastic(cluster, cmd, base_env=base_env,
                           log_dir=args.log_dir, devices=devices,
                           max_restarts=args.max_restarts,
                           timeout=args.timeout)
    procs = start_local_trainers(cluster, cmd, base_env=base_env,
                                 log_dir=args.log_dir, devices=devices)
    return watch_local_trainers(procs, timeout=args.timeout)


def main():
    sys.exit(launch())


if __name__ == "__main__":
    main()

"""``fleet``: the hybrid topology, its strategy, the worker queries, and
the wrappers of ``nn.Layer`` models and their optimizers.

Counterpart of ``paddle_tpu/distributed/fleet/__init__.py`` for the
collective path: :func:`init` starts the process group (NCCL on the card
unless gloo was started first, see
:func:`~paddle_tpu_torch.distributed.parallel.init_parallel_env`), builds
the ``dp x pp x sharding x mp`` topology of the strategy's
``hybrid_configs`` and installs its mesh.  :func:`distributed_model`
wraps a model by the topology's parallel mode (``PipelineParallel``,
``TensorParallel``, ``ShardingParallel`` or ``DataParallelSPMD``) and
:func:`distributed_optimizer` an optimizer in ``HybridParallelOptimizer``
(:mod:`.meta_parallel`); ``meta_optimizers`` and ``utils.recompute`` come
with them.  The parameter-server path is out of scope, as in the
reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import env as dist_env
from ..parallel import init_parallel_env
from . import meta_optimizers  # noqa: F401
from . import meta_parallel  # noqa: F401
from . import utils  # noqa: F401
from .distributed_strategy import DistributedStrategy
from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = [
    "init", "DistributedStrategy", "UserDefinedRoleMaker",
    "PaddleCloudRoleMaker", "worker_index", "worker_num", "is_worker",
    "worker_endpoints", "server_num", "server_index", "server_endpoints",
    "is_server", "is_first_worker", "barrier_worker", "init_worker",
    "init_server", "run_server", "stop_worker", "distributed_model",
    "distributed_optimizer", "get_hybrid_communicate_group", "meta_parallel",
    "UtilBase", "util",
]

_fleet_state = {"initialized": False, "strategy": None, "hcg": None,
                "is_collective": True}


class PaddleCloudRoleMaker:
    """Env-driven role discovery (collective mode: every process is a
    worker)."""

    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective

    def _worker_index(self):
        return dist_env.get_rank()

    def _worker_num(self):
        return dist_env.get_world_size()


UserDefinedRoleMaker = PaddleCloudRoleMaker


def init(role_maker=None, is_collective=True, strategy=None):
    """Start the group (if it is not up), build the strategy's hybrid
    topology and install its mesh.  ``dp_degree`` -1 (the default) takes
    the ranks the other degrees leave."""
    if strategy is None:
        strategy = DistributedStrategy()
    _fleet_state["strategy"] = strategy
    _fleet_state["is_collective"] = is_collective
    init_parallel_env()
    hc = strategy.hybrid_configs
    dp, mp = hc.get("dp_degree", -1), hc.get("mp_degree", 1)
    pp, sd = hc.get("pp_degree", 1), hc.get("sharding_degree", 1)
    world = dist_env.get_world_size()
    if dp in (-1, 0, None):
        dp = max(world // max(mp * pp * sd, 1), 1)
    topo = CommunicateTopology(dims=(dp, pp, sd, mp))
    _fleet_state["hcg"] = HybridCommunicateGroup(topo)
    _fleet_state["initialized"] = True


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if _fleet_state["hcg"] is None:
        init()
    return _fleet_state["hcg"]


def distributed_model(model):
    """``model`` wrapped by the parallel mode of the topology
    :func:`init` built (the reference's choice, ``fleet_base.py``'s
    ``distributed_model``)."""
    hcg = get_hybrid_communicate_group()
    strategy = _fleet_state["strategy"]
    mode = hcg.get_parallel_mode()
    if mode == "pipeline_parallel":
        return meta_parallel.PipelineParallel(model, hcg, strategy)
    if mode == "tensor_parallel":
        return meta_parallel.TensorParallel(model, hcg, strategy)
    if mode == "sharding_parallel":
        return meta_parallel.ShardingParallel(model, hcg, strategy)
    return meta_parallel.DataParallelSPMD(model, hcg, strategy)


def distributed_optimizer(optimizer, strategy=None):
    """``optimizer`` wrapped in ``HybridParallelOptimizer`` (sharded by
    ``DygraphShardingOptimizer`` when the strategy shards)."""
    if strategy is not None:
        _fleet_state["strategy"] = strategy
    return meta_parallel.HybridParallelOptimizer(
        optimizer, get_hybrid_communicate_group(),
        _fleet_state["strategy"] or DistributedStrategy())


def worker_index():
    return dist_env.get_rank()


def worker_num():
    return dist_env.get_world_size()


def is_worker():
    return True


def is_first_worker():
    return dist_env.get_rank() == 0


def worker_endpoints(to_string=False):
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
    return ",".join(eps) if to_string else eps


def barrier_worker():
    from .. import collective

    collective.barrier()


_PS_MSG = ("the parameter-server path is out of scope, as in the "
           "reference: use the collective path")


def init_server(*a, **k):
    raise NotImplementedError(_PS_MSG)


def run_server(*a, **k):
    raise NotImplementedError(_PS_MSG)


def init_worker(*a, **k):
    return None


def stop_worker(*a, **k):
    return None


def server_num():
    return 0


def server_index():
    return 0


def server_endpoints(to_string=False):
    return "" if to_string else []


def is_server():
    return False


class UtilBase:
    """Cross-worker helpers over the collective API on numpy values (on
    the group's device: the card under NCCL) and host-side file
    sharding."""

    @staticmethod
    def _tensor(value):
        from ..parallel import ParallelEnv

        return torch.as_tensor(np.asarray(value), device=ParallelEnv().device)

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        from .. import collective as C

        t = self._tensor(input)
        op = {"sum": C.ReduceOp.SUM, "max": C.ReduceOp.MAX,
              "min": C.ReduceOp.MIN}[mode]
        C.all_reduce(t, op=op)
        return t.cpu().numpy()

    def all_gather(self, input, comm_world="worker"):
        from .. import collective as C

        out = []
        C.all_gather(out, self._tensor(input))
        return [t.cpu().numpy() for t in out]

    def barrier(self, comm_world="worker"):
        from .. import collective as C

        C.barrier()

    def get_file_shard(self, files):
        """Split a file list contiguously across workers (the first
        ``len % n`` workers take one more)."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file paths")
        n = max(dist_env.get_world_size(), 1)
        idx = dist_env.get_rank()
        base, extra = divmod(len(files), n)
        counts = [base + (1 if i < extra else 0) for i in range(n)]
        start = sum(counts[:idx])
        return files[start:start + counts[idx]]

    def print_on_rank(self, message, rank_id):
        if dist_env.get_rank() == rank_id:
            print(message, flush=True)


util = UtilBase()

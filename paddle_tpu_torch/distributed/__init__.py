"""``paddle.distributed`` over ``torch.distributed``: the collective API,
the parallel environment, the hybrid mesh, ``spawn`` and ``fleet``.

Counterpart of ``paddle_tpu/distributed/`` for what the port has ported:
``env``, ``parallel``, ``mesh``, ``collective``, ``spawn`` (with the parts
of ``launch_utils`` it uses) and ``fleet`` (topology, strategy, worker
queries, ``meta_parallel``: the tensor-parallel layers, ``PipelineLayer``
and its 1F1B engine, the model wrappers, the sharding and hybrid
optimizers; ``meta_optimizers``; ``utils.recompute``;
``distributed_model`` / ``distributed_optimizer``).  NCCL on the card;
gloo when the caller asks for it (:func:`init_parallel_env`).  Not ported
yet (ROADMAP A.11): the launcher CLI, checkpoint, cloud_utils, utils,
elastic, ``fleet.utils.fs``, the parameter-server datasets.
"""

from . import fleet  # noqa: F401
from .collective import (  # noqa: F401
    ReduceOp, all_gather, all_reduce, alltoall, barrier, broadcast,
    get_group, new_group, recv, reduce, scatter, send, split, wait,
)
from .env import get_rank, get_world_size  # noqa: F401
from .parallel import ParallelEnv, init_parallel_env  # noqa: F401
from .spawn import spawn  # noqa: F401

__all__ = ["get_rank", "get_world_size", "init_parallel_env", "ParallelEnv",
           "all_gather", "all_reduce", "alltoall", "barrier", "broadcast",
           "new_group", "get_group", "recv", "reduce", "scatter", "send",
           "split", "wait", "ReduceOp", "fleet", "spawn"]

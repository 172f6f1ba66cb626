"""``paddle.distributed`` over ``torch.distributed``: the collective API,
the parallel environment, the hybrid mesh, ``spawn``, the launcher,
the sharded checkpoint and ``fleet``.

Counterpart of ``paddle_tpu/distributed/``: ``env``, ``parallel``,
``mesh``, ``collective`` (whose calls on a static Variable record the
``c_*`` ops of :mod:`paddle_tpu_torch.ops.collective_ops`), ``spawn``,
``launch`` and ``launch_utils`` (``python -m
paddle_tpu_torch.distributed.launch``, elastic restarts), ``utils``,
``cloud_utils``, ``checkpoint`` (``save_state_dict`` /
``load_state_dict``) and ``fleet`` (topology, strategy, worker queries,
``meta_parallel``: the tensor-parallel layers, ``PipelineLayer`` and its
1F1B engine, the model wrappers, the sharding and hybrid optimizers;
``meta_optimizers``; ``elastic``; ``utils``: ``recompute`` and the file
systems; ``distributed_model`` / ``distributed_optimizer``).  NCCL on
the card; gloo when the caller asks for it (:func:`init_parallel_env`).
The parameter-server path is out of scope, as in the reference: its
datasets raise, and its table entries are held as configuration.
"""

from . import fleet  # noqa: F401
from .collective import (  # noqa: F401
    ReduceOp, all_gather, all_reduce, alltoall, barrier, broadcast,
    get_group, new_group, recv, reduce, scatter, send, split, wait,
)
from .env import get_rank, get_world_size  # noqa: F401
from .parallel import ParallelEnv, init_parallel_env  # noqa: F401
from .spawn import spawn  # noqa: F401
from . import checkpoint  # noqa: F401
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401
from . import utils  # noqa: F401
from . import cloud_utils  # noqa: F401

__all__ = ["get_rank", "get_world_size", "init_parallel_env", "ParallelEnv",
           "all_gather", "all_reduce", "alltoall", "barrier", "broadcast",
           "new_group", "get_group", "recv", "reduce", "scatter", "send",
           "split", "wait", "ReduceOp", "fleet", "spawn", "launch",
           "checkpoint", "save_state_dict", "load_state_dict", "utils",
           "cloud_utils", "InMemoryDataset", "QueueDataset", "BoxPSDataset",
           "CountFilterEntry", "ProbabilityEntry"]


def __getattr__(name):
    # ``launch`` loads on first use: ``python -m
    # paddle_tpu_torch.distributed.launch`` runs it as __main__, which an
    # import here would have loaded already
    if name == "launch":
        import importlib

        return importlib.import_module(f"{__name__}.launch")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | {"launch"})


class _PSScopedDataset:
    """The parameter-server trainer's datasets.  The names resolve, as in
    the reference; making one raises, pointing at the collective path's
    ``paddle.io.DataLoader``."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            f"{type(self).__name__} feeds the parameter-server trainer "
            "loop, which is out of scope; use paddle.io.DataLoader on the "
            "collective path instead")


class InMemoryDataset(_PSScopedDataset):
    pass


class QueueDataset(_PSScopedDataset):
    pass


class BoxPSDataset(_PSScopedDataset):
    pass


class CountFilterEntry:
    """A sparse table's admission by count, held as configuration (the
    tables themselves are the parameter server's)."""

    def __init__(self, count_filter: int):
        self.count_filter = int(count_filter)

    def to_attr(self):
        return f"count_filter_entry:{self.count_filter}"


class ProbabilityEntry:
    """A sparse table's admission by probability, held as
    configuration."""

    def __init__(self, probability: float):
        self.probability = float(probability)

    def to_attr(self):
        return f"probability_entry:{self.probability}"

"""``paddle.DataParallel``.

Counterpart of ``paddle_tpu/dygraph/parallel.py``: the data-parallel
wrapper over the installed mesh (the world as dp when ``fleet.init`` was
not called; a process group must be up), with ``comm_buffer_size`` MB
gradient buckets (:class:`~paddle_tpu_torch.distributed.fleet.
meta_parallel.DataParallelSPMD`).
"""

from __future__ import annotations

from ..distributed import mesh as mesh_mod
from ..distributed.fleet.meta_parallel.parallel_wrappers import \
    DataParallelSPMD

__all__ = ["DataParallel"]


class DataParallel(DataParallelSPMD):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        mesh_mod.ensure_default_mesh()
        self.comm_buffer_mb = comm_buffer_size
        super().__init__(layers, hcg=None, strategy=strategy)

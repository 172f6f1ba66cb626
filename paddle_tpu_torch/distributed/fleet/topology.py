"""Hybrid-parallel topology: rank arithmetic over ``dp x pp x sharding x
mp``, and the groups of each axis.

Counterpart of ``paddle_tpu/distributed/fleet/topology.py``.
:class:`CommunicateTopology` is pure arithmetic (its own copy, the same
answers).  :class:`HybridCommunicateGroup` installs the hybrid mesh
(:func:`~paddle_tpu_torch.distributed.mesh.build_hybrid_mesh`) and hands
out each axis's rank, degree and group, as the reference's does over its
jax mesh.
"""

from __future__ import annotations

import collections
import itertools
from typing import List

import torch.distributed as dist

from .. import mesh as mesh_mod
from ..collective import Group


class CommunicateTopology:
    """Rank <-> coordinate arithmetic over named axes, row-major (the last
    axis innermost)."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"), dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(*(range(d) for d in dims)))
        self._word_size = 1
        for d in dims:
            self._word_size *= int(d)
        self._rank2coord = {self._coord_to_rank(c): c for c in self.coordinate}
        self._coord_type = collections.namedtuple("Coord",
                                                  self._parallel_names)

    def _coord_to_rank(self, coord) -> int:
        rank = 0
        for c, d in zip(coord, self._dims):
            rank = rank * d + c
        return rank

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._word_size

    def get_rank(self, **kwargs) -> int:
        return self._coord_to_rank(tuple(kwargs[n]
                                         for n in self._parallel_names))

    def get_coord(self, rank: int):
        return self._coord_type(*self._rank2coord[rank])

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        axis = self._parallel_names.index(axis_name)
        return sorted(self._coord_to_rank(c) for c in self.coordinate
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Every group along ``axis_name``: the ranks that vary only on
        it."""
        axis = self._parallel_names.index(axis_name)
        others = [(i, d) for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for combo in itertools.product(*(range(d) for _, d in others)):
            group = []
            for v in range(self._dims[axis]):
                coord = [0] * len(self._dims)
                for (i, _), cv in zip(others, combo):
                    coord[i] = cv
                coord[axis] = v
                group.append(self._coord_to_rank(tuple(coord)))
            groups.append(group)
        return groups


# paddle axis name -> mesh axis name
_AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding", "model": "mp"}


class HybridCommunicateGroup:
    """The hybrid mesh of ``topology`` (installed in the registry) and each
    axis's rank, degree and :class:`~paddle_tpu_torch.distributed.
    collective.Group`.  Every rank of the world constructs it."""

    def __init__(self, topology: CommunicateTopology, timeout=None):
        self._topo = topology
        if not dist.is_initialized():
            raise RuntimeError("HybridCommunicateGroup needs an initialised "
                               "process group: call init_parallel_env()")
        self.global_rank = dist.get_rank()
        self.nranks = topology.world_size()
        dims = {n: topology.get_dim(n)
                for n in topology.get_hybrid_group_names()}
        self._dp_degree = dims.get("data", 1)
        self._pp_degree = dims.get("pipe", 1)
        self._sharding_degree = dims.get("sharding", 1)
        self._mp_degree = dims.get("model", 1)
        self.mesh = mesh_mod.build_hybrid_mesh(
            dp=self._dp_degree, mp=self._mp_degree, pp=self._pp_degree,
            sharding=self._sharding_degree, timeout=timeout)
        c = self.mesh.coord
        self._dp_rank, self._pp_rank = c["dp"], c["pp"]
        self._sharding_rank, self._mp_rank = c["sharding"], c["mp"]

        def group(i, axis):
            ranks = self.mesh.group_ranks(axis)
            return Group(ranks.index(self.global_rank), len(ranks), i,
                         ranks, self.mesh.group(axis))

        self._dp_group = group(1, "dp")
        self._pp_group = group(2, "pp")
        self._sharding_group = group(3, "sharding")
        self._mp_group = group(4, "mp")
        self._check_group = Group(self.global_rank, self.nranks, 0,
                                  list(range(self.nranks)), dist.group.WORLD)

    def get_parallel_mode(self):
        if (self._mp_degree == 1 and self._pp_degree == 1
                and self._sharding_degree == 1):
            return "data_parallel"
        if (self._sharding_degree > 1 and self._mp_degree == 1
                and self._pp_degree == 1):
            return "sharding_parallel"
        if self._mp_degree > 1 and self._pp_degree == 1:
            return "tensor_parallel"
        if self._pp_degree > 1:
            return "pipeline_parallel"
        return "data_parallel"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    def get_data_parallel_rank(self):
        return self._dp_rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    def get_model_parallel_rank(self):
        return self._mp_rank

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    def get_stage_id(self):
        return self._pp_rank

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def is_first_stage(self):
        return self._pp_rank == 0

    def is_last_stage(self):
        return self._pp_rank == self._pp_degree - 1

    def get_sharding_parallel_rank(self):
        return self._sharding_rank

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    def get_check_parallel_group(self):
        return self._check_group

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank(data=self._dp_rank, pipe=stage_id,
                                   sharding=self._sharding_rank,
                                   model=self._mp_rank)

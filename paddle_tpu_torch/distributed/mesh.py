"""The hybrid mesh: this rank's coordinates on the ``(dp, pp, sharding,
mp)`` axes and one process group per axis.

Counterpart of ``paddle_tpu/distributed/mesh.py``.  The reference's mesh
is a ``jax.sharding.Mesh`` whose named axes XLA lowers collectives onto;
here a :class:`Mesh` holds the degrees, this rank's coordinates and a
``torch.distributed`` group for each axis (and for ``("dp",
"sharding")``, the data-parallel group of ZeRO, whose ranks each read
their own batch slice).  Ranks are laid out as the reference reshapes
its devices: ``rank = ((dp * PP + pp) * SHARDING + sharding) * MP + mp``,
``mp`` innermost.  A group of one rank is still a group: collectives over
it run (and are exact), so one process exercises the distributed path.

:func:`build_hybrid_mesh` installs the mesh in the registry
(:func:`get_mesh` / :func:`set_mesh`) that the train step and the
tensor-parallel layers read, as the reference's read ``get_mesh()``.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist

from . import parallel as _parallel

# canonical hybrid axis order (outermost..innermost), the reference's
HYBRID_AXES = ("dp", "pp", "sharding", "mp")
# the axis sets a group is built for, in creation order (every rank must
# create every group, in the same order)
_GROUP_AXES = (("dp",), ("pp",), ("sharding",), ("mp",), ("dp", "sharding"))

_MESH: Optional["Mesh"] = None


class Mesh:
    """Degrees, this rank's coordinates and its group on each axis set.

    ``shape`` maps each of :data:`HYBRID_AXES` to its degree, ``coord``
    to this rank's index on it; :meth:`group` returns the process group
    of the ranks that differ from this one only on the given axes, and
    :meth:`group_ranks` their global ranks in group order."""

    axis_names = HYBRID_AXES

    def __init__(self, shape: Dict[str, int], rank: int, timeout=None):
        self.shape = {a: int(shape.get(a, 1)) for a in HYBRID_AXES}
        self.size = 1
        for a in HYBRID_AXES:
            self.size *= self.shape[a]
        self.rank = rank
        self.coord = self.coord_of(rank)
        self._groups = {}
        self._ranks = {}
        for axes in _GROUP_AXES:
            mine = None
            for ranks in self._all_groups(axes):
                g = dist.new_group(ranks, timeout=_parallel._timeout(timeout))
                if rank in ranks:
                    mine = (g, ranks)
            self._groups[axes], self._ranks[axes] = mine

    def rank_of(self, **coord) -> int:
        r = 0
        for a in HYBRID_AXES:
            r = r * self.shape[a] + int(coord.get(a, 0))
        return r

    def coord_of(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(HYBRID_AXES):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in HYBRID_AXES}

    def _all_groups(self, axes):
        """Every group over ``axes``: the ranks that vary on ``axes`` with
        the other coordinates fixed, in row-major order over ``axes``."""
        others = [a for a in HYBRID_AXES if a not in axes]
        groups = []
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            base = dict(zip(others, fixed))
            groups.append([self.rank_of(**base, **dict(zip(axes, var)))
                           for var in itertools.product(
                               *(range(self.shape[a]) for a in axes))])
        return groups

    @staticmethod
    def _key(axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in HYBRID_AXES if a in axes)
        if key not in _GROUP_AXES:
            raise ValueError(f"no group over axes {axes}")
        return key

    def group(self, axes):
        """The process group over ``axes`` (a name or a tuple of names)."""
        return self._groups[self._key(axes)]

    def group_ranks(self, axes):
        """The global ranks of :meth:`group`, in group order."""
        return list(self._ranks[self._key(axes)])

    def index(self, axes) -> int:
        """This rank's index in :meth:`group` over ``axes``."""
        return self.group_ranks(axes).index(self.rank)

    def degree(self, axes) -> int:
        return len(self.group_ranks(axes))

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coord={self.coord})"


def set_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    global _MESH
    _MESH = mesh
    return mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def _require_group():
    if not dist.is_initialized():
        raise RuntimeError("the hybrid mesh needs an initialised process "
                           "group: call init_parallel_env() first")


def build_hybrid_mesh(dp: int = 1, mp: int = 1, pp: int = 1,
                      sharding: int = 1, timeout=None) -> Mesh:
    """Create and install the ``(dp, pp, sharding, mp)`` mesh over the
    world's ranks; the degrees' product must be the world size.  Every
    rank calls it (it creates process groups)."""
    _require_group()
    need = dp * mp * pp * sharding
    world = dist.get_world_size()
    if need != world:
        raise ValueError(f"hybrid topology dp={dp} mp={mp} pp={pp} "
                         f"sharding={sharding} needs {need} ranks, the "
                         f"world has {world}")
    return set_mesh(Mesh({"dp": dp, "pp": pp, "sharding": sharding,
                          "mp": mp}, dist.get_rank(), timeout=timeout))


def ensure_default_mesh() -> Mesh:
    """The installed mesh, or a data-parallel one over the whole world."""
    if _MESH is None:
        _require_group()
        build_hybrid_mesh(dp=dist.get_world_size())
    return _MESH


def axis_size(name: str) -> int:
    mesh = get_mesh()
    return 1 if mesh is None else int(mesh.shape.get(name, 1))


def axis_rank(name: str) -> int:
    mesh = get_mesh()
    return 0 if mesh is None else int(mesh.coord.get(name, 0))


def axis_group(name):
    """The installed mesh's group over ``name`` (an axis or a tuple)."""
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("no hybrid mesh is installed")
    return mesh.group(name)


def shard_batch(x, axis_names: Tuple[str, ...] = ("dp", "sharding"),
                dim: int = 0):
    """This rank's slice of the global batch ``x`` (numpy or torch) over
    ``axis_names`` along ``dim``: the ranks of the data-parallel group
    (dp and ZeRO's sharding ranks each read their own rows) take equal
    consecutive slices in group order."""
    mesh = ensure_default_mesh()
    axes = tuple(a for a in HYBRID_AXES
                 if a in axis_names and mesh.shape[a] > 1)
    if not axes:
        return x
    n, i = mesh.degree(axes), mesh.index(axes)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"batch of {size} rows does not split over {n} "
                         f"ranks of {axes}")
    step = size // n
    index = [slice(None)] * len(x.shape)
    index[dim] = slice(i * step, (i + 1) * step)
    return x[tuple(index)]

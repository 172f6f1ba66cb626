"""The sharded checkpoint: ``save_state_dict`` / ``load_state_dict``.

Counterpart of ``paddle_tpu/distributed/checkpoint.py``, in its on-disk
format, so a checkpoint written by either package loads in the other
(a save over an earlier one also removes the files of the ranks the
earlier, larger world had beyond this one's):

* ``{path}/meta.json``: each entry's global ``shape`` and ``dtype`` (a
  numpy name; ``"bfloat16"`` for bf16), written by rank 0;
* ``{path}/shards_{rank}.npz``: the pieces rank ``rank`` writes, under
  keys ``{name}::{k}``; bf16 pieces as raw 2-byte ``V2`` values, as the
  reference's numpy writes them;
* ``{path}/shards_{rank}.idx.json``: for each key, the entry's name and the
  piece's place in the global array, one ``[start, stop]`` per dim.

A state-dict value is a torch tensor or an eager-API Tensor (replicated:
every rank that holds it holds all of it, and the lowest such rank writes
it once), or a :class:`Shard`: this rank's piece of a partitioned entry,
which each rank writes (the lowest rank holding an identical piece).  A
:class:`Shard` describes two partitions, alone or together: a
tensor-parallel slice (the global array's ``index`` along ``dim``, as
:func:`paddle_tpu_torch.weights.tp_index` gives them) and ZeRO's flat
partition (elements ``flat`` on of the slice flattened and zero-padded,
:class:`~paddle_tpu_torch.distributed.collective._Flat`); on disk such a
piece becomes the few rectangles of the global array it covers.

:func:`load_state_dict` reassembles each entry from every rank's files
and fills the given state in place on the CURRENT layout: each value, or
each :class:`Shard`'s ``data``, gets its part, whatever layout wrote it.
Every rank of the group calls both functions.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["save_state_dict", "load_state_dict", "Shard"]


class Shard:
    """This rank's piece ``data`` of a global entry of ``shape``.

    ``dim`` / ``index``: the piece is (a part of) the global array's
    ``index`` (consecutive or not) along ``dim``, the tensor-parallel
    slice; without them the whole array.  ``flat``: ``data`` is the 1-D
    run of elements ``flat, flat + data.numel()`` of that slice flattened
    and zero-padded (ZeRO's partition; the padding is not saved)."""

    def __init__(self, data: torch.Tensor, shape: Sequence[int],
                 dim: Optional[int] = None, index=None,
                 flat: Optional[int] = None):
        self.data = data
        self.shape = tuple(int(s) for s in shape)
        self.dim = dim
        self.index = (None if index is None
                      else np.asarray(index, dtype=np.int64))
        self.flat = flat
        if (dim is None) != (self.index is None):
            raise ValueError("Shard: give dim and index together")

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The slice's shape (the global one outside ``dim``)."""
        if self.index is None:
            return self.shape
        s = list(self.shape)
        s[self.dim] = len(self.index)
        return tuple(s)

    def pieces(self):
        """``(global slices, numpy data)`` of each rectangle of the global
        array that ``data`` covers."""
        arr = _host(self.data)
        local = self.local_shape
        if self.flat is None:
            rects = [(_full(local), arr.reshape(local))]
        else:
            stop = min(self.flat + arr.size, int(np.prod(local)))
            rects = [(sl, arr[a - self.flat:b - self.flat].reshape(
                [e - s for s, e in sl]))
                for a, b, sl in _flat_rects(self.flat, stop, local)]
        if self.index is None:
            return rects
        out = []
        for sl, piece in rects:
            lo, hi = sl[self.dim]
            for r0, r1 in _runs(self.index[lo:hi]):
                g = list(sl)
                g[self.dim] = [int(self.index[lo + r0]),
                               int(self.index[lo + r0]) + r1 - r0]
                out.append((g, np.take(piece, np.arange(r0, r1),
                                       axis=self.dim)))
        return out

    def take(self, full: np.ndarray) -> np.ndarray:
        """This piece of the global array ``full``."""
        if self.index is not None:
            full = np.take(full, self.index, axis=self.dim)
        if self.flat is None:
            return full
        flat = full.reshape(-1)
        n = self.data.numel()
        out = np.zeros(n, dtype=full.dtype)
        part = flat[self.flat:self.flat + n]
        out[:part.size] = part
        return out


def _full(shape):
    return [[0, int(s)] for s in shape]


def _flat_rects(a: int, b: int, shape) -> List[tuple]:
    """The flat range ``[a, b)`` of a row-major array of ``shape`` as
    rectangles: ``(flat start, flat stop, slices)`` in order, at most two
    a dim plus one."""
    if a >= b:
        return []
    if not shape:
        return [(a, b, [])]
    row = int(np.prod(shape[1:], dtype=np.int64))
    if a % row == 0 and b % row == 0:
        return [(a, b, [[a // row, b // row]] + _full(shape[1:]))]
    out = []
    first = -(-a // row) * row
    if a % row:
        r = a // row
        stop = min(b, first)
        out += [(s + r * row, e + r * row, [[r, r + 1]] + sl)
                for s, e, sl in _flat_rects(a - r * row, stop - r * row,
                                            shape[1:])]
    last = (b // row) * row
    if first < last:
        out.append((first, last, [[first // row, last // row]]
                    + _full(shape[1:])))
    if b % row and last >= first:
        r = b // row
        out += [(s + r * row, e + r * row, [[r, r + 1]] + sl)
                for s, e, sl in _flat_rects(0, b - r * row, shape[1:])]
    return out


def _runs(idx):
    """Maximal runs of consecutive values in ``idx``: ``(start, stop)``
    positions."""
    out, s = [], 0
    for i in range(1, len(idx) + 1):
        if i == len(idx) or idx[i] != idx[i - 1] + 1:
            out.append((s, i))
            s = i
    return out


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def _host(t) -> np.ndarray:
    """A tensor as numpy; bf16 as its raw bits, ``V2``."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view("V2")
    return t.cpu().numpy()


def _tensor(v):
    from ..dygraph.tensor import Tensor

    return v._t if isinstance(v, Tensor) else v


def _rank_world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_state_dict(state_dict: Dict[str, object], path: str) -> None:
    """Write this rank's pieces of every entry (see the module
    docstring), and, on rank 0, the manifest."""
    os.makedirs(path, exist_ok=True)
    rank, world = _rank_world()
    mine = {}
    for name, v in state_dict.items():
        if isinstance(v, Shard):
            pieces = v.pieces()
            sig = tuple(tuple(map(tuple, sl)) for sl, _ in pieces)
            mine[name] = (list(v.shape), _dtype_name(v.data), sig, pieces)
        else:
            t = _tensor(v)
            mine[name] = (list(t.shape), _dtype_name(t), "whole",
                          [(_full(t.shape), _host(t))])
    info = {n: (s, d, sig) for n, (s, d, sig, _) in mine.items()}
    every = [info]
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, info)
    # the lowest rank holding an identical piece writes it
    writer = {}
    for r, held in enumerate(every):
        for name, (_, _, sig) in held.items():
            writer.setdefault((name, sig), r)
    arrays, index = {}, {}
    for name, (_, _, sig, pieces) in mine.items():
        if writer[(name, sig)] != rank:
            continue
        for k, (sl, arr) in enumerate(pieces):
            key = f"{name}::{k}"
            arrays[key] = arr
            index[key] = {"name": name, "slices": [list(s) for s in sl]}
    if rank == 0:
        _remove_stale(path, world)
        meta = {}
        for held in every:
            for name, (shape, dtype, _) in held.items():
                meta.setdefault(name, {"shape": shape, "dtype": dtype})
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
    np.savez(os.path.join(path, f"shards_{rank}.npz"), **arrays)
    with open(os.path.join(path, f"shards_{rank}.idx.json"), "w") as f:
        json.dump(index, f)
    if world > 1:
        dist.barrier()


def _remove_stale(path: str, world: int) -> None:
    """Remove the files of ranks ``world`` and up that an earlier save
    to ``path`` at a larger world size left: the loader reads every
    ``shards_*`` file, and theirs would overwrite this save's pieces."""
    for fn in os.listdir(path):
        m = re.fullmatch(r"shards_(\d+)(\.npz|\.idx\.json)", fn)
        if m and int(m.group(1)) >= world:
            os.remove(os.path.join(path, fn))


def _numpy_dtype(name: str):
    return np.dtype("int16") if name == "bfloat16" else np.dtype(name)


def _assemble(path: str, names) -> Dict[str, np.ndarray]:
    """The global arrays of ``names`` from every rank's files (bf16 as
    int16 bits)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    full, filled = {}, {}
    for name in names:
        if name not in meta:
            raise KeyError(f"checkpoint at {path!r} has no entry {name!r}")
        shape = meta[name]["shape"]
        full[name] = np.empty(shape, dtype=_numpy_dtype(meta[name]["dtype"]))
        filled[name] = np.zeros(shape, dtype=bool)
    for fn in sorted(os.listdir(path)):
        if not (fn.startswith("shards_") and fn.endswith(".npz")):
            continue
        proc = fn[len("shards_"):-len(".npz")]
        with open(os.path.join(path, f"shards_{proc}.idx.json")) as f:
            index = json.load(f)
        with np.load(os.path.join(path, fn)) as data:
            for key in data.files:
                name = index[key]["name"]
                if name not in full:
                    continue
                sl = tuple(slice(a, b) for a, b in index[key]["slices"])
                piece = data[key]
                if piece.dtype.kind == "V":
                    piece = piece.view(np.int16)
                full[name][sl] = piece
                filled[name][sl] = True
    for name in names:
        if not filled[name].all():
            raise RuntimeError(
                f"checkpoint entry {name!r} is incomplete: only "
                f"{int(filled[name].sum())}/{filled[name].size} elements "
                f"present (missing shard files of another rank?)")
    return full, meta


def _fill(dst: torch.Tensor, arr: np.ndarray, dtype_name: str) -> None:
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype_name == "bfloat16":
        src = src.view(torch.bfloat16)
    if tuple(src.shape) != tuple(dst.shape):
        src = src.reshape(dst.shape)
    with torch.no_grad():
        dst.copy_(src.to(dst.device))


def load_state_dict(state_dict: Dict[str, object], path: str) -> None:
    """Fill ``state_dict`` IN PLACE from the checkpoint at ``path``: each
    tensor (or :class:`Shard`'s ``data``) gets its part of the saved
    entry, in its own dtype and on its own device."""
    full, meta = _assemble(path, list(state_dict))
    for name, v in state_dict.items():
        dt = meta[name]["dtype"]
        if isinstance(v, Shard):
            _fill(v.data, v.take(full[name]), dt)
        else:
            _fill(_tensor(v), full[name], dt)

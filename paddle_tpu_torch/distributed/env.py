"""Rank and world size of this process.

Counterpart of ``paddle_tpu/distributed/env.py``: the launcher's
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` first, then torchrun's
``RANK`` / ``WORLD_SIZE``, then the initialised process group, else rank 0
of 1.  :func:`get_local_rank` (the card a rank drives) reads
``PADDLE_RANK_IN_NODE`` or torchrun's ``LOCAL_RANK``.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def _env_int(*names):
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def get_rank() -> int:
    r = _env_int("PADDLE_TRAINER_ID", "RANK")
    if r is not None:
        return r
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    w = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE")
    if w is not None:
        return w
    return dist.get_world_size() if dist.is_initialized() else 1


def get_local_rank() -> int:
    r = _env_int("PADDLE_RANK_IN_NODE", "LOCAL_RANK")
    return get_rank() if r is None else r

"""Parallel environment bootstrap over ``torch.distributed``.

Counterpart of ``paddle_tpu/distributed/parallel.py`` (``ParallelEnv``,
``init_parallel_env``).  The reference starts ``jax.distributed`` and a
device mesh; here :func:`init_parallel_env` starts one
``torch.distributed`` process group per process:

* the backend is NCCL on the card unless the caller asks for gloo
  (``backend="gloo"``, the CPU tests' choice); without a card and without
  ``backend="gloo"`` it raises, as :func:`paddle_tpu_torch.device.
  default_device` does.  A rank's tensors live on ``cuda:<device id>``
  (:func:`~paddle_tpu_torch.distributed.env.get_device_id`: the
  launcher's ``FLAGS_selected_gpus``, else the local rank);
* the rendezvous is a ``FileStore`` at ``store_path`` when the caller
  gives one, else ``MASTER_ADDR`` / ``MASTER_PORT`` from the environment
  (``PADDLE_MASTER`` for the address as the reference's launcher sets
  it); rank and world come from :mod:`.env`;
* every group gets ``timeout``: a collective whose peer died raises
  instead of hanging.  Nothing retries a failed collective elsewhere.

It is idempotent: a second call returns the environment of the group
already up.  A new group starts without the groups and ring bindings of
an earlier, destroyed one (:func:`~paddle_tpu_torch.distributed.
collective.new_group`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from . import env as dist_env

#: the default timeout of every process group this package creates
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


class ParallelEnv:
    """This process's place in the group: rank, local rank, world size,
    and the device its tensors live on."""

    def __init__(self):
        self._rank = dist_env.get_rank()
        self._world_size = dist_env.get_world_size()
        self._local_rank = dist_env.get_local_rank()

    @property
    def rank(self):
        return self._rank

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def nranks(self):
        return self._world_size

    @property
    def device_id(self):
        return dist_env.get_device_id()

    @property
    def device(self) -> torch.device:
        """``cuda:<device id>`` under NCCL, the CPU under gloo."""
        if dist.is_initialized() and dist.get_backend() == "nccl":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    @property
    def current_endpoint(self):
        eps = self.trainer_endpoints
        return eps[self._rank] if self._rank < len(eps) else ""

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")


def _timeout(timeout):
    if timeout is None:
        return DEFAULT_TIMEOUT
    if isinstance(timeout, datetime.timedelta):
        return timeout
    return datetime.timedelta(seconds=float(timeout))


def init_parallel_env(backend: Optional[str] = None,
                      store_path: Optional[str] = None,
                      timeout=None) -> ParallelEnv:
    """Start this process's group (see the module docstring): NCCL on
    ``cuda:<local rank>`` by default, gloo only when asked
    (``backend="gloo"``); ``store_path`` a FileStore rendezvous, else
    MASTER_ADDR / MASTER_PORT; ``timeout`` (seconds or a timedelta) for
    every collective.  Idempotent."""
    if dist.is_initialized():
        return ParallelEnv()
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_parallel_env uses NCCL on the CUDA card by default "
                "and none is available; pass backend='gloo' to run the "
                "ranks on the CPU")
        backend = "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    rank, world = dist_env.get_rank(), dist_env.get_world_size()
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=_timeout(timeout))
    if store_path is not None:
        kw["init_method"] = f"file://{os.path.abspath(store_path)}"
    else:
        addr = os.environ.get("MASTER_ADDR") or os.environ.get(
            "PADDLE_MASTER")
        port = os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise RuntimeError(
                "init_parallel_env needs a rendezvous: MASTER_ADDR and "
                "MASTER_PORT in the environment, or store_path")
        kw["init_method"] = f"tcp://{addr}:{port}"
    if backend == "nccl":
        device = torch.device("cuda", dist_env.get_device_id())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(**kw)
    from .collective import _forget_groups

    _forget_groups()
    return ParallelEnv()


def get_rank():
    return dist_env.get_rank()


def get_world_size():
    return dist_env.get_world_size()

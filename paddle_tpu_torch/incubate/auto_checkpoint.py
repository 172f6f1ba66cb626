"""Automatic checkpoints of an epoch loop, keyed by the environment, for
elastic jobs.

Counterpart of ``paddle_tpu/incubate/auto_checkpoint.py``.  A job started
again under the same ``PADDLE_JOB_ID`` (the elastic launcher restarts the
world so) resumes after the last epoch it saved::

    for epoch in acp.train_epoch_range(10):
        train_one_epoch(...)

The environment, by the reference's names:

* ``PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT`` turns it on;
* ``PADDLE_JOB_ID``: the job, the same across restarts;
* ``PADDLE_EDL_HDFS_CHECKPOINT_PATH``: the checkpoint directory;
* ``PADDLE_EDL_SAVE_CHECKPOINT_INTER``: least seconds between snapshots
  (the last epoch is always saved).

A snapshot holds every value of the global scope (a static program's
persistables) and the ``state_dict`` of each object given to
:func:`register` (layers, optimizers, LR schedulers), in
:func:`paddle_tpu_torch.io_api.save`'s format; trainer 0 writes it, and
the epoch's ``meta.json`` is replaced last, so a crash mid-save leaves the
previous snapshot loadable.  Without the environment the range is a plain
``range``.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

__all__ = ["AutoCheckpointChecker", "train_epoch_range", "register",
           "_get_train_epoch_range"]


class AutoCheckpointChecker:
    """The environment protocol (see the module docstring)."""

    def __init__(self):
        self.running_env = os.environ.get("PADDLE_RUNNING_ENV", "")
        self.job_id = os.environ.get("PADDLE_JOB_ID", "")
        self.ckpt_path = os.environ.get("PADDLE_EDL_HDFS_CHECKPOINT_PATH", "")
        try:
            self.save_checkpoint_inter = int(
                os.environ.get("PADDLE_EDL_SAVE_CHECKPOINT_INTER", "900"))
        except ValueError:
            self.save_checkpoint_inter = 900
        self.trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))

    def valid(self) -> bool:
        return (self.running_env == "PADDLE_EDL_AUTO_CHECKPOINT"
                and bool(self.job_id) and bool(self.ckpt_path))

    @property
    def job_dir(self) -> str:
        return os.path.join(self.ckpt_path, f"job_{self.job_id}")


_registered: List[object] = []
_current_range: Optional["TrainEpochRange"] = None


def register(*objects):
    """Add objects with ``state_dict`` / ``set_state_dict`` to the
    snapshots, in order (a restarted job registers the same ones)."""
    _registered.extend(objects)


def _get_train_epoch_range():
    return _current_range


def _restore_scope(state) -> None:
    """The saved scope values into the global scope: in place where the
    scope holds a tensor of that shape, else on its device."""
    import torch

    from ..framework.place import current_device
    from ..framework.scope import global_scope

    scope = global_scope()
    for name, arr in state.items():
        cur = scope.find_var(name)
        src = torch.as_tensor(arr)
        if isinstance(cur, torch.Tensor) and tuple(cur.shape) == src.shape:
            cur.copy_(src.to(cur.device, cur.dtype))
        else:
            scope.set(name, src.to(current_device()))


class TrainEpochRange:
    def __init__(self, max_epoch_num: int, name: str = "train",
                 checker: Optional[AutoCheckpointChecker] = None,
                 save_checkpoint_inter: Optional[int] = None):
        self._checker = checker or AutoCheckpointChecker()
        self.name = name
        self.max_epoch_num = max_epoch_num
        self._inter = (self._checker.save_checkpoint_inter
                       if save_checkpoint_inter is None
                       else save_checkpoint_inter)
        self._last_save = 0.0
        self.restored_from = None
        self._start = 0
        if self._checker.valid():
            self._start = self._restore()

    def _meta_path(self):
        return os.path.join(self._checker.job_dir, f"{self.name}.meta.json")

    def _state_path(self, epoch):
        return os.path.join(self._checker.job_dir,
                            f"{self.name}.epoch{epoch}")

    def _restore(self) -> int:
        """The first epoch to run: one after the saved one, else 0."""
        from ..io_api import load

        if not os.path.exists(self._meta_path()):
            return 0
        with open(self._meta_path()) as f:
            epoch = int(json.load(f).get("epoch_no", -1))
        if epoch < 0:
            return 0
        state = load(self._state_path(epoch))
        _restore_scope(state.get("scope", {}))
        objects = state.get("objects", [])
        if len(objects) != len(_registered):
            # the objects restore by position: another set would load
            # state into the wrong object
            raise RuntimeError(
                f"auto_checkpoint: the snapshot holds {len(objects)} "
                f"registered object(s) but {len(_registered)} are "
                f"registered now; register() the same objects in the same "
                f"order before train_epoch_range()")
        for obj, sd in zip(_registered, objects):
            obj.set_state_dict(sd)
        self.restored_from = epoch
        return epoch + 1

    def save(self, epoch: int):
        """Snapshot the scope and the registered objects (trainer 0)."""
        from ..framework.scope import global_scope
        from ..io_api import save
        from ..static.io import _host

        if self._checker.trainer_id != 0:
            return
        os.makedirs(self._checker.job_dir, exist_ok=True)
        scope = global_scope()
        values = {n: scope.find_var(n) for n in scope.local_names()}
        state = {"scope": {n: _host(v) for n, v in values.items()
                           if v is not None},
                 "objects": [o.state_dict() for o in _registered]}
        save(state, self._state_path(epoch))
        prev = None
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                prev = json.load(f).get("epoch_no")
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch_no": epoch, "name": self.name,
                       "time": time.time()}, f)
        os.replace(tmp, self._meta_path())   # the commit
        if prev is not None and prev != epoch:
            # the superseded snapshot goes only after the commit
            try:
                os.remove(self._state_path(prev))
            except OSError:
                pass
        self._last_save = time.time()

    def __iter__(self):
        global _current_range
        _current_range = self
        try:
            for epoch in range(self._start, self.max_epoch_num):
                yield epoch
                if (self._checker.valid()
                        and (time.time() - self._last_save >= self._inter
                             or epoch == self.max_epoch_num - 1)):
                    self.save(epoch)
        finally:
            _current_range = None


def train_epoch_range(max_epoch_num: int,
                      save_checkpoint_inter: Optional[int] = None):
    """The epochs to run, saving after each as the environment says (see
    the module docstring)."""
    return TrainEpochRange(max_epoch_num,
                           save_checkpoint_inter=save_checkpoint_inter)

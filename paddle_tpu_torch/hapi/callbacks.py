"""hapi's callbacks.

Counterpart of ``paddle_tpu/hapi/callbacks.py``: ``Callback`` and
``CallbackList`` (which calls each callback's ``on_*`` hook in list
order), ``ProgBarLogger``, ``ModelCheckpoint`` (``<save_dir>/<epoch>``
every ``save_freq`` epochs and ``<save_dir>/final``), ``EarlyStopping``
(on the eval logs), ``LRScheduler`` (steps the optimizer's scheduler by
batch or by epoch), ``ReduceLROnPlateau`` and ``VisualDL``, which writes
TensorBoard event files through :mod:`paddle_tpu_torch.utils.tensorboard`.
"""

from __future__ import annotations

import os
from typing import List, Optional


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in logs.items()
            )
            print(f"step {step}: {items}")

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.verbose:
            items = " - ".join(
                f"{k}: {v}" for k, v in logs.items()
            )
            print(f"Eval: {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir and self.model:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.wait = 0
        self.best = None
        self.stopped_epoch = 0
        self.stop_training = False

    def _better(self, cur, best):
        if best is None:
            return True
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        from ..optimizer.lr import LRScheduler as Sched

        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


class ReduceLROnPlateau(Callback):
    """Reduce the optimizer's (float) learning rate by ``factor`` after
    ``patience`` evaluations without improvement of ``monitor``, then
    wait ``cooldown`` evaluations; it reads the eval logs only."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        if factor >= 1.0:
            raise ValueError(
                "ReduceLROnPlateau does not support a factor >= 1.0")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._reset()

    def _reset(self):
        import numpy as np

        if self.mode == "max" or (self.mode == "auto"
                                  and "acc" in self.monitor):
            self._better = lambda a, b: a > b + self.min_delta
            self.best = -np.inf
        else:
            self._better = lambda a, b: a < b - self.min_delta
            self.best = np.inf
        self.wait = 0
        self.cooldown_counter = 0

    def on_train_begin(self, logs=None):
        self._reset()

    def on_eval_end(self, logs=None):
        if not logs or self.monitor not in logs:
            return
        opt = getattr(self.model, "_optimizer", None)
        if opt is None or not isinstance(
                getattr(opt, "_learning_rate", None), float):
            return  # a scheduler's rate is not managed here
        val = logs[self.monitor]
        if isinstance(val, (list, tuple)):
            val = val[0]
        current = float(val)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._better(current, self.best):
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                old = opt.get_lr()
                new = max(old * self.factor, self.min_lr)
                if new < old:
                    opt.set_lr(new)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {old:.3g} -> {new:.3g}")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """The logs' scalars as TensorBoard event files under
    ``<log_dir>/train`` and ``<log_dir>/eval`` (written by
    :mod:`paddle_tpu_torch.utils.tensorboard`), which ``tensorboard
    --logdir`` or VisualDL render."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._train_writer = None
        self._eval_writer = None
        self._global_step = 0

    def _writer(self, mode):
        from ..utils.tensorboard import SummaryWriter

        attr = f"_{mode}_writer"
        if getattr(self, attr) is None:
            import os

            setattr(self, attr, SummaryWriter(
                os.path.join(self.log_dir, mode)))
        return getattr(self, attr)

    def _log(self, mode, step, logs):
        w = self._writer(mode)
        import numpy as np

        for k, v in (logs or {}).items():
            if k in ("batch_size", "num_samples"):
                continue
            try:
                arr = np.asarray(
                    v.numpy() if hasattr(v, "numpy") else v, dtype="float64")
            except (TypeError, ValueError):
                continue
            if arr.size == 1:
                w.add_scalar(f"{mode}/{k}", float(arr.reshape(())), step)
            else:
                for i, x in enumerate(arr.reshape(-1)):
                    w.add_scalar(f"{mode}/{k}_{i}", float(x), step)
        w.flush()

    def on_train_batch_end(self, step, logs=None):
        self._global_step += 1
        self._log("train", self._global_step, logs)

    def on_eval_end(self, logs=None):
        self._log("eval", self._global_step, logs)

    def on_train_end(self, logs=None):
        for w in (self._train_writer, self._eval_writer):
            if w is not None:
                w.close()
        # a later fit/evaluate with this callback must get fresh writers
        self._train_writer = None
        self._eval_writer = None

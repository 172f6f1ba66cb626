"""``paddle.Model``: the Keras-like trainer.

Counterpart of ``paddle_tpu/hapi/model.py``: ``prepare``,
``train_batch`` / ``eval_batch`` / ``predict_batch``, ``fit`` /
``evaluate`` / ``predict``, ``save`` / ``load``, ``parameters`` and
``summary``, with two engines chosen per batch by the current mode:

* in dygraph mode the network runs eagerly (its ops on the current
  place, the card unless ``set_device`` says otherwise) and the loss's
  backward and the optimizer's ``step`` train it;
* under ``paddle.enable_static()`` :class:`_StaticAdapter` builds the
  train / eval / predict Programs from the declared ``inputs`` /
  ``labels`` InputSpecs and runs them on the static Executor.  It builds
  in the reference's order: the forward, the predict clone, the loss,
  the eval clone, then the optimizer's ops (the train program keeps them
  all).  The network's eagerly made parameters and buffers are bound into
  the programs by name, their tensors set in the adapter's scope as they
  are (shared, not copied), so the Executor's in-place update of the
  persistables trains the same Layer objects the eager engine trains.

``amp_configs`` is accepted and has no effect, as in the reference.
``save`` writes ``<path>.pdparams`` (and ``<path>.pdopt``) with
:func:`paddle_tpu_torch.save`, which ``load`` reads back in either engine.
The static engine's optimizer state is saved as the values its program's
accumulators hold (the reference saves their variables, which no engine
can load), and a loaded optimizer state seeds those accumulators.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..dygraph.tensor import Tensor
from ..io import DataLoader, Dataset
from ..metric import Metric
from ..static.input import InputSpec  # noqa: F401
from .callbacks import (Callback, CallbackList, ModelCheckpoint,  # noqa: F401
                        ProgBarLogger)
from .progressbar import ProgressBar  # noqa: F401

__all__ = ["Model", "InputSpec"]


class _EagerScope:
    """Dygraph mode inside (metric updates on fetched arrays, saving)."""

    def __enter__(self):
        from ..framework import program as fw

        self._was_static = not fw.in_dygraph_mode()
        if self._was_static:
            fw.disable_static()
        return self

    def __exit__(self, *exc):
        from ..framework import program as fw

        if self._was_static:
            fw.enable_static()
        return False


def _feed_value(a):
    """A feed as the Executor takes it: a Tensor's torch tensor (kept on
    its device), a torch tensor as it is, anything else as numpy."""
    if isinstance(a, Tensor):
        return a._t
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


class _StaticAdapter:
    """The static engine (see the module docstring)."""

    def __init__(self, model: "Model"):
        self.model = model
        self._built = False

    def _specs(self, specs, kind):
        if specs is None:
            raise RuntimeError(
                f"a static-graph Model needs {kind}=[InputSpec(...)] at "
                f"construction (the shapes of its programs' inputs)")
        specs = specs if isinstance(specs, (list, tuple)) else [specs]
        out = []
        for i, s in enumerate(specs):
            if isinstance(s, InputSpec):
                out.append(s)
            else:  # a bare shape list
                out.append(InputSpec(list(s), "float32", f"{kind}_{i}"))
        return out

    @staticmethod
    def _data(specs, stem):
        from .. import static

        return [static.data(s.name or f"{stem}_{i}",
                            [d if d is not None else -1 for d in s.shape],
                            s.dtype)
                for i, s in enumerate(specs)]

    def _bind(self, block):
        """The network's parameters and buffers as persistables of the
        program, their tensors in the scope."""
        net = self.model.network
        for _, p in net.named_parameters():
            block.create_parameter(shape=p.shape, dtype=p.dtype, name=p.name)
            self._scope.set(p.name, p._t.detach())
        for _, b in net.named_buffers():
            if isinstance(b, Tensor):
                block.create_var(name=b.name, shape=tuple(b.shape),
                                 dtype=b.dtype, persistable=True)
                self._scope.set(b.name, b._t.detach())

    def _build(self):
        if self._built:
            return
        from ..framework import program as fw
        from ..framework.scope import Scope
        from ..nn.layer_base import Layer
        from ..static.executor import Executor

        m = self.model
        self._scope = Scope()
        self._exe = Executor()
        in_specs = self._specs(m._inputs, "inputs")
        main, startup = fw.Program(), fw.Program()
        with fw.program_guard(main, startup):
            in_vars = self._data(in_specs, "x")
            net = m.network
            if isinstance(net, Layer):
                net.train()  # the train form; the clones flip is_test
                self._bind(main.global_block())
            outs = net(*in_vars)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            self._predict_prog = main.clone(for_test=True)
            self._out_names = [o.name for o in outs]

            label_vars = []
            if m._loss is not None or m._metrics:
                label_vars = self._data(self._specs(m._labels, "labels"),
                                        "label")
            loss_name = None
            if m._loss is not None:
                loss = m._loss(*outs, *label_vars)
                loss_name = loss.name
                self._eval_prog = main.clone(for_test=True)
                if m._optimizer is not None:
                    m._optimizer.minimize(loss)
            elif label_vars:
                # metrics without a loss: the label variables came after
                # the predict clone, so the eval program clones now
                self._eval_prog = main.clone(for_test=True)
            else:
                self._eval_prog = self._predict_prog
            self._train_prog = main
            self._loss_name = loss_name
        self._in_names = [v.name for v in in_vars]
        self._label_names = [v.name for v in label_vars]
        self._exe.run(startup, scope=self._scope)
        # the startup program initialised what the optimizer added; the
        # network's own values are the eagerly made (or loaded) ones, and
        # so are the optimizer's where a loaded state holds them
        if isinstance(m.network, Layer):
            for _, p in m.network.named_parameters():
                self._scope.set(p.name, p._t.detach())
        self._load_held_optimizer_state()
        self._built = True

    def _load_held_optimizer_state(self):
        """Loaded accumulator values that the optimizer holds for its
        first step, into the program's accumulators in the scope."""
        opt = self.model._optimizer
        if opt is None:
            return
        with torch.no_grad():
            for acc_name, store in opt._accumulators.items():
                for pname, var in store.items():
                    held = opt._accumulators_holder.pop(
                        f"{pname}_{acc_name}_0", None)
                    t = self._scope.find_var(var.name)
                    if held is not None and isinstance(t, torch.Tensor):
                        t.copy_(torch.as_tensor(np.asarray(held)).reshape(
                            t.shape))

    def optimizer_state(self):
        """The optimizer's ``state_dict`` with the values of the program's
        accumulators (which the scope holds) in place of their
        variables."""
        from ..framework import program as fw

        state = self.model._optimizer.state_dict()
        for k, v in state.items():
            if isinstance(v, fw.Variable):
                t = self._scope.find_var(v.name)
                state[k] = t.detach().cpu().numpy()
        return state

    def _feeds(self, ins, labels=None):
        feed = {n: _feed_value(a) for n, a in zip(self._in_names, ins)}
        if labels is not None:
            labels = (labels if isinstance(labels, (list, tuple))
                      else [labels])
            feed.update({n: _feed_value(a)
                         for n, a in zip(self._label_names, labels)})
        return feed

    def train_batch(self, ins, labels=None):
        self._build()
        fetches = [self._loss_name] + self._out_names
        res = self._exe.run(self._train_prog, feed=self._feeds(ins, labels),
                            fetch_list=fetches, scope=self._scope)
        loss, outs = res[0], res[1:]
        self._update_metrics(outs, labels)
        return Tensor(np.asarray(loss), stop_gradient=True)

    def eval_batch(self, ins, labels=None):
        self._build()
        fetches = ([self._loss_name] if self._loss_name else []) \
            + self._out_names
        res = self._exe.run(self._eval_prog, feed=self._feeds(ins, labels),
                            fetch_list=fetches, scope=self._scope)
        if self._loss_name:
            loss, outs = res[0], res[1:]
        else:
            loss, outs = np.zeros(()), res
        self._update_metrics(outs, labels)
        return Tensor(np.asarray(loss), stop_gradient=True)

    def predict_batch(self, ins):
        self._build()
        res = self._exe.run(self._predict_prog, feed=self._feeds(ins),
                            fetch_list=self._out_names, scope=self._scope)
        outs = [Tensor(np.asarray(r), stop_gradient=True) for r in res]
        return outs[0] if len(outs) == 1 else outs

    def _update_metrics(self, outs, labels):
        m = self.model
        if not m._metrics:
            return
        with _EagerScope():
            out_t = [Tensor(np.asarray(o), stop_gradient=True)
                     for o in outs]
            labels = (labels if isinstance(labels, (list, tuple))
                      else [labels])
            lab_t = [Tensor(np.asarray(
                lb.numpy() if hasattr(lb, "numpy") else lb),
                stop_gradient=True) for lb in labels]
            for metric in m._metrics:
                Model._update_metric(
                    metric, out_t[0] if len(out_t) == 1 else out_t, lab_t)

    def sync_to_network(self):
        """The scope's values into the Layer's parameters, so that
        ``state_dict`` and ``save`` see the static engine's training (a
        no-op where the scope holds the parameters' own tensors)."""
        from ..nn.layer_base import Layer

        if not self._built or not isinstance(self.model.network, Layer):
            return
        with torch.no_grad():
            for _, p in self.model.network.named_parameters():
                t = self._scope.find_var(p.name)
                if isinstance(t, torch.Tensor) and \
                        t.data_ptr() != p._t.data_ptr():
                    p._t.copy_(t)


class Model:
    """The network with its optimizer, loss and metrics (``prepare``),
    trained, evaluated and used to predict by batch or over datasets."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False

    # ------------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            metrics = []
        elif isinstance(metrics, Metric):
            metrics = [metrics]
        self._metrics = list(metrics)

    # ------------------------------------------------------------------
    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            raise RuntimeError("call prepare(loss=...) before training")
        if not isinstance(outputs, (list, tuple)):
            outputs = [outputs]
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        return self._loss(*outputs, *labels)

    @staticmethod
    def _update_metric(m, outputs, labels):
        label = labels[0] if isinstance(labels, (list, tuple)) else labels
        res = m.compute(outputs, label)
        if not isinstance(res, tuple):
            res = (res,)
        m.update(*res)

    @property
    def _adapter(self) -> Optional[_StaticAdapter]:
        from ..framework import program as fw

        if fw.in_dygraph_mode():
            return None
        if getattr(self, "_static_adapter", None) is None:
            self._static_adapter = _StaticAdapter(self)
        return self._static_adapter

    def train_batch(self, inputs, labels=None):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        adapter = self._adapter
        if adapter is not None:
            return adapter.train_batch(inputs, labels)
        self.network.train()
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        loss.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        for m in self._metrics:
            self._update_metric(m, outputs, labels)
        return loss

    def eval_batch(self, inputs, labels=None):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        adapter = self._adapter
        if adapter is not None:
            return adapter.eval_batch(inputs, labels)
        self.network.eval()
        from ..dygraph.base import no_grad

        with no_grad():
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels)
        for m in self._metrics:
            self._update_metric(m, outputs, labels)
        return loss

    def predict_batch(self, inputs):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        adapter = self._adapter
        if adapter is not None:
            return adapter.predict_batch(inputs)
        self.network.eval()
        from ..dygraph.base import no_grad

        with no_grad():
            return self.network(*inputs)

    # ------------------------------------------------------------------
    @staticmethod
    def _as_loader(data, batch_size, shuffle, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers)
        return data  # any iterable of batches

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return list(batch[:-1]), batch[-1]
            return [batch[0]], None
        return [batch], None

    def _logs(self, logs):
        for m in self._metrics:
            name = m.name()
            acc = m.accumulate()
            logs[name if isinstance(name, str) else name[0]] = (
                acc if not isinstance(acc, (list, tuple)) else acc[0])
        return logs

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        loader = self._as_loader(train_data, batch_size, shuffle, num_workers)
        eval_loader = self._as_loader(eval_data, batch_size, False,
                                      num_workers)

        cbks = [ProgBarLogger(log_freq, verbose=verbose)]
        if save_dir:
            cbks.append(ModelCheckpoint(save_freq, save_dir))
        if callbacks:
            cbks.extend(callbacks)
        cbk = CallbackList(cbks)
        cbk.set_model(self)
        steps = None
        try:
            steps = len(loader)
        except TypeError:
            pass
        cbk.set_params({"epochs": epochs, "steps": steps, "verbose": verbose})

        cbk.on_train_begin()
        it = 0
        logs = {}
        for epoch in range(epochs):
            cbk.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            for step, batch in enumerate(loader):
                cbk.on_train_batch_begin(step)
                ins, label = self._split_batch(batch)
                loss = self.train_batch(ins, label)
                logs = self._logs({"loss": float(loss.numpy())})
                cbk.on_train_batch_end(step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    break
            cbk.on_epoch_end(epoch, logs or None)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, batch_size=batch_size,
                              verbose=verbose, num_workers=num_workers,
                              _cbk=cbk)
            if any(getattr(c, "stop_training", False) for c in cbks):
                break
            if num_iters is not None and it >= num_iters:
                break
        cbk.on_train_end()

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None, _cbk=None):
        loader = self._as_loader(eval_data, batch_size, False, num_workers)
        if _cbk is None and callbacks:
            _cbk = CallbackList(list(callbacks))
            _cbk.set_model(self)
        if _cbk is not None:
            _cbk.on_eval_begin()
        for m in self._metrics:
            m.reset()
        total_loss, n = 0.0, 0
        for step, batch in enumerate(loader):
            if _cbk is not None:
                _cbk.on_eval_batch_begin(step)
            ins, label = self._split_batch(batch)
            loss = self.eval_batch(ins, label)
            total_loss += float(loss.numpy())
            n += 1
            if _cbk is not None:
                _cbk.on_eval_batch_end(step, {"loss": float(loss.numpy())})
        logs = {"loss": total_loss / max(n, 1)}
        for m in self._metrics:
            name = m.name()
            logs[name if isinstance(name, str) else name[0]] = m.accumulate()
        if _cbk is not None:
            _cbk.on_eval_end(logs)
        if verbose:
            print("Eval - " + " - ".join(f"{k}: {v}" for k, v in logs.items()))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._as_loader(test_data, batch_size, False, num_workers)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch)
            out = self.predict_batch(ins)
            outputs.append(out.numpy() if hasattr(out, "numpy") else out)
        if stack_outputs and outputs and isinstance(outputs[0], np.ndarray):
            return [np.concatenate(outputs)]
        return [outputs]

    # ------------------------------------------------------------------
    def save(self, path, training=True):
        from .. import io_api

        # the static engine's values into the Layer objects, so one
        # state_dict serves both engines
        adapter = getattr(self, "_static_adapter", None)
        if adapter is not None:
            adapter.sync_to_network()
        with _EagerScope():
            io_api.save(self.network.state_dict(), path + ".pdparams")
            if training and self._optimizer is not None:
                state = (adapter.optimizer_state()
                         if adapter is not None and adapter._built
                         else self._optimizer.state_dict())
                io_api.save(state, path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from .. import io_api

        state = io_api.load(path + ".pdparams")
        self.network.set_state_dict(state)
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(io_api.load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        total = 0
        lines = ["-" * 60]
        for name, p in self.network.named_parameters():
            n = int(np.prod(p.shape))
            total += n
            lines.append(f"{name:<40} {str(tuple(p.shape)):<15} {n}")
        lines.append("-" * 60)
        lines.append(f"Total params: {total}")
        print("\n".join(lines))
        return {"total_params": total}

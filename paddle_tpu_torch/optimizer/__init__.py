"""``paddle.optimizer``: the Optimizer base and SGD, Momentum,
LarsMomentum, Adam, AdamW, Lamb, RMSProp, Adagrad, Adadelta, Adamax, and
the schedulers of :mod:`.lr`.

Counterpart of ``paddle_tpu/optimizer/__init__.py``, in dygraph mode.
Every optimizer runs its registered update op (:mod:`paddle_tpu_torch.
ops.optimizer_ops`) once per parameter and writes the outputs back: the
parameter in place (it stays the same leaf tensor), its accumulators by
rebinding.  Accumulators are keyed by the parameter's unique name, and
the state dict uses the reference's keys (``{param}_{acc}_0``, e.g.
``linear_0.w_0_moment1_0``), so the two packages' state dicts carry
over.  With ``multi_precision`` (or ``amp.decorate(level="O2")``) a
bf16 / fp16 parameter is updated through an fp32 master weight.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..dygraph.tensor import Tensor
from ..dygraph import tracer
from . import lr as lr_sched_mod
from .lr import LRScheduler

__all__ = [
    "Optimizer", "SGD", "Momentum", "LarsMomentum", "Adam", "AdamW", "Lamb",
    "RMSProp", "Adagrad", "Adadelta", "Adamax", "lr",
]

lr = lr_sched_mod


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        from ..regularizer import L2Decay

        if isinstance(weight_decay, (int, float)) and not isinstance(
                weight_decay, bool):
            self.regularization = L2Decay(float(weight_decay))
        else:
            self.regularization = weight_decay
        self._grad_clip = grad_clip
        # accumulators: acc_name -> param_name -> Tensor
        self._accumulators: Dict[str, Dict[str, Tensor]] = {}
        # state loaded before its accumulator exists, keyed ``{param}_
        # {acc}_0`` and consumed by _add_accumulator
        self._accumulators_holder: Dict[str, object] = {}
        self._lr_cache: Dict[torch.device, Tuple[float, torch.Tensor]] = {}
        self._multi_precision = False

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def _lr_input(self, p):
        """The LearningRate input on ``p``'s device: [1] fp32, made once
        per value and device."""
        value = self.get_lr()
        dev = p._t.device
        hit = self._lr_cache.get(dev)
        if hit is None or hit[0] != value:
            hit = (value, torch.tensor([value], dtype=torch.float32,
                                       device=dev))
            self._lr_cache[dev] = hit
        return Tensor._wrap(hit[1])

    # -- accumulators -----------------------------------------------------
    def _add_accumulator(self, name: str, param, fill_value: float = 0.0,
                         shape=None, dtype=None):
        store = self._accumulators.setdefault(name, {})
        pname = param.name
        if pname in store:
            return store[pname]
        shape = list(shape if shape is not None else param.shape)
        dt = _torch_dtype(dtype or "float32")
        held = self._pop_held(pname, name, dt, shape, param._t.device)
        if held is None:
            held = torch.full(shape, fill_value, dtype=dt,
                              device=param._t.device)
        acc = Tensor._wrap(held)
        store[pname] = acc
        return acc

    def _pop_held(self, pname, acc_name, dtype, shape=None, device=None):
        """A value stashed by set_state_dict for a not-yet-created
        accumulator (cast and reshaped), or None."""
        held = self._accumulators_holder.pop(f"{pname}_{acc_name}_0", None)
        if held is None:
            return None
        t = torch.as_tensor(np.asarray(held), device=device).to(dtype)
        return t.reshape(shape) if shape is not None else t

    # -- fp32 master weights ----------------------------------------------
    def _master_weight(self, p):
        """The fp32 master copy of a low-precision parameter (from its
        current value on first touch; ``amp.decorate`` seeds it from the
        fp32 weights before the cast)."""
        store = self._accumulators.setdefault("master_weight", {})
        mw = store.get(p.name)
        if mw is None:
            held = self._pop_held(p.name, "master_weight", torch.float32,
                                  device=p._t.device)
            mw = Tensor._wrap(held if held is not None
                              else p._t.detach().float().clone())
            mw.name = p.name  # per-parameter accumulators keep their keys
            store[p.name] = mw
        return mw

    def _update_target(self, p):
        """(target, finalize): the tensor the update writes (the master
        under multi_precision) and a callback that mirrors the new master
        into the low-precision parameter."""
        if self._multi_precision and p._t.dtype in (torch.float16,
                                                    torch.bfloat16):
            mw = self._master_weight(p)

            def finalize():
                with torch.no_grad():
                    p._t.copy_(mw._t.to(p._t.dtype))

            return mw, finalize
        return p, None

    # -- the shared update ------------------------------------------------
    def _run_update(self, op_type: str, ins: Dict[str, list],
                    bind: Dict[str, object], attrs: Dict[str, object]):
        """Run an update op; ``bind`` maps output slot -> the Tensor that
        takes the new value (a parameter in place, an accumulator by
        rebinding)."""
        arrays = {s: [t._t if isinstance(t, Tensor) else t for t in vs]
                  for s, vs in ins.items()}
        outs = tracer.run_eager_kernel(op_type, arrays, attrs)
        for slot, target in bind.items():
            if slot not in outs or target is None:
                continue
            new = outs[slot][0]
            if target._t.requires_grad or target.persistable:
                with torch.no_grad():
                    target._t.copy_(new)
            else:
                target._t = new

    # -- main entries ------------------------------------------------------
    def _params_grads_dygraph(self) -> List[Tuple]:
        if self._parameter_list is None:
            raise ValueError("pass `parameters=` to the optimizer")
        out = []
        for p in self._parameter_list:
            if getattr(p, "trainable", True):
                g = p.grad
                if g is not None:
                    out.append((p, g))
        return out

    def _apply_regularization(self, params_grads):
        if self.regularization is None:
            return params_grads
        out = []
        for p, g in params_grads:
            reg = getattr(p, "regularizer", None) or self.regularization
            if reg is not None:
                g = reg(p, g)
            out.append((p, g))
        return out

    def _apply_clip(self, params_grads):
        if self._grad_clip is not None:
            return self._grad_clip(params_grads)
        return params_grads

    @property
    def _param_groups(self):
        return self._parameter_list

    @torch.no_grad()
    def step(self):
        """The update of every parameter with a gradient: regularization,
        the gradient clip, then each parameter's update op."""
        params_grads = self._params_grads_dygraph()
        params_grads = self._apply_regularization(params_grads)
        params_grads = self._apply_clip(params_grads)
        for p, g in params_grads:
            self._apply_optimize_op(p, g)
        if self._accumulators_holder:
            # held state that can no longer be consumed: keys of unknown
            # parameters, and keys of parameters that just stepped (this
            # optimizer never makes that accumulator)
            owned = {p.name for p in (self._parameter_list or [])}
            stepped = {p.name for p, _ in params_grads}
            orphans = []
            for k in list(self._accumulators_holder):
                owner = max((n for n in owned if k.startswith(n + "_")),
                            key=len, default=None)
                if owner is None or owner in stepped:
                    orphans.append(k)
                    self._accumulators_holder.pop(k)
            if orphans:
                import warnings

                warnings.warn(
                    f"optimizer.set_state_dict: {len(orphans)} loaded key(s) "
                    f"could not be applied to this optimizer and were "
                    f"ignored: {sorted(orphans)[:8]}"
                    + ("..." if len(orphans) > 8 else ""))

    def clear_grad(self):
        if self._parameter_list:
            for p in self._parameter_list:
                p.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()
        return None, self._params_grads_dygraph()

    @torch.no_grad()
    def apply_gradients(self, params_grads):
        params_grads = self._apply_regularization(params_grads)
        params_grads = self._apply_clip(params_grads)
        for p, g in params_grads:
            self._apply_optimize_op(p, g)

    def _apply_optimize_op(self, p, g):
        target, finalize = self._update_target(p)
        self._append_optimize_op(target, g)
        if finalize is not None:
            finalize()

    def _append_optimize_op(self, param, grad):
        raise NotImplementedError

    # -- state dict --------------------------------------------------------
    def state_dict(self):
        """Keys ``{param}_{acc}_0`` (e.g. ``linear_0.w_0_moment1_0``), the
        reference's accumulator names; ``LR_Scheduler`` for a
        scheduler."""
        d = dict(self._accumulators_holder)
        for acc_name, store in self._accumulators.items():
            for pname, acc in store.items():
                d[f"{pname}_{acc_name}_0"] = acc
        if isinstance(self._learning_rate, LRScheduler):
            d["LR_Scheduler"] = self._learning_rate.state_dict()
        return d

    def _find_accumulator(self, key):
        if "/" in key:
            pname, acc_name = key.rsplit("/", 1)
            return self._accumulators.get(acc_name, {}).get(pname)
        for acc_name, store in self._accumulators.items():
            suffix = f"_{acc_name}_0"
            if key.endswith(suffix):
                tgt = store.get(key[: -len(suffix)])
                if tgt is not None:
                    return tgt
        return None

    def set_state_dict(self, state):
        for key, val in state.items():
            if key == "LR_Scheduler":
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(val)
                continue
            tgt = self._find_accumulator(key)
            if tgt is not None:
                tgt.set_value(val)
                continue
            # accumulators are made at the first step(): keep the value
            # (a snapshot) until _add_accumulator asks for it
            if "/" in key:
                pname, acc_name = key.rsplit("/", 1)
                key = f"{pname}_{acc_name}_0"
            self._accumulators_holder[key] = np.array(
                val.numpy() if hasattr(val, "numpy") else val)

    set_dict = set_state_dict


def _torch_dtype(d):
    from ..framework.dtype import to_torch_dtype

    return to_torch_dtype(d)


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)

    def _append_optimize_op(self, p, g):
        self._run_update(
            "sgd",
            {"Param": [p], "Grad": [g], "LearningRate": [self._lr_input(p)]},
            {"ParamOut": p},
            {},
        )


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_optimize_op(self, p, g):
        vel = self._add_accumulator("velocity", p)
        self._run_update(
            "momentum",
            {"Param": [p], "Grad": [g], "Velocity": [vel],
             "LearningRate": [self._lr_input(p)]},
            {"ParamOut": p, "VelocityOut": vel},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class LarsMomentum(Optimizer):
    """Layer-wise Adaptive Rate Scaling (parity:
    ``fluid/optimizer.py`` LarsMomentumOptimizer / lars_momentum_op) —
    large-batch vision training."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, epsilon=0.0,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _append_optimize_op(self, p, g):
        vel = self._add_accumulator("velocity", p)
        self._run_update(
            "lars_momentum",
            {"Param": [p], "Grad": [g], "Velocity": [vel],
             "LearningRate": [self._lr_input(p)]},
            {"ParamOut": p, "VelocityOut": vel},
            {"mu": self._momentum, "lars_coeff": self._lars_coeff,
             "lars_weight_decay": self._lars_weight_decay,
             "epsilon": self._epsilon},
        )


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._multi_precision = bool(multi_precision)

    _op = "adam"

    def _extra_attrs(self):
        return {}

    def _append_optimize_op(self, p, g):
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1])
        b2p = self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2, shape=[1])
        self._run_update(
            self._op,
            {"Param": [p], "Grad": [g], "LearningRate": [self._lr_input(p)],
             "Moment1": [m1], "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
             "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon,
             **self._extra_attrs()},
        )


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        if isinstance(weight_decay, (int, float)) and not isinstance(weight_decay, bool):
            self._coeff = float(weight_decay)
        else:
            self._coeff = 0.01
        self._apply_decay_param_fun = apply_decay_param_fun

    _op = "adamw"

    def _extra_attrs(self):
        return {"coeff": self._coeff, "with_decay": True}

    def _append_optimize_op(self, p, g):
        if self._apply_decay_param_fun is not None and not self._apply_decay_param_fun(p.name):
            # fall back to plain adam for excluded params
            saved, self._op = self._op, "adam"
            try:
                Adam._append_optimize_op(self, p, g)
            finally:
                self._op = saved
            return
        Adam._append_optimize_op(self, p, g)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, p, g):
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1])
        b2p = self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2, shape=[1])
        wd = self._wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        self._run_update(
            "lamb",
            {"Param": [p], "Grad": [g], "LearningRate": [self._lr_input(p)],
             "Moment1": [m1], "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
             "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon,
             "weight_decay": wd},
        )


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _append_optimize_op(self, p, g):
        ms = self._add_accumulator("mean_square", p)
        mom = self._add_accumulator("momentum", p)
        ins = {"Param": [p], "Grad": [g], "LearningRate": [self._lr_input(p)],
               "MeanSquare": [ms], "Moment": [mom]}
        bind = {"ParamOut": p, "MeanSquareOut": ms, "MomentOut": mom}
        if self._centered:
            mg = self._add_accumulator("mean_grad", p)
            ins["MeanGrad"] = [mg]
            bind["MeanGradOut"] = mg
        self._run_update(
            "rmsprop", ins, bind,
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum, "centered": self._centered},
        )


class Adadelta(Optimizer):
    """Parity: paddle.optimizer.Adadelta (adadelta_op.cc)."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon, self._rho = epsilon, rho

    def _append_optimize_op(self, p, g):
        g2 = self._add_accumulator("_avg_squared_grad", p)
        u2 = self._add_accumulator("_avg_squared_update", p)
        self._run_update(
            "adadelta",
            {"Param": [p], "Grad": [g], "LearningRate": [self._lr_input(p)],
             "AvgSquaredGrad": [g2], "AvgSquaredUpdate": [u2]},
            {"ParamOut": p, "AvgSquaredGradOut": g2,
             "AvgSquaredUpdateOut": u2},
            {"rho": self._rho, "epsilon": self._epsilon},
        )


class Adamax(Optimizer):
    """Parity: paddle.optimizer.Adamax (adamax_op.cc, infinity norm)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, p, g):
        m = self._add_accumulator("moment", p)
        inf = self._add_accumulator("inf_norm", p)
        b1p = self._add_accumulator("beta1_pow_acc", p,
                                    fill_value=self._beta1, shape=[1])
        self._run_update(
            "adamax",
            {"Param": [p], "Grad": [g], "LearningRate": [self._lr_input(p)],
             "Moment": [m], "InfNorm": [inf], "Beta1Pow": [b1p]},
            {"ParamOut": p, "MomentOut": m, "InfNormOut": inf,
             "Beta1PowOut": b1p},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon},
        )


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, initial_accumulator_value=0.0,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _append_optimize_op(self, p, g):
        mom = self._add_accumulator("moment", p, fill_value=self._init_acc)
        self._run_update(
            "adagrad",
            {"Param": [p], "Grad": [g], "LearningRate": [self._lr_input(p)],
             "Moment": [mom]},
            {"ParamOut": p, "MomentOut": mom},
            {"epsilon": self._epsilon},
        )

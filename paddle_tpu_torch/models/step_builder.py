"""The generic train step for any ``nn.Layer``: forward, backward and a
momentum or AdamW update over fp32 masters.

Counterpart of ``paddle_tpu/models/step_builder.py`` with its signature and
its state: :func:`build_model_train_step` returns ``(step_fn, params,
buffers, opt_state)`` and ``step_fn(params, buffers, opt_state, *batch)``
returns ``(params, buffers, opt_state, loss)``.

* ``params`` are fp32 copies of the model's trainable parameters (the
  masters), cast to ``compute_dtype`` where the forward uses them; floating
  inputs are cast too.  The model keeps its own tensors at their initial
  values: it is the template the step swaps the state into.
* ``buffers`` (BatchNorm's running statistics) are swapped into their
  layers before the forward and read back after it: the step returns the
  forward's new ones.
* The gradient is ``torch.autograd.grad`` of the fp32 loss over the
  masters, with torch's grad mode on: torch autograd is the port's tape,
  where the reference turns its tracer's tape off and differentiates with
  ``jax.value_and_grad``.
* The updates are the reference's, written over ``torch._foreach_*`` in
  place on the masters and the moments (not ``torch.optim``, whose decay
  is ordered and rounded differently): momentum ``gf = g + wd * p; v = mu
  * v + gf; p -= lr * v``; AdamW ``m = b1 m + (1 - b1) g; v = b2 v + (1 -
  b2) g^2; p -= lr ((m / b1t) / (sqrt(v / b2t) + eps) + wd p)`` with
  ``bNt = 1 - bN ** t``.  ``opt_state["t"]`` counts the steps.

``inline_kernels`` groups the reference's jitted kernels; eager PyTorch
has nothing to group, so it is accepted and has no effect (ROADMAP C).

**Data parallel.**  On an installed hybrid mesh whose data-parallel group
(``dp`` x ``sharding`` for ``dp_axis="dp"``, else the ``dp_axis`` group)
has more than one rank, each rank's batch is its rows of the global batch
(:func:`~paddle_tpu_torch.distributed.mesh.shard_batch`), as the
reference shards one SPMD program over it: the gradients are averaged
over the group (one coalesced all-reduce) before the update, so every
rank takes the update of the global batch's mean loss, and the returned
loss is that mean on every rank.  BatchNorm reduces its statistics over
the same group (``ops/nn_ops.py``).  Such a mesh without an initialised
process group raises RuntimeError.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.collective import _coalesced

__all__ = ["build_model_train_step"]


def _data_group(mesh, dp_axis):
    """``(process group, ranks)`` of the mesh's data-parallel group, or
    None on one rank."""
    if mesh is None:
        return None
    axes = ("dp", "sharding") if dp_axis == "dp" else dp_axis
    n = int(np.prod([mesh.shape[a] for a in (
        axes if isinstance(axes, tuple) else (axes,))]))
    if n <= 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            f"build_model_train_step on a mesh with a data-parallel group "
            f"of {n} ranks needs an initialised process group "
            "(init_parallel_env / fleet.init)")
    return mesh.group(axes), n


def build_model_train_step(
    model,
    loss_builder: Callable,
    *,
    optimizer: str = "momentum",
    lr: float = 0.1,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    compute_dtype: Optional[str] = "bfloat16",
    dp_axis: str = "dp",
    inline_kernels: bool = False,
):
    """``loss_builder(model, *batch_tensors) -> Tensor`` runs the forward
    and the loss on the port's Tensors.

    Returns ``(step_fn, params, buffers, opt_state)`` with
    ``step_fn(params, buffers, opt_state, *batch) -> (params, buffers,
    opt_state, loss)``; a batch entry is a Tensor, a torch tensor or a
    numpy array (moved to the parameters' device).  ``params`` and the
    moments are updated in place and returned; ``loss`` is a 0-d fp32
    torch tensor."""
    from ..distributed import mesh as mesh_mod
    from ..dygraph.tensor import Tensor
    from ..framework.dtype import to_torch_dtype

    if optimizer not in ("momentum", "adamw"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    data = _data_group(mesh_mod.get_mesh(), dp_axis)

    model.train()
    param_objs = [p for p in model.parameters()
                  if not getattr(p, "stop_gradient", False)]
    buf_sites = [(layer, name)
                 for layer in model.sublayers(include_self=True)
                 for name in list(layer._buffers)]
    # copies: the model stays a valid template at its initial weights
    params = [p._t.detach().clone() for p in param_objs]
    buffers = [layer._buffers[name]._t.detach().clone()
               for layer, name in buf_sites]
    device = params[0].device if params else torch.device("cpu")
    cd = to_torch_dtype(compute_dtype) if compute_dtype is not None else None

    def _to_compute(a):
        if cd is not None and a.dtype != cd and a.is_floating_point():
            return a.to(cd)
        return a

    def _as_input(a):
        if isinstance(a, Tensor):
            a = a._t
        elif not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return _to_compute(a.to(device))

    def run_loss(masters, buf_arrays, batch):
        old_p = [p._t for p in param_objs]
        old_b = [layer._buffers[name] for layer, name in buf_sites]
        for p, a in zip(param_objs, masters):
            p._t = _to_compute(a)
        for (layer, name), a in zip(buf_sites, buf_arrays):
            layer._buffers[name] = Tensor._wrap(a)
        try:
            loss = loss_builder(model, *[Tensor._wrap(a) for a in batch])
            new_bufs = [layer._buffers[name]._t.detach()
                        for layer, name in buf_sites]
            return loss._t.float(), new_bufs
        finally:
            for p, a in zip(param_objs, old_p):
                p._t = a
            for (layer, name), t in zip(buf_sites, old_b):
                layer._buffers[name] = t

    if optimizer == "momentum":
        opt_state = {"v": [torch.zeros_like(p) for p in params], "t": 0}
    else:
        opt_state = {"m": [torch.zeros_like(p) for p in params],
                     "v": [torch.zeros_like(p) for p in params], "t": 0}

    def step(params, buffers, opt_state, *batch):
        batch = [_as_input(a) for a in batch]
        masters = [p.detach().requires_grad_() for p in params]
        with torch.enable_grad():
            loss, new_bufs = run_loss(masters, buffers, batch)
            grads = torch.autograd.grad(loss, masters, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(params, grads)]
        if data is not None:
            group, n = data
            _coalesced(grads, lambda b: dist.all_reduce(b, group=group))
            torch._foreach_div_(grads, float(n))
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=group)
            loss = loss / n
        t = opt_state["t"] + 1
        with torch.no_grad():
            if optimizer == "momentum":
                v = opt_state["v"]
                gf = torch._foreach_add(grads, params, alpha=weight_decay)
                torch._foreach_mul_(v, momentum)
                torch._foreach_add_(v, gf)
                torch._foreach_add_(params, v, alpha=-lr)
                new_state = {"v": v, "t": t}
            else:
                m, v = opt_state["m"], opt_state["v"]
                b1t = float(1.0 - np.float32(beta1) ** np.float32(t))
                b2t = float(1.0 - np.float32(beta2) ** np.float32(t))
                torch._foreach_mul_(m, beta1)
                torch._foreach_add_(m, grads, alpha=1.0 - beta1)
                torch._foreach_mul_(v, beta2)
                torch._foreach_addcmul_(v, grads, grads, value=1.0 - beta2)
                den = torch._foreach_div(v, b2t)
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, eps)
                upd = torch._foreach_div(m, b1t)
                torch._foreach_div_(upd, den)
                torch._foreach_add_(upd, params, alpha=weight_decay)
                torch._foreach_add_(params, upd, alpha=-lr)
                new_state = {"m": m, "v": v, "t": t}
        return params, new_bufs, new_state, loss.detach()

    return step, params, buffers, opt_state

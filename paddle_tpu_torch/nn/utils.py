"""``paddle.nn.utils``: ``weight_norm``, ``remove_weight_norm`` and
``spectral_norm``.

Counterpart of ``paddle_tpu/nn/utils.py``: a layer's weight is
reparameterised as ``g * v / ||v||`` (weight norm, the norm over every dim
but ``dim``) or ``w / sigma_max`` (spectral norm, by power iteration) and
recomputed before every forward by a pre-hook.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm"]


def _row_norms(a, dim):
    """The 2-norm of ``a`` over every dim but ``dim`` ([a.shape[dim]]), or
    of all of it ([1]) for ``dim=None``."""
    if dim is None:
        return torch.sqrt(torch.sum(torch.square(a))).reshape(1)
    perm = [dim] + [i for i in range(a.ndim) if i != dim]
    mat = a.permute(perm).reshape(a.shape[dim], -1)
    return torch.sqrt(torch.sum(torch.square(mat), dim=1))


def weight_norm(layer, name="weight", dim=0):
    """Split ``layer.<name>`` into its direction ``<name>_v`` and
    magnitude ``<name>_g`` (parameters); the weight is recomposed before
    every forward."""
    from ..dygraph import tracer

    w = getattr(layer, name)
    g0 = tracer.trace_fn(lambda a: _row_norms(a, dim), [w], name="wn_norm")
    v = layer.create_parameter(shape=list(w.shape))
    v.set_value(w)
    g = layer.create_parameter(shape=list(g0.shape))
    g.set_value(g0)
    setattr(layer, name + "_v", v)
    setattr(layer, name + "_g", g)
    # the weight becomes derived state, not a parameter
    del layer._parameters[name]

    def recompute(lyr, inputs):
        def fn(vv, gg):
            if dim is None:
                return vv * (gg.reshape(()) / _row_norms(vv, None)[0])
            perm = [dim] + [i for i in range(vv.ndim) if i != dim]
            scale = (gg / _row_norms(vv, dim)).reshape(
                (-1,) + (1,) * (vv.ndim - 1))
            return (vv.permute(perm) * scale).permute(
                list(np.argsort(perm)))

        new_w = tracer.trace_fn(fn, [getattr(lyr, name + "_v"),
                                     getattr(lyr, name + "_g")],
                                name="weight_norm")
        object.__setattr__(lyr, name, new_w)

    h = layer.register_forward_pre_hook(recompute)
    layer._weight_norm_hook = (h, name, dim)
    recompute(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """The recomposed weight as a plain parameter again."""
    h, nm, _ = layer._weight_norm_hook
    h.remove()
    w = getattr(layer, nm)
    p = layer.create_parameter(shape=list(w.shape))
    p.set_value(w)
    layer._parameters[nm] = p
    object.__setattr__(layer, nm, p)
    for suffix in ("_v", "_g"):
        layer._parameters.pop(nm + suffix, None)
    del layer._weight_norm_hook
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """``layer.<name>`` divided by its top singular value (a
    :class:`~paddle_tpu_torch.nn.SpectralNorm` over ``<name>_orig``)
    before every forward."""
    from .layer.extras import SpectralNorm

    w = getattr(layer, name)
    sn = SpectralNorm(list(w.shape), dim=0 if dim is None else dim,
                      power_iters=n_power_iterations, eps=eps)
    layer._spectral_norm = sn
    raw = layer.create_parameter(shape=list(w.shape))
    raw.set_value(w)
    setattr(layer, name + "_orig", raw)
    del layer._parameters[name]

    def recompute(lyr, inputs):
        object.__setattr__(lyr, name, sn(getattr(lyr, name + "_orig")))

    layer.register_forward_pre_hook(recompute)
    recompute(layer, None)
    return layer

"""ASP: automatic 2:4 structured sparsity.

Counterpart of ``paddle_tpu/incubate/asp.py``, after the reference's
``fluid/contrib/sparsity/`` (``prune_model``, ``decorate``; ``get_mask_1d``,
``check_sparsity``, ``calculate_density``).  ASP is a model-quality tool
here, as in the JAX package: training keeps n:m masks on the weights
across optimizer steps, and the products stay dense (the card's sparse
tensor cores are not used).

The masks are picked on the host with the JAX package's numpy code
(``argsort`` of ``|w|`` in groups of m), on a copy of the weight, and
held on the weight's device in its dtype; ``torch.topk`` on the card can
break ties another way.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "calculate_density", "check_sparsity", "get_mask_1d", "prune_model",
    "decorate", "reset_excluded_layers", "set_excluded_layers", "ASPHelper",
]

_EXCLUDED: set = set()


def _host(x) -> np.ndarray:
    from ..dygraph.tensor import Tensor

    if isinstance(x, Tensor):
        x = x._t
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def calculate_density(x) -> float:
    """The share of non-zero elements."""
    a = _host(x)
    return float(np.count_nonzero(a)) / a.size


def get_mask_1d(mat, n: int = 2, m: int = 4) -> np.ndarray:
    """The n:m mask along the last dim: the n largest |values| of every
    group of m are kept."""
    a = _host(mat)
    shape = a.shape
    assert shape[-1] % m == 0, f"last dim {shape[-1]} not divisible by {m}"
    g = np.abs(a).reshape(-1, m)
    order = np.argsort(g, axis=1)  # ascending
    mask = np.zeros_like(g, dtype=bool)
    np.put_along_axis(mask, order[:, m - n:], True, axis=1)
    return mask.reshape(shape)


def check_sparsity(mat, n: int = 2, m: int = 4) -> bool:
    """True when every group of m along the last dim has at most n
    non-zeros."""
    a = _host(mat)
    if a.shape[-1] % m:
        return False
    g = (np.abs(a.reshape(-1, m)) > 0).sum(axis=1)
    return bool((g <= n).all())


def set_excluded_layers(param_names: List[str], main_program=None):
    _EXCLUDED.update(param_names)


def reset_excluded_layers(main_program=None):
    _EXCLUDED.clear()


def _prunable(p, m: int = 4) -> bool:
    """Every trainable 2-D weight whose last dim m divides, unless
    excluded (embeddings included)."""
    return (p._t.ndim == 2 and p.shape[-1] % m == 0
            and not getattr(p, "stop_gradient", False)
            and p.name not in _EXCLUDED)


class ASPHelper:
    """The masks of a set of parameters.  It holds the parameters weakly:
    a pruned model that is dropped is neither kept alive nor masked
    again through it."""

    def __init__(self):
        self._masks: Dict[int, torch.Tensor] = {}
        self._params: "weakref.WeakValueDictionary[int, object]" = (
            weakref.WeakValueDictionary())

    def prune(self, params, n=2, m=4):
        for p in params:
            if not _prunable(p, m):
                continue
            mask = torch.as_tensor(get_mask_1d(p._t, n, m)).to(
                device=p._t.device, dtype=p._t.dtype)
            with torch.no_grad():
                p._t.mul_(mask)
            self._masks[id(p)] = mask  # a second prune replaces the mask
            self._params[id(p)] = p
        return self

    @torch.no_grad()
    def apply_masks(self):
        dead = [k for k in self._masks if k not in self._params]
        for k in dead:
            del self._masks[k]
        for k, p in list(self._params.items()):
            p._t.mul_(self._masks[k])

    def reset(self):
        self._masks.clear()
        self._params = type(self._params)()


_helper = ASPHelper()


def prune_model(model, n: int = 2, m: int = 4, mask_algo: str = "mask_1d",
                with_mask: bool = True) -> ASPHelper:
    """Mask every prunable 2-D weight of the Layer (or parameter list) to
    n:m sparsity.  Only ``mask_1d`` is implemented; other algorithms
    raise.  ``with_mask=False`` prunes once and registers no masks (so
    ``decorate`` does not apply them again)."""
    if mask_algo not in ("mask_1d",):
        raise NotImplementedError(
            f"mask_algo {mask_algo!r} not implemented (supported: mask_1d); "
            f"the reference's mask_2d_greedy/best search is CUDA-sparse-"
            f"tensor-core oriented")
    params = list(model.parameters() if hasattr(model, "parameters")
                  else model)
    if not with_mask:
        tmp = ASPHelper()
        tmp.prune(params, n, m)
        return tmp
    return _helper.prune(params, n, m)


class DecoratedASPOptimizer:
    """Applies the masks again after every optimizer step (the
    reference's ``OptimizerWithSparsityGuarantee``)."""

    def __init__(self, optimizer, helper: Optional[ASPHelper] = None):
        self._inner = optimizer
        self._helper = helper or _helper

    def step(self):
        self._inner.step()
        self._helper.apply_masks()

    def minimize(self, loss, **kw):
        out = self._inner.minimize(loss, **kw)
        self._helper.apply_masks()
        return out

    def clear_grad(self):
        self._inner.clear_grad()

    clear_gradients = clear_grad

    def __getattr__(self, name):
        return getattr(self._inner, name)


def decorate(optimizer) -> DecoratedASPOptimizer:
    return DecoratedASPOptimizer(optimizer)

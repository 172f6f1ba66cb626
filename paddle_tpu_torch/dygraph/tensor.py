"""The eager Tensor: one ``torch.Tensor`` with paddle's metadata.

Counterpart of ``paddle_tpu/dygraph/tensor.py`` (``Tensor``,
``to_tensor``).  A :class:`Tensor` wraps one torch tensor (``_t``) and
hands autograd to torch: ``stop_gradient`` is the inverse of
``requires_grad``, :meth:`backward` is ``torch.autograd.backward``, and
``.grad`` is the leaf's accumulated gradient (None on a tensor that is
not a leaf, as the reference writes gradients to leaves only).

Data types follow the reference, which runs with x64 on: Python ints
and int64 arrays stay int64, and float64 data given without a dtype
(Python floats, numpy float64) becomes the default float dtype
(``float32``).  A tensor lives on the current place's device
(``paddle.set_device``).

In-place writes keep the tape sound as the reference's do: a write into
a tensor with gradient history (or of a value that needs a gradient)
becomes an out-of-place op whose result rebinds the tensor, so the ops
that read the old value keep it; a write into a leaf (a parameter) is an
in-place update without gradient.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Optional

import numpy as np
import torch

from ..framework import unique_name
from ..framework.dtype import (convert_dtype, get_default_dtype,
                               to_torch_dtype)
from ..framework.place import current_device

_TRUE = torch.tensor(True)


def _as_torch(data, dtype=None, device=None) -> torch.Tensor:
    """``data`` (a Tensor, a torch tensor, numpy or Python data) as a
    torch tensor on ``device`` (the current place's by default)."""
    if isinstance(data, Tensor):
        t = data._t
    elif isinstance(data, torch.Tensor):
        t = data
    else:
        arr = np.asarray(data)
        if arr.dtype == np.float64 and dtype is None:
            arr = arr.astype(get_default_dtype()
                             if get_default_dtype() != "bfloat16"
                             else "float32")
            if get_default_dtype() == "bfloat16":
                dtype = "bfloat16"
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:
            arr = arr.copy()
        t = torch.from_numpy(arr)
    dev = current_device() if device is None else device
    t = t.to(device=dev)
    if dtype is not None:
        t = t.to(to_torch_dtype(dtype))
    return t


class Tensor:
    __slots__ = ("_t", "_name", "persistable", "_leaf", "__dict__",
                 "__weakref__")

    def __init__(self, data: Any, dtype: Any = None,
                 stop_gradient: bool = True, name: Optional[str] = None,
                 persistable: bool = False, place=None):
        device = None if place is None else place.torch_device()
        t = _as_torch(data, dtype, device)
        if isinstance(data, (Tensor, torch.Tensor)):
            src = data._t if isinstance(data, Tensor) else data
            # a copy of the data, as paddle.to_tensor makes one
            t = t.detach()
            if t.data_ptr() == src.data_ptr():
                t = t.clone()
        self._t = t
        self._name = name
        self.persistable = persistable
        self._leaf = None
        self.stop_gradient = stop_gradient

    @classmethod
    def _wrap(cls, t: torch.Tensor, name=None) -> "Tensor":
        """A Tensor over torch tensor ``t`` as it is (the tracer's fast
        path: no copy, no dtype decision)."""
        self = object.__new__(cls)
        self._t = t
        self._name = name
        self.persistable = False
        self._leaf = None
        return self

    # -- metadata -----------------------------------------------------------
    @property
    def name(self) -> str:
        if self._name is None:
            self._name = unique_name.generate("eager_tmp")
        return self._name

    @name.setter
    def name(self, v):
        self._name = v

    @property
    def stop_gradient(self) -> bool:
        return not self._t.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, v: bool):
        t = self._t
        if v:
            if t.requires_grad:
                self._t = t.requires_grad_(False) if t.is_leaf \
                    else t.detach()
        elif not t.requires_grad and (t.is_floating_point()
                                      or t.is_complex()):
            self._t = (t if t.is_leaf else t.detach()).requires_grad_(True)

    @property
    def shape(self):
        return list(self._t.shape)

    @property
    def dtype(self) -> str:
        return convert_dtype(self._t.dtype)

    @property
    def ndim(self) -> int:
        return self._t.ndim

    def dim(self) -> int:
        return self._t.ndim

    @property
    def size(self) -> int:
        return self._t.numel()

    def numel(self) -> int:
        return self._t.numel()

    @property
    def place(self):
        from ..framework.place import CPUPlace, CUDAPlace

        dev = self._t.device
        return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)

    @property
    def is_leaf(self) -> bool:
        return self._t.is_leaf

    # -- value access -------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A copy of the value as numpy (bf16 as fp32): it does not
        change when the tensor does."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type == "cpu":
            return t.numpy().copy()
        return t.cpu().numpy()

    def item(self, *args):
        return self.numpy().item(*args)

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self._t)

    def __int__(self):
        return int(self._t)

    def __index__(self):
        return int(self._t.reshape(-1)[0])

    def __bool__(self):
        return bool(self._t)

    def __len__(self):
        if self._t.ndim == 0:
            raise TypeError("len() of a 0-D tensor")
        return self._t.shape[0]

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={self.dtype}, "
                f"stop_gradient={self.stop_gradient},\n       "
                f"{self.numpy()})")

    __str__ = __repr__

    # -- autograd -----------------------------------------------------------
    def _leaf_t(self):
        return self._leaf if self._leaf is not None else self._t

    @property
    def grad(self) -> Optional["Tensor"]:
        t = self._leaf_t()
        if not t.is_leaf or t.grad is None:
            return None
        return Tensor._wrap(t.grad)

    @grad.setter
    def grad(self, value):
        t = self._leaf_t()
        t.grad = None if value is None else _as_torch(value,
                                                      device=t.device)

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        from .engine import run_backward

        run_backward([self], None if grad_tensor is None else [grad_tensor],
                     retain_graph)

    def clear_grad(self):
        self._leaf_t().grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """``hook(grad) -> Tensor or None`` runs when this tensor's
        gradient is computed; a returned tensor replaces it.  Returns a
        handle with ``remove()``."""

        def fn(g):
            out = hook(Tensor._wrap(g))
            return None if out is None else out._t

        return self._t.register_hook(fn)

    def detach(self) -> "Tensor":
        return Tensor._wrap(self._t.detach(), self.name + ".detached")

    def detach_(self) -> "Tensor":
        self._t = self._t.detach()
        return self

    def clone(self) -> "Tensor":
        from . import tracer

        return tracer.trace_op("assign", {"X": [self]}, {})["Out"][0]

    # -- mutation -----------------------------------------------------------
    def _has_history(self) -> bool:
        return self._t.requires_grad and not self._t.is_leaf

    def _rebind(self, new: torch.Tensor):
        """An out-of-place write on the tape: ``new`` (computed from the
        old value) becomes this tensor; a leaf that needed a gradient
        keeps receiving it through ``_leaf``."""
        if self._t.is_leaf and self._t.requires_grad and self._leaf is None:
            self._leaf = self._t
        self._t = new

    def _full_value(self, value) -> torch.Tensor:
        return _as_torch(value, device=self._t.device).to(
            self._t.dtype).reshape(self._t.shape)

    def set_value(self, value):
        """Overwrite the value; a tensor with gradient history keeps its
        place on the tape (no gradient flows into the old value)."""
        v = self._full_value(value)
        if torch.is_grad_enabled() and self._has_history():
            self._rebind(torch.where(_TRUE.to(v.device), v, self._t))
            return
        with torch.no_grad():
            self._t.copy_(v)

    def copy_(self, other, blocking=True):
        self.set_value(other)
        return self

    def fill_(self, value):
        return self._inplace(lambda a: torch.full_like(a, value))

    def zero_(self):
        return self._inplace(torch.zeros_like)

    def scale_(self, scale):
        return self._inplace(lambda a: a * scale)

    def _inplace(self, fn):
        if torch.is_grad_enabled() and self._has_history():
            self._rebind(fn(self._t))
            return self
        with torch.no_grad():
            self._t.copy_(fn(self._t))
        return self

    # -- dtype / device -----------------------------------------------------
    def astype(self, dtype) -> "Tensor":
        from . import tracer

        return tracer.trace_op("cast", {"X": [self]},
                               {"out_dtype": convert_dtype(dtype)})["Out"][0]

    cast = astype

    def cpu(self):
        return Tensor._wrap(self._t.cpu())

    def cuda(self, device_id=None, blocking=True):
        return Tensor._wrap(self._t.cuda(device_id))

    def pin_memory(self):
        return Tensor._wrap(self._t.pin_memory())

    def to(self, *args, **kwargs):
        out = self
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, str) and a.split(":")[0] in ("cpu", "gpu",
                                                         "cuda"):
                from ..framework.place import _parse

                out = Tensor._wrap(out._t.to(_parse(a).torch_device()))
                continue
            try:
                out = out.astype(convert_dtype(a))
            except TypeError:
                continue
        return out

    @property
    def T(self):
        from . import tracer

        axes = list(range(self.ndim))[::-1]
        return tracer.trace_op("transpose2", {"X": [self]},
                               {"axis": axes})["Out"][0]

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, idx):
        return Tensor._wrap(self._t[_normalize_index(idx, self._t.device)])

    def __setitem__(self, idx, value):
        idx = _normalize_index(idx, self._t.device)
        if isinstance(value, Tensor):
            v = value._t.to(self._t.dtype)
        else:
            v = torch.as_tensor(np.asarray(value), device=self._t.device).to(
                self._t.dtype)
        if torch.is_grad_enabled() and (self._has_history()
                                        or v.requires_grad):
            new = self._t.clone()
            new[idx] = v
            self._rebind(new)
            return
        with torch.no_grad():
            self._t[idx] = v

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __hash__(self):
        return id(self)

    def __deepcopy__(self, memo):
        """A copy with a fresh unique name (optimizer state is keyed by
        name, so two tensors must never share one)."""
        cls = self.__class__
        new = cls.__new__(cls)
        memo[id(self)] = new
        t = self._t.detach().clone()
        new._t = t.requires_grad_(self._t.requires_grad) if (
            t.is_floating_point() or t.is_complex()) else t
        new._name = unique_name.generate(
            self.name.split("_")[0] or "eager_tmp")
        new.persistable = self.persistable
        new._leaf = None
        for k, v in self.__dict__.items():
            if k not in new.__dict__:
                new.__dict__[k] = _copy.deepcopy(v, memo)
        return new


def _normalize_index(idx, device):
    def conv(i):
        if isinstance(i, Tensor):
            return i._t
        if isinstance(i, np.ndarray):
            return torch.as_tensor(i, device=device)
        return i

    if isinstance(idx, tuple):
        return tuple(conv(i) for i in idx)
    return conv(idx)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """``paddle.to_tensor``: ``data`` on ``place`` (the current place by
    default), as ``dtype``."""
    return Tensor(data, dtype=dtype, stop_gradient=stop_gradient,
                  place=place)

"""``paddle.save`` / ``paddle.load`` and the legacy ``paddle.batch``.

Counterpart of ``paddle_tpu/io_api.py``, with its on-disk format: a pickle
(protocol 4) of the object with every Tensor replaced by ``{"__tensor__":
True, "value": <numpy array>, "name": ..., "stop_gradient": ...}``, so a
file written by either package loads in the other.  A bf16 tensor is saved
as fp32 (:meth:`Tensor.numpy`); a static ``Variable`` is saved with its
value in the global scope (None before its startup program ran).
"""

from __future__ import annotations

import os
import pickle
from typing import Any

__all__ = ["save", "load", "batch"]

_PROTO = 4


def _to_saveable(obj: Any):
    from .dygraph.tensor import Tensor
    from .framework import program as fw
    from .framework.scope import global_scope

    if isinstance(obj, Tensor):
        return {"__tensor__": True, "value": obj.numpy(), "name": obj.name,
                "stop_gradient": obj.stop_gradient}
    if isinstance(obj, fw.Variable):
        from .static.io import _host

        val = global_scope().find_var(obj.name)
        return {"__tensor__": True,
                "value": _host(val) if val is not None else None,
                "name": obj.name, "stop_gradient": obj.stop_gradient}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saved(obj: Any, return_numpy: bool):
    from .dygraph.tensor import Tensor

    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            val = obj["value"]
            if return_numpy or val is None:
                return val
            return Tensor(val, stop_gradient=obj.get("stop_gradient", True),
                          name=obj.get("name"))
        return {k: _from_saved(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saved(v, return_numpy) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = _PROTO, **configs):
    """Write ``obj`` (a state dict, nested containers of Tensors) to
    ``path``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """Read what :func:`save` wrote: Tensors on the current place, or
    numpy arrays with ``return_numpy=True``.  Unpickles the file, so load
    only files this program or the reference package wrote."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return _from_saved(data, return_numpy)


def batch(reader, batch_size, drop_last=False):
    """Wrap a sample reader creator into a batch reader creator yielding
    lists of ``batch_size`` samples (the last one shorter unless
    ``drop_last``)."""

    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    if batch_size <= 0:
        raise ValueError(
            f"batch_size should be a positive integer, got {batch_size}")
    return batch_reader

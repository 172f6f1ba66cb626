"""``paddle.static.data`` and ``InputSpec``.

Counterpart of ``paddle_tpu/static/input.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..framework import program as fw
from ..framework.dtype import convert_dtype


def data(name: str, shape: Sequence[int], dtype="float32",
         lod_level: int = 0) -> fw.Variable:
    """A feed slot of the current main program (``None`` dims are -1)."""
    block = fw.default_main_program().global_block()
    shape = tuple(-1 if s is None else int(s) for s in shape)
    return block.create_var(name=name, shape=shape,
                            dtype=convert_dtype(dtype), is_data=True,
                            stop_gradient=True)


class InputSpec:
    """A feed's shape, dtype and name."""

    def __init__(self, shape, dtype="float32", name: Optional[str] = None):
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = convert_dtype(dtype)
        self.name = name

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype,
                   name or getattr(tensor, "name", None))

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"

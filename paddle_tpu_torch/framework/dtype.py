"""Dtype names of the eager core and their torch and numpy counterparts.

Counterpart of ``paddle_tpu/framework/dtype.py``: a dtype is named by its
canonical string (``"float32"``, ``"int64"``, ``"bfloat16"`` ...), the
public aliases ``paddle.float32`` etc. are those strings, and the default
float dtype is ``float32`` on every device (``set_default_dtype``).  The
bf16 default of :func:`paddle_tpu_torch.device.default_dtype` belongs to
the GPT entry points and is not this one.
"""

from __future__ import annotations

import numpy as np
import torch


class DataType:
    """The dtype names that matter for tensors (``VarType.Type``)."""

    BOOL = "bool"
    INT8 = "int8"
    UINT8 = "uint8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FP16 = "float16"
    BF16 = "bfloat16"
    FP32 = "float32"
    FP64 = "float64"
    COMPLEX64 = "complex64"
    COMPLEX128 = "complex128"


bool = "bool"  # noqa: A001
int8 = "int8"
uint8 = "uint8"
int16 = "int16"
int32 = "int32"
int64 = "int64"
float16 = "float16"
bfloat16 = "bfloat16"
float32 = "float32"
float64 = "float64"
complex64 = "complex64"
complex128 = "complex128"

_TORCH = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NAMES = {v: k for k, v in _TORCH.items()}
_ALL_DTYPES = set(_TORCH)
_FLOAT_DTYPES = {"float16", "bfloat16", "float32", "float64"}
_INT_DTYPES = {"bool", "int8", "uint8", "int16", "int32", "int64"}


def convert_dtype(dtype) -> str:
    """Any dtype spec (a name, a numpy or torch dtype, a Python type) as
    its canonical name; None is ``float32``."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        name = _NAMES.get(dtype, str(dtype))
    elif isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, np.dtype):
        name = dtype.name
    elif isinstance(dtype, type) and issubclass(dtype, np.generic):
        name = np.dtype(dtype).name
    else:
        name = getattr(dtype, "name", None) or np.dtype(dtype).name
    if name == "float":
        name = "float32"
    if name == "int":
        name = "int64"
    if name not in _ALL_DTYPES:
        raise TypeError(f"Unsupported dtype: {dtype!r} -> {name}")
    return name


def to_torch_dtype(dtype) -> torch.dtype:
    return _TORCH[convert_dtype(dtype)]


def to_numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of ``dtype``; numpy has no bfloat16, which raises."""
    name = convert_dtype(dtype)
    if name == "bfloat16":
        raise TypeError("numpy has no bfloat16")
    return np.dtype(name)


def is_floating(dtype) -> bool:
    return convert_dtype(dtype) in _FLOAT_DTYPES


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in _INT_DTYPES


_DEFAULT_DTYPE = "float32"


def set_default_dtype(d):
    """``paddle.set_default_dtype`` (float types only)."""
    global _DEFAULT_DTYPE
    d = convert_dtype(d)
    if d not in _FLOAT_DTYPES:
        raise TypeError(f"default dtype must be a float type, got {d!r}")
    _DEFAULT_DTYPE = d


def get_default_dtype() -> str:
    return _DEFAULT_DTYPE

"""Device and dtype policy of the PyTorch port.

Every entry point of the port runs on the CUDA card unless the caller asks
for another device.  There is no quiet fallback: without a card and without
an explicit ``device``, :func:`resolve_device` raises.

Dtypes follow the device: fp32 on the CPU, where the port is held against
the JAX reference at tight tolerances, and bf16 on the card, the serving
dtype.

The module is also ``paddle.device``, the reference's namespace
(``paddle_tpu/device.py``): ``set_device`` / ``get_device``, the
``is_compiled_with_*`` probes, ``get_cudnn_version``, ``XPUPlace`` and the
device listings, which name the torch devices present (``cpu``, and
``gpu`` with one ``gpu:<i>`` a card).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]

__all__ = ["get_device", "set_device", "get_cudnn_version",
           "is_compiled_with_cuda", "is_compiled_with_tpu",
           "is_compiled_with_xpu", "is_compiled_with_npu",
           "is_compiled_with_rocm", "XPUPlace", "get_all_device_type",
           "get_all_custom_device_type", "get_available_device",
           "get_available_custom_device"]


def default_device() -> torch.device:
    """The CUDA card, or a RuntimeError when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means :func:`default_device`.
    A CUDA device without an index gets the current one, so it compares
    equal to the device of the tensors made on it."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """fp32 on the CPU (parity with the reference), bf16 on the card."""
    return torch.float32 if device.type == "cpu" else torch.bfloat16


def resolve_dtype(dtype: Optional[torch.dtype],
                  device: torch.device) -> torch.dtype:
    return default_dtype(device) if dtype is None else dtype


# -- paddle.device ------------------------------------------------------------


def get_cudnn_version():
    """The cuDNN version torch was built with (an int such as 90100), or
    None without cuDNN."""
    return torch.backends.cudnn.version()


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def get_all_device_type():
    """The kinds of device present: ``cpu``, and ``gpu`` with a card."""
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def get_all_custom_device_type():
    return []


def get_available_device():
    """One ``gpu:<i>`` a card, as ``set_device`` takes them."""
    return [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def get_available_custom_device():
    return []


from .framework.place import (  # noqa: E402,F401  (after the helpers)
    XPUPlace, get_device, is_compiled_with_cuda, is_compiled_with_npu,
    is_compiled_with_tpu, is_compiled_with_xpu, set_device)

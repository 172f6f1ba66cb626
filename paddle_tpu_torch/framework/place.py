"""Device places and ``paddle.set_device``.

Counterpart of ``paddle_tpu/framework/place.py``.  A place names a torch
device: :class:`CUDAPlace` the card, :class:`CPUPlace` the host.  The
default place is ``gpu:0`` (``PADDLE_TPU_DEVICE`` in the environment
overrides it), as every entry point of the port runs on the card unless
the caller asks for the CPU: without a card and without
``set_device("cpu")``, making a tensor raises
(:func:`paddle_tpu_torch.device.default_device`).  ``"tpu"``, ``"xpu"``
and ``"npu"`` are accepted as other names of the card, as the reference
accepts ``"gpu"`` for its accelerator.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch


class Place:
    _kind = "cpu"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    @property
    def backend(self) -> str:
        return self._kind

    def __eq__(self, other):
        return (isinstance(other, Place) and self._kind == other._kind
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((self._kind, self._device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self._device_id})"

    def torch_device(self) -> torch.device:
        if self._kind == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch's eager API runs on the CUDA card by "
                "default and none is available; call "
                "paddle_tpu_torch.set_device('cpu') to run on the CPU")
        return torch.device("cuda", self._device_id)


class CPUPlace(Place):
    _kind = "cpu"

    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    """The CUDA card with index ``device_id``."""

    _kind = "gpu"


class CUDAPinnedPlace(CPUPlace):
    pass


class TPUPlace(CUDAPlace):
    """Accepted for parity with the reference's first-class place; it is
    the card here."""


class XPUPlace(CUDAPlace):
    pass


class NPUPlace(CUDAPlace):
    pass


_state = threading.local()
_ACCEL = ("gpu", "cuda", "tpu", "xpu", "npu", "accel")


def _parse(device: str) -> Place:
    device = str(device).lower()
    kind, _, idx = device.partition(":")
    if kind in _ACCEL:
        return CUDAPlace(int(idx or 0))
    if kind == "cpu":
        return CPUPlace()
    raise ValueError(f"Unknown device {device!r}")


def set_device(device: str) -> Place:
    """``paddle.set_device("gpu")`` / ``("gpu:0")`` / ``("cpu")``."""
    place = _parse(device)
    if isinstance(place, CUDAPlace):
        place.torch_device()  # refuse a card that is not there
    _state.place = place
    return place


def get_device() -> str:
    p = _get_current_place()
    if isinstance(p, CPUPlace):
        return "cpu"
    return f"gpu:{p.get_device_id()}"


def _get_current_place() -> Place:
    place = getattr(_state, "place", None)
    if place is None:
        place = _parse(os.environ.get("PADDLE_TPU_DEVICE", "gpu:0"))
        _state.place = place
    return place


@contextlib.contextmanager
def place_guard(place: Place):
    """Make ``place`` the current place inside the block (the static
    executor runs its ops so: creation ops make their tensors on the
    executor's device)."""
    old = getattr(_state, "place", None)
    _state.place = place
    try:
        yield place
    finally:
        _state.place = old


def current_device() -> torch.device:
    """The torch device of the current place (raises on the default place
    without a card)."""
    return _get_current_place().torch_device()


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False

"""``paddle.vision.image``: the image backend switch and ``image_load``.

Counterpart of ``paddle_tpu/vision/image.py``: a global ``pil`` / ``cv2``
/ ``tensor`` backend that the datasets consult, and ``image_load``
through PIL (imported when an image is loaded, so the module imports
without it).
"""

from __future__ import annotations

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_BACKEND = "pil"


def set_image_backend(backend: str):
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(
            f"expected backend 'pil', 'cv2' or 'tensor', got {backend!r}")
    global _BACKEND
    _BACKEND = backend


def get_image_backend() -> str:
    return _BACKEND


def image_load(path: str, backend=None):
    """The image at ``path``: a PIL image (``pil``), an HWC BGR uint8
    array (``cv2``) or an HWC RGB Tensor (``tensor``)."""
    backend = backend or _BACKEND
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(f"bad backend {backend!r}")
    from PIL import Image

    img = Image.open(path)
    if backend == "pil":
        return img
    import numpy as np

    arr = np.asarray(img.convert("RGB"))
    if backend == "cv2":
        return arr[:, :, ::-1].copy()  # RGB -> BGR, as cv2.imread gives
    from ..dygraph.tensor import Tensor

    return Tensor(arr)

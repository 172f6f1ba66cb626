"""``paddle.vision.transforms``: image transforms on numpy HWC arrays.

Counterpart of ``paddle_tpu/vision/transforms/__init__.py``: images are
numpy HWC uint8 or float arrays (no PIL needed), ``ToTensor`` gives CHW
float32, and the random transforms draw from Python's ``random`` module,
as the reference's do, so one ``random.seed`` gives both packages the
same draws.  ``resize`` is the reference's ``jax.image.resize``
arithmetic in numpy: ``nearest`` takes ``floor((i + 0.5) * in / out)``
in float32; ``bilinear`` contracts each changed spatial axis with a
weight matrix of the triangle kernel (widened by ``in / out`` where it
shrinks, so a shrink is antialiased), normalised per output sample and
zero for samples outside the input, computed in float64 and applied in
float32; a uint8 image is clipped and truncated back to uint8.
"""

from __future__ import annotations

import numbers
import random
from typing import Sequence

import numpy as np

__all__ = [
    "Compose", "ToTensor", "Normalize", "Resize", "RandomResizedCrop",
    "CenterCrop", "RandomCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
    "Transpose", "BrightnessTransform", "ContrastTransform", "HueTransform",
    "SaturationTransform", "ColorJitter", "Pad", "RandomRotation", "Grayscale",
    "to_tensor", "normalize", "resize", "hflip", "vflip", "center_crop", "crop", "pad",
]


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


def _as_hwc(img) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def to_tensor(img, data_format="CHW"):
    img = _as_hwc(img)
    if img.dtype == np.uint8:
        img = img.astype("float32") / 255.0
    else:
        img = img.astype("float32")
    if data_format == "CHW":
        img = img.transpose(2, 0, 1)
    return img


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    img = np.asarray(img, dtype="float32")
    mean = np.asarray(mean, dtype="float32")
    std = np.asarray(std, dtype="float32")
    if data_format == "CHW":
        return (img - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)
    return (img - mean) / std


def resize(img, size, interpolation="bilinear"):
    img = _as_hwc(img)
    if isinstance(size, int):
        h, w = img.shape[:2]
        if h < w:
            oh, ow = size, int(size * w / h)
        else:
            oh, ow = int(size * h / w), size
    else:
        oh, ow = size
    out = _resize_axes(img.astype("float32"), (oh, ow),
                       interpolation == "nearest")
    if img.dtype == np.uint8:
        out = np.clip(out, 0, 255).astype("uint8")
    return out


def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of ``jax.image``'s antialiased linear resize
    along one axis (its ``compute_weight_mat`` with zero translation)."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = np.maximum(0.0, 1.0 - x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def _resize_axes(img: np.ndarray, size, nearest: bool) -> np.ndarray:
    """``img`` (HWC float32) resized to ``size`` (h, w) along the axes
    whose length changes."""
    for axis, n_out in enumerate(size):
        n_in = img.shape[axis]
        if n_in == n_out:
            continue
        if nearest:
            # XLA folds ``* in / out`` into one factor, in * (1 / out)
            step = np.float32(n_in) * (np.float32(1) / np.float32(n_out))
            pos = (np.arange(n_out, dtype=np.float32) + 0.5) * step
            img = np.take(img, np.floor(pos.astype(np.float32)).astype(
                np.int32), axis=axis)
        else:
            w = _triangle_weights(n_in, n_out)
            img = np.moveaxis(np.tensordot(np.moveaxis(img, axis, -1), w,
                                           axes=([-1], [0])), -1, axis)
    return np.ascontiguousarray(img, dtype=np.float32)


def hflip(img):
    return _as_hwc(img)[:, ::-1, :]


def vflip(img):
    return _as_hwc(img)[::-1, :, :]


def crop(img, top, left, height, width):
    return _as_hwc(img)[top : top + height, left : left + width, :]


def center_crop(img, output_size):
    img = _as_hwc(img)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    h, w = img.shape[:2]
    th, tw = output_size
    top = max(0, (h - th) // 2)
    left = max(0, (w - tw) // 2)
    return crop(img, top, left, th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    img = _as_hwc(img)
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    if len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    l, t, r, b = padding
    if padding_mode == "constant":
        return np.pad(img, ((t, b), (l, r), (0, 0)), constant_values=fill)
    mode = {"reflect": "reflect", "edge": "edge", "symmetric": "symmetric"}[padding_mode]
    return np.pad(img, ((t, b), (l, r), (0, 0)), mode=mode)


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean, self.std, self.data_format = mean, std, data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        self.size = (size, size) if isinstance(size, int) else size
        self.padding = padding

    def _apply_image(self, img):
        img = _as_hwc(img)
        if self.padding:
            img = pad(img, self.padding)
        h, w = img.shape[:2]
        th, tw = self.size
        top = random.randint(0, max(0, h - th))
        left = random.randint(0, max(0, w - tw))
        return crop(img, top, left, th, tw)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4, 4.0 / 3),
                 interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * random.uniform(*self.scale)
            ar = random.uniform(*self.ratio)
            cw = int(round(np.sqrt(target_area * ar)))
            ch = int(round(np.sqrt(target_area / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                return resize(crop(img, top, left, ch, cw), self.size, self.interpolation)
        return resize(center_crop(img, min(h, w)), self.size, self.interpolation)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        return hflip(img) if random.random() < self.prob else _as_hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def _apply_image(self, img):
        return vflip(img) if random.random() < self.prob else _as_hwc(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def _apply_image(self, img):
        return _as_hwc(img).transpose(self.order)


def _restore_dtype(out: np.ndarray, like) -> np.ndarray:
    """uint8 images stay clipped uint8; float images keep their dtype/range."""
    src = np.asarray(like)
    if src.dtype == np.uint8:
        return np.clip(out, 0, 255).astype("uint8")
    return out.astype(src.dtype)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return _restore_dtype(_as_hwc(img).astype("float32") * f, img)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        out = _as_hwc(img).astype("float32")
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        mean = out.mean()
        return _restore_dtype((out - mean) * f + mean, img)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        out = _as_hwc(img).astype("float32")
        gray = out.mean(axis=2, keepdims=True)
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return _restore_dtype(gray + (out - gray) * f, img)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        self.value = value

    def _apply_image(self, img):
        return img  # hue shift needs HSV conversion; no-op approximation


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        self.ts = [
            BrightnessTransform(brightness), ContrastTransform(contrast),
            SaturationTransform(saturation), HueTransform(hue),
        ]

    def _apply_image(self, img):
        ts = list(self.ts)
        random.shuffle(ts)
        for t in ts:
            img = t(img)
        return img


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding, self.fill, self.mode = padding, fill, padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees

    def _apply_image(self, img):
        img = _as_hwc(img)
        k = random.choice([0, 1, 2, 3])  # right-angle approximation
        return np.rot90(img, k).copy()


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        out = _as_hwc(img).astype("float32")
        gray = (out * np.array([0.299, 0.587, 0.114])[: out.shape[2]]).sum(
            axis=2, keepdims=True
        )
        if self.num_output_channels == 3:
            gray = np.repeat(gray, 3, axis=2)
        return _restore_dtype(gray, img)

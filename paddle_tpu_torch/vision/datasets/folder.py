"""Folder datasets: images under a local root, nothing downloaded.

Counterpart of ``paddle_tpu/vision/datasets/folder.py``:
``DatasetFolder`` (one class a subdirectory, classes sorted),
``ImageFolder`` (every image under the root, unlabelled) and
``default_loader``, which loads a ``.npy`` array as it is and any other
image through PIL (imported when such an image is loaded).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from ...io import Dataset

__all__ = ["DatasetFolder", "ImageFolder", "default_loader",
           "has_valid_extension", "IMG_EXTENSIONS"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp", ".npy")


def has_valid_extension(filename: str, extensions) -> bool:
    return filename.lower().endswith(tuple(extensions))


def _walk_files(root, is_valid_file):
    """The files under ``root`` that ``is_valid_file`` takes, in a fixed
    (sorted) order."""
    out = []
    for dirpath, _, files in sorted(os.walk(root, followlinks=True)):
        for fn in sorted(files):
            path = os.path.join(dirpath, fn)
            if is_valid_file(path):
                out.append(path)
    return out


def default_loader(path: str):
    """A ``.npy`` file as its array; any other image through PIL, as
    RGB."""
    if path.lower().endswith(".npy"):
        return np.load(path)
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f)
        return img.convert("RGB")


class DatasetFolder(Dataset):
    """``root/<class>/<image>`` -> ``(sample, class index)`` items, the
    classes sorted (``classes``, ``class_to_idx``, ``targets``); files
    chosen by ``extensions`` or ``is_valid_file``."""

    def __init__(self, root: str, loader: Optional[Callable] = None,
                 extensions=None, transform=None,
                 is_valid_file: Optional[Callable] = None):
        self.root = root
        self.loader = loader or default_loader
        self.transform = transform
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS
        self.extensions = extensions

        self.classes, self.class_to_idx = self._find_classes(root)
        self.samples = self._make_dataset(root, self.class_to_idx,
                                          extensions, is_valid_file)
        if not self.samples:
            raise RuntimeError(
                f"Found 0 files in subfolders of {root!r} with extensions "
                f"{extensions}")
        self.targets = [s[1] for s in self.samples]

    @staticmethod
    def _find_classes(root):
        classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
        if not classes:
            raise RuntimeError(f"no class folders found in {root!r}")
        return classes, {c: i for i, c in enumerate(classes)}

    @staticmethod
    def _make_dataset(root, class_to_idx, extensions, is_valid_file):
        if is_valid_file is None:
            def is_valid_file(p):
                return has_valid_extension(p, extensions)
        samples = []
        for cls in sorted(class_to_idx):
            for path in _walk_files(os.path.join(root, cls), is_valid_file):
                samples.append((path, class_to_idx[cls]))
        return samples

    def __getitem__(self, index):
        path, target = self.samples[index]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Every image under ``root``, unlabelled: items are ``[sample]``."""

    def __init__(self, root: str, loader: Optional[Callable] = None,
                 extensions=None, transform=None,
                 is_valid_file: Optional[Callable] = None):
        self.root = root
        self.loader = loader or default_loader
        self.transform = transform
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS
        if is_valid_file is None:
            def is_valid_file(p):
                return has_valid_extension(p, extensions)
        samples: List[str] = _walk_files(root, is_valid_file)
        if not samples:
            raise RuntimeError(
                f"Found 0 files in {root!r} with extensions {extensions}")
        self.samples = samples

    def __getitem__(self, index):
        sample = self.loader(self.samples[index])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)

"""``paddle.vision.datasets``: FakeData, the MNIST / FashionMNIST /
Cifar10 / Cifar100 readers, the folder datasets (``DatasetFolder``,
``ImageFolder``) and Flowers / VOC2012, all over local files.

Counterpart of ``paddle_tpu/vision/datasets/__init__.py``.  Nothing is
downloaded: a missing file raises with a message naming it; point
``image_path`` / ``data_file`` at local copies, or use ``FakeData``.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ...io import Dataset

from .folder import DatasetFolder, ImageFolder  # noqa: F401
from .extra import Flowers, VOC2012  # noqa: F401

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeData",
           "DatasetFolder", "ImageFolder", "Flowers", "VOC2012"]

_NO_DOWNLOAD = (
    "nothing is downloaded: place the dataset files locally "
    "and pass their paths (image_path/label_path or data_file), or use "
    "paddle.vision.datasets.FakeData for synthetic data"
)


class FakeData(Dataset):
    """Synthetic images and labels, each drawn from a RandomState seeded by
    its index (the same sample in every process)."""

    def __init__(self, num_samples=1000, image_shape=(1, 28, 28), num_classes=10,
                 transform=None, dtype="float32"):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.dtype = dtype

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        img = rng.rand(*self.image_shape).astype(self.dtype)
        label = np.asarray(rng.randint(0, self.num_classes), dtype="int64")
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.num_samples


class MNIST(Dataset):
    """The IDX-format files (gzipped or not)."""

    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path is None or label_path is None:
            root = os.environ.get("PADDLE_DATASET_HOME", os.path.expanduser("~/.cache/paddle/dataset"))
            tag = "train" if mode == "train" else "t10k"
            image_path = image_path or os.path.join(root, self.NAME, f"{tag}-images-idx3-ubyte.gz")
            label_path = label_path or os.path.join(root, self.NAME, f"{tag}-labels-idx1-ubyte.gz")
        if not (os.path.exists(image_path) and os.path.exists(label_path)):
            raise FileNotFoundError(
                f"MNIST files not found at {image_path} / {label_path}; " + _NO_DOWNLOAD
            )
        self.images, self.labels = self._parse(image_path, label_path)

    @staticmethod
    def _parse(image_path, label_path):
        opener = gzip.open if image_path.endswith(".gz") else open
        with opener(image_path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)
        opener = gzip.open if label_path.endswith(".gz") else open
        with opener(label_path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), dtype=np.uint8).astype("int64")
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx][:, :, None]  # HWC
        label = np.asarray(self.labels[idx], dtype="int64")
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype("float32") / 255.0
            img = img.transpose(2, 0, 1)
        return img, label

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"


class _CifarBase(Dataset):
    MODE_FLAG_MAP = {}

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if data_file is None:
            root = os.environ.get("PADDLE_DATASET_HOME", os.path.expanduser("~/.cache/paddle/dataset"))
            data_file = os.path.join(root, "cifar", self.FILENAME)
        if not os.path.exists(data_file):
            raise FileNotFoundError(f"CIFAR archive not found at {data_file}; " + _NO_DOWNLOAD)
        self.data, self.labels = self._load(data_file)

    def _load(self, data_file):
        images, labels = [], []
        with tarfile.open(data_file, "r:*") as tf:
            names = [n for n in tf.getnames() if self._want(n)]
            for name in sorted(names):
                f = tf.extractfile(name)
                batch = pickle.load(f, encoding="bytes")
                data = batch[b"data"].reshape(-1, 3, 32, 32)
                labs = batch.get(b"labels", batch.get(b"fine_labels"))
                images.append(data)
                labels.extend(labs)
        return np.concatenate(images), np.asarray(labels, dtype="int64")

    def __getitem__(self, idx):
        img = self.data[idx].transpose(1, 2, 0)  # HWC uint8
        label = np.asarray(self.labels[idx], dtype="int64")
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = (img.astype("float32") / 255.0).transpose(2, 0, 1)
        return img, label

    def __len__(self):
        return len(self.labels)


class Cifar10(_CifarBase):
    FILENAME = "cifar-10-python.tar.gz"

    def _want(self, name):
        if self.mode == "train":
            return "data_batch" in name
        return "test_batch" in name


class Cifar100(_CifarBase):
    FILENAME = "cifar-100-python.tar.gz"

    def _want(self, name):
        return ("train" in name) if self.mode == "train" else ("test" in name)

"""Legacy ``paddle.dataset.cifar`` readers (reference dataset/cifar.py):
yields (3072-float32 array scaled to [0, 1], int label)."""

import numpy as np


def _reader(cls_name, mode, **kw):
    def reader():
        from ..vision import datasets as vd

        ds = getattr(vd, cls_name)(mode=mode, **kw)
        for img, label in ds:
            # Cifar __getitem__ already yields CHW float32 in [0, 1]
            yield np.asarray(img, "float32").reshape(-1), int(label)

    return reader


def train10(**kw):
    return _reader("Cifar10", "train", **kw)


def test10(**kw):
    return _reader("Cifar10", "test", **kw)


def train100(**kw):
    return _reader("Cifar100", "train", **kw)


def test100(**kw):
    return _reader("Cifar100", "test", **kw)

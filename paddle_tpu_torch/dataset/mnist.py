"""Legacy ``paddle.dataset.mnist`` readers (reference dataset/mnist.py):
yields (flattened float32 image scaled to [-1, 1], int label)."""

import numpy as np


def _reader(mode, **kw):
    def reader():
        from ..vision.datasets import MNIST

        ds = MNIST(mode=mode, **kw)
        for img, label in ds:
            # MNIST.__getitem__ yields CHW float32 in [0, 1]; the legacy
            # reader contract is flat float32 in [-1, 1] (raw/127.5 - 1)
            flat = np.asarray(img, "float32").reshape(-1) * 2.0 - 1.0
            yield flat, int(label)

    return reader


def train(**kw):
    return _reader("train", **kw)


def test(**kw):
    return _reader("test", **kw)

"""Legacy ``paddle.dataset.uci_housing`` readers (reference
dataset/uci_housing.py): yields (13 float32 features, float32 price)."""

import numpy as np


def _reader(mode, **kw):
    def reader():
        from ..text.datasets import UCIHousing

        for feat, price in UCIHousing(mode=mode, **kw):
            yield np.asarray(feat, "float32"), np.asarray(price, "float32")

    return reader


def train(**kw):
    return _reader("train", **kw)


def test(**kw):
    return _reader("test", **kw)

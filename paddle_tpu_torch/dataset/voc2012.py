"""Legacy ``paddle.dataset.voc2012`` readers (reference
dataset/voc2012.py): yields (image array, segmentation label array)."""

import numpy as np


def _reader(mode, **kw):
    def reader():
        from ..vision.datasets import VOC2012

        for img, label in VOC2012(mode=mode, **kw):
            yield np.asarray(img), np.asarray(label)

    return reader


def train(**kw):
    return _reader("train", **kw)


def test(**kw):
    return _reader("test", **kw)


def val(**kw):
    return _reader("valid", **kw)

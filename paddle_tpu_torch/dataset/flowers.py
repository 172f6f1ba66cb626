"""Legacy ``paddle.dataset.flowers`` readers (reference
dataset/flowers.py): yields (image array as the backend produces it —
HWC for the default PIL backend — scaled to [0, 1], 0-based int label).

Split note (reference parity): the legacy API deliberately EXCHANGES the
official Flowers-102 splits — ``train()`` reads the official *test* ids
(~6149 images, ``tstid``) and ``test()`` the official *train* ids
(~1020, ``trnid``) — because the official train split is too small to
train on (dataset/flowers.py TRAIN_FLAG/TEST_FLAG comment).  The class
API (``paddle_tpu_torch.vision.datasets.Flowers``) keeps the official mapping;
this shim applies the legacy exchange.
"""

import numpy as np

_LEGACY_MODE = {"train": "test", "test": "train", "valid": "valid"}


def _reader(mode, **kw):
    def reader():
        from ..vision.datasets import Flowers

        for img, label in Flowers(mode=_LEGACY_MODE[mode], **kw):
            img = np.asarray(img, "float32")
            if img.max() > 1.5:  # PIL-backed HWC uint8 path
                img = img / 255.0
            # imagelabels.mat labels are 1-based; legacy reader yields
            # int(label) - 1
            yield img, int(np.asarray(label).reshape(-1)[0]) - 1

    return reader


def train(**kw):
    return _reader("train", **kw)


def test(**kw):
    return _reader("test", **kw)


def valid(**kw):
    return _reader("valid", **kw)

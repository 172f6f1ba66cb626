"""Legacy ``paddle.dataset.movielens`` readers (reference
dataset/movielens.py): (user feats..., movie feats..., rating) tuples."""


def _reader(mode, **kw):
    def reader():
        from ..text.datasets import Movielens

        for sample in Movielens(mode=mode, **kw):
            yield tuple(sample)

    return reader


def train(**kw):
    return _reader("train", **kw)


def test(**kw):
    return _reader("test", **kw)

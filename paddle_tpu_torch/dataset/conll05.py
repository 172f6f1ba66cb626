"""Legacy ``paddle.dataset.conll05`` readers (reference
dataset/conll05.py): SRL tuples from the CoNLL-2005 test split."""


def _reader(**kw):
    def reader():
        from ..text.datasets import Conll05st

        for sample in Conll05st(**kw):
            yield tuple(sample)

    return reader


def test(**kw):
    return _reader(**kw)

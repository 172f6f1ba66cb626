"""Legacy ``paddle.dataset.imdb`` readers (reference dataset/imdb.py):
yields (word-id list, 0/1 label); ``word_dict()`` builds the vocabulary."""


def word_dict(cutoff=150):
    from ..text.datasets import Imdb

    return Imdb(mode="train", cutoff=cutoff).word_idx


def _reader(mode, word_idx, **kw):
    def reader():
        from ..text.datasets import Imdb

        ds = Imdb(mode=mode, word_idx=word_idx, **kw)
        for doc, label in ds:
            yield list(doc), int(label)

    return reader


def train(word_idx=None, **kw):
    return _reader("train", word_idx, **kw)


def test(word_idx=None, **kw):
    return _reader("test", word_idx, **kw)

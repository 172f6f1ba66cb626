"""Legacy ``paddle.dataset.imikolov`` readers (reference
dataset/imikolov.py): n-gram tuples from PTB text."""


def build_dict(min_word_freq=50):
    from ..text.datasets import Imikolov

    return Imikolov(mode="train", min_word_freq=min_word_freq).word_idx


def _reader(mode, n, word_idx, **kw):
    def reader():
        from ..text.datasets import Imikolov

        ds = Imikolov(mode=mode, data_type="NGRAM", window_size=n,
                      word_idx=word_idx, **kw)
        for sample in ds:
            yield tuple(int(v) for v in sample)

    return reader


def train(word_idx=None, n=5, **kw):
    return _reader("train", n, word_idx, **kw)


def test(word_idx=None, n=5, **kw):
    return _reader("test", n, word_idx, **kw)

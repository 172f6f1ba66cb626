"""Legacy ``paddle.dataset.wmt14`` readers (reference dataset/wmt14.py):
(src ids, trg ids, trg-next ids) tuples."""


def _reader(mode, dict_size, **kw):
    def reader():
        from ..text.datasets import WMT14

        for sample in WMT14(mode=mode, dict_size=dict_size, **kw):
            yield tuple(sample)

    return reader


def train(dict_size=-1, **kw):
    return _reader("train", dict_size, **kw)


def test(dict_size=-1, **kw):
    return _reader("test", dict_size, **kw)

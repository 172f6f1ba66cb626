"""Legacy ``paddle.dataset.wmt16`` readers (reference dataset/wmt16.py)."""


def _reader(mode, src_dict_size, trg_dict_size, lang, **kw):
    def reader():
        from ..text.datasets import WMT16

        for sample in WMT16(mode=mode, src_dict_size=src_dict_size,
                            trg_dict_size=trg_dict_size, lang=lang, **kw):
            yield tuple(sample)

    return reader


def train(src_dict_size=-1, trg_dict_size=-1, src_lang="en", **kw):
    return _reader("train", src_dict_size, trg_dict_size, src_lang, **kw)


def test(src_dict_size=-1, trg_dict_size=-1, src_lang="en", **kw):
    return _reader("test", src_dict_size, trg_dict_size, src_lang, **kw)


def validation(src_dict_size=-1, trg_dict_size=-1, src_lang="en", **kw):
    return _reader("val", src_dict_size, trg_dict_size, src_lang, **kw)

"""``paddle.text`` — NLP datasets.

Counterpart of ``paddle_tpu/text/__init__.py``: the seven datasets
(Imdb, Imikolov, Movielens, UCIHousing, WMT14, WMT16, Conll05st).
"""

from .datasets import (  # noqa: F401
    Conll05st,
    Imdb,
    Imikolov,
    Movielens,
    UCIHousing,
    WMT14,
    WMT16,
)

__all__ = [
    "Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing",
    "WMT14", "WMT16",
]

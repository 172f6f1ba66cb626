"""Legacy ``paddle.dataset`` reader-creator surface.

Counterpart of ``paddle_tpu/dataset/``, after the reference's
``dataset/`` (mnist, cifar, uci_housing, imdb, imikolov, movielens,
flowers, voc2012, wmt14, wmt16, conll05): the pre-2.x API where each
dataset module's ``train()`` / ``test()`` return a *reader creator* (a
callable of no arguments yielding sample tuples), which ``paddle.batch``
loops consume.

Every reader delegates to the class-based datasets of
``paddle_tpu_torch.vision.datasets`` / ``paddle_tpu_torch.text.datasets``,
which read local files only; a dataset is built inside the reader, so
importing this package needs no data file.
"""

from . import (  # noqa: F401
    cifar, conll05, flowers, imdb, imikolov, mnist, movielens, uci_housing,
    voc2012, wmt14, wmt16,
)

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "imikolov", "movielens",
           "flowers", "voc2012", "wmt14", "wmt16", "conll05"]

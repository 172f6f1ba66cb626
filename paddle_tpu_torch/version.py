"""Version information: ``paddle.version``.

Counterpart of ``paddle_tpu/version.py`` (the reference generates this
file when it builds).  ``cuda()`` and ``cudnn()`` report what the
installed torch was built with, as a CUDA build of the reference reports
its own; "False" on a build without them.  cuDNN's version is read when
asked for, not at import: reading it loads cuDNN, and a DataLoader worker
that imports the package must not touch the card.
"""

import torch

full_version = "2.1.0+cuda.0.1.0"
major = "2"
minor = "1"
patch = "0"
rc = "0"
istaged = True
commit = "torch-cuda"
with_mkl = "OFF"
cuda_version = str(torch.version.cuda) if torch.version.cuda else "False"


def show():
    print(f"full_version: {full_version}")
    print(f"major: {major}")
    print(f"minor: {minor}")
    print(f"patch: {patch}")
    print(f"commit: {commit}")


def cuda():
    return cuda_version


def cudnn():
    v = torch.backends.cudnn.version()
    return str(v) if v else "False"


def __getattr__(name):
    if name == "cudnn_version":
        return cudnn()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

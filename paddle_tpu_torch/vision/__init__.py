"""``paddle.vision``: the datasets and the models ported so far.

Counterpart of ``paddle_tpu/vision/__init__.py``.  ``transforms``,
``ops``, ``image`` and the folder / extra datasets wait for ROADMAP
A.12.
"""

from . import datasets  # noqa: F401
from . import models  # noqa: F401
from .models import (  # noqa: F401
    LeNet, ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
)

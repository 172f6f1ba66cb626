"""``paddle.vision``: the datasets, the models, the transforms, the
detection ops and the image backend.

Counterpart of ``paddle_tpu/vision/__init__.py``.
"""

from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import transforms  # noqa: F401
from .models import (  # noqa: F401
    LeNet, ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
)
from . import ops  # noqa: F401
from .image import get_image_backend, image_load, set_image_backend  # noqa: F401

"""``paddle.vision.models``: LeNet, ResNet, VGG, MobileNet v1 / v2 and
the Vision Transformer.

Counterpart of ``paddle_tpu/vision/models/__init__.py``.
"""

from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152,
)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenetv1 import MobileNetV1, mobilenet_v1  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .vit import (  # noqa: F401
    PatchEmbed, ViTBlock, VisionTransformer, vit_b_16, vit_b_32, vit_l_16,
    vit_s_16, vit_tiny,
)

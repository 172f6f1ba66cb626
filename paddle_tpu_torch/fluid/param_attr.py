"""``paddle.fluid.param_attr``: ``ParamAttr`` and ``WeightNormParamAttr``."""

from ..nn.layer_base import ParamAttr  # noqa: F401
from ..static import WeightNormParamAttr  # noqa: F401

"""``paddle.nn``: layers, functional, initializers and gradient clips.

Counterpart of ``paddle_tpu/nn/__init__.py``: the layers (with the
recurrent layers, the extras and ``BeamSearchDecoder`` /
``dynamic_decode``), ``functional``, ``initializer``, ``utils`` and
``quant``.
"""

from .layer_base import (  # noqa: F401
    EagerParameter,
    Layer,
    LayerList,
    ParamAttr,
    ParameterList,
    Sequential,
)
from .layer import *  # noqa: F401,F403
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import utils  # noqa: F401
from . import quant  # noqa: F401
from .utils import spectral_norm  # noqa: F401

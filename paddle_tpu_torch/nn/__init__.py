"""``paddle.nn``: layers, functional, initializers and gradient clips.

Counterpart of ``paddle_tpu/nn/__init__.py`` for the modules ported so
far; ``nn/quant``, ``nn/utils`` and the rnn and extras layers wait for
later slices (ROADMAP A.7).
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

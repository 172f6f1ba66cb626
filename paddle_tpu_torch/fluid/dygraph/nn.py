"""``paddle.fluid.dygraph.nn``: the layer classes v2.1 scripts import
from here (``from paddle.fluid.dygraph.nn import Linear``)."""

from . import (  # noqa: F401
    BatchNorm, BilinearTensorProduct, Conv2D, Conv2DTranspose, Dropout,
    Embedding, GroupNorm, LayerNorm, Linear, NCE, Pool2D, PRelu,
    SpectralNorm,
)

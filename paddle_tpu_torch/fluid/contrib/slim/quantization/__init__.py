"""``fluid.contrib.slim.quantization``: ``ImperativeQuantAware`` and
``ImperativePTQ``, the classes of :mod:`paddle_tpu_torch.incubate.quant`
(counterpart of ``paddle_tpu/fluid/contrib/slim/quantization``)."""

from .....incubate.quant import (  # noqa: F401
    ImperativePTQ, ImperativeQuantAware,
)

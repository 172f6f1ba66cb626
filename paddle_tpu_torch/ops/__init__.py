"""The port's op library (counterpart of ``paddle_tpu/ops``): importing
it registers the math, activation, tensor, nn, sequence, optimizer and
quant ops (:mod:`.registry`), which :func:`.dispatch.dispatch` runs eagerly; plus
the numerics the GPT layers call directly (the quantization decisions of
:mod:`.quant_ops`, :func:`.nn_ops.dropout`); :func:`.dispatch.dispatch`
appends them to a Program in static mode.  :mod:`.collective_ops`
registers the reference's ``c_*`` collective ops over
``torch.distributed``."""

from . import registry  # noqa: F401
from . import math_ops  # noqa: F401
from . import activation_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import quant_ops  # noqa: F401
from . import collective_ops  # noqa: F401
from .dispatch import dispatch, dispatch_dygraph, dispatch_static, single  # noqa: F401
from .nn_ops import dropout
from .quant_ops import (dequantize_int4, pack_int4, quantize_int4_per_token,
                        quantize_per_channel, quantize_per_token, unpack_int4,
                        w8a8_apply, w8a8_matmul)
from .registry import (OpNotRegistered, get_op_def, is_registered,  # noqa: F401
                       register_op)

__all__ = ["quantize_per_token", "pack_int4", "unpack_int4",
           "quantize_int4_per_token", "dequantize_int4",
           "quantize_per_channel", "w8a8_apply", "w8a8_matmul", "dropout",
           "dispatch", "dispatch_static", "single", "register_op",
           "get_op_def"]

"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu``.

The port is a package of its own: it imports ``torch``, numpy and the
standard library, never ``jax`` and nothing of ``paddle_tpu``.  Its layout
mirrors the JAX package so that every module has an obvious counterpart:

* ``models/gpt.py`` and ``models/generation.py``: the GPT decoder, its
  training step, the dense KV-cache decoder (the engine's oracle) and
  beam search;
* ``kernels/``: hand-written CUDA kernels for Hopper (``csrc/*.cu``), each
  beside its plain PyTorch version;
* ``serving/``: the paged, continuous-batching serving engine and its
  streaming HTTP front end (``serving/frontend.py``);
* ``distributed/``: ``paddle.distributed`` over ``torch.distributed``
  (the collective API, the ``(dp, pp, sharding, mp)`` mesh, ``spawn``,
  ``fleet`` and its tensor-parallel layers), which the train step, TP
  decoding and ``kernels/ring.py`` (ring attention) run over;
* ``framework/``: the seed chain of explicit ``torch.Generator``s and the
  flags the profiler reads; ``profiler.py``: host spans, their table and
  ``torch.profiler`` traces;
* the paddle-shaped eager core: ``framework/`` (dtypes, places,
  ``set_device``, flags, unique names, the seed chain), ``ops/`` (the
  op registry and the registered ops, dispatched eagerly),
  ``dygraph/`` (the Tensor over one ``torch.Tensor``, the tracer, torch
  autograd as the tape), ``tensor_api.py`` (the ``paddle.*``
  functions), ``autograd/`` (``PyLayer``), ``nn/``, ``optimizer/``,
  ``regularizer.py`` and ``amp/``; ``models/bert.py`` pretrains BERT
  on them and ``models/gpt_layers.py`` is GPT as paddle layers, which
  ``fleet`` trains (``distributed_model`` / ``distributed_optimizer``,
  ``PipelineParallel``, ``DataParallel``, the sharding optimizer);
* data and the generic step: ``io/`` (datasets, samplers, the
  DataLoader with its shared-memory ring), ``reader/``, ``io_api.py``
  (``save`` / ``load`` / ``batch``), ``vision/`` (ResNet, VGG,
  MobileNet, LeNet and the datasets over the 2-D conv and pool ops) and
  ``models/step_builder.py`` (``build_model_train_step``, one train step
  for any ``nn.Layer``);
* ``examples/serve_gpt.py``: the serve CLI
  (``python -m paddle_tpu_torch.examples.serve_gpt``), and
  ``examples/pretrain_bert.py``: BERT pretraining through the eager API
  (``python -m paddle_tpu_torch.examples.pretrain_bert``);
* graph mode: ``framework/program.py`` (Program, Block, Variable,
  Operator, Parameter), ``static/`` (the Executor, ``append_backward``,
  ``static.nn``, ``static.amp``, static io, ``cond`` / ``while_loop``)
  and ``fluid/``, the v2.1 namespace; ``examples/fluid_mnist.py`` trains
  BASELINE config 0 through it;
* deployment: ``jit/`` (``to_static`` with the dy2static AST pass,
  ``jit.save`` / ``jit.load``, ``TracedLayer``), ``inference/`` (``Config``
  and the ``Predictor``, in fp32, bf16 or int8 through
  ``static/quant_int8.py``) and ``incubate/quant.py`` (quantization-aware
  training and post-training quantization);
* the rest of the eager API: ``nn/layer/rnn.py`` (SimpleRNN, LSTM, GRU),
  ``nn/layer/extras.py`` (the 3-D convs and pools, the CTC and
  hierarchical-sigmoid losses, ``BeamSearchDecoder`` /
  ``dynamic_decode``), ``nn/utils.py``, ``nn/quant/`` and
  ``ops/sequence_ops.py`` (the padded sequence ops);
* ``weights.py``: lifts a JAX parameter tree (as numpy) into the port.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``
(see :mod:`paddle_tpu_torch.device`), and the eager API's place is the
card (``gpu:0``) unless ``set_device("cpu")`` says otherwise.  The
top-level namespace is the reference's ``paddle_tpu`` namespace for the
modules ported so far: ``to_tensor``, ``seed``, ``set_device``,
``no_grad``, ``grad``, ``DataParallel``, ``io``, ``reader``, ``vision``,
``static``, ``fluid``, ``jit``, ``inference``, ``incubate``,
``enable_static``, ``save``, ``load``, ``batch``, the tensor functions
and the helpers (``get_cudnn_version``, ``is_compiled_with_*``,
``set_printoptions``, ``summary``, ``check_shape``, ``monkey_patch_*``),
which report the card's build where the reference reports the TPU's.
"""

from .device import default_device, default_dtype, resolve_device  # noqa: F401

from . import framework  # noqa: F401
from .framework import (  # noqa: F401
    CPUPlace,
    CUDAPinnedPlace,
    CUDAPlace,
    NPUPlace,
    TPUPlace,
    XPUPlace,
    disable_static,
    enable_static,
    get_device,
    in_dygraph_mode,
    is_compiled_with_cuda,
    is_compiled_with_tpu,
    set_device,
)
from .framework.dtype import (  # noqa: F401
    bfloat16,
    bool,
    complex64,
    complex128,
    float16,
    float32,
    float64,
    int8,
    int16,
    int32,
    int64,
    uint8,
)
from .framework.dtype import DataType as dtype  # noqa: F401
from .framework.dtype import get_default_dtype, set_default_dtype  # noqa: F401
from .framework.flags import get_flags, set_flags  # noqa: F401
from .framework.random import get_rng_state, seed, set_rng_state  # noqa: F401
from . import ops  # noqa: F401  (registers the ops)
from .dygraph.tensor import Tensor, to_tensor  # noqa: F401
from .dygraph.base import (  # noqa: F401
    enable_grad,
    grad,
    is_grad_enabled,
    no_grad,
    set_grad_enabled,
)
from . import tensor_api as tensor  # noqa: F401
from .tensor_api import *  # noqa: F401,F403
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from . import amp  # noqa: F401
from . import autograd  # noqa: F401
from . import regularizer  # noqa: F401
from .nn import ParamAttr  # noqa: F401
from .dygraph.parallel import DataParallel  # noqa: F401
from . import io  # noqa: F401
from . import reader  # noqa: F401
from . import vision  # noqa: F401
from . import metric  # noqa: F401
from .io_api import batch, load, save  # noqa: F401
from . import static  # noqa: F401
from . import fluid  # noqa: F401
from . import jit  # noqa: F401
from . import inference  # noqa: F401
from . import incubate  # noqa: F401

VarBase = Tensor
in_dynamic_mode = in_dygraph_mode
enable_dygraph = disable_static
disable_dygraph = enable_static
get_cuda_rng_state = get_rng_state
set_cuda_rng_state = set_rng_state


from .device import (  # noqa: E402,F401
    get_cudnn_version, is_compiled_with_npu, is_compiled_with_rocm,
    is_compiled_with_xpu)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Display options of a Tensor's values (printed through numpy)."""
    import numpy as _np

    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    _np.set_printoptions(**kw)


def summary(net, input_size=None, dtypes=None):
    """Print a Layer's parameters (name, shape, count) and their totals;
    returns ``{"total_params", "trainable_params"}``."""
    import numpy as _np

    total = trainable = 0
    lines = ["-" * 64,
             f"{'Layer (type)':<38}{'Param shape':<16}{'Param #':>10}",
             "=" * 64]
    for name, p in net.named_parameters():
        n = int(_np.prod(p.shape))
        total += n
        if not p.stop_gradient:
            trainable += n
        lines.append(f"{name:<38}{str(tuple(p.shape)):<16}{n:>10,}")
    lines += ["=" * 64, f"Total params: {total:,}",
              f"Trainable params: {trainable:,}",
              f"Non-trainable params: {total - trainable:,}", "-" * 64]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def check_shape(shape):
    """Raise TypeError unless every entry of ``shape`` is an int or
    None."""
    for s in shape:
        if s is not None and not isinstance(s, int):
            raise TypeError(f"shape entries must be ints/None, got {s!r}")


def monkey_patch_math_varbase():
    """A no-op: the Tensor has its operators built in."""


def monkey_patch_variable():
    """A no-op: the static Variable has its operators built in."""

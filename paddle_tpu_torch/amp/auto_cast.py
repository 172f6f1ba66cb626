"""``auto_cast``: the tracer's per-op dtype policy.

Counterpart of ``paddle_tpu/amp/auto_cast.py``: under O1 the white-list
ops (the matmuls and attention) cast their float inputs to the low
dtype, the black-list ops (reductions, norms, losses, softmax) to fp32,
and the rest take their inputs as they come; under O2 every op but the
black list runs in the low dtype.  A cast of a tensor that needs a
gradient is itself a traced ``cast`` op, so autograd carries the
gradient back to the fp32 parameter.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Set

import torch

from ..framework.dtype import to_torch_dtype

white_list: Set[str] = {
    "conv2d", "depthwise_conv2d", "conv2d_transpose", "matmul", "matmul_v2",
    "mul", "scaled_dot_product_attention",
}
black_list: Set[str] = {
    "exp", "square", "log", "mean", "sum", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "c_softmax_with_cross_entropy",
    "cross_entropy", "layer_norm", "batch_norm", "reduce_mean", "reduce_sum",
    "softmax", "log_softmax", "p_norm", "squared_l2_norm",
}


class AmpState:
    def __init__(self, enable: bool, dtype: str, level: str,
                 custom_white: Optional[List[str]] = None,
                 custom_black: Optional[List[str]] = None):
        self.enable = enable
        self.dtype = dtype  # 'bfloat16' (default) or 'float16'
        self.level = level.upper()  # 'O1' | 'O2'
        custom_white = set(custom_white or ())
        custom_black = set(custom_black or ())
        # a custom black entry wins over the default white list
        self.white = (set(white_list) | custom_white) - custom_black
        self.black = (set(black_list) | custom_black) - custom_white


def _cast_tensor(t, dtype):
    from ..dygraph.tensor import Tensor

    tdt = to_torch_dtype(dtype)
    if not t._t.is_floating_point() or t._t.dtype == tdt:
        return t
    if not t._t.requires_grad:
        return Tensor._wrap(t._t.to(tdt))
    # a tensor that needs a gradient is cast through the tape
    from ..dygraph import tracer

    return tracer.trace_op("cast", {"X": [t]}, {"out_dtype": dtype})["Out"][0]


def maybe_autocast_inputs(amp: AmpState, op_type: str,
                          ins: Dict[str, list], attrs: Dict):
    """The tracer's hook for every op while amp is on."""
    if not amp.enable or op_type == "cast":
        # the amp casts are cast ops: they are never cast again (under O2
        # the reference's would recurse)
        return ins, attrs
    low = amp.dtype
    if amp.level == "O2":
        target = "float32" if op_type in amp.black else low
        return ({s: [_cast_tensor(t, target) for t in ts]
                 for s, ts in ins.items()}, attrs)
    if op_type in amp.white:
        return ({s: [_cast_tensor(t, low) for t in ts]
                 for s, ts in ins.items()}, attrs)
    if op_type in amp.black:
        return ({s: [_cast_tensor(t, "float32") for t in ts]
                 for s, ts in ins.items()}, attrs)
    return ins, attrs


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16"):
    """``paddle.amp.auto_cast`` (bf16 by default)."""
    from ..dygraph import tracer

    old = tracer.amp_state()
    tracer.set_amp_state(
        AmpState(enable, dtype, level, custom_white_list, custom_black_list)
        if enable else None)
    try:
        yield
    finally:
        tracer.set_amp_state(old)


amp_guard = auto_cast


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: under O2 the models' float parameters are
    cast to the low dtype, and the optimizers keep fp32 master weights,
    seeded from the fp32 values before the cast, which the updates run
    on."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = ([] if optimizers is None
                else [optimizers] if opt_single else list(optimizers))
    if level.upper() == "O2":
        target = torch.bfloat16 if dtype == "bfloat16" else torch.float16
        use_master = master_weight is not False
        for m in model_list:
            if m is None:
                continue
            for p in m.parameters():
                if not p._t.is_floating_point():
                    continue
                if use_master and p._t.dtype == torch.float32:
                    for o in opt_list:
                        o._master_weight(p)
                p._t = p._t.detach().to(target).requires_grad_(
                    p._t.requires_grad)
        if use_master:
            for o in opt_list:
                o._multi_precision = True
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers

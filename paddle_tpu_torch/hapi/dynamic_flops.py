"""``paddle.flops``: a network's multiply-accumulates, counted by layer.

Counterpart of ``paddle_tpu/hapi/dynamic_flops.py``: forward post hooks
on the sublayers of the known types (or of ``custom_ops``' types) count
each one's work from its output's shape during one forward pass of a
zero input, with the same counter per layer type.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["flops"]


def _count_linear(m, x, y):
    # in_features multiply-adds per output element
    return int(np.prod(y.shape)) * m.weight.shape[0]


def _count_conv2d(m, x, y):
    kh, kw = m.weight.shape[-2:]
    cin = m.weight.shape[1]  # per-group input channels
    return int(np.prod(y.shape)) * cin * kh * kw


def _count_elementwise(m, x, y):
    return int(np.prod(y.shape))


def _count_norm(m, x, y):
    return 2 * int(np.prod(y.shape))


def _count_pool(m, x, y):
    return int(np.prod(y.shape))


_COUNTERS = {
    "Linear": _count_linear,
    "Conv2D": _count_conv2d,
    "ReLU": _count_elementwise,
    "GELU": _count_elementwise,
    "Sigmoid": _count_elementwise,
    "Tanh": _count_elementwise,
    "BatchNorm2D": _count_norm,
    "BatchNorm1D": _count_norm,
    "LayerNorm": _count_norm,
    "AvgPool2D": _count_pool,
    "MaxPool2D": _count_pool,
    "AdaptiveAvgPool2D": _count_pool,
}


def flops(net, input_size, custom_ops: Optional[Dict] = None,
          print_detail: bool = False) -> int:
    """Count multiply-accumulate FLOPs of one forward pass.

    ``input_size``: shape list (with batch dim) of a float32 input;
    ``custom_ops``: {LayerClass: fn(layer, input, output) -> int}
    override the counters.  Returns the total; ``print_detail`` also
    prints a table of the layers' output shapes, counts and parameters.
    """
    from ..dygraph.tensor import to_tensor

    custom = {}
    for cls, fn in (custom_ops or {}).items():
        custom[cls.__name__ if isinstance(cls, type) else str(cls)] = fn

    rows = []
    handles = []

    def attach(layer, name):
        cls = type(layer).__name__
        counter = custom.get(cls) or _COUNTERS.get(cls)
        if counter is None:
            return

        def hook(m, inputs, outputs, _counter=counter, _name=name):
            out = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
            n = int(_counter(m, inputs, out))
            n_params = sum(int(np.prod(p.shape)) for p in m.parameters())
            rows.append((_name or type(m).__name__, tuple(out.shape), n,
                         n_params))

        handles.append(layer.register_forward_post_hook(hook))

    for name, sub in net.named_sublayers(include_self=True):
        attach(sub, name)

    was_training = net.training
    net.eval()
    try:
        x = to_tensor(np.zeros(list(input_size), dtype="float32"))
        net(x)
    finally:
        if was_training:
            net.train()
        for h in handles:
            if hasattr(h, "remove"):
                h.remove()

    total = sum(r[2] for r in rows)
    if print_detail:
        print(f"{'Layer':<32}{'Output shape':<22}{'FLOPs':<14}{'Params':<10}")
        for name, shape, n, n_params in rows:
            print(f"{name:<32}{str(list(shape)):<22}{n:<14}{n_params:<10}")
        print(f"Total FLOPs: {total}")
    return total

"""``paddle.onnx``: ONNX export without the ``onnx`` package.

Counterpart of ``paddle_tpu/onnx/__init__.py`` (the reference's
``onnx/export.py`` hands the work to ``paddle2onnx``): the layer is traced
to a ``Program`` through ``jit.to_static``, the ops become ONNX nodes
(:mod:`.convert`, the JAX package's op map) and the ModelProto is
written in protobuf's wire format by hand (:mod:`.proto`).  The trace
runs under fresh unique-name counters, so the names it gives do not
depend on what ran before in the process: the same Layer gives the same
file on the card and, moved by ``Layer.to``, on the CPU.

:mod:`.runner` runs an exported file in numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["export"]


def export(layer, path: str, input_spec: Optional[Sequence] = None,
           opset_version: int = 17, **configs):
    """Write ``layer`` to ``{path}.onnx`` and return that path.

    ``input_spec``: ``paddle.static.InputSpec``s (or Tensors) that fix the
    inputs' shapes and dtypes, as in the reference's API."""
    from .. import jit
    from ..dygraph.tensor import Tensor
    from ..framework import unique_name
    from .convert import convert_program

    if input_spec is None:
        raise ValueError(
            "paddle.onnx.export requires input_spec (shapes of the inputs)")
    specs = []
    concrete = []
    for s in input_spec:
        if isinstance(s, Tensor):
            s = jit.InputSpec(list(s.shape), s.dtype,
                              getattr(s, "name", None))
        specs.append(s)
        shape = [1 if (d is None or int(d) < 0) else int(d)
                 for d in s.shape]
        concrete.append(Tensor(np.zeros(shape, s.dtype or "float32")))

    was_training = getattr(layer, "training", False)
    if hasattr(layer, "eval"):
        layer.eval()  # the inference graph: no dropout, BatchNorm's stats
    try:
        fn = layer.forward if hasattr(layer, "forward") else layer
        with unique_name.guard():
            sf = jit.to_static(fn, input_spec=specs)
            main, startup, feed_names, fetch_names, _ = sf.get_traced(
                tuple(concrete))
        model_bytes = convert_program(
            main, sf._scope, feed_names, fetch_names,
            opset_version=opset_version,
            graph_name=type(layer).__name__)
    finally:
        if was_training and hasattr(layer, "train"):
            layer.train()

    out_path = path if path.endswith(".onnx") else path + ".onnx"
    with open(out_path, "wb") as f:
        f.write(model_bytes)
    return out_path

"""The pipeline-parallel layer container.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``
(``LayerDesc``, ``SharedLayerDesc``, ``SegmentLayers``, ``PipelineLayer``).
A ``PipelineLayer`` builds every layer of its descriptions in order (so
each rank draws the same weights from the seed chain as the one-device
model of that seed) and holds the uniform stage partition;
:class:`~.pipeline_engine.PipelineEngine` decides what each rank keeps
and runs (its stage's blocks, and the prologue and epilogue stored 1/S)
and drops the other stages' blocks.  ``recompute_interval`` is kept and
not used, as in the reference.
"""

from __future__ import annotations

import math
from typing import Callable, List

from ....nn.layer_base import Layer, LayerList
from ... import mesh as mesh_mod

__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineLayer"]


class LayerDesc:
    """A layer's class and arguments, built when the pipeline is."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_func, Layer):
            raise TypeError("The input of LayerDesc should be Layer")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer built once for every description of its ``key`` (the tied
    embedding and head); ``forward_func(layer, x)`` runs it where it is
    not called as itself."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """The boundaries of ``num_parts`` stages over the descriptions:
    ``uniform``, or ``layer:<ClassName>`` (equal counts of that class)."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self._layers_desc = layers_desc
        self.method = method
        self.num_parts = num_parts
        self.num_items = len(layers_desc)
        if self.num_items < self.num_parts:
            raise ValueError("layer number should be greater than number "
                             "of segments")

    def do_segment(self) -> List[int]:
        if self.method == "uniform":
            return self.uniform(self.num_items, self.num_parts)
        if self.method.startswith("layer:"):
            cls_name = self.method.split(":", 1)[1]
            hits = [i for i, d in enumerate(self._layers_desc)
                    if (d.layer_func.__name__ if isinstance(d, LayerDesc)
                        else d.__class__.__name__) == cls_name]
            if len(hits) < self.num_parts:
                raise ValueError(f"{len(hits)} {cls_name} layers for "
                                 f"{self.num_parts} stages")
            per = len(hits) // self.num_parts
            result = [0] * (self.num_parts + 1)
            for p in range(1, self.num_parts):
                result[p] = hits[p * per]
            result[self.num_parts] = self.num_items
            return result
        raise ValueError(f"unknown segment method {self.method}")

    @staticmethod
    def uniform(num_items, num_parts) -> List[int]:
        result = [0] * (num_parts + 1)
        part_size = math.floor(num_items / num_parts)
        extra = num_items % num_parts
        for i in range(1, num_parts + 1):
            result[i] = result[i - 1] + part_size + (1 if i <= extra else 0)
        return result


def _run(funcs, x):
    for layer, fwd in funcs:
        if layer is None:
            raise RuntimeError(
                "this rank holds only its own stage's blocks (the pipeline "
                "engine dropped the others); run the whole stack through "
                "PipelineParallel.eval_batch")
        if fwd is not None:
            x = fwd(layer, x)
        elif isinstance(x, tuple):
            x = layer(*x)
        else:
            x = layer(x)
    return x


class PipelineLayer(Layer):
    """The layers of ``layers`` (descriptions, layers or callables), all
    built, with the stage partition; ``run_function(stage)`` runs a
    stage's layers and ``forward`` the whole stack."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 seq_major=False, **kwargs):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        # [S, B, H] activations (GPTConfig.seq_major): the engine splits
        # microbatches off the ids' batch dim either way
        self.seq_major = seq_major
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = num_stages or max(mesh_mod.axis_size("pp"), 1)
        self._layers_desc = list(layers)
        self._recompute_interval = recompute_interval
        seg = SegmentLayers(self._layers_desc, self._num_stages, seg_method)
        self.segment_parts = seg.do_segment()

        self._shared = {}
        built = []
        for d in self._layers_desc:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared:
                    self._shared[d.layer_name] = d.build_layer()
                built.append((self._shared[d.layer_name], d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append((d.build_layer(), None))
            elif isinstance(d, Layer) or callable(d):
                built.append((d, None))
            else:
                raise TypeError(f"bad layer desc {d!r}")
        self._funcs = built
        self.run_functions = LayerList(
            [l for l, _ in built if isinstance(l, Layer)])

    def get_num_stages(self):
        return self._num_stages

    def get_stage_from_index(self, layer_idx) -> int:
        for s in range(self._num_stages):
            if self.segment_parts[s] <= layer_idx < self.segment_parts[s + 1]:
                return s
        return self._num_stages - 1

    def stage_layers(self, stage: int):
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return self._funcs[lo:hi]

    def run_function(self, stage: int) -> Callable:
        funcs = self.stage_layers(stage)
        return lambda x: _run(funcs, x)

    def forward(self, x):
        return _run(self._funcs, x)

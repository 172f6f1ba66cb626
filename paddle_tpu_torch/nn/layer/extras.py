"""The rest of ``paddle.nn``'s layers: activation, dropout, padding,
pooling and conv variants, ``PixelShuffle``, ``Unfold``,
``SpectralNorm``, ``PairwiseDistance``, ``LayerDict``, the CTC and
hierarchical-sigmoid losses, and ``BeamSearchDecoder`` with
``dynamic_decode``.

Counterpart of ``paddle_tpu/nn/layer/extras.py``, class for class: each
layer is a thin shell over ``paddle.nn.functional``, with the reference's
parameters (names, shapes, creation order).

:func:`dynamic_decode` keeps the reference's contract (the initial states
tiled ``beam_size`` times, beams 1..k-1 starting at -1e9, a finished beam
extended only by the end token at no cost, an early stop once every beam
has finished, and the best beam's ids and score backtracked through the
parents), but its states stay on their device: they are tiled with
``repeat_interleave`` and reordered with ``index_select``, the
log-softmax and the top k run where the logits are, and only the
stopping test (one flag a step) is read back.  It runs under
``no_grad``: the reference's decode returns host values without
gradient.  Among equal candidates the lower flat index (beam * V +
token) wins (a stable sort); the reference's ``np.argsort`` orders equal
candidates in no fixed way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..layer_base import Layer
from .. import functional as F
from ... import tensor_api as T
from ...dygraph.base import no_grad
from ...dygraph.tensor import Tensor, to_tensor
from .pooling import AvgPool1D, MaxPool1D

__all__ = [
    "Silu", "AlphaDropout", "Dropout3D", "Pad1D", "Pad3D",
    "PairwiseDistance", "PixelShuffle", "Unfold", "SpectralNorm",
    "LayerDict", "MaxPool3D", "AvgPool3D", "MaxPool1D", "AvgPool1D",
    "AdaptiveAvgPool1D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
    "AdaptiveMaxPool3D", "Conv3D", "Conv3DTranspose", "Conv1DTranspose",
    "CTCLoss", "HSigmoidLoss", "BeamSearchDecoder", "dynamic_decode",
]


class Silu(Layer):
    def forward(self, x):
        return F.silu(x)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class _PadND(Layer):
    SPATIAL = 1

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format=None, name=None):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding] * (2 * self.SPATIAL)
        self.padding = list(padding)
        self.mode = mode
        self.value = value

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value)


class Pad1D(_PadND):
    SPATIAL = 1


class Pad3D(_PadND):
    SPATIAL = 3


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        diff = T.add(T.subtract(x, y), T.full_like(x, self.epsilon))
        return T.norm(diff, p=self.p, axis=-1, keepdim=self.keepdim)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class SpectralNorm(Layer):
    """``weight / sigma``: sigma the top singular value of the weight (as
    a matrix of rows ``dim``) by ``power_iters`` steps of power iteration
    from the stored u, v, which carry over to the next call in dygraph."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter([h])
        self.weight_u.stop_gradient = True
        self.weight_u.set_value(
            np.random.RandomState(0).randn(h).astype("float32"))
        self.weight_v = self.create_parameter([w])
        self.weight_v.stop_gradient = True
        self.weight_v.set_value(
            np.random.RandomState(1).randn(w).astype("float32"))

    def forward(self, weight):
        from ...dygraph import tracer
        from ...framework import program as fw

        dim, iters, eps = self.dim, self.power_iters, self.eps

        def fn(w, u, v):
            # u and v are overwritten below: the graph keeps copies
            u, v = u.detach().clone(), v.detach().clone()
            perm = [dim] + [i for i in range(w.ndim) if i != dim]
            mat = w.permute(perm).reshape(w.shape[dim], -1)
            for _ in range(iters):
                v = mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = mat @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            sigma = u @ mat @ v
            return w / sigma, u.detach(), v.detach()

        out, u_new, v_new = tracer.trace_fn(
            fn, [weight, self.weight_u, self.weight_v], name="spectral_norm")
        if fw.in_dygraph_mode():
            self.weight_u.set_value(u_new._t)
            self.weight_v.set_value(v_new._t)
        return out


class LayerDict(Layer):
    """A dict of sublayers."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, sublayer):
        self.add_sublayer(key, sublayer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        return self._sub_layers.pop(key)

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) else sublayers
        for k, v in items:
            self.add_sublayer(k, v)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCDHW", name=None):
        super().__init__()
        self._a = (kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        k, s, p, cm = self._a
        return F.max_pool3d(x, k, s, p, ceil_mode=cm)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__()
        self._a = (kernel_size, stride, padding, ceil_mode, exclusive)

    def forward(self, x):
        k, s, p, cm, ex = self._a
        return F.avg_pool3d(x, k, s, p, ceil_mode=cm, exclusive=ex)


class _Adaptive(Layer):
    FN = None

    def __init__(self, output_size, *args, name=None, **kwargs):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return getattr(F, self.FN)(x, self.output_size)


class AdaptiveAvgPool1D(_Adaptive):
    FN = "adaptive_avg_pool1d"


class AdaptiveMaxPool1D(_Adaptive):
    FN = "adaptive_max_pool1d"


class AdaptiveAvgPool3D(_Adaptive):
    FN = "adaptive_avg_pool3d"


class AdaptiveMaxPool3D(_Adaptive):
    FN = "adaptive_max_pool3d"


class _ConvNd(Layer):
    SPATIAL = 3
    TRANSPOSE = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format=None):
        super().__init__()
        n = self.SPATIAL
        ks = ([kernel_size] * n if isinstance(kernel_size, int)
              else list(kernel_size))
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        if self.TRANSPOSE:
            wshape = [in_channels, out_channels // groups] + ks
        else:
            wshape = [out_channels, in_channels // groups] + ks
        self.weight = self.create_parameter(shape=wshape, attr=weight_attr)
        self.bias = (None if bias_attr is False else self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True))


class Conv3D(_ConvNd):
    SPATIAL = 3
    TRANSPOSE = False

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups)


class Conv3DTranspose(_ConvNd):
    SPATIAL = 3
    TRANSPOSE = True

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._dilation, self._groups,
            output_size=output_size)


class Conv1DTranspose(_ConvNd):
    SPATIAL = 1
    TRANSPOSE = True

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._dilation, self._groups,
            output_size=output_size)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if is_custom:
            raise NotImplementedError(
                "custom-tree hsigmoid is not wired; the default complete "
                "binary tree is")
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [num_classes - 1], attr=bias_attr, is_bias=True))

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias)


class BeamSearchDecoder:
    """Beam search over a cell, driven by :func:`dynamic_decode`: each
    step the cell takes ``embedding_fn(tokens)`` (the tokens as a float
    column without one) and its states, and ``output_fn`` turns its output
    into the logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def _torch(s):
    return (s if isinstance(s, Tensor) else to_tensor(s))._t


def _map_states(fn, s):
    if isinstance(s, (tuple, list)):
        return type(s)(_map_states(fn, v) for v in s)
    return Tensor._wrap(fn(_torch(s)))


def _first(s):
    return _first(s[0]) if isinstance(s, (tuple, list)) else s


@no_grad()
def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    """Beam search to the end token or ``max_step_num`` steps: returns
    (ids [B, T], scores [B]) of each row's best beam.  Each step's
    candidates are the beams' scores plus the log-softmax of their logits
    (fp32); the top k of a row's k * V candidates become its beams."""
    if inits is None:
        raise ValueError("dynamic_decode needs initial states (inits)")
    cell, k = decoder.cell, decoder.beam_size
    first = _torch(_first(inits))
    b, dev = first.shape[0], first.device
    states = _map_states(lambda a: a.repeat_interleave(k, dim=0), inits)
    tokens = torch.full((b * k,), decoder.start_token, dtype=torch.int64,
                        device=dev)
    scores = torch.zeros((b, k), dtype=torch.float32, device=dev)
    scores[:, 1:] = -1e9  # all beams start alike: one stays live
    finished = torch.zeros((b * k,), dtype=torch.bool, device=dev)
    base = torch.arange(b, device=dev)[:, None] * k
    ended = None
    collected = []
    for _ in range(max_step_num):
        tok = Tensor._wrap(tokens)
        inp = (decoder.embedding_fn(tok) if decoder.embedding_fn is not None
               else T.cast(T.unsqueeze(tok, [-1]), "float32"))
        out, new_states = cell(inp, states)
        logits = (decoder.output_fn(out) if decoder.output_fn is not None
                  else out)
        lp = torch.log_softmax(logits._t.to(torch.float32), dim=-1)
        v = lp.shape[-1]
        if ended is None:
            # a finished beam: the end token at no cost, all else -1e9
            ended = torch.full((v,), -1e9, dtype=torch.float32, device=dev)
            ended[decoder.end_token] = 0.0
        lp = torch.where(finished[:, None], ended, lp)
        cand = (scores.reshape(-1, 1) + lp).reshape(b, k * v)
        top = torch.sort(cand, dim=1, descending=True, stable=True)[1][:, :k]
        scores = torch.gather(cand, 1, top)
        tokens = (top % v).reshape(-1)
        rows = (base + torch.div(top, v, rounding_mode="floor")).reshape(-1)
        states = _map_states(lambda a: a.index_select(0, rows), new_states)
        finished = finished[rows] | (tokens == decoder.end_token)
        collected.append((tokens, rows))
        if bool(finished.all()):
            break
    best = torch.argmax(scores, dim=1)
    rows = base[:, 0] + best
    seq = torch.empty((b, len(collected)), dtype=torch.int64, device=dev)
    for t in range(len(collected) - 1, -1, -1):
        toks, parents = collected[t]
        seq[:, t] = toks[rows]
        rows = parents[rows]
    return (Tensor._wrap(seq),
            Tensor._wrap(torch.gather(scores, 1, best[:, None])[:, 0]))

"""Recurrent layers: the SimpleRNN, LSTM and GRU cells, ``RNN`` and
``BiRNN`` over a cell, and the stacked ``SimpleRNN`` / ``LSTM`` / ``GRU``.

Counterpart of ``paddle_tpu/nn/layer/rnn.py``, class for class, over the
port's registered ops (``matmul_v2``, ``split``, the activations), so a
cell runs eagerly on the card or the CPU and records ops in a static
program.  The gate algebra and order are the reference's: LSTM's gates
are i, f, c, o (``c = f * c_prev + i * tanh(g)``, ``h = o * tanh(c)``);
GRU applies its reset gate after the matmul (``c = tanh(x_c + r * h_c)``,
``h = (h_prev - c) * z + c``).  Every weight and bias is drawn from
``Uniform(-1/sqrt(hidden), 1/sqrt(hidden))`` by the port's generator.

The time loop is a Python loop over the steps, one cell call a step.
With ``sequence_length``, a row's outputs past its length are 0 and its
state freezes at its last valid step (``new * valid + old * (1 -
valid)``).
"""

from __future__ import annotations

import math

from ..layer_base import Layer, LayerList, ParamAttr
from ..initializer import Uniform
from .. import functional as F
from ... import tensor_api as T

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        b = batch_ref.shape[batch_dim_idx]
        shapes = shape if isinstance(shape, tuple) and shape and \
            isinstance(shape[0], tuple) else (shape,)
        outs = tuple(T.full([b] + list(s), init_value, dtype) for s in shapes)
        return outs if len(outs) > 1 else outs[0]


def _uniform_attr(hidden_size):
    std = 1.0 / math.sqrt(hidden_size)
    return ParamAttr(initializer=Uniform(-std, std))


class _Cell(RNNCellBase):
    """A cell with ``GATES`` gate blocks: weight_ih [G * hidden, input],
    weight_hh [G * hidden, hidden] and their biases."""

    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = self.GATES * hidden_size
        ua = _uniform_attr(hidden_size)
        self.weight_ih = self.create_parameter(
            [g, input_size], attr=weight_ih_attr or ua)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], attr=weight_hh_attr or ua)
        self.bias_ih = self.create_parameter(
            [g], attr=bias_ih_attr or ua, is_bias=True)
        self.bias_hh = self.create_parameter(
            [g], attr=bias_hh_attr or ua, is_bias=True)

    @property
    def state_shape(self):
        return (self.hidden_size,)


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        if activation not in ("tanh", "relu"):
            raise ValueError(f"activation must be tanh or relu: {activation}")
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        pre = (T.matmul(inputs, self.weight_ih, transpose_y=True)
               + self.bias_ih
               + T.matmul(states, self.weight_hh, transpose_y=True)
               + self.bias_hh)
        h = T.tanh(pre) if self.activation == "tanh" else T.maximum(
            pre, T.zeros_like(pre))
        return h, h


class LSTMCell(_Cell):
    GATES = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        pre_h, pre_c = states
        gates = (T.matmul(inputs, self.weight_ih, transpose_y=True)
                 + self.bias_ih
                 + T.matmul(pre_h, self.weight_hh, transpose_y=True)
                 + self.bias_hh)
        i, f, g, o = T.split(gates, 4, axis=-1)
        i, f, o = F.sigmoid(i), F.sigmoid(f), F.sigmoid(o)
        c = f * pre_c + i * T.tanh(g)
        h = o * T.tanh(c)
        return h, (h, c)


class GRUCell(_Cell):
    GATES = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        pre_h = states
        xg = T.matmul(inputs, self.weight_ih, transpose_y=True) + self.bias_ih
        hg = T.matmul(pre_h, self.weight_hh, transpose_y=True) + self.bias_hh
        x_r, x_z, x_c = T.split(xg, 3, axis=-1)
        h_r, h_z, h_c = T.split(hg, 3, axis=-1)
        r = F.sigmoid(x_r + h_r)
        z = F.sigmoid(x_z + h_z)
        c = T.tanh(x_c + r * h_c)  # the reset gate after the matmul
        h = (pre_h - c) * z + c
        return h, h


def _mask_step(new, old, valid):
    """``new`` where ``valid`` ([b, 1] float) is 1, else ``old``."""
    return new * valid + old * (1.0 - valid)


def _tree_map2(fn, a, b):
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


class RNN(Layer):
    """A cell run over the time dim (1, or 0 with ``time_major``),
    forward or reversed."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        time_axis = 0 if self.time_major else 1
        steps = inputs.shape[time_axis]
        states = initial_states
        if states is None:
            batch_ref = (T.transpose(inputs, [1, 0, 2]) if self.time_major
                         else inputs)
            states = self.cell.get_initial_states(batch_ref,
                                                  self.cell.state_shape)
        seq_len = (None if sequence_length is None
                   else T.cast(sequence_length, "float32"))
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        outs = [None] * steps
        for t in order:
            xt = T.squeeze(T.slice(inputs, [time_axis], [t], [t + 1]),
                           [time_axis])
            out, new_states = self.cell(xt, states)
            if seq_len is not None:
                valid = T.unsqueeze(T.cast(T.less_than(
                    T.full_like(seq_len, float(t)), seq_len), "float32"),
                    [-1])
                out = out * valid
                states = _tree_map2(lambda n, o: _mask_step(n, o, valid),
                                    new_states, states)
            else:
                states = new_states
            outs[t] = out
        return T.stack(outs, axis=time_axis), states


class BiRNN(Layer):
    """A forward and a reversed ``RNN``, their outputs concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        sf = sb = None
        if initial_states is not None:
            sf, sb = initial_states
        of, fs = self.rnn_fw(inputs, sf, sequence_length)
        ob, bs = self.rnn_bw(inputs, sb, sequence_length)
        return T.concat([of, ob], axis=-1), (fs, bs)


class _RNNBase(Layer):
    """A stack of ``num_layers`` RNNs (BiRNNs when bidirectional), dropout
    between layers in training."""

    CELL = None
    STATE_TUPLE = False

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation=None, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction: {direction}")
        self.bidirectional = direction != "forward"
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.time_major = time_major
        self.dropout = dropout
        kw = dict(weight_ih_attr=weight_ih_attr,
                  weight_hh_attr=weight_hh_attr,
                  bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)
        if activation is not None:
            kw["activation"] = activation
        num_dirs = 2 if self.bidirectional else 1
        layers = []
        for l in range(num_layers):
            in_sz = input_size if l == 0 else hidden_size * num_dirs
            cell_fw = type(self).CELL(in_sz, hidden_size, **kw)
            if self.bidirectional:
                cell_bw = type(self).CELL(in_sz, hidden_size, **kw)
                layers.append(BiRNN(cell_fw, cell_bw, time_major=time_major))
            else:
                layers.append(RNN(cell_fw, time_major=time_major))
        self._stack = LayerList(layers)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        finals = []
        for li, layer in enumerate(self._stack):
            init = (None if initial_states is None
                    else self._layer_init(initial_states, li))
            x, st = layer(x, init, sequence_length)
            finals.append(st)
            if self.dropout and li < self.num_layers - 1:
                x = F.dropout(x, p=self.dropout, training=self.training)
        return x, self._pack_finals(finals)

    def _layer_init(self, initial_states, li):
        """Layer ``li``'s states from (h[, c]) whose leading dim is
        num_layers * num_dirs."""
        nd = 2 if self.bidirectional else 1

        def pick(s, idx):
            return T.squeeze(T.slice(s, [0], [idx], [idx + 1]), [0])

        if type(self).STATE_TUPLE:
            h0, c0 = initial_states
            if nd == 2:
                return ((pick(h0, 2 * li), pick(c0, 2 * li)),
                        (pick(h0, 2 * li + 1), pick(c0, 2 * li + 1)))
            return (pick(h0, li), pick(c0, li))
        if nd == 2:
            return (pick(initial_states, 2 * li),
                    pick(initial_states, 2 * li + 1))
        return pick(initial_states, li)

    def _pack_finals(self, finals):
        """The final states stacked as [num_layers * num_dirs, b, h]."""
        hs, cs = [], []
        for st in finals:
            for d in (st if self.bidirectional else (st,)):
                if type(self).STATE_TUPLE:
                    hs.append(d[0])
                    cs.append(d[1])
                else:
                    hs.append(d)
        h = T.stack(hs, axis=0)
        if type(self).STATE_TUPLE:
            return (h, T.stack(cs, axis=0))
        return h


class SimpleRNN(_RNNBase):
    CELL = SimpleRNNCell
    STATE_TUPLE = False

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation=activation, **kw)


class LSTM(_RNNBase):
    CELL = LSTMCell
    STATE_TUPLE = True


class GRU(_RNNBase):
    CELL = GRUCell
    STATE_TUPLE = False

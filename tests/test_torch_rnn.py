"""The port's recurrent layers against the reference's, on carried
weights, on the CPU.

Each network is built in both packages under fresh unique-name counters
(so parameter names and state-dict keys agree) and the reference's
``state_dict()`` is loaded into the port's.  The same seeded input (and
lengths, and initial states where given) runs forward; the outputs and
the final states agree to 1e-5, and so do the gradients of ``sum(out *
g) + sum(h * gh) [+ sum(c * gc)]`` (g seeded) through ``loss.backward()``
with respect to the input and every parameter.  SimpleRNN, LSTM and GRU
run with one and two layers, forward and bidirectional, with and without
``sequence_length`` (rows shorter than the batch's steps: their outputs
are 0 past their length, their states frozen there).  The cells, ``RNN``
reversed and time-major, and ``BiRNN`` from initial states run the same
way.
"""

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.weights import load_paddle_state_dict

B, T, IN, H = 3, 4, 5, 6
LENS = np.array([4, 2, 3], "int64")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _data(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _run(P, names, build, feed, state=None):
    """(the layer's initial state dict, every output, final state and
    gradient as numpy) of ``build(P)`` on ``feed(P)``, under one fresh
    unique-name generator (the reference's tape tells tensors apart by
    name)."""
    old = names.switch()
    try:
        P.seed(0)
        layer = build(P)
        if state is not None:
            load_paddle_state_dict(layer, state)
        init = {k: v.numpy() for k, v in layer.state_dict().items()}
        args, kwargs = feed(P)
        out, final = layer(*args, **kwargs)
        res = {"out": out.numpy()}
        loss = P.sum(out * P.to_tensor(_data(*out.shape, seed=7)))
        for i, s in enumerate(_leaves(final)):
            res[f"final{i}"] = s.numpy()
            loss = loss + P.sum(s * P.to_tensor(_data(*s.shape, seed=8 + i)))
        loss.backward()
        for i, t in enumerate(_leaves(args)):
            if hasattr(t, "stop_gradient") and not t.stop_gradient:
                res[f"grad:in{i}"] = t.grad.numpy()
        for n, p in layer.named_parameters():
            res[f"grad:{n}"] = p.grad.numpy()
        return init, res
    finally:
        names.switch(old)


def _compare(build, feed):
    state, want = _run(jp, jnames, build, feed)
    _, got = _run(tp, tnames, build, feed, state)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL * max(
            1.0, float(np.abs(w).max())), err_msg=k)
    return want


def _feed(time_major=False, lengths=True, init=None):
    def feed(P):
        shape = (T, B, IN) if time_major else (B, T, IN)
        x = P.to_tensor(_data(*shape), stop_gradient=False)
        kwargs = {}
        if lengths:
            kwargs["sequence_length"] = P.to_tensor(LENS)
        if init is not None:
            kwargs["initial_states"] = init(P)
        return (x,), kwargs

    return feed


NETS = [(kind, layers, direction, lengths)
        for kind in ("SimpleRNN", "LSTM", "GRU")
        for layers in (1, 2)
        for direction in ("forward", "bidirect")
        for lengths in (False, True)]


@pytest.mark.parametrize("kind,layers,direction,lengths", NETS,
                         ids=[f"{k}-{n}-{d}-{'len' if s else 'full'}"
                              for k, n, d, s in NETS])
def test_stacked_rnn_matches_reference(kind, layers, direction, lengths):
    want = _compare(lambda P: getattr(P.nn, kind)(
        IN, H, num_layers=layers, direction=direction),
        _feed(lengths=lengths))
    if lengths:
        # past a row's length its outputs are 0
        out = want["out"]
        for b, n in enumerate(LENS):
            assert not out[b, n:].any()


def test_lstm_from_initial_states_and_time_major_matches_reference():
    def init(P):
        return (P.to_tensor(_data(4, B, H, seed=3), stop_gradient=False),
                P.to_tensor(_data(4, B, H, seed=4), stop_gradient=False))

    _compare(lambda P: P.nn.LSTM(IN, H, num_layers=2, direction="bidirect",
                                 time_major=True),
             _feed(time_major=True, init=init))


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cell_matches_reference(cell):
    def feed(P):
        x = P.to_tensor(_data(B, IN), stop_gradient=False)
        h = P.to_tensor(_data(B, H, seed=1), stop_gradient=False)
        if cell == "LSTMCell":
            c = P.to_tensor(_data(B, H, seed=2), stop_gradient=False)
            return (x, (h, c)), {}
        return (x, h), {}

    _compare(lambda P: getattr(P.nn, cell)(IN, H), feed)


def test_relu_rnn_reversed_matches_reference():
    _compare(lambda P: P.nn.RNN(P.nn.SimpleRNNCell(IN, H,
                                                   activation="relu"),
                                is_reverse=True), _feed())


def test_birnn_of_gru_cells_from_initial_states_matches_reference():
    def init(P):
        return (P.to_tensor(_data(B, H, seed=3)),
                P.to_tensor(_data(B, H, seed=4)))

    _compare(lambda P: P.nn.BiRNN(P.nn.GRUCell(IN, H), P.nn.GRUCell(IN, H)),
             _feed(init=init))


def test_initialisers_are_uniform_over_the_hidden_size():
    tp.seed(0)
    lstm = tp.nn.LSTM(IN, 64, num_layers=2)
    bound = 1 / np.sqrt(64)
    for n, p in lstm.named_parameters():
        v = p.numpy()
        assert np.abs(v).max() <= bound, n
        assert v.std() > 0.8 * bound / np.sqrt(3), n

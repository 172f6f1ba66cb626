"""``nn.BeamSearchDecoder`` + ``nn.dynamic_decode`` through the port
against the reference, on the CPU.

Two cells, each built in both packages with the reference's weights
carried into the port: a ``GRUCell`` with an embedding table and a
``Linear`` head (as ``tests/test_nn_extras.py`` drives the reference),
and a 2-layer ``nn.Transformer`` decoder over ``gen_cache``: its states
are a flat list of tensors (the memory, the source bias, then each
layer's ``Cache`` and ``StaticCache`` keys and values; the reference's
``tile`` cannot rebuild a namedtuple), the cell rebuilds the caches and
takes the position from the self-attention cache's length.  The ids agree
exactly and the best beams' scores to 1e-5; with beam 1 the ids are the
greedy argmax rollout's (the end token repeated once a row has emitted
it).  The data has no exact ties; a separate case holds the port's rule
for them (the lower flat index wins).
"""

import numpy as np
import pytest

import paddle_tpu as jp

import paddle_tpu_torch as tp
import torch_step_parity

TOL = 1e-5
END = 2


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


# -- a GRU cell ---------------------------------------------------------------

VOCAB, HIDDEN = 12, 8


def gru_net(P):
    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = P.nn.Embedding(VOCAB, VOCAB)
            self.cell = P.nn.GRUCell(VOCAB, HIDDEN)
            self.head = P.nn.Linear(HIDDEN, VOCAB)

    return Net()


def _gru_decode(P, net, beam, h0, steps=6):
    dec = P.nn.BeamSearchDecoder(net.cell, start_token=1, end_token=END,
                                 beam_size=beam,
                                 embedding_fn=net.embedding,
                                 output_fn=net.head)
    # beam 1 from a Tensor, wider beams from the numpy array itself
    inits = P.to_tensor(h0) if beam == 1 else h0
    ids, scores = P.nn.dynamic_decode(dec, inits=inits, max_step_num=steps)
    return ids.numpy(), scores.numpy()


def _gru_greedy(P, net, h0, steps):
    tok = np.ones((h0.shape[0],), "int64")
    h = P.to_tensor(h0)
    done = np.zeros(h0.shape[0], bool)
    out = []
    for _ in range(steps):
        o, h = net.cell(net.embedding(P.to_tensor(tok)), h)
        nxt = np.where(done, END, net.head(o).numpy().argmax(-1))
        out.append(nxt)
        done |= nxt == END
        tok = nxt.astype("int64")
    return np.stack(out, 1)


@pytest.mark.parametrize("beam", [1, 3])
def test_gru_beam_search_matches_reference(beam):
    jn, tn = torch_step_parity.pair(gru_net)
    h0 = np.random.RandomState(9).randn(4, HIDDEN).astype("float32")
    jids, jsc = _gru_decode(jp, jn, beam, h0)
    tids, tsc = _gru_decode(tp, tn, beam, h0)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tsc, jsc, rtol=TOL, atol=TOL)
    if beam == 1:
        np.testing.assert_array_equal(
            tids, _gru_greedy(tp, tn, h0, tids.shape[1]))


# -- a 2-layer Transformer decoder ---------------------------------------------

V, D, HEADS, LAYERS, FFN = 64, 32, 4, 2, 64
B, SS = 3, 10


def seq2seq(P):
    """Token embedding times sqrt(d) plus sinusoidal positions, a post-norm
    ``nn.Transformer``, logits by the embedding's transpose."""
    pos = np.arange(64)[:, None] / np.power(10000.0, np.arange(0, D, 2) / D)
    table = np.zeros((64, D), "float32")
    table[:, 0::2], table[:, 1::2] = np.sin(pos), np.cos(pos)

    class Seq2Seq(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = P.nn.Embedding(V, D)
            self.transformer = P.nn.Transformer(
                D, HEADS, LAYERS, LAYERS, FFN, dropout=0.0,
                attn_dropout=0.0, act_dropout=0.0)

        def embed(self, ids, start=0):
            x = self.embedding(ids) * float(np.sqrt(D))
            return x + P.to_tensor(table[start:start + ids.shape[1]])

        def logits(self, h):
            return P.matmul(h, self.embedding.weight, transpose_y=True)

    return Seq2Seq()


def _source():
    r = np.random.RandomState(0)
    src = r.randint(3, V, (B, SS)).astype("int64")
    src[1, 6:] = 0
    src[2, 3:] = 0
    bias = np.where(src == 0, -1e9, 0.0).astype("float32")[:, None, None]
    return src, bias


def transformer_beam_search(P, model, src, bias, beam, steps):
    """Beam search through ``model.transformer.decoder`` with its caches as
    the cell's flat list of states."""
    mha = P.nn.MultiHeadAttention
    m = P.to_tensor(bias)
    memory = model.transformer.encoder(model.embed(P.to_tensor(src)), m)
    caches = model.transformer.decoder.gen_cache(memory)
    n = len(caches)

    def flat(memory, m, caches):
        return [memory, m] + [t for inc, st in caches
                              for t in (inc.k, inc.v, st.k, st.v)]

    def cell(ids, states):
        memory, m = states[0], states[1]
        cache = [(mha.Cache(*states[2 + 4 * i:4 + 4 * i]),
                  mha.StaticCache(*states[4 + 4 * i:6 + 4 * i]))
                 for i in range(n)]
        start = states[2].shape[2] - memory.shape[1]
        h, new = model.transformer.decoder(model.embed(ids, start), memory,
                                           None, m, cache)
        return P.squeeze(h, [1]), flat(memory, m, new)

    dec = P.nn.BeamSearchDecoder(
        cell, start_token=1, end_token=END, beam_size=beam,
        embedding_fn=lambda tok: P.unsqueeze(tok, [-1]),
        output_fn=model.logits)
    ids, scores = P.nn.dynamic_decode(dec, inits=flat(memory, m, caches),
                                      max_step_num=steps)
    return ids.numpy(), scores.numpy()


def _transformer_greedy(P, model, src, bias, steps):
    m = P.to_tensor(bias)
    memory = model.transformer.encoder(model.embed(P.to_tensor(src)), m)
    cache = model.transformer.decoder.gen_cache(memory)
    tok = np.ones((src.shape[0], 1), "int64")
    done = np.zeros(src.shape[0], bool)
    out = []
    for t in range(steps):
        h, cache = model.transformer.decoder(
            model.embed(P.to_tensor(tok), start=t), memory, None, m, cache)
        nxt = np.where(done, END, model.logits(h).numpy()[:, -1].argmax(-1))
        out.append(nxt)
        done |= nxt == END
        tok = nxt[:, None].astype("int64")
    return np.stack(out, 1)


@pytest.mark.parametrize("beam", [1, 4])
def test_transformer_beam_search_matches_reference(beam):
    jm, tm = torch_step_parity.pair(seq2seq)
    jm.eval()
    tm.eval()
    src, bias = _source()
    jids, jsc = transformer_beam_search(jp, jm, src, bias, beam, 8)
    tids, tsc = transformer_beam_search(tp, tm, src, bias, beam, 8)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tsc, jsc, rtol=TOL, atol=TOL)
    if beam == 1:
        with tp.no_grad():
            want = _transformer_greedy(tp, tm, src, bias, tids.shape[1])
        np.testing.assert_array_equal(tids, want)


def test_equal_candidates_take_the_lower_flat_index():
    """Equal logits everywhere: every candidate ties, and the port's beams
    are beam 0's tokens 0..k-1 (then their own token 0 ...)."""

    def cell(inp, states):
        return tp.zeros([inp.shape[0], 5]), states

    dec = tp.nn.BeamSearchDecoder(cell, start_token=1, end_token=4,
                                  beam_size=3)
    ids, scores = tp.nn.dynamic_decode(dec, inits=tp.zeros([2, 1]),
                                       max_step_num=3)
    np.testing.assert_array_equal(ids.numpy(), [[0, 0, 0], [0, 0, 0]])
    np.testing.assert_allclose(scores.numpy(), 3 * np.log(1 / 5.0),
                               rtol=1e-6)


def test_dynamic_decode_needs_initial_states():
    dec = tp.nn.BeamSearchDecoder(tp.nn.GRUCell(2, 2), 1, 2, 2)
    with pytest.raises(ValueError, match="inits"):
        tp.nn.dynamic_decode(dec)

"""The encoder-decoder Transformer through the port against the
reference, on the CPU: a small sequence-to-sequence model (shared
embedding with sinusoidal positions, ``nn.Transformer``, the output tied
to the embedding) built from the API's layers in each package.

Each model is built in both packages under fresh unique-name counters
and the reference's ``state_dict()`` is carried into the port's.  The
source and target rows end in pad tails of their own lengths; the masks
are the source key-padding bias ([B, 1, 1, Ss], on encoder
self-attention and on cross-attention) and ``generate_square_subsequent_
mask`` plus the target padding ([B, 1, St, St], decoder self-attention),
so cross-attention has Sq != Sk.  Compared (fp32): 3 steps of
``build_model_train_step`` (AdamW) from the reference's state at each
step (losses to 1e-5, updates to 2e-3 as ``tests/test_torch_ernie.py``
holds them, the key projections' biases left out: a bias on the keys
adds the same score to a whole row, which the softmax cancels, so its
gradient is rounding and AdamW steps it by ~lr on that noise); and greedy
incremental decoding through ``TransformerDecoder.gen_cache`` (the
growing ``Cache`` of self-attention and the ``StaticCache`` of the
memory), token for token, with each step's logits to 1e-5 relative.  The
port decodes under ``no_grad``, so its ``Cache`` grows in place.
"""

import numpy as np
import pytest

import paddle_tpu as jp

import paddle_tpu_torch as tp
import torch_step_parity

V, D, HEADS, LAYERS, FFN = 64, 32, 4, 2, 64
B, SS, ST, MAXLEN = 3, 12, 9, 32
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _sinusoid(n, d):
    pos = np.arange(n)[:, None] / np.power(10000.0, np.arange(0, d, 2) / d)
    table = np.zeros((n, d), "float32")
    table[:, 0::2], table[:, 1::2] = np.sin(pos), np.cos(pos)
    return table


def seq2seq(P):
    """A Transformer translation model of package ``P``: token embedding
    times sqrt(d) plus sinusoidal positions, ``nn.Transformer`` (post-norm,
    ReLU), logits by the embedding's transpose."""

    class Seq2Seq(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = P.nn.Embedding(V, D)
            self.transformer = P.nn.Transformer(
                D, HEADS, LAYERS, LAYERS, FFN, dropout=0.0,
                attn_dropout=0.0, act_dropout=0.0)
            self._pos = _sinusoid(MAXLEN, D)

        def embed(self, ids, start=0):
            x = self.embedding(ids) * float(np.sqrt(D))
            pos = P.to_tensor(self._pos[start:start + ids.shape[1]])
            return x + P.cast(pos, x.dtype)

        def logits(self, h):
            return P.matmul(h, self.embedding.weight, transpose_y=True)

        def forward(self, src, tgt, src_mask, tgt_mask):
            h = self.transformer(self.embed(src), self.embed(tgt), src_mask,
                                 tgt_mask, src_mask)
            return self.logits(h)

    return Seq2Seq()


def _batch():
    """Source and target ids with pad tails (pad id 0), the decoder's
    input and labels, and the two masks."""
    r = np.random.RandomState(0)
    src = r.randint(3, V, (B, SS)).astype("int64")
    tgt = r.randint(3, V, (B, ST + 1)).astype("int64")
    src_len, tgt_len = [SS, 7, 4], [ST + 1, 6, 3]
    for i in range(B):
        src[i, src_len[i]:] = 0
        tgt[i, tgt_len[i]:] = 0
    tgt[:, 0] = 1                                      # BOS
    src_mask = np.where(src == 0, -1e9, 0.0).astype("float32")[:, None,
                                                              None]
    causal = tp.nn.Transformer.generate_square_subsequent_mask(
        None, ST).numpy()
    pad = np.where(tgt[:, :-1] == 0, -1e9, 0.0).astype("float32")
    tgt_mask = (causal[None, None] + pad[:, None, None]).astype("float32")
    return src, tgt[:, :-1], tgt[:, 1:], src_mask, tgt_mask


def _loss(P):
    def loss(model, src, tgt_in, tgt_out, src_mask, tgt_mask):
        logits = model(src, tgt_in, src_mask, tgt_mask)
        return P.nn.functional.cross_entropy(
            P.reshape(logits, [-1, V]), P.reshape(tgt_out, [-1, 1]))
    return loss


def test_generic_step_matches_reference():
    """3 AdamW steps of ``build_model_train_step`` in fp32, each from the
    reference's state."""
    hist, _ = torch_step_parity.run_both(
        (seq2seq, _loss, _batch()), steps=3, skip=("k_proj.bias",),
        optimizer="adamw", lr=1e-3, weight_decay=0.01, compute_dtype=None)
    for h in hist:
        assert torch_step_parity.loss_rel(h) <= TOL, h
        assert h["update"] <= 2e-3 and h["moments"] <= 2e-3, h
    assert hist[-1]["loss"][0] < hist[0]["loss"][0]


def _greedy(P, model, src, src_mask, steps):
    """Greedy decoding from BOS through the decoder's caches: the tokens
    and each step's logits."""
    m = P.to_tensor(src_mask)
    memory = model.transformer.encoder(model.embed(P.to_tensor(src)), m)
    cache = model.transformer.decoder.gen_cache(memory)
    tok = np.ones((src.shape[0], 1), "int64")
    toks, logits = [], []
    for t in range(steps):
        h, cache = model.transformer.decoder(
            model.embed(P.to_tensor(tok), start=t), memory, None, m, cache)
        out = np.asarray(model.logits(h).numpy())[:, -1]
        tok = out.argmax(-1)[:, None].astype("int64")
        toks.append(tok[:, 0])
        logits.append(out)
    return np.stack(toks, 1), np.stack(logits, 1)


def test_greedy_decode_through_the_caches_matches_reference():
    jm, tm = torch_step_parity.pair(seq2seq)
    jm.eval()
    tm.eval()
    src, _, _, src_mask, _ = _batch()
    jt, jl = _greedy(jp, jm, src, src_mask, 8)
    with tp.no_grad():
        tt, tl = _greedy(tp, tm, src, src_mask, 8)
    np.testing.assert_allclose(tl, jl, rtol=TOL,
                               atol=TOL * np.abs(jl).max())
    np.testing.assert_array_equal(tt, jt)

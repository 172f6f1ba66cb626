"""The port's transformer layers (``nn.MultiHeadAttention`` with its
caches, ``TransformerEncoder{,Layer}``, ``TransformerDecoder{,Layer}``
and ``Transformer``) against the reference's, on carried weights, on the
CPU.

Each case builds its layer in both packages under fresh unique-name
counters, loads the reference's ``state_dict()`` into the port's, runs
the same seeded inputs (and masks) forward and takes the gradient of
``sum(out * g)`` (g seeded) with respect to the inputs and every
parameter.  fp32, 1e-5 relative to each tensor's largest value: the two
sides differ in summation order only (LayerNorm and softmax over a few
dozen elements).
"""

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.weights import load_paddle_state_dict

E, H, FF = 16, 2, 32           # width, heads, feed-forward width
B, S, M = 2, 6, 9              # batch, target length, memory length
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _data(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _float_mask(*shape, seed=0):
    """An additive mask: 0 or -1e4, with every row keeping its first key."""
    keep = np.random.RandomState(seed).rand(*shape) > 0.3
    keep[..., 0] = True
    return np.where(keep, 0.0, -1e4).astype("float32")


def _bool_mask(*shape, seed=0):
    keep = np.random.RandomState(seed).rand(*shape) > 0.3
    keep[..., 0] = True
    return keep


def _mha(P):
    return P.nn.MultiHeadAttention(E, H)


def _mha_cross(P):
    return P.nn.MultiHeadAttention(E, H, kdim=12, vdim=10)


def _enc(P, before):
    return P.nn.TransformerEncoder(P.nn.TransformerEncoderLayer(
        E, H, FF, dropout=0.0, normalize_before=before),
        2, P.nn.LayerNorm(E) if before else None)


def _dec(P, before):
    return P.nn.TransformerDecoder(P.nn.TransformerDecoderLayer(
        E, H, FF, dropout=0.0, activation="gelu",
        normalize_before=before), 2, P.nn.LayerNorm(E) if before else None)


def _transformer(P):
    return P.nn.Transformer(d_model=E, nhead=H, num_encoder_layers=2,
                            num_decoder_layers=2, dim_feedforward=FF,
                            dropout=0.0, normalize_before=True)


def _mha_cache(P, layer, x, mem):
    """Incremental self-attention: the cache of a 3-token prefix, then the
    6 new tokens attend over all 9 keys; the output and the grown cache."""
    cache = layer.gen_cache(mem[:, :3])
    out, cache = layer(x, x, x, None, cache)
    return out + P.sum(cache.k) * 0.01 + P.sum(cache.v) * 0.01


def _mha_static(P, layer, x, mem):
    cache = layer.gen_cache(mem, mem, type=P.nn.MultiHeadAttention.StaticCache)
    return layer(x, mem, mem, None, cache)


def _dec_cache(P, layer, x, mem):
    """The decoder stack with gen_cache's caches: incremental self
    attention over a cache of the memory, static cross attention."""
    out, caches = layer(x, mem, None, None, layer.gen_cache(mem))
    assert len(caches) == 2 and caches[0][0].k.shape == [B, H, M + S, E // H]
    return out


def _square(P, layer):
    return layer.generate_square_subsequent_mask(S)


# name, factory, call(P, layer, x, mem, masks) -> out
CASES = [
    ("mha_self", _mha, lambda P, l, x, m, k: l(x)),
    ("mha_float_mask", _mha,
     lambda P, l, x, m, k: l(x, attn_mask=k["float_bhss"])),
    ("mha_bool_mask", _mha, lambda P, l, x, m, k: l(x, x, x, k["bool_ss"])),
    ("mha_cross_kdim", _mha_cross,
     lambda P, l, x, m, k: l(x, k["mem12"], k["mem10"], k["cross_b1sm"])),
    ("mha_cache", _mha, lambda P, l, x, m, k: _mha_cache(P, l, x, m)),
    ("mha_static_cache", _mha,
     lambda P, l, x, m, k: _mha_static(P, l, x, m)),
    ("encoder_post_ln", lambda P: _enc(P, False),
     lambda P, l, x, m, k: l(x, k["pad_b11s"])),
    ("encoder_pre_ln", lambda P: _enc(P, True),
     lambda P, l, x, m, k: l(x, k["bool_ss"])),
    ("encoder_cache", lambda P: _enc(P, False),
     lambda P, l, x, m, k: l(x, None, l.gen_cache(m))[0]),
    ("decoder_post_ln", lambda P: _dec(P, False),
     lambda P, l, x, m, k: l(x, m, k["square"], k["cross_b1sm"])),
    ("decoder_pre_ln", lambda P: _dec(P, True),
     lambda P, l, x, m, k: l(x, m, k["square"])),
    ("decoder_cache", lambda P: _dec(P, False),
     lambda P, l, x, m, k: _dec_cache(P, l, x, m)),
    ("transformer", _transformer,
     lambda P, l, x, m, k: l(m, x, None, k["square"], None)),
    ("transformer_masks", _transformer,
     lambda P, l, x, m, k: l(m, x, k["mem_pad"], k["square"],
                             k["cross_b1sm"])),
]


def _masks(P, layer):
    t = P.to_tensor
    return {"float_bhss": t(_float_mask(B, H, S, S, seed=3)),
            "bool_ss": t(_bool_mask(S, S, seed=4)),
            "pad_b11s": t(_float_mask(B, 1, 1, S, seed=5)),
            "cross_b1sm": t(_float_mask(B, 1, S, M, seed=6)),
            "mem_pad": t(_float_mask(B, 1, 1, M, seed=7)),
            "mem12": t(_data(B, M, 12, seed=8), stop_gradient=False),
            "mem10": t(_data(B, M, 10, seed=9), stop_gradient=False),
            "square": (layer.generate_square_subsequent_mask(S)
                       if hasattr(layer, "generate_square_subsequent_mask")
                       else t(np.triu(np.full((S, S), -np.inf, "float32"),
                                      k=1)))}


def _run(P, names, factory, call, state=None):
    old = names.switch()
    try:
        P.seed(0)
        layer = factory(P)
        if state is not None:
            load_paddle_state_dict(layer, state)
        init = {k: v.numpy() for k, v in layer.state_dict().items()}
        x = P.to_tensor(_data(B, S, E, seed=1), stop_gradient=False)
        mem = P.to_tensor(_data(B, M, E, seed=2), stop_gradient=False)
        masks = _masks(P, layer)
        out = call(P, layer, x, mem, masks)
        g = P.to_tensor(_data(*out.shape, seed=10))
        P.sum(out * g).backward()
        res = {"out": out.numpy()}
        for name, t in [("x", x), ("mem", mem), ("mem12", masks["mem12"]),
                        ("mem10", masks["mem10"])]:
            res[f"grad:{name}"] = None if t.grad is None else t.grad.numpy()
        for n, p in layer.named_parameters():
            res[f"grad:{n}"] = None if p.grad is None else p.grad.numpy()
        return init, res
    finally:
        names.switch(old)


@pytest.mark.parametrize("name,factory,call", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_reference(name, factory, call):
    state, want = _run(jp, jnames, factory, call)
    _, got = _run(tp, tnames, factory, call, state)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL * max(
            1.0, float(np.abs(w).max())), err_msg=f"{name} {k}")


def test_names_and_state_dict_match_reference():
    """Parameter names (the deep copies of the stacked layers keep their
    original's, as the reference's do) and state_dict keys."""
    def build(P, names):
        with names.guard():
            return _transformer(P)

    jm, tm = build(jp, jnames), build(tp, tnames)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [p.name for p in tm.parameters()] == [p.name for p in
                                                 jm.parameters()]
    mask = tm.generate_square_subsequent_mask(4).numpy()
    np.testing.assert_array_equal(
        mask, jm.generate_square_subsequent_mask(4).numpy())

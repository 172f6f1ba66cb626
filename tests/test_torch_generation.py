"""The port's GPT decoder against the JAX reference, on the same weights.

The reference model is built from a seed, its parameter tree lifted into
the port through numpy (``paddle_tpu_torch.weights``), and both decoders
run on the same numpy inputs in fp32: one block's forward, the whole
dense decoder's logits (rtol = atol = 1e-5: only summation orders differ)
and greedy tokens (exact) for MHA, GQA and a sliding window.  Sampling
draws from different generators in the two packages, so it is held to
determinism and to the reference's top-k / top-p masks instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTForPretraining as JModel
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.gpt import GPTConfig, GPTParams, gpt_tiny
from paddle_tpu_torch.weights import load_jax_params, params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=96)
TINY = dict(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
            max_seq_len=256)


def _pair(seed=3, **cfg):
    """(reference model, port model with the reference's weights, the
    reference's parameter tree as numpy)."""
    paddle.seed(seed)
    jm = JModel(JConfig(dropout=0.0, **cfg))
    jm.eval()
    tree = jax.tree_util.tree_map(np.asarray, jgen._decoder_setup(jm)[0])
    tm = GPTParams(GPTConfig(**cfg), device="cpu")
    load_jax_params(tm, tree)
    return jm, tm, tree


def test_weight_bridge_round_trips_the_reference_tree():
    _, tm, tree = _pair(**CFG, num_kv_heads=2)
    back = tgen._decoder_setup(tm)[0]
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == 4 + 12 * CFG["num_layers"]
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), leaf)
    # the port keeps the reference's [in, out] layout
    assert tuple(tm.blocks[0].qkv_w.shape) == (64, (4 + 2 * 2) * 16)
    with pytest.raises(ValueError):
        params_from_jax({**tree, "blocks": [{"qkv_wq": 0}]})


def test_tiny_preset_matches_reference_widths():
    assert {k: getattr(gpt_tiny(), k) for k in TINY} == TINY


@pytest.mark.parametrize("over", [{}, {"num_kv_heads": 2},
                                  {"num_kv_heads": 2, "attn_window": 5}],
                         ids=["mha", "gqa", "gqa_window"])
def test_block_fwd_matches_reference(over):
    """One block, prefill (T=7 at pos 0) then a decode step (T=1 at pos 7)
    into the same dense cache: outputs and caches agree."""
    _, _, tree = _pair(**CFG, **over)
    jb = jax.tree_util.tree_map(jnp.asarray, tree["blocks"][1])
    tb = {k: torch.tensor(v) for k, v in tree["blocks"][1].items()}
    rng = np.random.RandomState(0)
    nkv, hd = over.get("num_kv_heads", 4), 16
    kc = np.zeros((2, nkv, 12, hd), np.float32)
    jk, jv = jnp.asarray(kc), jnp.asarray(kc)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(kc.copy())
    for pos, t in ((0, 7), (7, 1)):
        x = rng.randn(2, t, 64).astype(np.float32)
        jy, jk, jv = jgen._block_fwd(jb, jnp.asarray(x), jk, jv, pos, 4,
                                     1e-5, n_kv_heads=nkv,
                                     window=over.get("attn_window"))
        ty, tk, tv = tgen._block_fwd(tb, torch.from_numpy(x), tk, tv, pos,
                                     4, 1e-5, n_kv_heads=nkv,
                                     window=over.get("attn_window"))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_dense_decoder_logits_match_reference_on_tiny():
    """The whole gpt_tiny-sized dense decoder: prefill logits, then a
    decode step's logits, fp32."""
    jm, tm, _ = _pair(**TINY)
    jp, jmake = jgen._decoder_setup(jm)[:2]
    tp, tmake = tgen._decoder_setup(tm)
    cfg = tm.cfg
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 1024, (2, 9)).astype(np.int32)
    jkc, jvc = jgen._empty_cache(jm.cfg, 2, 12, jnp.float32)
    tkc, tvc = tgen._empty_cache(cfg, 2, 12, torch.float32, "cpu")
    jl, jkc, jvc = jmake(jp)(jnp.asarray(ids), 0, jkc, jvc)
    tl, tkc, tvc = tmake(tp)(torch.from_numpy(ids).long(), 0, tkc, tvc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = ids[:, -1:]
    jl, _, _ = jmake(jp)(jnp.asarray(nxt), 9, jkc, jvc)
    tl, _, _ = tmake(tp)(torch.from_numpy(nxt).long(), 9, tkc, tvc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("over", [{}, {"num_kv_heads": 2},
                                  {"num_kv_heads": 2, "attn_window": 8}],
                         ids=["mha", "gqa", "gqa_window"])
def test_greedy_tokens_match_reference(over):
    jm, tm, _ = _pair(seed=5, **CFG, **over)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 512, (2, 11)).astype(np.int32)
    ref = np.asarray(jgen.build_generate_fn(jm, 16, greedy=True)(ids))
    out = tgen.generate(tm, ids, 16).numpy()
    np.testing.assert_array_equal(out, ref)


def test_eos_masks_finished_rows():
    _, tm, _ = _pair(**CFG)
    ids = np.random.RandomState(4).randint(0, 512, (2, 6)).astype(np.int32)
    free = tgen.generate(tm, ids, 10).numpy()[:, 6:]
    eos = int(free[0, 2])
    out = tgen.generate(tm, ids, 10, eos_token_id=eos).numpy()[0, 6:]
    hit = int(np.argmax(free[0] == eos))
    np.testing.assert_array_equal(out[:hit + 1], free[0, :hit + 1])
    assert (out[hit:] == eos).all()


def test_sampling_is_deterministic_per_seed():
    _, tm, _ = _pair(**CFG)
    ids = np.random.RandomState(3).randint(0, 512, (3, 5)).astype(np.int32)
    kw = dict(greedy=False, temperature=0.9, top_k=40, top_p=0.95)
    a = tgen.generate(tm, ids, 12, seed=7, **kw)
    b = tgen.generate(tm, ids, 12, seed=7, **kw)
    c = tgen.generate(tm, ids, 12, seed=8, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("top_p", [0.3, 0.8, 0.95])
def test_top_p_mask_matches_reference(top_p):
    logits = np.random.RandomState(6).randn(4, 50).astype(np.float32) * 2
    ref = np.asarray(jgen._top_p_mask(jnp.asarray(logits), top_p))
    out = tgen._top_p_mask(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(out, ref)


def test_sampler_top_k_and_top_p_restrict_the_draw():
    """top-k keeps the k largest logits, top-p the nucleus the reference's
    mask keeps; no draw ever leaves them."""
    logits = torch.from_numpy(
        np.random.RandomState(9).randn(6, 64).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    topk = tgen._make_sampler(False, 1.0, 3)
    allowed = torch.topk(logits, 3, dim=-1).indices
    nucleus = tgen._make_sampler(False, 1.0, 0, 0.5)
    keep = np.asarray(jgen._top_p_mask(jnp.asarray(logits.numpy()), 0.5)) \
        > -1e29
    for _ in range(50):
        draw = topk(logits, gen)
        assert (allowed == draw[:, None]).any(dim=1).all()
        draw = nucleus(logits, gen).numpy()
        assert keep[np.arange(6), draw].all()
    assert torch.equal(tgen._make_sampler(False, 1.0, 1)(logits, gen),
                       logits.argmax(-1))

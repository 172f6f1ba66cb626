"""W8A8 projections and int8 / int4 KV caches in the port, against the JAX
reference on the same weights (fp32 on the CPU):

* the int8 weight tree: the port's ``_block_params(int8=True)`` quantizes
  the float weights exactly as the reference's ``_decoder_setup(model,
  int8=True)`` does, bit for bit (the port stores each weight transposed);
* the dense decoder with ``int8`` and ``kv_bits`` 8 / 4: logits at
  rtol = atol = 1e-5 (only summation orders differ) and greedy tokens
  identical;
* the page pool's int8 / int4 layouts and bytes per token;
* the engine: port ServingEngine == port dense decoder == JAX
  ServingEngine, token for token, for ``int8``, ``kv_bits=4`` and int8 KV
  alone, through chunked prefill, ``decode_block``, GQA with a window,
  preemption under a small pool and a copy-on-write prefix tail, with
  ``check_invariants()`` after every step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import generation as jgen
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.serving import KVPool, ServingEngine
from torch_parity import (assert_all_equal, dense, drain, pair, prompts_of,
                          serve_both)

TOL = dict(rtol=1e-5, atol=1e-5)
DEC = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=96)
MODES = [(True, None), (True, 4), (False, 8), (False, 4)]
MODE_IDS = ["w8a8_kv8", "w8a8_kv4", "kv8", "kv4"]


def test_int8_block_params_match_the_reference_tree():
    jm, tm = pair(num_heads=4, num_kv_heads=2)
    ref = jax.tree_util.tree_map(np.asarray,
                                 jgen._decoder_setup(jm, int8=True)[0])
    got = tgen._decoder_setup(tm, int8=True)[0]
    for key in ("wte", "wpe", "lnf_g", "lnf_b"):
        np.testing.assert_array_equal(got[key].detach().numpy(), ref[key])
    for jb, tb in zip(ref["blocks"], got["blocks"]):
        assert set(jb) == set(tb)
        for key, val in jb.items():
            mine = tb[key].detach().numpy()
            if key.endswith("_wq"):
                assert mine.dtype == np.int8
                mine = mine.T                    # the port stores (N, K)
                assert tb[key].is_contiguous()
            assert mine.dtype == val.dtype
            np.testing.assert_array_equal(mine, val)
    assert not any(k.endswith("_w") for k in got["blocks"][0])


@pytest.mark.parametrize("over", [{}, {"num_kv_heads": 2, "attn_window": 8}],
                         ids=["mha", "gqa_window"])
@pytest.mark.parametrize("int8,kv_bits", MODES, ids=MODE_IDS)
def test_quantized_dense_decoder_matches_reference(int8, kv_bits, over):
    """Prefill logits, one decode step's logits and 16 greedy tokens."""
    jm, tm = pair(seed=5, **DEC, **over)
    jp, jmake, _ = jgen._decoder_setup(jm, int8=int8)
    tp, tmake = tgen._decoder_setup(tm, int8=int8)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 512, (2, 9)).astype(np.int32)
    jkc, jvc = jgen._empty_cache(jm.cfg, 2, 12, jnp.float32, int8=int8,
                                 kv_bits=kv_bits)
    tkc, tvc = tgen._empty_cache(tm.cfg, 2, 12, torch.float32, "cpu",
                                 int8=int8, kv_bits=kv_bits)
    assert isinstance(tkc, tuple)
    assert tkc[0].shape[-1] == (8 if kv_bits == 4 else 16)
    for toks, pos in ((ids, 0), (ids[:, -1:], 9)):
        jl, jkc, jvc = jmake(jp)(jnp.asarray(toks), pos, jkc, jvc)
        tl, tkc, tvc = tmake(tp)(torch.from_numpy(toks).long(), pos, tkc,
                                 tvc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    ids = rng.randint(0, 512, (2, 11)).astype(np.int32)
    ref = jgen.build_generate_fn(jm, 16, greedy=True, int8=int8,
                                 kv_bits=kv_bits)(ids)
    out = tgen.generate(tm, ids, 16, int8=int8, kv_bits=kv_bits)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_kv_bits_resolution_and_validation():
    cfg = GPTConfig(**DEC)
    assert tgen._resolve_kv_bits(cfg, False) is None
    assert tgen._resolve_kv_bits(cfg, True) == 8          # int8 implies it
    assert tgen._resolve_kv_bits(cfg, True, 4) == 4       # override wins
    assert tgen._resolve_kv_bits(GPTConfig(**DEC, kv_bits=4), True) == 4
    with pytest.raises(ValueError):
        tgen._resolve_kv_bits(cfg, False, 3)
    with pytest.raises(ValueError):
        GPTConfig(**DEC, kv_bits=2)


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def test_kv_pool_int4_gqa_layout_and_bytes():
    pool = KVPool(2, 4, 16, 8, 8, num_kv_heads=2, kv_bits=4, device="cpu")
    assert tuple(pool.buffers["k"].shape) == (2, 8, 2, 8, 8)   # D // 2
    assert pool.buffers["k"].dtype == torch.int8
    assert tuple(pool.buffers["ks"].shape) == (2, 8, 2, 8, 1)
    assert pool.buffers["vs"].dtype == torch.float32
    # per layer, per side: 2 kv heads x (8 packed bytes + 4 scale bytes)
    assert pool.bytes_per_token() == 2 * 2 * (2 * 8 + 2 * 4) == 96
    assert (KVPool(2, 4, 16, 8, 8, device="cpu").bytes_per_token()
            == 2 * 2 * 4 * 16 * 4)
    int8 = KVPool(2, 4, 16, 8, 8, kv_bits=8, device="cpu")
    assert int8.buffers["v"].shape[-1] == 16
    assert int8.bytes_per_token() == 2 * 4 * (2 * 16 + 2 * 4)
    # GPT-1.3B (24 layers, 16 heads, D = 128): bf16, int8, int4 pages
    full = dict(num_pages=2, page_size=32, device="cpu")
    assert KVPool(24, 16, 128, dtype=torch.bfloat16,
                  **full).bytes_per_token() == 196608
    assert KVPool(24, 16, 128, kv_bits=8, **full).bytes_per_token() == 101376
    assert KVPool(24, 16, 128, kv_bits=4, **full).bytes_per_token() == 52224


def test_kv_pool_ctor_validation():
    with pytest.raises(ValueError):
        KVPool(1, 4, 16, 8, 8, kv_bits=3, device="cpu")
    with pytest.raises(ValueError):
        KVPool(1, 4, 15, 8, 8, kv_bits=4, device="cpu")      # odd head_dim
    with pytest.raises(ValueError):
        KVPool(1, 4, 16, 8, 8, num_kv_heads=3, device="cpu")  # 4 % 3 != 0


# ---------------------------------------------------------------------------
# the engine: port engine == port dense decoder == JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("over,kw", [
    ({}, {"int8": True}),
    ({}, {"int8": True, "chunk_tokens": 8}),
    ({}, {"int8": True, "kv_bits": 4}),
    ({}, {"kv_bits": 8, "decode_block": 4}),
    ({"num_heads": 4, "num_kv_heads": 2, "attn_window": 16},
     {"kv_bits": 4, "chunk_tokens": 8}),
    ({"num_heads": 4, "num_kv_heads": 2, "attn_window": 16},
     {"int8": True}),
], ids=["w8a8", "w8a8_chunked8", "w8a8_kv4", "kv8_decode_block4",
        "gqa_window_kv4_chunked8", "gqa_window_w8a8"])
def test_engine_quantized_matches_dense_and_reference(over, kw):
    jm, tm = pair(**over)
    prompts = prompts_of(np.random.RandomState(3), (5, 11, 23, 7))
    port, ref, eng, _ = serve_both(jm, tm, prompts, 20, **kw)
    modes = {k: kw[k] for k in ("int8", "kv_bits") if k in kw}
    assert_all_equal(port, dense(tm, prompts, 20, **modes), ref)
    assert eng.kv_bits == kw.get("kv_bits", 8)
    assert eng.int8 == kw.get("int8", False)
    if eng.int8:
        assert eng.params["blocks"][0]["fc2_wq"].dtype == torch.int8


@pytest.mark.parametrize("kw", [{"int8": True}, {"int8": True, "kv_bits": 4}],
                         ids=["w8a8_kv8", "w8a8_kv4"])
def test_engine_quantized_preemption_under_a_small_pool(kw):
    """Six usable pages cannot hold both residents' growth: the younger is
    preempted and recomputed, and every token stays exact."""
    jm, tm = pair()
    rng = np.random.RandomState(51)
    A, B = prompts_of(rng, (8, 16))
    port, ref, eng, jeng = serve_both(jm, tm, [A, B], [24, 16], num_pages=7,
                                      chunk_tokens=16, **kw)
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["recompute_tokens"] > 0
    assert eng.stats["preemptions"] == jeng.stats["preemptions"]
    assert_all_equal(port, dense(tm, [A, B], [24, 16], **kw), ref)


@pytest.mark.parametrize("kv_bits", [8, 4], ids=["kv8", "kv4"])
def test_engine_quantized_prefix_cow(kv_bits):
    """Prefix-cache hits and a copy-on-write tail on quantized pages: the
    clone copies the values and their scales, so B decodes exactly."""
    jm, tm = pair(seed=2, num_heads=4, num_kv_heads=2)
    rng = np.random.RandomState(9)
    A = rng.randint(0, 512, (20,)).astype(np.int32)
    B = np.concatenate([A[:12], rng.randint(0, 512, (6,)).astype(np.int32)])
    eng = ServingEngine(tm, device="cpu", max_slots=2, page_size=8,
                        kv_bits=kv_bits)
    jeng = JEngine(jm, max_slots=2, page_size=8, kv_bits=kv_bits,
                   use_paged_kernel=False)
    for p in (A, B):
        rid, jrid = eng.add_request(p, 10), jeng.add_request(p, 10)
        tok = drain(eng)[rid].tokens
        assert_all_equal([tok], dense(tm, [p], 10, kv_bits=kv_bits),
                         [jeng.run()[jrid].tokens])
    assert eng.stats["prefix_hit_tokens"] == 12          # 8 + 4 via COW
    assert eng.stats["prefix_hit_tokens"] == jeng.stats["prefix_hit_tokens"]


def test_engine_int4_window_recycles_pages():
    """GQA + a 16-token window + int4 pages over a 40-token generation:
    the live pages stay a bounded ring and the tokens stay exact."""
    jm, tm = pair(seed=6, num_heads=4, num_kv_heads=2, attn_window=16)
    prompts = prompts_of(np.random.RandomState(11), (5, 13))
    seen = {"live": 0, "hw": 0}

    def trace(eng):
        for st in eng._slots:
            if st is not None:
                seen["live"] = max(seen["live"], len(st.pages))
                seen["hw"] = max(seen["hw"], st.hw_pages)

    port, ref, eng, _ = serve_both(jm, tm, prompts, 40, trace=trace,
                                   prefix_cache=False, kv_bits=4)
    assert_all_equal(port, dense(tm, prompts, 40, kv_bits=4), ref)
    assert seen["live"] <= eng.pool.pages_for(16 + 1) + 1 < seen["hw"]

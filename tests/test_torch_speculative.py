"""Speculative decoding in the port, against the JAX reference:

* the n-gram drafter and the greedy acceptance rule (unit tests mirroring
  ``tests/test_speculative.py``);
* ``paged_attention_mq_plain`` against ``paged_attention_mq_ref`` and the
  reference's interpreted Pallas kernel at rtol = atol = 1e-5, over
  group {1, 2} x window x float / int8 / int4 pages x q_tile {1, 3, 5};
  each row equals the decode version at its own position, and q_tile 1
  is the decode version with ``lengths + 1``;
* the engine: port speculative engine == port dense decoder == JAX
  speculative engine, token for token, for spec_k {2, 4} over float, int8
  and int4 pages, GQA with a window, preemption, a copy-on-write prefix
  tail and injected always-right / always-wrong drafters, with
  ``check_invariants()`` after every step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.ops import quant_ops as jq
from paddle_tpu_torch.kernels import (paged_attention_mq,
                                      paged_attention_mq_plain,
                                      paged_attention_plain)
from paddle_tpu_torch.models.generation import spec_accept_greedy
from paddle_tpu_torch.serving import (FCFSScheduler, KVPool, NGramDrafter,
                                      ServingEngine)
from torch_parity import (assert_all_equal, dense, drain,  # noqa: F401
                          interpretable, pair, prompts_of, serve_both)

TOL = dict(rtol=1e-5, atol=1e-5)

def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the drafter and the acceptance rule
# ---------------------------------------------------------------------------


def test_drafter_prompt_lookup_basics():
    d = NGramDrafter(4, max_ngram=3)
    # trailing [2,3,4] occurred earlier; continuation after the match
    np.testing.assert_array_equal(
        d.draft([1, 2, 3, 4, 9, 2, 3, 4]), [9, 2, 3, 4])
    # no earlier occurrence at any n: nothing proposed
    assert d.draft([1, 2, 3, 4, 5, 6]).size == 0
    assert d.draft([]).size == 0
    assert d.draft([7]).size == 0


def test_drafter_longest_ngram_and_recency_win():
    d = NGramDrafter(2, max_ngram=3)
    np.testing.assert_array_equal(
        d.draft([5, 6, 7, 8, 0, 7, 1, 5, 6, 7]), [8, 0])
    d1 = NGramDrafter(1, max_ngram=1)
    np.testing.assert_array_equal(d1.draft([4, 1, 4, 2, 4]), [2])


def test_drafter_max_tokens_caps_proposal():
    d = NGramDrafter(4, max_ngram=2)
    np.testing.assert_array_equal(d.draft([1, 2, 3, 4, 1, 2], max_tokens=2),
                                  [3, 4])
    assert d.draft([1, 2, 3, 1, 2], max_tokens=0).size == 0


def test_drafter_validation_and_reference_agreement():
    with pytest.raises(ValueError):
        NGramDrafter(0)
    with pytest.raises(ValueError):
        NGramDrafter(2, max_ngram=1, min_ngram=2)
    from paddle_tpu.serving import NGramDrafter as JDrafter

    rng = np.random.RandomState(0)
    for _ in range(200):
        h = rng.randint(0, 6, (int(rng.randint(0, 30)),))
        k, n = int(rng.randint(1, 5)), int(rng.randint(1, 4))
        cap = int(rng.randint(0, 6))
        np.testing.assert_array_equal(NGramDrafter(k, n).draft(h, cap),
                                      JDrafter(k, n).draft(h, cap))


def test_spec_accept_greedy_rule():
    assert spec_accept_greedy(np.asarray([5, 6, 7]), [5, 6]) == (2, [5, 6, 7])
    assert spec_accept_greedy(np.asarray([5, 9, 7]), [5, 6]) == (1, [5, 9])
    assert spec_accept_greedy(np.asarray([4, 6, 7]), [5, 6]) == (0, [4])
    assert spec_accept_greedy(np.asarray([3]), []) == (0, [3])


def test_prefill_budget_reserves_the_verify_width():
    pool = KVPool(1, 1, 8, num_pages=20, page_size=4, device="cpu")
    sched = FCFSScheduler(n_slots=8, pool=pool, token_budget=32)
    assert sched.prefill_budget(4, chunk_tokens=64) == 28
    assert sched.prefill_budget(4, chunk_tokens=64, decode_cost=5) == 12
    assert sched.prefill_budget(8, chunk_tokens=64, decode_cost=5) == 1


# ---------------------------------------------------------------------------
# the multi-query verify attention
# ---------------------------------------------------------------------------


def _mq_inputs(rng, B, T, H, HKV, D, PS, MAXP, P, bits):
    q = rng.randn(B, T, H, D).astype(np.float32)
    kf = rng.randn(P, HKV, PS, D).astype(np.float32)
    vf = rng.randn(P, HKV, PS, D).astype(np.float32)
    bt = rng.randint(1, P, (B, MAXP)).astype(np.int32)
    if bits is None:
        return q, kf, vf, bt, {}
    quant = jq.quantize_int4_per_token if bits == 4 else jq.quantize_per_token
    (kq, ks), (vq, vs) = quant(jnp.asarray(kf)), quant(jnp.asarray(vf))
    return (q, np.asarray(kq), np.asarray(vq), bt,
            dict(k_scales=np.asarray(ks), v_scales=np.asarray(vs)))


@pytest.mark.parametrize("q_tile", [1, 3, 5])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp", "int8", "int4"])
@pytest.mark.parametrize("window", [None, 7], ids=["full", "win"])
@pytest.mark.parametrize("group", [1, 2], ids=["mha", "gqa2"])
def test_mq_plain_matches_reference(group, window, bits, q_tile,
                                    interpretable):
    rng = np.random.RandomState(31 * group + (bits or 1) + q_tile)
    HKV, D, PS, MAXP, P = 2, 16, 8, 3, 8
    q, kp, vp, bt, sc = _mq_inputs(rng, 2, q_tile, HKV * group, HKV, D, PS,
                                   MAXP, P, bits)
    lens = np.array([5, 13], np.int32)
    out = paged_attention_mq(_t(q), _t(kp), _t(vp), _t(bt), _t(lens),
                             window=window,
                             **{k: _t(v) for k, v in sc.items()}).numpy()
    j = [jnp.asarray(a) for a in (q, kp, vp, bt, lens)]
    jkw = dict({k: jnp.asarray(v) for k, v in sc.items()}, window=window)
    ref = np.asarray(jpa.paged_attention_mq_ref(*j, **jkw))
    kern = np.asarray(jpa.paged_attention_mq(*j, interpret=True, **jkw))
    assert out.shape == (2, q_tile, HKV * group, D)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, kern, **TOL)


@pytest.mark.parametrize("bits", [None, 4], ids=["fp", "int4"])
def test_mq_rows_match_decode_at_their_positions(bits):
    """Row t of one verify call is the decode version at length
    ``lengths + t + 1``; T == 1 is exactly the decode version at
    ``lengths + 1``."""
    rng = np.random.RandomState(3)
    q, kp, vp, bt, sc = _mq_inputs(rng, 3, 4, 4, 2, 16, 8, 4, 10, bits)
    lens = _t(np.array([0, 9, 27], np.int32))
    sc = {k: _t(v) for k, v in sc.items()}
    args = (_t(kp), _t(vp), _t(bt))
    out = paged_attention_mq(_t(q), *args, lens, **sc)
    for t in range(4):
        row = paged_attention_plain(_t(q)[:, t], *args, lens + t + 1, **sc)
        torch.testing.assert_close(out[:, t], row, **TOL)
    one = paged_attention_mq_plain(_t(q)[:, :1], *args, lens, **sc)
    assert torch.equal(one[:, 0],
                       paged_attention_plain(_t(q)[:, 0], *args, lens + 1,
                                             **sc))


# ---------------------------------------------------------------------------
# the engine: port spec engine == port dense decoder == JAX spec engine
# ---------------------------------------------------------------------------


def _motif_prompts(rng, n, lens):
    """Prompts that repeat a short motif, so that the drafter finds
    n-grams to propose from the start."""
    return [np.tile(rng.randint(0, 512, (5,)), 8)[:k].astype(np.int32)
            for k in lens[:n]]


class OracleDrafter:
    """Always-right drafter: proposes the true continuation, so every
    draft is accepted."""

    def __init__(self, spec_k, continuations):
        self.spec_k = spec_k
        self._conts = continuations          # [(prompt list, tokens list)]

    def draft(self, history, max_tokens=None):
        k = self.spec_k if max_tokens is None else min(self.spec_k,
                                                       int(max_tokens))
        h = [int(t) for t in history]
        for prompt, toks in self._conts:
            done = h[len(prompt):]
            if h[:len(prompt)] == prompt and done == toks[:len(done)]:
                return np.asarray(toks[len(done):len(done) + k], np.int32)
        return np.zeros((0,), np.int32)


class AdversarialDrafter:
    """Always-wrong drafter: proposes a token greedy decoding does not
    pick here, so every draft is rejected."""

    def __init__(self, spec_k):
        self.spec_k = spec_k

    def draft(self, history, max_tokens=None):
        k = self.spec_k if max_tokens is None else min(self.spec_k,
                                                       int(max_tokens))
        return np.full((max(k, 0),), 511, np.int32)


@pytest.mark.parametrize("spec_k,kw", [
    (2, {}), (4, {}), (2, {"int8": True}), (4, {"int8": True}),
    (2, {"kv_bits": 4}), (4, {"int8": True, "kv_bits": 4}),
], ids=["fp_k2", "fp_k4", "w8a8_k2", "w8a8_k4", "kv4_k2", "w8a8_kv4_k4"])
def test_engine_spec_matches_dense_and_reference(spec_k, kw):
    """Speculative greedy == plain greedy, token for token, with nonzero
    acceptance; the port's spec counters equal the reference engine's."""
    jm, tm = pair()
    rng = np.random.RandomState(0)
    prompts = (_motif_prompts(rng, 2, (15, 12))
               + prompts_of(rng, (8, 16)))
    news = [16, 12, 16, 10]
    port, ref, eng, jeng = serve_both(jm, tm, prompts, news, spec_k=spec_k,
                                      **kw)
    assert_all_equal(port, dense(tm, prompts, news, **kw), ref)
    s = eng.stats
    assert s["spec_accepted"] > 0
    assert s["spec_drafted"] == s["spec_accepted"] + s["spec_rejected"]
    for key in ("spec_drafted", "spec_accepted", "spec_rejected",
                "decode_calls"):
        assert s[key] == jeng.stats[key], key


@pytest.mark.parametrize("kv_bits", [None, 4], ids=["fp", "kv4"])
def test_engine_spec_gqa_window(kv_bits):
    """Verify over GQA + a window, long enough that pages recycle."""
    jm, tm = pair(seed=1, num_heads=4, num_kv_heads=2, attn_window=20)
    rng = np.random.RandomState(4)
    prompts = _motif_prompts(rng, 3, (15, 15, 9))
    port, ref, eng, _ = serve_both(jm, tm, prompts, 30, spec_k=2,
                                   kv_bits=kv_bits, prefix_cache=False)
    assert_all_equal(port, dense(tm, prompts, 30, kv_bits=kv_bits), ref)
    assert eng.stats["spec_drafted"] > 0


@pytest.mark.parametrize("kw", [{}, {"int8": True, "kv_bits": 4}],
                         ids=["fp", "w8a8_kv4"])
def test_engine_spec_preemption_under_a_small_pool(kw):
    jm, tm = pair()
    rng = np.random.RandomState(51)
    A, B = prompts_of(rng, (8, 16))
    port, ref, eng, jeng = serve_both(jm, tm, [A, B], [24, 16], num_pages=7,
                                      chunk_tokens=16, spec_k=2, **kw)
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["preemptions"] == jeng.stats["preemptions"]
    assert_all_equal(port, dense(tm, [A, B], [24, 16], **kw), ref)


def test_engine_spec_prefix_cow_int8_pages():
    jm, tm = pair(seed=2)
    rng = np.random.RandomState(9)
    A = np.tile(rng.randint(0, 512, (4,)), 5).astype(np.int32)
    B = np.concatenate([A[:12], rng.randint(0, 512, (6,)).astype(np.int32)])
    eng = ServingEngine(tm, device="cpu", max_slots=2, page_size=8,
                        kv_bits=8, spec_k=4)
    for p in (A, B):
        rid = eng.add_request(p, 12)
        assert_all_equal([drain(eng)[rid].tokens],
                         dense(tm, [p], 12, kv_bits=8))
    assert eng.stats["prefix_hit_tokens"] == 12
    assert eng.stats["spec_accepted"] > 0


def test_engine_spec_oracle_and_adversarial_drafters():
    """An always-right drafter accepts every draft and needs few verify
    steps; an always-wrong one rejects every draft; the output is exact
    either way, and never runs past max_new_tokens."""
    _, tm = pair()
    rng = np.random.RandomState(21)
    prompts = prompts_of(rng, (8, 12))
    news = [12, 7]
    refs = dense(tm, prompts, news)
    conts = [([int(t) for t in p], [int(t) for t in r])
             for p, r in zip(prompts, refs)]
    for drafter in (OracleDrafter(3, conts), AdversarialDrafter(3)):
        eng = ServingEngine(tm, device="cpu", max_slots=2, page_size=8,
                            spec_k=3, drafter=drafter)
        rids = [eng.add_request(p, n) for p, n in zip(prompts, news)]
        out = drain(eng)
        assert_all_equal([out[r].tokens for r in rids], refs)
        s = eng.stats
        if isinstance(drafter, OracleDrafter):
            assert s["spec_rejected"] == 0
            assert s["spec_accepted"] == s["spec_drafted"] > 0
            assert s["decode_calls"] <= 4       # 11 tokens in k + 1 strides
        else:
            assert s["spec_accepted"] == 0
            assert s["spec_rejected"] == s["spec_drafted"] > 0


def test_engine_spec_validation():
    _, tm = pair()
    with pytest.raises(ValueError):
        ServingEngine(tm, device="cpu", spec_k=2, greedy=False)
    with pytest.raises(ValueError):
        ServingEngine(tm, device="cpu", spec_k=2, decode_block=4)
    eng = ServingEngine(tm, device="cpu", spec_k=3, spec_ngram=2)
    assert isinstance(eng._drafter, NGramDrafter)
    assert (eng._drafter.spec_k, eng._drafter.max_ngram) == (3, 2)

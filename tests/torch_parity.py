"""Shared helpers of the port's parity tests: one seeded reference model
and the port model holding its weights, a step loop that audits the port
engine after every step, the token comparisons, and the fixture that lets
the reference's Pallas kernels run in interpret mode.

    port ServingEngine == port dense decoder == JAX ServingEngine
"""

import numpy as np
import pytest

import jax
import jax.experimental

import paddle_tpu as paddle
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTForPretraining as JModel
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.models import generate
from paddle_tpu_torch.models.gpt import GPTConfig, GPTParams
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.weights import load_jax_params

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=96)


@pytest.fixture
def interpretable(monkeypatch):
    """Lets the reference's Pallas kernels run in interpret mode on a jax
    whose ``jax.experimental`` lacks ``disable_x64`` (the reference's
    ``flash._x64_off`` imports it): the same context manager under its
    newer spelling, ``jax.enable_x64(False)``.  Nothing changes on a jax
    that has it.  Test modules import it from here."""
    if not hasattr(jax.experimental, "disable_x64"):
        monkeypatch.setattr(jax.experimental, "disable_x64",
                            lambda: jax.enable_x64(False), raising=False)


def pair(seed=3, **over):
    """(reference model, port model on the CPU with the same weights)."""
    paddle.seed(seed)
    jm = JModel(JConfig(**{**CFG, **over}, dropout=0.0))
    jm.eval()
    tree = jax.tree_util.tree_map(np.asarray, jgen._decoder_setup(jm)[0])
    tm = GPTParams(GPTConfig(**{**CFG, **over}), device="cpu")
    load_jax_params(tm, tree)
    return jm, tm


def drain(eng, trace=None):
    """Step ``eng`` to completion, auditing invariants after every step;
    ``trace(eng)`` observes the engine after each step."""
    done = {}
    while eng.has_work:
        for fin in eng.step():
            done[fin.rid] = fin
        eng.check_invariants()
        if trace is not None:
            trace(eng)
    assert eng.scheduler.n_active == 0 and eng.pool.pages_in_use == 0
    return done


def serve_both(jm, tm, prompts, n, trace=None, max_slots=2, page_size=8,
               **kw):
    """The same requests through the port engine and the JAX engine (its
    jnp attention path); returns (port tokens, JAX tokens, port engine,
    JAX engine).  ``n`` is one max_new_tokens or one per prompt."""
    news = [n] * len(prompts) if np.isscalar(n) else list(n)
    eng = ServingEngine(tm, device="cpu", max_slots=max_slots,
                        page_size=page_size, **kw)
    rids = [eng.add_request(p, k) for p, k in zip(prompts, news)]
    out = drain(eng, trace)
    jeng = JEngine(jm, max_slots=max_slots, page_size=page_size,
                   use_paged_kernel=False, **kw)
    jrids = [jeng.add_request(p, k) for p, k in zip(prompts, news)]
    jout = jeng.run()
    assert all(out[r].reason == "length" for r in rids)
    return ([out[r].tokens for r in rids], [jout[r].tokens for r in jrids],
            eng, jeng)


def dense(tm, prompts, n, **kw):
    """The port dense decoder's greedy continuations (``kw``: int8,
    kv_bits)."""
    news = [n] * len(prompts) if np.isscalar(n) else list(n)
    return [generate(tm, p[None], k, **kw)[0, len(p):].numpy()
            for p, k in zip(prompts, news)]


def prompts_of(rng, lens, vocab=512):
    return [rng.randint(0, vocab, (k,)).astype(np.int32) for k in lens]


def assert_all_equal(*token_lists):
    first = token_lists[0]
    for other in token_lists[1:]:
        assert len(other) == len(first)
        for a, b in zip(first, other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

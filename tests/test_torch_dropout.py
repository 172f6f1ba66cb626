"""Dropout in the port's training path against the reference, and the
port's seed chain.

The two packages draw their masks from different generators, so every
parity test here hands both the same uniforms: the reference's
``jax.random.uniform`` and the port's one draw function
(``paddle_tpu_torch.framework.random.uniform``) are patched to return
the same seeded numpy uniforms, the n-th distinct key drawn getting the
n-th array.  The reference runs under ``jax.disable_jit()`` (no remat
there), so its keys are concrete and each site draws once per step, in
call order: the embedding, then each block's attention.  The port's
keys are mapped the same way, so a block that ``torch.utils.checkpoint``
recomputes (which reseeds its generator from the same key) reads the
uniforms its forward read.

Tolerances: the dropout op bit for bit (the same comparison and the same
multiply); attention fp32 1e-6 (summation order); the train step
``test_torch_train.py``'s fp32 ones — losses 1e-5 relative, parameters
2e-5 absolute, each leaf's update within 1e-3 of the reference's.

What the injected test also shows: on one device the reference runs its
blocks as an unrolled loop (its ``lax.scan`` needs a pipeline axis), so
every block draws its own mask; its draw count per step (1 + layers,
each with its own key) and the port's agree, and the losses with them.

Model: ``test_torch_train.py``'s (vocab 512, hidden 64, 2 layers, 2
heads, seq 64, batch 2), with ``dropout=0.1``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.dygraph.tensor import Tensor as JTensor
from paddle_tpu.kernels import attention as jatt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu_torch.framework import random as trand
from paddle_tpu_torch.kernels import attention as tatt
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTParams,
                                         build_functional_train_step)
from paddle_tpu_torch.ops import dropout as tdropout
from paddle_tpu_torch.weights import (load_jax_named_params,
                                      params_to_numpy, port_name)

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.1)


def _uniforms(i, shape):
    return np.random.RandomState(1000 + i).rand(*shape).astype(np.float32)


class _Draws:
    """The same uniforms for both packages: the n-th distinct key (per
    package) gets ``_uniforms(n, shape)``.  ``ref`` replaces
    ``jax.random.uniform``, ``port`` the port's ``uniform``."""

    def __init__(self):
        self.ref_calls, self.port_keys = [], {}

    def ref(self, key, shape=(), dtype=jnp.float32, *args, **kw):
        assert dtype == jnp.float32
        self.ref_calls.append((np.asarray(key).tobytes(), tuple(shape)))
        return jnp.asarray(_uniforms(len(self.ref_calls) - 1, shape))

    def port(self, key, shape, device):
        i = self.port_keys.setdefault(key, len(self.port_keys))
        return torch.from_numpy(_uniforms(i, tuple(shape))).to(device)


@pytest.fixture
def draws(monkeypatch):
    d = _Draws()
    monkeypatch.setattr(jax.random, "uniform", d.ref)
    monkeypatch.setattr(trand, "uniform", d.port)
    return d


def _pair(seed=0, **over):
    paddle.seed(seed)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**{**CFG, **over}))
    named = [(n, np.asarray(p._array)) for n, p in jm.named_parameters()]
    tm = GPTParams(GPTConfig(**{**CFG, **over}), device="cpu")
    load_jax_named_params(tm, named)
    return jm, tm


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 512, (2, 64)).astype("int32"),
            rng.randint(0, 512, (2, 64)).astype("int64"))


# ---------------------------------------------------------------------------
# the op and the attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.1, 0.5, 1.0])
def test_dropout_op_matches_reference_bit_for_bit(draws, dtype, p):
    x = np.random.RandomState(0).randn(3, 5, 16).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = jnn.dropout_kernel({"X": jx}, {"dropout_prob": p},
                              rng=jax.random.PRNGKey(0))["Out"]
    got = tdropout(torch.from_numpy(x).to(getattr(torch, dtype)), p, 7)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_dropout_op_draws_nothing_at_p0_and_is_identity_in_eval(draws):
    x = torch.randn(4, 8)
    assert tdropout(x, 0.0, 1) is x
    assert tdropout(x, 0.3, 1, training=False) is x
    assert draws.port_keys == {}


@pytest.mark.parametrize("layout,nkv", [("bnsd", 4), ("bsnd", 2),
                                        ("sbnd", 4)])
def test_attention_dropout_matches_reference(draws, layout, nkv):
    """``sdpa_dropout`` (and ``sdpa`` with ``dropout_p > 0``, which routes
    to it) against ``_sdpa_reference``'s dropout branch, causal, with GQA
    in the seq-major layouts."""
    rng = np.random.RandomState(1)
    b, h, s, d = 2, 4, 24, 16
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, nkv, s, d).astype(np.float32)
    v = rng.randn(b, nkv, s, d).astype(np.float32)
    want = np.asarray(jatt.sdpa(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), is_causal=True,
                                dropout_p=0.2, rng=jax.random.PRNGKey(1)))
    perm = {"bnsd": (0, 1, 2, 3), "bsnd": (0, 2, 1, 3),
            "sbnd": (2, 0, 1, 3)}[layout]
    tq, tk, tv = (torch.from_numpy(a).permute(perm) for a in (q, k, v))
    got = tatt.sdpa(tq, tk, tv, is_causal=True, dropout_p=0.2, key=11,
                    layout=layout)
    back = np.argsort(perm)
    np.testing.assert_allclose(got.permute(*back).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    assert len(draws.ref_calls) == 1 and len(draws.port_keys) == 1


# ---------------------------------------------------------------------------
# the eager forward and the train step
# ---------------------------------------------------------------------------


def test_eager_forward_with_dropout_matches_reference(draws):
    """The training-mode forward: embedding dropout, then each block's
    attention dropout, one key each in that order on both sides."""
    jm, tm = _pair()
    ids, _ = _batch()
    with jax.disable_jit():      # the eager ops' keys stay concrete
        want = np.asarray(jm(JTensor(jnp.asarray(ids)))._array)
    got = tm(ids).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    shapes = [s for _, s in draws.ref_calls]
    assert shapes == [(2, 64, 64)] + [(2, 2, 64, 64)] * 2
    assert len(draws.port_keys) == 3


@pytest.fixture(scope="module")
def reference_run():
    """Three steps of the reference's train step with dropout, its draws
    patched: per step, the parameters, the loss and the draws' shapes."""
    d = _Draws()
    jm, _ = _pair()
    ids, labels = _batch()
    jstep, jp, jo = jgpt.build_functional_train_step(jm, remat=False)
    orig = jax.random.uniform
    jax.random.uniform = d.ref
    try:
        losses = []
        with jax.disable_jit():
            for _ in range(3):
                jp, jo, jl = jstep(jp, jo, ids, labels)
                losses.append(float(jl))
    finally:
        jax.random.uniform = orig
    params = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(jp)]
    names = [port_name(n) for n, _ in jm.named_parameters()]
    return losses, params, names, d.ref_calls


@pytest.mark.parametrize("remat", [False, True, "dots"],
                         ids=["remat_false", "remat_true", "remat_dots"])
def test_train_step_with_dropout_matches_reference(reference_run, draws,
                                                   remat):
    """Three train steps with dropout=0.1 from the same weights and draws:
    losses, parameters and each leaf's update as the reference's, under
    every remat mode of the port.  The reference drew 1 + 2 masks a step,
    each under its own key: one per block."""
    losses, want, names, ref_calls = reference_run
    shapes = [s for _, s in ref_calls]
    assert shapes == ([(2, 64, 64)] + [(2, 2, 64, 64)] * 2) * 3
    assert len({k for k, _ in ref_calls}) == 9
    _, tm = _pair()
    ids, labels = _batch()
    tstep, tp, to = build_functional_train_step(tm, remat=remat)
    init = [a.copy() for a in params_to_numpy(tp)]
    for want_loss in losses:
        tp, to, tl = tstep(tp, to, ids, labels)
        np.testing.assert_allclose(float(tl), want_loss, rtol=1e-5)
    assert len(draws.port_keys) == 9
    got = params_to_numpy(tp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    for n, a, b, a0 in zip(names, got, want, init):
        if n.endswith("qkv_b"):
            continue        # the softmax cancels its key part (see train)
        ratio = np.linalg.norm(a - b) / np.linalg.norm(b - a0)
        assert ratio < 1e-3, (n, ratio)


def _grads(tm, remat, ids, labels, seed):
    """The gradients of one dropout train step's loss, at ``seed``."""
    trand.seed(seed)
    captured = {}
    step, params, opt = build_functional_train_step(tm, remat=remat)
    orig = torch.autograd.grad

    def grad(loss, leaves, *a, **kw):
        out = orig(loss, leaves, *a, **kw)
        captured["g"] = [g.clone() for g in out]
        return out

    torch.autograd.grad = grad
    try:
        step([p.clone() for p in params], opt, ids, labels)
    finally:
        torch.autograd.grad = orig
    return captured["g"]


def test_remat_does_not_change_dropout_gradients():
    """The port's own generators (nothing patched): remat True, "dots"
    and False give the same gradients at one seed, since a recomputed
    block reseeds its generator from its key."""
    _, tm = _pair()
    ids, labels = _batch()
    base = _grads(tm, False, ids, labels, 5)
    for remat in (True, "dots"):
        for a, b in zip(_grads(tm, remat, ids, labels, 5), base):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    other = _grads(tm, False, ids, labels, 6)
    assert not torch.equal(other[0], base[0])


def test_masks_differ_between_steps_and_repeat_for_a_seed(monkeypatch):
    """Each step draws fresh masks (the step counter folds into the base
    key); the same seed gives the same masks again."""
    _, tm = _pair()
    ids, labels = _batch()
    seen = []
    orig = trand.uniform

    def record(key, shape, device):
        u = orig(key, shape, device)
        seen.append(u)
        return u

    monkeypatch.setattr(trand, "uniform", record)

    def run(seed):
        seen.clear()
        trand.seed(seed)
        step, params, opt = build_functional_train_step(tm, remat=False)
        params = [p.clone() for p in params]
        for _ in range(2):
            params, opt, _ = step(params, opt, ids, labels)
        return list(seen)

    a, b = run(4), run(4)
    assert len(a) == 6
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], a[3]) and not torch.equal(a[1], a[4])
    assert not torch.equal(a[1], a[2])     # each block its own mask
    c = run(5)
    assert not torch.equal(a[0], c[0])


def test_eval_mode_train_step_draws_no_mask(monkeypatch):
    _, tm = _pair()
    tm.eval()
    monkeypatch.setattr(trand, "uniform", lambda *a: pytest.fail("a draw"))
    step, params, opt = build_functional_train_step(tm, remat=False)
    step(params, opt, *_batch())


# ---------------------------------------------------------------------------
# the seed chain
# ---------------------------------------------------------------------------


def test_seed_chain_is_deterministic_and_scoped():
    trand.seed(3)
    a = [trand.next_rng_key() for _ in range(3)]
    trand.seed(3)
    assert [trand.next_rng_key() for _ in range(3)] == a
    assert len(set(a)) == 3
    trand.seed(3)
    with trand.trace_rng_scope(trand.fold_in(a[0], 2)):
        inner = [trand.next_rng_key() for _ in range(2)]
    assert trand.next_rng_key() == a[0]      # the scope left the chain
    with trand.trace_rng_scope(trand.fold_in(a[0], 2)):
        assert [trand.next_rng_key() for _ in range(2)] == inner
    assert trand.fold_in(a[0], 2) != trand.fold_in(a[0], 3)
    g1 = trand.uniform(a[1], (4,), "cpu")
    assert torch.equal(g1, trand.uniform(a[1], (4,), "cpu"))
    assert not torch.equal(g1, trand.uniform(a[2], (4,), "cpu"))

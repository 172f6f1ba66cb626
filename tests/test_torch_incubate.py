"""The port's ``paddle.incubate`` (the wrapper optimizers, the fused
softmax masks, ASP) against the JAX package's, on the CPU.

The wrappers train the same small MLP in both packages, built under
fresh unique-name counters with the JAX package's weights carried into
the port's, on the same seeded batches: after every step each
parameter (and each EMA shadow or ModelAverage average under ``apply``)
is held to the JAX package's at 1e-6 relative (norm of the difference
over the norm of the value; fp32, the two differing by the order of a
matmul's sums), and ``restore`` gives back the weights bit for bit.  The
fused softmax masks are held to the JAX kernels and their ``jax.vjp`` at
1e-6, and a static program records the registered op types.  ASP:
``get_mask_1d`` bit for bit (ties included), ``prune_model``'s selection
by name, 3 steps of ``decorate`` training against the JAX package's, and
``check_sparsity`` / ``calculate_density`` (mirroring
``tests/test_asp_meta_optimizers.py:21-58``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu import incubate as jinc
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.incubate import asp as jasp
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch as tp
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.incubate import asp as tasp
from paddle_tpu_torch.weights import load_paddle_state_dict

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    jasp._helper.reset()
    tasp._helper.reset()
    jasp.reset_excluded_layers()
    tasp.reset_excluded_layers()
    yield
    jasp._helper.reset()
    tasp._helper.reset()


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 4))


def _pair(factory=_mlp):
    with jnames.guard():
        jp.seed(0)
        jm = factory(jp)
    with tnames.guard():
        tp.seed(0)
        tm = factory(tp)
    load_paddle_state_dict(tm, {k: np.asarray(v.numpy())
                                for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(i):
    r = np.random.RandomState(100 + i)
    return r.randn(16, 8).astype("float32"), r.randn(16, 4).astype("float32")


def _backward(P, m, i):
    x, y = _batch(i)
    loss = P.nn.functional.mse_loss(m(P.to_tensor(x)), P.to_tensor(y))
    loss.backward()
    return float(loss.numpy())


def _rel(got, want):
    got, want = np.asarray(got, "float64"), np.asarray(want, "float64")
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _same_params(jm, tm, rtol=RTOL):
    for (jn, jpar), (tn, tpar) in zip(jm.named_parameters(),
                                      tm.named_parameters()):
        assert jn == tn
        assert _rel(tpar.numpy(), jpar.numpy()) <= rtol, jn


def _values(m):
    return [p.numpy().copy() for p in m.parameters()]


# -- the wrapper optimizers --------------------------------------------------


def test_ema_tracks_and_applies_like_reference():
    jm, tm = _pair()
    jopt = jp.optimizer.SGD(0.1, parameters=jm.parameters())
    topt = tp.optimizer.SGD(0.1, parameters=tm.parameters())
    jema = jinc.ExponentialMovingAverage(jm.parameters(), decay=0.9,
                                         thres_steps=1)
    tema = tinc.ExponentialMovingAverage(tm.parameters(), decay=0.9,
                                         thres_steps=1)
    for i in range(4):
        for P, m, opt, ema in ((jp, jm, jopt, jema), (tp, tm, topt, tema)):
            _backward(P, m, i)
            opt.step()
            opt.clear_grad()
            ema.update()
        _same_params(jm, tm)
        before = _values(tm)
        with jema.apply(), tema.apply():
            _same_params(jm, tm)
            assert all(p._t.dtype == torch.float32 for p in tm.parameters())
        for a, p in zip(before, tm.parameters()):
            np.testing.assert_array_equal(p.numpy(), a)
    # apply(need_restore=False), then restore() by hand
    with tema.apply(need_restore=False):
        pass
    tema.restore()
    for a, p in zip(before, tm.parameters()):
        np.testing.assert_array_equal(p.numpy(), a)


def test_lookahead_matches_reference():
    jm, tm = _pair()
    jla = jinc.LookAhead(jp.optimizer.Momentum(
        0.05, momentum=0.9, parameters=jm.parameters()), alpha=0.5, k=3)
    tla = tinc.LookAhead(tp.optimizer.Momentum(
        0.05, momentum=0.9, parameters=tm.parameters()), alpha=0.5, k=3)
    assert tp.fluid.optimizer.LookaheadOptimizer is tinc.LookAhead
    for i in range(7):
        for P, m, la in ((jp, jm, jla), (tp, tm, tla)):
            _backward(P, m, i)
            la.step()
            la.clear_grad()
        _same_params(jm, tm)
        if (i + 1) % 3 == 0:   # fast = slow after the slow update
            for p in tm.parameters():
                np.testing.assert_array_equal(
                    p.numpy(), tla._slow[id(p)].numpy())
    assert tla.get_lr() == jla.get_lr()


def test_model_average_matches_reference():
    jm, tm = _pair()
    jopt = jp.optimizer.Adam(0.01, parameters=jm.parameters())
    topt = tp.optimizer.Adam(0.01, parameters=tm.parameters())
    jma = jinc.ModelAverage(0.15, jm.parameters(), min_average_window=2,
                            max_average_window=4)
    tma = tinc.ModelAverage(0.15, tm.parameters(), min_average_window=2,
                            max_average_window=4)
    for i in range(6):
        for P, m, opt, ma in ((jp, jm, jopt, jma), (tp, tm, topt, tma)):
            _backward(P, m, i)
            opt.step()
            opt.clear_grad()
            ma.step()
        _same_params(jm, tm)
        before = _values(tm)
        with jma.apply(), tma.apply():
            _same_params(jm, tm)
        for a, p in zip(before, tm.parameters()):
            np.testing.assert_array_equal(p.numpy(), a)
    assert tp.fluid.optimizer.ModelAverage is tinc.ModelAverage


@pytest.mark.parametrize("k,avg", [(2, True), (3, False)])
def test_gradient_merge_matches_reference(k, avg):
    jm, tm = _pair()
    jgm = jinc.GradientMergeOptimizer(jp.optimizer.Adam(
        0.01, parameters=jm.parameters()), k_steps=k, avg=avg)
    tgm = tinc.GradientMergeOptimizer(tp.optimizer.Adam(
        0.01, parameters=tm.parameters()), k_steps=k, avg=avg)
    start = _values(tm)
    for i in range(2 * k):
        for P, m, gm in ((jp, jm, jgm), (tp, tm, tgm)):
            _backward(P, m, i)
            gm.step()
            gm.clear_grad()
        # the gradients are cleared after every micro-step
        assert all(p.grad is None for p in tm.parameters())
        _same_params(jm, tm)
        if i + 1 < k:   # no real step before the k-th micro-step
            for a, p in zip(start, tm.parameters()):
                np.testing.assert_array_equal(p.numpy(), a)
    assert not tgm._acc
    assert any(not np.array_equal(a, p.numpy())
               for a, p in zip(start, tm.parameters()))


# -- the fused softmax masks -------------------------------------------------


def _jax_op(op, ins):
    kern = jreg.get_op_def(op).kernel
    names = sorted(ins)

    def f(*xs):
        return kern(dict(zip(names, xs)), {})["Out"]

    return jax.vjp(f, *[jnp.asarray(ins[n]) for n in names])


@pytest.mark.parametrize("causal", [False, True], ids=["mask", "triangle"])
def test_fused_softmax_masks_match_reference(causal):
    r = np.random.RandomState(0)
    x = r.randn(2, 3, 5, 7).astype("float32") * 3
    mask = np.where(r.rand(2, 1, 5, 7) < 0.3, -1e4, 0.0).astype("float32")
    g = r.randn(*x.shape).astype("float32")
    ins = {"X": x} if causal else {"X": x, "Mask": mask}
    op = ("fused_softmax_mask_upper_triangle" if causal
          else "fused_softmax_mask")
    want, vjp = _jax_op(op, ins)
    want_dx = np.asarray(vjp(jnp.asarray(g))[sorted(ins).index("X")])
    tx = tp.to_tensor(x, stop_gradient=False)
    out = (tinc.softmax_mask_fuse_upper_triangle(tx) if causal
           else tinc.softmax_mask_fuse(tx, tp.to_tensor(mask)))
    out.backward(tp.to_tensor(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(tx.grad.numpy(), want_dx, rtol=1e-5,
                               atol=1e-6)
    if causal:   # keys after the query's position take nothing
        assert (np.triu(out.numpy()[0, 0], 3) == 0).all()


def test_fused_softmax_masks_record_their_ops():
    types = []
    for P, inc in ((jp, jinc), (tp, tinc)):
        P.enable_static()
        try:
            main, startup = P.static.Program(), P.static.Program()
            with P.static.program_guard(main, startup):
                x = P.static.data("x", [2, 4, 4], "float32")
                m = P.static.data("m", [2, 4, 4], "float32")
                inc.softmax_mask_fuse_upper_triangle(
                    inc.softmax_mask_fuse(x, m))
            types.append([op.type for op in main.global_block().ops])
        finally:
            P.disable_static()
    assert types[1] == types[0] == ["fused_softmax_mask",
                                    "fused_softmax_mask_upper_triangle"]


def test_incubate_names():
    for name in jinc.__all__:
        assert hasattr(tinc, name), name
    assert tinc.checkpoint is tinc.auto_checkpoint


# -- ASP ---------------------------------------------------------------------


def test_mask_1d_and_checks():
    r = np.random.RandomState(0)
    w = r.randn(6, 8).astype("float32")
    ties = np.array([[1, 1, 1, 1, 2, -2, 2, 0.5]], "float32")
    for m in (w, ties, np.round(w)):
        np.testing.assert_array_equal(tasp.get_mask_1d(m, 2, 4),
                                      jasp.get_mask_1d(m, 2, 4))
        np.testing.assert_array_equal(
            tasp.get_mask_1d(torch.as_tensor(m), 1, 4),
            jasp.get_mask_1d(m, 1, 4))
    mask = tasp.get_mask_1d(w, 2, 4)
    assert tasp.check_sparsity(w * mask, 2, 4)
    assert not tasp.check_sparsity(np.ones((4, 4)), 2, 4)
    assert not tasp.check_sparsity(np.ones((4, 3)), 2, 4)
    groups = np.abs(w).reshape(-1, 4)
    kept = np.sort(groups[mask.reshape(-1, 4)].reshape(-1, 2), axis=1)
    np.testing.assert_array_equal(kept, np.sort(groups, axis=1)[:, 2:])
    assert tasp.calculate_density(w * mask) == jasp.calculate_density(
        w * mask) == 0.5
    with pytest.raises(NotImplementedError, match="mask_2d"):
        tasp.prune_model(tp.nn.Linear(4, 4), mask_algo="mask_2d_greedy")


def _asp_model(P):
    return P.nn.Sequential(P.nn.Embedding(12, 8), P.nn.Linear(8, 16),
                           P.nn.LayerNorm(16), P.nn.Linear(16, 3))


def test_prune_model_selects_the_reference_parameters():
    jm, tm = _pair(_asp_model)
    jasp.set_excluded_layers([jm[1].bias.name])
    tasp.set_excluded_layers([tm[1].bias.name])
    jasp.prune_model(jm, n=2, m=4)
    tasp.prune_model(tm, n=2, m=4)
    jnames_ = sorted(p.name for p in jasp._helper._params.values())
    tnames_ = sorted(p.name for p in tasp._helper._params.values())
    assert tnames_ == jnames_
    assert tnames_ == sorted([tm[0].weight.name, tm[1].weight.name])
    for (n, jpar), tpar in zip(jm.named_parameters(), tm.parameters()):
        np.testing.assert_array_equal(tpar.numpy(), jpar.numpy())
    # the helper holds its parameters weakly
    del tm
    import gc

    gc.collect()
    tasp._helper.apply_masks()
    assert not tasp._helper._masks


def test_decorated_training_matches_reference():
    jm, tm = _pair(_asp_model)
    for P, asp, m in ((jp, jasp, jm), (tp, tasp, tm)):
        asp.prune_model(m, n=2, m=4)
    jopt = jasp.decorate(jp.optimizer.Momentum(0.05, parameters=jm.parameters()))
    topt = tasp.decorate(tp.optimizer.Momentum(0.05, parameters=tm.parameters()))
    ids = np.random.RandomState(3).randint(0, 12, (16,)).astype("int64")
    y = np.random.RandomState(4).randn(16, 3).astype("float32")
    losses = []
    for _ in range(3):
        for P, m, opt in ((jp, jm, jopt), (tp, tm, topt)):
            loss = P.nn.functional.mse_loss(m(P.to_tensor(ids)),
                                            P.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        _same_params(jm, tm)
        for p in (tm[0].weight, tm[1].weight):
            assert tasp.check_sparsity(p, 2, 4)
            assert tasp.calculate_density(p) == 0.5
    assert abs(losses[-1] - losses[-2]) <= 1e-6 * abs(losses[-2])

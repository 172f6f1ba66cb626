"""The port's ``paddle.distribution`` against the JAX package's, on the CPU.

Mirrors ``tests/test_distribution.py`` (11 cases).  ``log_prob``,
``probs``, ``entropy`` and ``kl_divergence`` are held to the JAX
package's values on the same seeded inputs at 1e-6 relative (both are
fp32 elementwise math; measured: equal or one rounding apart).  The
draws cannot equal ``jax.random``'s bits, so the samplers are held by
statistics (support, mean and spread within 5 standard errors, category
shares within 0.05) and by seed: two draws with one seed are equal, and
two seeds differ.  ``fluid.layers.Categorical`` / ``Normal`` /
``Uniform`` are the same classes.
"""

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.distribution as JD

import paddle_tpu_torch as tp
import paddle_tpu_torch.distribution as TD

st = pytest.importorskip("scipy.stats")
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _both(P, D, cls, *args):
    """``cls`` of package ``P`` over ``args`` (numpy arrays become the
    package's tensors; floats stay floats)."""
    conv = [P.to_tensor(a) if isinstance(a, np.ndarray) else a
            for a in args]
    return getattr(D, cls)(*conv)


def _pair(cls, *args):
    return _both(jp, JD, cls, *args), _both(tp, TD, cls, *args)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a.numpy()), np.asarray(b.numpy())
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-7)


def test_uniform_scalar_args():
    ju, tu = _pair("Uniform", 1.0, 3.0)
    tp.seed(7)
    s = tu.sample([2000]).numpy()
    assert s.shape == (2000,) and s.min() >= 1.0 and s.max() <= 3.0
    assert abs(s.mean() - 2.0) < 5 * (2.0 / np.sqrt(12)) / np.sqrt(2000)
    _close(ju.entropy(), tu.entropy())
    v = np.array([1.5, 2.9, 5.0, 0.5], "float32")
    _close(ju.probs(jp.to_tensor(v)), tu.probs(tp.to_tensor(v)))
    lp = tu.log_prob(tp.to_tensor(v)).numpy()
    assert np.isneginf(lp[2:]).all()
    np.testing.assert_allclose(lp[:2], ju.log_prob(
        jp.to_tensor(v)).numpy()[:2], rtol=RTOL)
    np.testing.assert_allclose(lp[:2], st.uniform.logpdf(v[:2], 1.0, 2.0),
                               rtol=1e-5)


def test_uniform_batch_args():
    low = np.array([0.0, 1.0], "float32")
    high = np.array([1.0, 4.0], "float32")
    ju, tu = _pair("Uniform", low, high)
    s = tu.sample([16], seed=5).numpy()
    assert s.shape == (16, 2)
    assert ((s >= low) & (s < high)).all()
    np.testing.assert_array_equal(tu.sample([16], seed=5).numpy(), s)
    assert not np.array_equal(tu.sample([16], seed=6).numpy(), s)
    _close(ju.entropy(), tu.entropy())


def test_uniform_mixed_args_raise():
    with pytest.raises(ValueError, match="all arguments should be Tensor"):
        TD.Uniform(tp.to_tensor(np.array([0.0], "float32")), 1.0)


def test_normal_scalar_args():
    jn, tn = _pair("Normal", 0.5, 2.0)
    tp.seed(9)
    s = tn.sample([4000]).numpy()
    assert s.shape == (4000,)
    assert abs(s.mean() - 0.5) < 5 * 2.0 / np.sqrt(4000)
    assert abs(s.std() - 2.0) < 5 * 2.0 / np.sqrt(2 * 4000)
    _close(jn.entropy(), tn.entropy())
    v = np.array([0.3, -1.0, 4.2], "float32")
    _close(jn.log_prob(jp.to_tensor(v)), tn.log_prob(tp.to_tensor(v)))
    _close(jn.probs(jp.to_tensor(v)), tn.probs(tp.to_tensor(v)))
    np.testing.assert_allclose(tn.log_prob(tp.to_tensor(v)).numpy(),
                               st.norm.logpdf(v, 0.5, 2.0), rtol=1e-5)
    a, b = tn.sample([64], seed=3).numpy(), tn.sample([64], seed=3).numpy()
    np.testing.assert_array_equal(a, b)


def test_normal_kl_closed_form():
    r = np.random.RandomState(0)
    loc = r.randn(5).astype("float32")
    scale = (r.rand(5) + 0.5).astype("float32")
    loc2 = r.randn(5).astype("float32")
    scale2 = (r.rand(5) + 0.5).astype("float32")
    j1, t1 = _pair("Normal", loc, scale)
    j2, t2 = _pair("Normal", loc2, scale2)
    _close(j1.kl_divergence(j2), t1.kl_divergence(t2))
    ref = (np.log(scale2 / scale) + (scale ** 2 + (loc - loc2) ** 2)
           / (2 * scale2 ** 2) - 0.5)
    np.testing.assert_allclose(t1.kl_divergence(t2).numpy(), ref, rtol=1e-5)
    with pytest.raises(TypeError):
        t1.kl_divergence(TD.Uniform(0.0, 1.0))


def test_normal_batch_entropy_shape():
    loc = np.zeros((3,), "float32")
    scale = np.array([1.0, 2.0, 0.5], "float32")
    jn, tn = _pair("Normal", loc, scale)
    _close(jn.entropy(), tn.entropy())
    np.testing.assert_allclose(tn.entropy().numpy(),
                               st.norm.entropy(loc, scale), rtol=1e-5)


def test_categorical_1d():
    w = np.array([0.5, 0.2, 0.3], "float32")
    jc, tc = _pair("Categorical", w)
    tp.seed(11)
    s = tc.sample([3000]).numpy()
    assert s.shape == (3000,)
    np.testing.assert_allclose(np.bincount(s, minlength=3) / s.size,
                               w / w.sum(), atol=0.05)
    tp.seed(11)
    np.testing.assert_array_equal(tc.sample([3000]).numpy(), s)
    idx = np.array([0, 1, 2], "int64")
    _close(jc.probs(jp.to_tensor(idx)), tc.probs(tp.to_tensor(idx)))
    _close(jc.log_prob(jp.to_tensor(idx)), tc.log_prob(tp.to_tensor(idx)))
    _close(jc.entropy(), tc.entropy())
    j2, t2 = _pair("Categorical", np.array([1.0, 2.0, 0.5], "float32"))
    _close(jc.kl_divergence(j2), tc.kl_divergence(t2))


def test_categorical_2d():
    r = np.random.RandomState(1)
    w = r.rand(4, 6).astype("float32") + 0.1
    jc, tc = _pair("Categorical", w)
    tp.seed(12)
    s = tc.sample([5]).numpy()
    assert s.shape == (5, 4) and s.min() >= 0 and s.max() < 6
    for v in (np.array([[0], [1], [5], [2]], "int64"),
              np.array([0, 3], "int64")):
        _close(jc.probs(jp.to_tensor(v)), tc.probs(tp.to_tensor(v)))
    with pytest.raises(ValueError, match="must match"):
        tc.probs(tp.to_tensor(np.array([[0], [1], [0]], "int64")))
    j2, t2 = _pair("Categorical", r.rand(4, 6).astype("float32") + 0.1)
    _close(jc.entropy(), tc.entropy())
    _close(jc.kl_divergence(j2), tc.kl_divergence(t2))


def test_distribution_base_is_abstract():
    d = TD.Distribution()
    for m in ("sample", "entropy"):
        with pytest.raises(NotImplementedError):
            getattr(d, m)()
    with pytest.raises(NotImplementedError):
        d.log_prob(None)
    with pytest.raises(NotImplementedError):
        d.kl_divergence(d)


def test_log_prob_differentiable():
    """The policy-gradient shape: d log_prob / d loc, as the JAX
    package's."""
    grads = []
    for P, D in ((jp, JD), (tp, TD)):
        loc = P.to_tensor(np.array([0.0, 0.3], "float32"),
                          stop_gradient=False)
        n = D.Normal(loc, P.to_tensor(np.array([1.0, 2.0], "float32")))
        n.log_prob(P.to_tensor(np.array([0.7, -1.0], "float32"))) \
            .sum().backward()
        grads.append(np.asarray(loc.grad.numpy()))
    np.testing.assert_allclose(grads[1], grads[0], rtol=RTOL)
    np.testing.assert_allclose(grads[1], [0.7, -1.3 / 4], rtol=1e-6)


def test_top_level_and_fluid_names():
    assert tp.distribution is TD
    assert sorted(TD.__all__) == sorted(JD.__all__)
    L = tp.fluid.layers
    assert (L.Categorical, L.Normal, L.Uniform) == (
        TD.Categorical, TD.Normal, TD.Uniform)
    u = L.Uniform(0.0, 2.0)
    np.testing.assert_allclose(u.entropy().numpy(), [np.log(2.0)],
                               rtol=1e-6)

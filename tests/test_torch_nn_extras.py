"""The rest of the port's ``paddle.nn`` against the reference's, on the
CPU: the extras layers, the 3-D convs and pools, the upsampling layers,
the new ``nn.functional`` names, ``nn.utils``, ``nn.quant`` and the
top-level helpers.

Layers are built in both packages under fresh unique-name counters, the
reference's ``state_dict()`` is carried into the port's, and the same
seeded inputs run forward; outputs, the inputs' gradients and every
parameter's gradient of ``sum(out * g)`` (g seeded) agree to 1e-5
relative to the tensor's scale.  ``ctc_loss`` is held on feasible,
infeasible (the -1e30 floor: a loss near 1e30, not inf) and blank-only
labels in its three reductions.  The random functions (``alpha_dropout``,
``dropout3d``) draw the same injected uniforms in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import random as trand
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.weights import load_paddle_state_dict

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _data(*shape, seed=0):
    return np.asarray(np.random.RandomState(seed).randn(*shape), "float32")


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _run(P, names, factory, feed, state=None):
    old = names.switch()
    try:
        P.seed(0)
        layer = factory(P)
        if state is not None:
            load_paddle_state_dict(layer, state)
        init = ({k: v.numpy() for k, v in layer.state_dict().items()}
                if isinstance(layer, P.nn.Layer) else None)
        args = feed(P)
        outs = _leaves(layer(*args))
        res, loss = {}, None
        for i, o in enumerate(outs):
            res[f"out{i}"] = o.numpy()
            if o.dtype in (P.float32,) and not o.stop_gradient:
                term = P.sum(o * P.to_tensor(_data(*o.shape, seed=7 + i)))
                loss = term if loss is None else loss + term
        if loss is not None:
            loss.backward()
        for i, t in enumerate(args):
            if hasattr(t, "stop_gradient") and not t.stop_gradient:
                res[f"grad:in{i}"] = t.grad.numpy()
        if isinstance(layer, P.nn.Layer):
            for n, p in layer.named_parameters():
                res[f"grad:{n}"] = None if p.grad is None else p.grad.numpy()
        return init, res
    finally:
        names.switch(old)


def _compare(factory, feed, tol=TOL):
    state, want = _run(jp, jnames, factory, feed)
    _, got = _run(tp, tnames, factory, feed, state)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol * max(
            1.0, float(np.abs(w).max()) if w.size else 0.0), err_msg=k)
    return want


def _x(*shape, seed=0):
    return lambda P: [P.to_tensor(_data(*shape, seed=seed),
                                  stop_gradient=False)]


LAYERS = [
    ("Silu", lambda P: P.nn.Silu(), _x(2, 3, 4)),
    ("Pad1D", lambda P: P.nn.Pad1D([0, 0, 0, 0, 1, 2], value=0.5),
     _x(2, 3, 5)),
    ("Pad3D", lambda P: P.nn.Pad3D([1, 0, 2, 1, 0, 1], value=0.5),
     _x(1, 2, 3, 4, 5)),
    ("PairwiseDistance", lambda P: P.nn.PairwiseDistance(keepdim=True),
     lambda P: _x(3, 5)(P) + _x(3, 5, seed=1)(P)),
    ("PixelShuffle", lambda P: P.nn.PixelShuffle(2), _x(2, 8, 3, 3)),
    ("PixelShuffle_NHWC", lambda P: P.nn.PixelShuffle(2, "NHWC"),
     _x(2, 3, 3, 8)),
    ("Unfold", lambda P: P.nn.Unfold([2, 3], strides=[1, 2], paddings=1,
                                     dilations=[2, 1]), _x(2, 3, 5, 6)),
    ("MaxPool3D", lambda P: P.nn.MaxPool3D(2), _x(2, 3, 4, 4, 4)),
    ("MaxPool3D_pad", lambda P: P.nn.MaxPool3D(3, stride=2, padding=1),
     _x(2, 3, 5, 6, 4)),
    ("AvgPool3D", lambda P: P.nn.AvgPool3D(3, stride=2, padding=1),
     _x(2, 3, 5, 6, 4)),
    ("AvgPool3D_inclusive", lambda P: P.nn.AvgPool3D(
        [2, 3, 2], padding=[1, 0, 1], exclusive=False), _x(2, 3, 5, 6, 4)),
    ("AdaptiveAvgPool3D", lambda P: P.nn.AdaptiveAvgPool3D([2, 3, 2]),
     _x(2, 3, 4, 6, 4)),
    ("AdaptiveMaxPool3D", lambda P: P.nn.AdaptiveMaxPool3D(2),
     _x(2, 3, 4, 4, 6)),
    ("AdaptiveAvgPool1D", lambda P: P.nn.AdaptiveAvgPool1D(2), _x(2, 3, 6)),
    ("AdaptiveMaxPool1D", lambda P: P.nn.AdaptiveMaxPool1D(3), _x(2, 3, 6)),
    ("MaxPool1D", lambda P: P.nn.MaxPool1D(2), _x(2, 3, 6)),
    ("AvgPool1D", lambda P: P.nn.AvgPool1D(3, 2, 1), _x(2, 3, 7)),
    ("Conv3D", lambda P: P.nn.Conv3D(3, 4, 3, padding=1), _x(2, 3, 4, 5, 4)),
    ("Conv3D_strided", lambda P: P.nn.Conv3D(
        3, 4, [2, 3, 2], stride=[1, 2, 1], dilation=[2, 1, 1],
        bias_attr=False), _x(2, 3, 5, 6, 4)),
    ("Conv3DTranspose", lambda P: P.nn.Conv3DTranspose(
        3, 2, 3, stride=2, padding=1, output_padding=1), _x(2, 3, 3, 4, 3)),
    ("Conv1DTranspose", lambda P: P.nn.Conv1DTranspose(
        3, 4, 3, stride=2, padding=1), _x(2, 3, 5)),
    ("Upsample_bilinear", lambda P: P.nn.Upsample(size=[6, 7],
                                                  mode="bilinear"),
     _x(2, 3, 4, 5)),
    ("UpsamplingNearest2D", lambda P: P.nn.UpsamplingNearest2D(
        scale_factor=2), _x(2, 3, 4, 5)),
    ("UpsamplingBilinear2D_down", lambda P: P.nn.UpsamplingBilinear2D(
        size=[3, 2]), _x(2, 3, 7, 5)),
    ("SpectralNorm", lambda P: P.nn.SpectralNorm([4, 6], dim=1,
                                                 power_iters=2),
     _x(4, 6)),
    ("HSigmoidLoss", lambda P: P.nn.HSigmoidLoss(6, 5),
     lambda P: _x(4, 6)(P) + [P.to_tensor(np.array([[0], [4], [2], [3]]))]),
    ("HSigmoidLoss_nobias", lambda P: P.nn.HSigmoidLoss(6, 8,
                                                        bias_attr=False),
     lambda P: _x(4, 6)(P) + [P.to_tensor(np.array([[7], [1], [5], [0]]))]),
]


@pytest.mark.parametrize("name,factory,feed", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_reference(name, factory, feed):
    _compare(factory, feed)


def _ctc_feed(labels, label_len, in_len=(6, 5, 3)):
    def feed(P):
        return [P.to_tensor(_data(6, 3, 5), stop_gradient=False),
                P.to_tensor(np.asarray(labels, "int64")),
                P.to_tensor(np.asarray(in_len, "int64")),
                P.to_tensor(np.asarray(label_len, "int64"))]

    return feed


CTC = [
    ("feasible", [[1, 2, 2], [3, 4, 0], [1, 0, 0]], [3, 2, 1]),
    # 3 frames cannot hold 1, 1, 1 (it needs blanks between): infeasible
    ("infeasible", [[1, 2, 2], [3, 4, 0], [1, 1, 1]], [3, 2, 3]),
    ("blank_only", [[0, 0, 0], [3, 4, 0], [0, 0, 0]], [0, 2, 0]),
]


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("case,labels,label_len", CTC,
                         ids=[c[0] for c in CTC])
def test_ctc_loss_matches_reference(case, labels, label_len, reduction):
    want = _compare(lambda P: P.nn.CTCLoss(blank=0, reduction=reduction),
                    _ctc_feed(labels, label_len))
    if case == "infeasible" and reduction == "none":
        assert 1e29 < want["out0"][2] < 1e31


FUNCTIONS = [
    ("diag_embed", lambda P: lambda x: P.nn.functional.diag_embed(
        x, offset=1, dim1=0, dim2=2), _x(2, 3)),
    ("diag_embed_neg", lambda P: lambda x: P.nn.functional.diag_embed(
        x, offset=-2), _x(2, 3, 4)),
    ("temporal_shift", lambda P: lambda x: P.nn.functional.temporal_shift(
        x, 4, 0.25), _x(8, 8, 2, 2)),
    ("affine_grid", lambda P: lambda t: P.nn.functional.affine_grid(
        t, [2, 1, 4, 5]), _x(2, 2, 3)),
    ("affine_grid_half", lambda P: lambda t: P.nn.functional.affine_grid(
        t, [2, 1, 4, 5], align_corners=False), _x(2, 2, 3)),
    ("grid_sample", lambda P: lambda x, g: P.nn.functional.grid_sample(
        x, g), lambda P: _x(2, 3, 4, 5)(P) + [P.to_tensor(
            np.random.RandomState(3).uniform(-1.2, 1.2, (2, 3, 4, 2))
            .astype("float32"), stop_gradient=False)]),
    ("grid_sample_border", lambda P: lambda x, g:
     P.nn.functional.grid_sample(x, g, padding_mode="border",
                                 align_corners=False),
     lambda P: _x(2, 3, 4, 5)(P) + [P.to_tensor(
         np.random.RandomState(3).uniform(-1.2, 1.2, (2, 3, 4, 2))
         .astype("float32"), stop_gradient=False)]),
    ("grid_sample_nearest", lambda P: lambda x, g:
     P.nn.functional.grid_sample(x, g, mode="nearest"),
     lambda P: _x(2, 3, 4, 5)(P) + [P.to_tensor(
         np.random.RandomState(3).uniform(-1.2, 1.2, (2, 3, 4, 2))
         .astype("float32"))]),
    ("gather_tree", lambda P: P.nn.functional.gather_tree,
     lambda P: [P.to_tensor(np.random.RandomState(4).randint(
         0, 9, (5, 2, 3))), P.to_tensor(np.random.RandomState(5).randint(
             0, 3, (5, 2, 3)))]),
    ("interpolate_scale", lambda P: lambda x: P.nn.functional.interpolate(
        x, scale_factor=[1.5, 0.5], mode="bilinear"), _x(2, 3, 4, 6)),
    ("upsample_nearest", lambda P: lambda x: P.nn.functional.upsample(
        x, size=[5, 3]), _x(2, 3, 4, 6)),
    ("conv3d_fn", lambda P: lambda x, w, b: P.nn.functional.conv3d(
        x, w, b, padding=[1, 0, 1]),
     lambda P: _x(2, 3, 4, 5, 4)(P) + _x(2, 3, 3, 1, 3, seed=1)(P)
     + _x(2, seed=2)(P)),
    ("conv3d_transpose_fn", lambda P: lambda x, w:
     P.nn.functional.conv3d_transpose(x, w, stride=[2, 1, 1]),
     lambda P: _x(2, 3, 3, 4, 3)(P) + _x(3, 2, 2, 2, 2, seed=1)(P)),
    ("max_pool3d_fn", lambda P: lambda x: P.nn.functional.max_pool3d(
        x, [1, 2, 2]), _x(2, 3, 4, 4, 6)),
]


@pytest.mark.parametrize("name,factory,feed", FUNCTIONS,
                         ids=[c[0] for c in FUNCTIONS])
def test_function_matches_reference(name, factory, feed):
    _compare(factory, feed)


@pytest.fixture
def uniforms(monkeypatch):
    """Both packages' draws from the same numpy uniforms."""
    def draws(shape):
        return np.random.RandomState(11).rand(*shape).astype("float32")

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(
                            draws(tuple(shape))) < np.float32(p))
    monkeypatch.setattr(trand, "uniform", lambda key, shape, device:
                        __import__("torch").as_tensor(draws(tuple(shape))))


@pytest.mark.parametrize("layer,shape", [
    ("AlphaDropout", (4, 6)), ("Dropout3D", (2, 4, 2, 3, 2))])
def test_random_dropouts_match_reference(layer, shape, uniforms):
    want = _compare(lambda P: getattr(P.nn, layer)(0.4), _x(*shape))
    assert want["grad:in0"].std() > 0
    evals = [_run(P, names, lambda P: getattr(P.nn, layer)(0.4).eval(),
                  _x(*shape))[1]["out0"]
             for P, names in ((jp, jnames), (tp, tnames))]
    np.testing.assert_array_equal(evals[1], evals[0])


def _linear_with(P, util):
    lin = P.nn.Linear(5, 4)
    getattr(P.nn.utils, util)(lin) if util != "spectral_norm" else \
        P.nn.spectral_norm(lin, n_power_iterations=3)
    return lin


@pytest.mark.parametrize("util", ["weight_norm", "spectral_norm"])
def test_weight_reparameterisations_match_reference(util):
    _compare(lambda P: _linear_with(P, util), _x(3, 5))


def test_remove_weight_norm_matches_reference():
    def build(P):
        lin = P.nn.Linear(5, 4)
        P.nn.utils.weight_norm(lin, dim=None)
        lin(P.to_tensor(_data(3, 5)))
        return P.nn.utils.remove_weight_norm(lin)

    want = _compare(build, _x(3, 5))
    assert "grad:weight" in want


def test_quant_functional_layers_match_reference():
    for op in ("add", "subtract", "multiply", "divide"):
        _compare(lambda P: getattr(P.nn.quant, op)(),
                 lambda P: _x(3, 4)(P) + [P.to_tensor(
                     np.abs(_data(3, 4, seed=1)) + 0.5,
                     stop_gradient=False)])


def test_layer_dict_holds_its_layers():
    d = tp.nn.LayerDict({"a": tp.nn.Linear(2, 3), "b": tp.nn.ReLU()})
    assert list(d.keys()) == ["a", "b"] and len(d) == 2 and "a" in d
    d["c"] = tp.nn.Silu()
    assert len(list(d.parameters())) == 2 and len(d) == 3
    assert isinstance(d.pop("b"), tp.nn.ReLU) and "b" not in d
    d.update([("e", tp.nn.Linear(3, 1))])
    assert list(d) == ["a", "c", "e"] and len(list(d.parameters())) == 4
    d.clear()
    assert len(d) == 0


def test_ring_attention_without_a_mesh_is_attention():
    q, k, v = (tp.to_tensor(_data(1, 2, 8, 16, seed=s)) for s in range(3))
    got = tp.nn.functional.ring_attention(q, k, v, is_causal=True).numpy()
    want = tp.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_top_level_helpers_match_reference(capsys):
    def net(P, names):
        with names.guard():
            return P.nn.Sequential(P.nn.Linear(4, 3), P.nn.LayerNorm(3))

    want = jp.summary(net(jp, jnames))
    ref_table = capsys.readouterr().out
    got = tp.summary(net(tp, tnames))
    assert got == want and capsys.readouterr().out == ref_table
    for P in (jp, tp):
        P.check_shape([2, None, 3])
        with pytest.raises(TypeError):
            P.check_shape([2, "3"])
        P.monkey_patch_math_varbase()
        P.monkey_patch_variable()
        assert not P.is_compiled_with_npu() and not P.is_compiled_with_xpu()
    import torch

    assert tp.get_cudnn_version() == torch.backends.cudnn.version()
    assert tp.is_compiled_with_rocm() == (torch.version.hip is not None)
    old = np.get_printoptions()
    try:
        tp.set_printoptions(precision=3, sci_mode=False)
        assert np.get_printoptions()["precision"] == 3
    finally:
        np.set_printoptions(**old)
    assert tp.nn.functional.convert_dtype(tp.float32) == "float32"

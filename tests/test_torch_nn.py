"""The port's ``paddle.nn`` layers against the reference's, on carried
weights, on the CPU.

Each layer is built in both packages under fresh unique-name counters
(so parameter names agree), the reference layer's ``state_dict()``
is loaded into the port's, and the same seeded input runs forward; the
outputs, the input's gradient and every parameter's gradient of
``sum(out * g)`` (g seeded) agree to 1e-6 relative (1e-5 for the layers
that reduce over many elements).  Dropout layers draw the same injected
uniforms in both packages.  Also: the containers, ``state_dict`` keys
and round trips, BatchNorm's running statistics, and the functional
losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import random as trand
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.weights import load_paddle_state_dict


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


@pytest.fixture
def uniforms(monkeypatch):
    def draws(shape):
        return np.random.RandomState(11).rand(*shape).astype("float32")

    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None, **kw:
                        jnp.asarray(draws(tuple(shape))))
    monkeypatch.setattr(trand, "uniform", lambda key, shape, device:
                        torch.as_tensor(draws(tuple(shape))))


def _data(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


LAYERS = [
    ("Linear", lambda P: P.nn.Linear(6, 4), (3, 6)),
    ("Embedding", lambda P: P.nn.Embedding(10, 4, padding_idx=3), "ids"),
    ("Dropout_eval", lambda P: P.nn.Dropout(0.3).eval(), (3, 6)),
    ("Dropout_train", lambda P: P.nn.Dropout(0.3), (3, 6)),
    ("Dropout_axis", lambda P: P.nn.Dropout(0.5, axis=1), (3, 6)),
    ("Dropout2D", lambda P: P.nn.Dropout2D(0.4), (2, 3, 4, 4)),
    ("Flatten", lambda P: P.nn.Flatten(), (2, 3, 4)),
    ("Pad2D", lambda P: P.nn.Pad2D([1, 0, 2, 1], mode="reflect"),
     (1, 2, 4, 4)),
    ("Identity", lambda P: P.nn.Identity(), (3, 4)),
    ("CosineSimilarity", lambda P: P.nn.CosineSimilarity(axis=1), "pair"),
    ("Bilinear", lambda P: P.nn.Bilinear(3, 4, 5), "bilinear"),
    ("LayerNorm", lambda P: P.nn.LayerNorm([4, 6]), (2, 4, 6)),
    ("BatchNorm1D", lambda P: P.nn.BatchNorm1D(6), (8, 6)),
    ("BatchNorm2D", lambda P: P.nn.BatchNorm2D(3), (4, 3, 2, 2)),
    ("BatchNorm2D_eval", lambda P: P.nn.BatchNorm2D(3).eval(),
     (4, 3, 2, 2)),
    ("BatchNorm", lambda P: P.nn.BatchNorm(3, act="relu"), (4, 3, 2, 2)),
    ("GroupNorm", lambda P: P.nn.GroupNorm(2, 4), (2, 4, 3, 3)),
    ("InstanceNorm2D", lambda P: P.nn.InstanceNorm2D(3), (2, 3, 4, 4)),
    ("LocalResponseNorm", lambda P: P.nn.LocalResponseNorm(3),
     (2, 5, 3, 3)),
    ("Sequential", lambda P: P.nn.Sequential(
        P.nn.Linear(6, 5), P.nn.GELU(), P.nn.Linear(5, 3)), (4, 6)),
    ("LayerList", lambda P: _Stack(P), (4, 6)),
]
ACTS = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "GELU", "SiLU", "Swish", "Mish",
        "Hardswish", "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink",
        "Softplus", "Softsign", "Tanhshrink", "ThresholdedReLU",
        "LogSigmoid", "ELU", "SELU", "LeakyReLU", "Softmax", "LogSoftmax",
        "PReLU", "Maxout"]
LAYERS += [(a, (lambda a: lambda P: (P.nn.Maxout(2) if a == "Maxout"
                                     else getattr(P.nn, a)()))(a),
            (2, 4, 3, 3)) for a in ACTS]


def _Stack(P):
    class Stack(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.blocks = P.nn.LayerList([P.nn.Linear(6, 6)
                                          for _ in range(2)])
            self.extra = P.nn.ParameterList([self.create_parameter([6])])

        def forward(self, x):
            for b in self.blocks:
                x = P.tanh(b(x))
            return x * self.extra[0]

    return Stack()


def _inputs(P, spec):
    if spec == "ids":
        ids = np.array([[1, 3, 9], [0, 3, 5]], "int64")
        return [P.to_tensor(ids)]
    if spec == "pair":
        return [P.to_tensor(_data(3, 5), stop_gradient=False),
                P.to_tensor(_data(3, 5, seed=1), stop_gradient=False)]
    if spec == "bilinear":
        return [P.to_tensor(_data(2, 3), stop_gradient=False),
                P.to_tensor(_data(2, 4, seed=1), stop_gradient=False)]
    return [P.to_tensor(_data(*spec), stop_gradient=False)]


def _run(P, names, factory, spec, state=None):
    # one fresh name generator for the whole run: the reference's tape
    # tells tensors apart by name, so names made inside a guard must not
    # meet names made after it
    old = names.switch()
    try:
        return _run_named(P, factory, spec, state)
    finally:
        names.switch(old)


def _run_named(P, factory, spec, state):
    P.seed(0)
    layer = factory(P)
    if state is not None:
        load_paddle_state_dict(layer, state)
    init = {k: v.numpy() for k, v in layer.state_dict().items()}
    ins = _inputs(P, spec)
    out = layer(*ins)
    g = P.to_tensor(_data(*out.shape, seed=7))
    P.sum(out * g).backward()
    res = {"out": out.numpy()}
    for i, t in enumerate(ins):
        if not t.stop_gradient:
            res[f"in{i}"] = t.grad.numpy()
    for n, p in layer.named_parameters():
        res[f"grad:{n}"] = None if p.grad is None else p.grad.numpy()
    for n, v in layer.state_dict().items():
        res[f"state:{n}"] = v.numpy()
    return init, res


@pytest.mark.parametrize("name,factory,spec", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_reference(name, factory, spec, uniforms):
    state, want = _run(jp, jnames, factory, spec)
    _, got = _run(tp, tnames, factory, spec, state)
    assert sorted(got) == sorted(want)
    tol = 1e-5 if "Norm" in name else 1e-6
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol * max(
            1.0, float(np.abs(w).max()) if w.size else 0.0), err_msg=k)


def test_batchnorm_running_statistics_follow_the_reference():
    def run(P, names):
        with names.guard():
            bn = P.nn.BatchNorm2D(3, momentum=0.8)
        for i in range(3):
            bn(P.to_tensor(_data(4, 3, 2, 2, seed=i) * (i + 1) + i))
        bn.eval()
        out = bn(P.to_tensor(_data(4, 3, 2, 2, seed=9)))
        return {k: v.numpy() for k, v in bn.state_dict().items()}, \
            out.numpy()

    (js, jo), (ts, to) = run(jp, jnames), run(tp, tnames)
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)


def test_state_dict_keys_names_and_round_trip():
    def build(P, names):
        with names.guard():
            P.seed(0)
            return P.nn.Sequential(P.nn.Linear(4, 3), P.nn.LayerNorm(3),
                                   P.nn.BatchNorm1D(3))

    jm, tm = build(jp, jnames), build(tp, tnames)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [p.name for p in tm.parameters()] == [p.name for p in
                                                 jm.parameters()]
    load_paddle_state_dict(tm, {k: v.numpy() for k, v in
                                jm.state_dict().items()})
    saved = {k: v.numpy() for k, v in tm.state_dict().items()}
    other = build(tp, tnames)
    missing, unexpected = other.set_state_dict(saved)
    assert missing == [] and unexpected == []
    for k, v in other.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved[k])
    with pytest.raises(ValueError):
        load_paddle_state_dict(other, {"nope": np.zeros(3)})


LOSSES = [
    ("CrossEntropyLoss", lambda P: P.nn.CrossEntropyLoss(ignore_index=2),
     "ce"),
    ("CrossEntropyLoss_weight", lambda P: P.nn.CrossEntropyLoss(
        weight=P.to_tensor(np.arange(1, 6).astype("float32"))), "ce"),
    ("CrossEntropyLoss_soft", lambda P: P.nn.CrossEntropyLoss(
        soft_label=True, reduction="sum"), "soft"),
    ("MSELoss", lambda P: P.nn.MSELoss(), "reg"),
    ("L1Loss", lambda P: P.nn.L1Loss(reduction="sum"), "reg"),
    ("SmoothL1Loss", lambda P: P.nn.SmoothL1Loss(delta=0.5), "reg"),
    ("NLLLoss", lambda P: P.nn.NLLLoss(ignore_index=1), "nll"),
    ("BCELoss", lambda P: P.nn.BCELoss(), "bce"),
    ("BCEWithLogitsLoss", lambda P: P.nn.BCEWithLogitsLoss(
        pos_weight=P.to_tensor(np.full(5, 2.0, "float32"))), "bcel"),
    ("KLDivLoss", lambda P: P.nn.KLDivLoss(reduction="batchmean"), "kl"),
    ("MarginRankingLoss", lambda P: P.nn.MarginRankingLoss(0.1), "rank"),
]


def _loss_inputs(P, kind, x):
    r = np.random.RandomState(4)
    if kind == "ce":
        return [x, P.to_tensor(np.array([[0], [2], [4], [1]], "int64"))]
    if kind == "soft":
        p = r.rand(4, 5).astype("float32")
        return [x, P.to_tensor(p / p.sum(-1, keepdims=True))]
    if kind == "reg":
        return [x, P.to_tensor(r.randn(4, 5).astype("float32"))]
    if kind == "nll":
        return [P.nn.functional.log_softmax(x),
                P.to_tensor(np.array([0, 1, 4, 2], "int64"))]
    if kind == "bce":
        return [P.nn.functional.sigmoid(x),
                P.to_tensor((r.rand(4, 5) > 0.5).astype("float32"))]
    if kind == "bcel":
        return [x, P.to_tensor((r.rand(4, 5) > 0.5).astype("float32"))]
    if kind == "kl":
        p = r.rand(4, 5).astype("float32")
        return [P.nn.functional.log_softmax(x),
                P.to_tensor(p / p.sum(-1, keepdims=True))]
    return [x, P.to_tensor(r.randn(4, 5).astype("float32")),
            P.to_tensor(np.sign(r.randn(4, 5)).astype("float32"))]


@pytest.mark.parametrize("name,factory,kind", LOSSES,
                         ids=[c[0] for c in LOSSES])
def test_loss_layer_matches_reference(name, factory, kind):
    def run(P):
        x = P.to_tensor(np.random.RandomState(3).randn(4, 5).astype(
            "float32"), stop_gradient=False)
        loss = factory(P)(*_loss_inputs(P, kind, x))
        P.sum(loss).backward()
        return loss.numpy(), x.grad.numpy()

    (jl, jg), (tl, tg) = run(jp), run(tp)
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-7)


def test_functional_extras_match_reference():
    def run(P):
        F = P.nn.functional
        r = np.random.RandomState(4)
        x = P.to_tensor(r.randn(3, 4).astype("float32"), stop_gradient=False)
        outs = [F.normalize(x, axis=1), F.glu(x, axis=1),
                F.label_smooth(F.softmax(x)), F.one_hot(
                    P.to_tensor(np.array([0, 3, 1])), 4),
                F.sequence_mask(P.to_tensor(np.array([1, 3, 2])), 4),
                F.log_loss(F.sigmoid(x), P.to_tensor(
                    (r.rand(3, 4) > 0.5).astype("float32"))),
                F.sigmoid_focal_loss(x, P.to_tensor(
                    (r.rand(3, 4) > 0.5).astype("float32"))),
                F.dice_loss(F.softmax(x), P.to_tensor(
                    np.array([[0], [3], [1]]))),
                F.square_error_cost(x, x * 0.5),
                F.accuracy(x, P.to_tensor(np.array([[0], [3], [1]])), k=2)]
        P.sum(outs[0] * outs[1].mean()).backward()
        return [o.numpy() for o in outs] + [x.grad.numpy()]

    for i, (g, w) in enumerate(zip(run(tp), run(jp))):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                   err_msg=str(i))

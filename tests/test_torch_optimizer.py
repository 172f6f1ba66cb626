"""The port's optimizers, schedulers, gradient clips and regularizers
against the reference's, on the CPU.

* Every optimizer, 3 steps on a small two-layer model with carried
  weights: parameters to 2e-5 absolute (``tests/test_torch_train.py``'s
  tolerance: a normalising update such as Adam's or RMSProp's turns a
  last-bit difference of a small gradient into up to ~lr of a weight),
  optimizer state (same keys, ``{param}_{acc}_0``) to 2e-5 relative to
  each tensor's scale (the moments behind a normalised update, RMSProp's
  momentum or Adadelta's update average, inherit the same
  amplification).
* Every learning-rate scheduler's values over 20 steps (1e-12).
* ``ClipGradByValue`` / ``ByNorm`` / ``ByGlobalNorm``, ``L1Decay`` /
  ``L2Decay`` on the same (param, grad) pairs (1e-6).
* State-dict round trips: the reference's optimizer state loaded into
  the port's optimizer continues as the reference does, and the port's
  own state dict restores an optimizer that continues as the original.
"""

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.weights import (load_optimizer_state,
                                      load_paddle_state_dict,
                                      optimizer_state_to_numpy)

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _data(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


OPTIMIZERS = [
    ("SGD", lambda O, ps: O.SGD(0.1, parameters=ps)),
    ("SGD_l2", lambda O, ps: O.SGD(0.1, parameters=ps, weight_decay=0.05)),
    ("Momentum", lambda O, ps: O.Momentum(0.05, 0.8, parameters=ps,
                                          use_nesterov=True)),
    ("LarsMomentum", lambda O, ps: O.LarsMomentum(0.1, parameters=ps)),
    ("Adam", lambda O, ps: O.Adam(0.01, parameters=ps, beta1=0.8)),
    ("AdamW", lambda O, ps: O.AdamW(0.01, parameters=ps, weight_decay=0.1,
                                    apply_decay_param_fun=lambda n:
                                    n.endswith("w_0"))),
    ("Lamb", lambda O, ps: O.Lamb(0.01, parameters=ps)),
    ("RMSProp", lambda O, ps: O.RMSProp(0.01, parameters=ps, centered=True,
                                        momentum=0.5)),
    ("Adagrad", lambda O, ps: O.Adagrad(0.1, parameters=ps,
                                        initial_accumulator_value=0.1)),
    ("Adadelta", lambda O, ps: O.Adadelta(1.0, parameters=ps)),
    ("Adamax", lambda O, ps: O.Adamax(0.01, parameters=ps)),
    ("Adam_clip", lambda O, ps: O.Adam(
        0.01, parameters=ps, grad_clip=_pkg(O).nn.ClipGradByGlobalNorm(
            0.1))),
]


def _pkg(O):
    return jp if O.__name__.startswith("paddle_tpu.") else tp


def _model(P):
    return P.nn.Sequential(P.nn.Linear(4, 3), P.nn.Tanh(),
                           P.nn.Linear(3, 2))


def _train(P, names, make_opt, steps=3, state=None, opt_state=None):
    old = names.switch()
    try:
        P.seed(0)
        model = _model(P)
        if state is not None:
            load_paddle_state_dict(model, state)
        init = {k: v.numpy() for k, v in model.state_dict().items()}
        opt = make_opt(P.optimizer, model.parameters())
        if opt_state is not None:
            load_optimizer_state(opt, opt_state)
        x = P.to_tensor(_data(5, 4, seed=1))
        for _ in range(steps):
            loss = P.mean(model(x) ** 2)
            loss.backward()
            opt.step()
            opt.clear_grad()
        params = {k: v.numpy() for k, v in model.state_dict().items()}
        ostate = {k: (v if k == "LR_Scheduler" else np.asarray(v.numpy()))
                  for k, v in opt.state_dict().items()}
        return init, params, ostate, opt
    finally:
        names.switch(old)


def _same(got, want, atol=None):
    """Equal keys; values to ``atol`` absolute, or else to 2e-5 relative
    to each tensor's scale."""
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "LR_Scheduler":
            assert got[k] == want[k]
            continue
        w = np.asarray(want[k])
        tol = atol if atol is not None else 2e-5 * float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("name,make", OPTIMIZERS,
                         ids=[o[0] for o in OPTIMIZERS])
def test_three_steps_match_reference(name, make):
    init, jparams, jstate, _ = _train(jp, jnames, make)
    _, tparams, tstate, topt = _train(tp, tnames, make, state=init)
    _same(tparams, jparams, atol=2e-5)
    _same(tstate, jstate)
    _same(optimizer_state_to_numpy(topt), jstate)


SCHEDULERS = [
    ("NoamDecay", lambda L: L.NoamDecay(64, 5, learning_rate=2.0)),
    ("PiecewiseDecay", lambda L: L.PiecewiseDecay([3, 8], [0.1, 0.05,
                                                           0.01])),
    ("NaturalExpDecay", lambda L: L.NaturalExpDecay(0.5, 0.1)),
    ("InverseTimeDecay", lambda L: L.InverseTimeDecay(0.5, 0.1)),
    ("PolynomialDecay", lambda L: L.PolynomialDecay(0.5, 7, end_lr=0.01,
                                                    power=2.0, cycle=True)),
    ("LinearWarmup", lambda L: L.LinearWarmup(
        L.PolynomialDecay(0.1, 10), warmup_steps=5, start_lr=0.0,
        end_lr=0.1)),
    ("LinearWarmup_float", lambda L: L.LinearWarmup(0.3, 4, 0.01, 0.3)),
    ("ExponentialDecay", lambda L: L.ExponentialDecay(0.5, 0.9)),
    ("MultiStepDecay", lambda L: L.MultiStepDecay(0.5, [2, 5, 11], 0.5)),
    ("StepDecay", lambda L: L.StepDecay(0.5, 3, 0.7)),
    ("LambdaDecay", lambda L: L.LambdaDecay(0.5, lambda e: 0.95 ** e)),
    ("CosineAnnealingDecay", lambda L: L.CosineAnnealingDecay(0.5, 6,
                                                              0.05)),
    ("ReduceOnPlateau", lambda L: L.ReduceOnPlateau(0.5, patience=2,
                                                    factor=0.5)),
]


@pytest.mark.parametrize("name,make", SCHEDULERS,
                         ids=[s[0] for s in SCHEDULERS])
def test_scheduler_values_over_20_steps(name, make):
    def run(L):
        s = make(L)
        out = []
        for i in range(20):
            out.append(s())
            if name == "ReduceOnPlateau":
                s.step(1.0 if i < 4 else 2.0)
            else:
                s.step()
        return out, s.state_dict()

    (jv, js), (tv, ts) = run(jp.optimizer.lr), run(tp.optimizer.lr)
    np.testing.assert_allclose(tv, jv, rtol=1e-12)
    assert ts == js


CLIPS = [
    ("ClipGradByValue", lambda P: P.nn.ClipGradByValue(0.3, -0.2)),
    ("ClipGradByNorm", lambda P: P.nn.ClipGradByNorm(0.5)),
    ("ClipGradByGlobalNorm", lambda P: P.nn.ClipGradByGlobalNorm(0.7)),
    ("L1Decay", lambda P: _regular(P.regularizer.L1Decay(0.1))),
    ("L2Decay", lambda P: _regular(P.regularizer.L2Decay(0.1))),
]


def _regular(reg):
    return lambda pairs: [(p, reg(p, g)) for p, g in pairs]


@pytest.mark.parametrize("name,make", CLIPS, ids=[c[0] for c in CLIPS])
def test_clips_and_regularizers_match_reference(name, make):
    def run(P):
        pairs = [(P.to_tensor(_data(3, 4, seed=i), stop_gradient=False),
                  P.to_tensor(_data(3, 4, seed=10 + i)))
                 for i in range(3)]
        return [g.numpy() for _, g in make(P)(pairs)]

    for g, w in zip(run(tp), run(jp)):
        np.testing.assert_allclose(g, w, **TOL)


def test_reference_optimizer_state_continues_in_the_port():
    make = OPTIMIZERS[4][1]  # Adam
    init, _, _, _ = _train(jp, jnames, make, steps=0)
    _, mid, mid_state, _ = _train(jp, jnames, make, steps=2)
    _, jend, jstate, _ = _train(jp, jnames, make, steps=3)
    # two reference steps, then one in the port from the carried state
    mid_state = {k: v for k, v in mid_state.items() if k != "LR_Scheduler"}
    _, tend, tstate, _ = _train(tp, tnames, make, steps=1, state=mid,
                                opt_state=mid_state)
    _same(tend, jend, atol=2e-5)
    _same(tstate, jstate)
    assert init  # the model was built


def test_port_state_dict_round_trip():
    make = OPTIMIZERS[5][1]  # AdamW
    _, full, full_state, _ = _train(tp, tnames, make, steps=3)
    _, mid, mid_state, _ = _train(tp, tnames, make, steps=2)
    _, end, end_state, _ = _train(tp, tnames, make, steps=1, state=mid,
                                  opt_state=mid_state)
    for k in full:
        np.testing.assert_array_equal(end[k], full[k])
    _same(end_state, full_state)

"""``paddle.amp`` in the port against the reference, on the CPU.

* Every op's O1 / O2 cast decision: the white-list, black-list and other
  ops run under ``auto_cast`` in both packages on fp32 (and bf16)
  inputs; the output dtypes agree exactly and the values to bf16's
  rounding (1e-2 relative).
* Under ``auto_cast`` a Linear's bf16 product hands its gradient back to
  the fp32 parameter (fp32 gradients, equal to the reference's to 1e-2).
* ``GradScaler``: the loss-scale state machine over a schedule of steps
  with and without overflowing gradients, and the updates it lets
  through, exactly (the scales are powers of two).
* ``decorate(level="O2")``: bf16 parameters, fp32 master weights, and
  one AdamW step equal to the reference's.
"""

import numpy as np
import pytest

import paddle_tpu as jp

import paddle_tpu_torch as tp

LOW = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _data(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _f32(t):
    return t.astype("float32").numpy()


OPS = [
    ("matmul_v2", lambda P, a, b: P.matmul(a, b)),
    ("mul_op", lambda P, a, b: P.nn.functional.linear(a, b)),
    ("sdpa", lambda P, a, b: P.nn.functional.scaled_dot_product_attention(
        P.reshape(a, [1, 1, 4, 4]), P.reshape(b, [1, 1, 4, 4]),
        P.reshape(b, [1, 1, 4, 4]))),
    ("softmax", lambda P, a, b: P.nn.functional.softmax(a)),
    ("layer_norm", lambda P, a, b: P.nn.functional.layer_norm(a, 4)),
    ("reduce_sum", lambda P, a, b: P.sum(a, axis=1)),
    ("reduce_mean", lambda P, a, b: P.mean(a)),
    ("exp", lambda P, a, b: P.exp(a)),
    ("swce", lambda P, a, b: P.nn.functional.softmax_with_cross_entropy(
        a, P.to_tensor(np.array([[0], [1], [2], [3]])))),
    ("elementwise_add", lambda P, a, b: a + b),
    ("relu", lambda P, a, b: P.nn.functional.relu(a)),
    ("gelu", lambda P, a, b: P.nn.functional.gelu(a)),
    ("transpose", lambda P, a, b: P.transpose(a, [1, 0])),
    ("mixed", lambda P, a, b: P.matmul(a, b) + a),
]


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,fn", OPS, ids=[o[0] for o in OPS])
def test_cast_decision_matches_reference(name, fn, level, in_dtype):
    def run(P):
        a = P.to_tensor(_data(4, 4)).astype(in_dtype)
        b = P.to_tensor(_data(4, 4, seed=1)).astype(in_dtype)
        with P.amp.auto_cast(level=level):
            out = fn(P, a, b)
        return out.dtype, _f32(out)

    (jd, jv), (td, tv) = run(jp), run(tp)
    assert str(td) == str(jd)
    np.testing.assert_allclose(tv, jv, **LOW)


def test_gradients_reach_the_fp32_parameters():
    def run(P):
        P.seed(0)
        lin = P.nn.Linear(4, 3)
        lin.set_state_dict({"weight": _data(4, 3), "bias": _data(3, seed=1)})
        x = P.to_tensor(_data(5, 4, seed=2))
        with P.amp.auto_cast():
            out = lin(x)
            loss = P.mean(out * out)
        loss.backward()
        return (out.dtype, loss.dtype, lin.weight.grad.dtype,
                lin.weight.grad.numpy(), lin.bias.grad.numpy())

    want, got = run(jp), run(tp)
    assert [str(v) for v in got[:3]] == [str(v) for v in want[:3]]
    assert got[2] == "float32"
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g, w, **LOW)


def test_grad_scaler_state_machine():
    overflow = [False, False, True, False, True, True, False, False, False]

    def run(P):
        p = P.to_tensor(_data(3), stop_gradient=False)
        opt = P.optimizer.SGD(0.5, parameters=[p])
        scaler = P.amp.GradScaler(init_loss_scaling=1024.0, incr_ratio=2.0,
                                  decr_ratio=0.5, incr_every_n_steps=2,
                                  decr_every_n_nan_or_inf=2)
        trace = []
        for bad in overflow:
            loss = scaler.scale(P.sum(p * p))
            loss.backward()
            if bad:
                g = np.array(p.grad.numpy())
                g[0] = np.inf
                p.grad = P.to_tensor(g)
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            trace.append((scaler.get_loss_scaling(),
                          scaler.state_dict()["incr_count"],
                          scaler.state_dict()["decr_count"]))
        return trace, p.numpy()

    (jt, jv), (tt, tv) = run(jp), run(tp)
    assert tt == jt
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_decorate_o2_keeps_fp32_masters():
    def run(P):
        P.seed(0)
        model = P.nn.Linear(4, 3)
        model.set_state_dict({"weight": _data(4, 3),
                              "bias": _data(3, seed=1)})
        opt = P.optimizer.AdamW(0.01, parameters=model.parameters())
        model, opt = P.amp.decorate(model, opt, level="O2")
        x = P.to_tensor(_data(5, 4, seed=2)).astype("bfloat16")
        with P.amp.auto_cast(level="O2"):
            out = model(x)
        loss = P.mean(out.astype("float32") ** 2)
        loss.backward()
        opt.step()
        masters = opt._accumulators["master_weight"]
        return (model.weight.dtype, masters[model.weight.name].dtype,
                _f32(model.weight), masters[model.weight.name].numpy())

    want, got = run(jp), run(tp)
    assert [str(v) for v in got[:2]] == [str(v) for v in want[:2]]
    assert got[0] == "bfloat16" and got[1] == "float32"
    np.testing.assert_allclose(got[3], want[3], **LOW)
    np.testing.assert_allclose(got[2], want[2], **LOW)


def test_o2_casts_a_tensor_that_needs_a_gradient():
    """Under O2 an fp32 tensor that needs a gradient reaches a non-black
    op through a traced cast; the cast op itself is not cast again (the
    reference's O2 recurses there), and the gradient comes back in
    fp32."""
    w = tp.to_tensor(_data(4), stop_gradient=False)
    with tp.amp.auto_cast(level="O2"):
        y = w * 2.0
    assert y.dtype == "bfloat16"
    tp.sum(y.astype("float32")).backward()
    assert w.grad.dtype == "float32"
    np.testing.assert_array_equal(w.grad.numpy(), np.full(4, 2.0, "float32"))


def _registered_ops():
    from paddle_tpu.ops import registry as jreg

    from paddle_tpu_torch.ops import registry as treg

    return sorted(set(treg.all_ops()) & set(jreg.all_ops()))


@pytest.mark.parametrize("op", _registered_ops())
def test_every_ops_cast_decision_matches_reference(op):
    """The amp hook's decision for every op both registries hold: the
    dtypes it hands each input slot, under O1 and O2, for fp32, bf16
    and int64 inputs, in both packages."""
    import importlib

    # the module (the packages export the function under the same name)
    jac = importlib.import_module("paddle_tpu.amp.auto_cast")
    tac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

    def decide(P, ac):
        out = []
        for level in ("O1", "O2"):
            amp = ac.AmpState(True, "bfloat16", level)
            ins = {"A": [P.to_tensor(_data(2))],
                   "B": [P.to_tensor(_data(2)).astype("bfloat16")],
                   "C": [P.to_tensor(np.arange(2))]}
            cast, _ = ac.maybe_autocast_inputs(amp, op, ins, {})
            out.append({s: [str(t.dtype) for t in ts]
                        for s, ts in cast.items()})
        return out

    got, want = decide(tp, tac), decide(jp, jac)
    if op == "cast":
        # the one recorded difference: the port never casts the inputs of
        # a cast op (the amp casts are cast ops; under O2 the reference's
        # recurses on a tensor that needs a gradient)
        assert got[0] == want[0]
        assert got[1] == {"A": ["float32"], "B": ["bfloat16"],
                          "C": ["int64"]}
        return
    assert got == want

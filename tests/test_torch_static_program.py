"""Graph mode's program building against the reference, on the CPU.

Programs built in both packages under fresh unique-name counters
(``tests/torch_static_parity.py``) must agree op for op: types, input
and output slots with their variable names, and every variable's
inferred shape, dtype and flags; ``append_backward``'s grad ops (their
``@GRAD`` names, ``fill_zeros_like`` and the accumulation of renamed
gradients) and the optimizer's update ops too.  Also the Variable's
operator overloads, ``clone(for_test=True)`` and the dict form, the
static amp rewrite's casts, the mode switch, and ``Executor()``'s place.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import place as tplace
from paddle_tpu_torch.framework import program as tfw
from paddle_tpu_torch.static import amp as tamp

from paddle_tpu.static import amp as jamp

from torch_static_parity import (  # noqa: F401
    build, op_list, reference_variable_indexing, var_table)


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    tp.disable_static()


def _mlp(P, st, optimizer=None):
    x = st.data("x", [-1, 8], "float32")
    y = st.data("y", [-1, 1], "int64")
    h = P.nn.functional.relu(P.nn.Linear(8, 16)(x))
    h = P.nn.functional.dropout(h, p=0.1)
    logits = P.nn.Linear(16, 4)(h)
    loss = P.mean(P.nn.functional.softmax_with_cross_entropy(logits, y))
    if optimizer is not None:
        optimizer(P).minimize(loss)
    return loss


def _conv(P, st, optimizer=None):
    img = st.data("img", [-1, 3, 12, 12], "float32")
    label = st.data("label", [-1, 1], "int64")
    h = P.nn.Conv2D(3, 4, 3, padding=1)(img)
    h = P.nn.BatchNorm2D(4)(h)
    h = P.nn.functional.max_pool2d(P.nn.functional.relu(h), 2, 2)
    h = P.reshape(h, [-1, 4 * 6 * 6])
    logits = st.nn.fc(h, 5)
    loss = P.mean(P.nn.functional.cross_entropy(logits, label))
    if optimizer is not None:
        optimizer(P).minimize(loss)
    return loss


def _bert(P, st, optimizer=None):
    from importlib import import_module

    bert = import_module(P.__name__ + ".models.bert")
    cfg = bert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                          num_heads=4, max_seq_len=16)
    model = bert.BertForPretraining(cfg)
    ids = st.data("ids", [2, 16], "int64")
    tt = st.data("tt", [2, 16], "int64")
    pos = st.data("pos", [6], "int64")
    mlm = st.data("mlm", [6, 1], "int64")
    nsp = st.data("nsp", [2, 1], "int64")
    logits, nsp_logits = model(ids, tt, masked_positions=pos)
    loss = bert.BertPretrainingCriterion()(logits, nsp_logits, mlm, nsp, 6.0)
    if optimizer is not None:
        optimizer(P).minimize(loss)
    return loss


OPTIMIZERS = {
    "adam": lambda P: P.optimizer.Adam(learning_rate=1e-3),
    "adamw_clip": lambda P: P.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01,
        grad_clip=P.nn.ClipGradByGlobalNorm(1.0)),
    "momentum_l2": lambda P: P.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9,
        weight_decay=P.regularizer.L2Decay(1e-4)),
    "lamb": lambda P: P.optimizer.Lamb(learning_rate=1e-3),
    "sgd": lambda P: P.optimizer.SGD(learning_rate=0.1),
}


@pytest.mark.parametrize("net", [_mlp, _conv], ids=["mlp", "conv"])
def test_forward_program_matches_reference(net):
    """Op types, slots, names, and every variable's shape (the -1 batch
    kept), dtype and flags; the startup program's initializer ops with
    their attributes."""
    jm, js, _ = build("ref", net)
    tm, ts, _ = build("port", net)
    assert op_list(tm) == op_list(jm)
    assert var_table(tm) == var_table(jm)
    assert [(o.type, o.outputs, o.attrs) for o in ts.global_block().ops] == \
        [(o.type, o.outputs, o.attrs) for o in js.global_block().ops]
    assert var_table(ts) == var_table(js)


@pytest.mark.parametrize("net,opt", [
    (_mlp, "adam"), (_mlp, "adamw_clip"), (_mlp, "lamb"),
    (_conv, "momentum_l2"), (_conv, "sgd"), (_bert, "adamw_clip")],
    ids=["mlp-adam", "mlp-adamw_clip", "mlp-lamb", "conv-momentum_l2",
         "conv-sgd", "bert-adamw_clip"])
def test_append_backward_matches_reference(net, opt,
                                           reference_variable_indexing):
    """The whole training program after ``minimize``: the grad ops
    (``<type>_grad``, the hand-written ones, ``fill_zeros_like``, the
    ``@RENAME@`` accumulations), the clip and regularizer ops, the
    accumulators and the update ops, with every variable's shape."""
    fn = lambda P, st: net(P, st, OPTIMIZERS[opt])  # noqa: E731
    jm, js, _ = build("ref", fn)
    tm, ts, _ = build("port", fn)
    assert op_list(tm) == op_list(jm)
    assert var_table(tm) == var_table(jm)
    assert op_list(ts) == op_list(js)
    grads = [o.type for o in tm.global_block().ops if o.type.endswith("_grad")]
    assert grads, "no grad ops"


def test_variable_overloads_match_reference():
    """The Tensor's operators on a static Variable append the reference's
    ops (scalars as ``fill_constant`` of the other side's dtype)."""
    def fn(P, st):
        x = st.data("x", [4, 3], "float32")
        w = st.data("w", [3, 2], "float32")
        outs = [x + 1, 2 * x, x - x, -x, x @ w, x / 2.0, x ** 2, 1 - x,
                x > 0.5, x.astype("float64"), P.numel(x), x.cast("int32"),
                x.sum(), x.mean(axis=1)]
        return outs

    jm, _, _ = build("ref", fn)
    tm, _, outs = build("port", fn)
    assert op_list(tm) == op_list(jm)
    assert var_table(tm) == var_table(jm)
    assert all(isinstance(o, tfw.Variable) for o in outs)
    with pytest.raises(TypeError, match="undefined in a static graph"):
        bool(outs[0])


def test_clone_for_test_and_dict_form():
    """``clone(for_test=True)`` sets ``is_test`` on dropout and
    batch_norm; the dict form round-trips and equals the reference's."""
    jm, _, _ = build("ref", _conv)
    tm, _, _ = build("port", _conv)

    def canon(d):  # variables by name (a kernel's output order differs)
        for b in d["blocks"]:
            b["vars"] = sorted(b["vars"], key=lambda v: v["name"])
        return d

    assert canon(tm.to_dict()) == canon(jm.to_dict())
    again = tfw.Program.from_dict(tm.to_dict())
    assert again.to_dict() == tm.to_dict()
    test = tm.clone(for_test=True)
    assert [o.attrs["is_test"] for o in test.global_block().ops
            if o.type == "batch_norm"] == [True]
    assert [o.attrs.get("is_test") for o in tm.global_block().ops
            if o.type == "batch_norm"] == [False]
    v0 = tm.version
    tm.global_block().append_op("scale", {"X": ["img"]}, {"Out": ["s"]},
                                {"scale": 2.0})
    assert tm.version == v0 + 1
    assert tm.global_block().var("s").shape == (-1, 3, 12, 12)


def _amp_net(bias):
    def fn(P, st):
        x = st.data("x", [4, 8], "float32")
        h = st.nn.fc(x, 16, bias_attr=None if bias else False)
        h = P.nn.functional.relu(h)
        h = st.nn.fc(h, 8, bias_attr=None if bias else False)
        return P.mean(P.nn.functional.softmax(h))

    return fn


def _casts(program):
    return [(o.inputs["X"][0], o.attrs["out_dtype"])
            for o in program.global_block().ops if o.type == "cast"]


def test_static_amp_cast_placement():
    """``rewrite_program``'s casts: without biases (every gray op over
    bf16 inputs) exactly the reference's; with a bias add (bf16 + fp32,
    which promotes to fp32) the port casts its output before the next
    matmul, as ``auto_cast`` O1 casts a matmul's inputs, where the
    reference leaves it fp32 beside a bf16 weight."""
    jm, _, _ = build("ref", _amp_net(False))
    tm, _, _ = build("port", _amp_net(False))
    jamp.rewrite_program(jm)
    tamp.rewrite_program(tm)
    assert op_list(tm) == op_list(jm)
    assert _casts(tm) == [("x", "bfloat16"), ("linear_0.w_0", "bfloat16"),
                          ("linear_1.w_0", "bfloat16"),
                          ("matmul_v2_out_1", "float32")]
    jm, _, _ = build("ref", _amp_net(True))
    tm, _, _ = build("port", _amp_net(True))
    jamp.rewrite_program(jm)
    tamp.rewrite_program(tm)
    want = ("relu_out_0", "bfloat16")
    assert want in _casts(tm) and want not in _casts(jm)
    # the attention op is white: its q, k, v are cast to bf16
    assert "scaled_dot_product_attention" in \
        tamp.AutoMixedPrecisionLists().white_list


def test_mode_switch_routes_dispatch():
    """``enable_static()`` makes the paddle functions append ops to the
    current program; ``disable_static()`` runs them eagerly again."""
    assert tp.in_dygraph_mode()
    main = tp.static.Program()
    tp.enable_static()
    try:
        assert not tp.in_dygraph_mode()
        with tp.static.program_guard(main):
            v = tp.ones([2, 3]) * 3.0
        assert isinstance(v, tfw.Variable) and v.shape == (2, 3)
        assert [o.type for o in main.global_block().ops] == \
            ["fill_constant", "fill_constant", "elementwise_mul"]
    finally:
        tp.disable_static()
    t = tp.ones([2, 3]) * 3.0
    assert isinstance(t, tp.Tensor) and float(t.numpy().sum()) == 18.0


def test_executor_without_a_place_takes_the_card(monkeypatch):
    """``Executor()`` takes the current place, the card (``gpu:0``) by
    default, without a CUDA call; without a card its first run raises
    with the device policy's message instead of running on the CPU."""
    monkeypatch.setattr(tplace._state, "place", None, raising=False)
    monkeypatch.delenv("PADDLE_TPU_DEVICE", raising=False)

    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call")

    with monkeypatch.context() as m:
        for name in ("is_available", "current_device", "device_count",
                     "init"):
            m.setattr(torch.cuda, name, no_cuda)
        exe = tp.static.Executor()
    assert exe.place == tp.CUDAPlace(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = tp.static.Program()
    with pytest.raises(RuntimeError, match="set_device\\('cpu'\\)"):
        exe.run(prog)

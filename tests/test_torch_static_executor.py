"""The static Executor against the reference's, on the CPU; and on the
card (marked ``cuda``), the small static BERT against its CPU run and
the flash launches of a static step.

The CPU tests build each program in both packages, run the reference's
startup program and carry its values into the port
(``static.set_program_state``), then step both Executors on the same
feeds (``tests/torch_static_parity.py``): an MLP over 30 Adam steps
(losses within 1e-5 relative), a 2-layer BERT (hidden 64, 4 heads, seq
16) over 3 AdamW steps (1e-4; the attention op runs its plain version
here, and its grad op takes dQ, dK and dV from the forward's kept
autograd graph), ``cond`` and ``while_loop`` (a counted loop's
gradient too), the ``static.nn`` builders, the learning-rate scheduler's
sync into the scope.  Then the port alone: one attention forward a
layer a step, inference models, static io, feeds and fetches, the
NaN/Inf check.

The reference (JAX) is imported inside the CPU tests only, so the card
tests run where only the port is installed::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_static_executor.py -m cuda
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tp
from paddle_tpu_torch import static as tst
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.framework.scope import Scope, scope_guard


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    tp.disable_static()


@pytest.fixture
def parity(monkeypatch):
    """tests/torch_static_parity.py, with the reference's Variable
    indexed as the port's is (its BERT takes ``qkv[0]``)."""
    import torch_static_parity as sp

    sp.give_reference_variable_indexing(monkeypatch)
    return sp


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def _mlp(P, st):
    x = st.data("x", [-1, 8], "float32")
    y = st.data("y", [-1, 1], "int64")
    h = P.nn.functional.relu(P.nn.Linear(8, 32)(x))
    logits = P.nn.Linear(32, 4)(h)
    loss = P.mean(P.nn.functional.softmax_with_cross_entropy(logits, y))
    P.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return loss


def _mlp_feed(i):
    r = np.random.RandomState(i)
    return {"x": r.randn(16, 8).astype("float32"),
            "y": r.randint(0, 4, (16, 1)).astype("int64")}


def test_mlp_adam_30_steps_match_reference(parity):
    got_j, got_t = parity.run_both(_mlp, lambda i: _mlp_feed(0),
                                   lambda loss: [loss], steps=30)
    lj = [float(v[0]) for v in got_j]
    lt = [float(v[0]) for v in got_t]
    assert _rel(lt, lj) <= 1e-5, (lt, lj)
    assert lt[-1] < lt[0]


BERT = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=16)
B, S, M = 2, 16, 6


def _bert(P, st, amp=False):
    from importlib import import_module

    bert = import_module(P.__name__ + ".models.bert")
    model = bert.BertForPretraining(bert.BertConfig(**BERT))
    ids = st.data("ids", [B, S], "int64")
    tt = st.data("tt", [B, S], "int64")
    pos = st.data("pos", [M], "int64")
    mlm = st.data("mlm", [M, 1], "int64")
    nsp = st.data("nsp", [B, 1], "int64")
    logits, nsp_logits = model(ids, tt, masked_positions=pos)
    loss = bert.BertPretrainingCriterion()(logits, nsp_logits, mlm, nsp,
                                           float(M))
    opt = P.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01)
    if amp:
        opt = st.amp.decorate(opt)
    opt.minimize(loss)
    return loss, logits


def _bert_feed(i=0):
    r = np.random.RandomState(i)
    return {"ids": r.randint(0, 64, (B, S)).astype("int64"),
            "tt": (r.rand(B, S) > 0.5).astype("int64"),
            "pos": r.choice(B * S, M, replace=False).astype("int64"),
            "mlm": r.randint(0, 64, (M, 1)).astype("int64"),
            "nsp": r.randint(0, 2, (B, 1)).astype("int64")}


def test_bert_static_step_matches_reference(parity):
    """A 2-layer BERT's static AdamW step, 3 steps: losses and the MLM
    logits within 1e-4 relative."""
    got_j, got_t = parity.run_both(_bert, _bert_feed, lambda out: list(out),
                                   steps=3)
    for (lj, gj), (lt, gt) in zip(got_j, got_t):
        assert _rel(lt, lj) <= 1e-4
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5)


def test_forward_runs_once_a_step(monkeypatch):
    """Each attention forward runs once a step: its grad op takes the
    gradients from the forward's kept graph instead of running it again
    (which would count two calls a layer)."""
    from paddle_tpu_torch.kernels import attention

    main, startup, (loss, _) = _port_build(_bert)
    calls = []
    real = attention.sdpa
    monkeypatch.setattr(attention, "sdpa",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    exe = tst.Executor(tp.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        grads = [o.type for o in main.global_block().ops
                 if o.type == "scaled_dot_product_attention_grad"]
        assert len(grads) == BERT["num_layers"]
        for i in range(2):
            exe.run(main, feed=_bert_feed(i), fetch_list=[loss])
    assert len(calls) == 2 * BERT["num_layers"]


def _port_build(fn):
    main, startup = tst.Program(), tst.Program()
    tp.enable_static()
    try:
        with tst.program_guard(main, startup), tnames.guard():
            out = fn(tp, tst)
    finally:
        tp.disable_static()
    return main, startup, out


def _cond(P, st):
    a = st.data("a", [1], "float32")
    b = st.data("b", [1], "float32")
    return [st.nn.cond(P.less_than(a, b), lambda: a + b, lambda: a - b)]


def _while_dynamic(P, st):
    v = st.data("a", [1], "float32")
    limit = P.full([1], 100.0, "float32")
    return st.nn.while_loop(lambda v: P.less_than(v, limit),
                            lambda v: [v * 2.0], [v])


def _while_counted_grad(P, st):
    x = st.data("x", [4, 8], "float32")
    x.stop_gradient = False
    w = P.create_parameter([8, 8], "float32")
    i = P.full([1], 0, "int64")
    steps = P.full([1], 3, "int64")

    def body(i, h):
        return P.increment(i, 1), P.tanh(P.matmul(h, w))

    _, h = st.nn.while_loop(lambda i, h: P.less_than(i, steps), body, [i, x])
    loss = P.mean(h)
    pg = st.append_backward(loss)
    return [loss, pg[0][1], x.name + "@GRAD"]


def _switch(P, st):
    a = st.data("a", [1], "float32")
    idx = P.full([1], 1, "int64")
    return [st.nn.switch_case(idx, [lambda: a * 2.0, lambda: a * 3.0,
                                    lambda: a * 4.0]),
            st.nn.case([(P.less_than(a, P.full([1], 0.0)), lambda: -a)],
                       default=lambda: a + 1.0)]


@pytest.mark.parametrize("fn,feeds", [
    (_cond, [{"a": [3.0], "b": [5.0]}, {"a": [7.0], "b": [5.0]}]),
    (_while_dynamic, [{"a": [3.0]}]),
    (_while_counted_grad, [{"x": np.random.RandomState(0).randn(4, 8)}]),
    (_switch, [{"a": [2.0]}, {"a": [-2.0]}])],
    ids=["cond", "while_dynamic", "while_counted_grad", "case_switch"])
def test_control_flow_matches_reference(parity, fn, feeds):
    """``cond`` / ``while_loop`` / ``case`` / ``switch_case`` values, and
    a counted loop's parameter and input gradients, equal the
    reference's."""
    feeds = [{k: np.asarray(v, "float32") for k, v in f.items()}
             for f in feeds]
    progs = (parity.build("ref", fn), parity.build("port", fn))
    got_j, got_t = parity.run_both(None, lambda i: feeds[i], lambda o: o,
                                   steps=len(feeds), programs=progs)
    for gj, gt in zip(got_j, got_t):
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_dynamic_loop_on_the_gradient_path_raises():
    def fn(P, st):
        v = st.data("v", [1], "float32")
        v.stop_gradient = False
        limit = P.full([1], 100.0, "float32")
        (out,) = st.nn.while_loop(lambda v: P.less_than(v, limit),
                                  lambda v: [v * 2.0], [v])
        st.append_backward(P.mean(out))

    with pytest.raises(RuntimeError, match="dynamic lax.while_loop"):
        _port_build(fn)


def _builders(P, st):
    x = st.data("x", [4, 6], "float32")
    img = st.data("img", [2, 3, 6, 6], "float32")
    seq = st.data("seq", [2, 5, 6], "float32")
    ids = st.data("ids", [4, 3], "int64")
    return [
        st.nn.fc(x, 5, activation="relu"),
        st.nn.conv2d(img, 4, 3, padding=1, act="relu"),
        st.nn.batch_norm(img, act="tanh"),
        st.nn.layer_norm(x),
        st.nn.group_norm(img, groups=3),
        st.nn.instance_norm(img),
        st.nn.embedding(ids, [10, 4]),
        st.nn.prelu(img, "channel"),
        st.nn.bilinear_tensor_product(x, x, 3),
        st.nn.row_conv(seq, 2),
        st.nn.data_norm(x),
        st.nn.conv2d_transpose(img, 2, filter_size=3, stride=2),
    ]


def test_static_nn_builders_match_reference(parity):
    """The builders' outputs from the same parameters (one forward)."""
    r = np.random.RandomState(0)
    feed = {"x": r.randn(4, 6).astype("float32"),
            "img": r.randn(2, 3, 6, 6).astype("float32"),
            "seq": r.randn(2, 5, 6).astype("float32"),
            "ids": r.randint(0, 10, (4, 3)).astype("int64")}
    got_j, got_t = parity.run_both(_builders, lambda i: feed, lambda o: o)
    for k, (a, b) in enumerate(zip(got_t[0], got_j[0])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                   err_msg=f"builder {k}")


def _py_func(P, st):
    x = st.data("x", [2, 3], "float32")
    x.stop_gradient = False
    out = st.default_main_program().global_block().create_var(
        name="pyf_out", shape=(2, 3), dtype="float32")
    y = st.nn.py_func(lambda a: a * a, x, out,
                      backward_func=lambda a, o, g: 2.0 * a * g)
    st.append_backward(P.sum(y), parameter_list=[x])
    return [out, "x@GRAD"]


def _data_norm(P, st):
    x = st.data("x", [8, 4], "float32")
    x.stop_gradient = False
    y = st.nn.data_norm(x, name="dn")
    st.append_backward(P.mean(y * y))
    return [y, "dn.batch_sum", "dn.batch_size", "dn.batch_square_sum"]


def _crf(P, st):
    emis = st.data("emis", [3, 5, 4], "float32")
    lab = st.data("lab", [3, 5], "int64")
    ln = st.data("ln", [3], "int64")
    attr = P.ParamAttr(name="crfw")
    return [st.nn.crf_decoding(emis, attr),
            st.nn.crf_decoding(emis, attr, length=ln),
            st.nn.crf_decoding(emis, attr, label=lab, length=ln)]


@pytest.mark.parametrize("fn,feed,steps", [
    (_py_func, {"x": np.random.RandomState(4).randn(2, 3)}, 1),
    (_data_norm, {"x": np.random.RandomState(5).randn(8, 4) * 2 + 3}, 4),
    (_crf, {"emis": np.random.RandomState(6).randn(3, 5, 4),
            "lab": np.random.RandomState(7).randint(0, 4, (3, 5)),
            "ln": np.array([5, 3, 1])}, 1)],
    ids=["py_func", "data_norm_trained", "crf_decoding"])
def test_stateful_and_host_builders_match_reference(parity, fn, feed, steps):
    """``py_func`` (a host callable, its gradient by ``backward_func``),
    ``data_norm``'s statistics over trained steps (moved by its grad op)
    and ``crf_decoding``'s Viterbi paths equal the reference's."""
    feed = {k: v.astype("int64" if v.dtype.kind == "i" else "float32")
            for k, v in feed.items()}
    got_j, got_t = parity.run_both(fn, lambda i: feed, lambda o: o,
                                   steps=steps)
    for gj, gt in zip(got_j, got_t):
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_fed_loop_bound_is_refused():
    """A counted loop bakes its ``fill_constant`` bound into its trip
    count, so feeding that variable is refused."""
    def fn(P, st):
        i = P.full([1], 0, "int64")
        n = P.full([1], 3, "int64")
        acc = P.full([1], 1.0, "float32")
        _, out = st.nn.while_loop(lambda i, a: P.less_than(i, n),
                                  lambda i, a: [P.increment(i, 1), a * 2.0],
                                  [i, acc])
        return n, out

    main, startup, (n, out) = _port_build(fn)
    exe = tst.Executor(tp.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        assert float(exe.run(main, fetch_list=[out])[0][0]) == 8.0
        with pytest.raises(ValueError, match="trip count"):
            exe.run(main, feed={n.name: np.array([5])}, fetch_list=[out])


def test_lr_scheduler_syncs_the_scope(parity):
    """A scheduler's ``step()`` writes the rate into the scope's
    learning-rate Variable, whose updates then follow it."""
    from paddle_tpu.optimizer import lr as jlr
    from paddle_tpu_torch.optimizer import lr as tlr

    scheds = {}

    def fn(P, st):
        x = st.data("x", [4, 3], "float32")
        loss = P.mean(P.nn.Linear(3, 1)(x))
        sched = (jlr if P is not tp else tlr).StepDecay(0.1, step_size=1,
                                                         gamma=0.5)
        opt = P.optimizer.SGD(learning_rate=sched)
        opt.minimize(loss)
        # the scheduler holds its optimizers weakly: keep this one alive
        scheds[P.__name__] = (sched, opt)
        return [loss, opt._lr_var]

    calls = []

    def feed(i):
        # the reference's steps run first, then the port's
        calls.append(i)
        pkg = "paddle_tpu" if len(calls) <= 3 else "paddle_tpu_torch"
        if i:
            scheds[pkg][0].step()
        return {"x": np.full((4, 3), 1.0 + i, "float32")}

    got_j, got_t = parity.run_both(fn, feed, lambda o: o, steps=3)
    for gj, gt in zip(got_j, got_t):
        np.testing.assert_allclose(gt[1], gj[1], rtol=1e-7)
        np.testing.assert_allclose(gt[0], gj[0], rtol=1e-5)
    np.testing.assert_allclose([g[1][0] for g in got_t], [0.1, 0.05, 0.025],
                               rtol=1e-7)


def test_inference_model_and_static_io_round_trip(tmp_path):
    """save_inference_model / load_inference_model (pruned to the fetch:
    no backward or update op), save / load, the program's dict form in
    bytes, program state and vars, all reproduce the trained program's
    forward."""
    def fn(P, st):
        x = st.data("x", [-1, 8], "float32")
        y = st.data("y", [-1, 1], "int64")
        logits = P.nn.Linear(16, 4)(P.nn.functional.dropout(
            P.nn.functional.relu(P.nn.Linear(8, 16)(x)), p=0.5))
        loss = P.mean(P.nn.functional.softmax_with_cross_entropy(logits, y))
        P.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return x, logits, loss

    main, startup, (x, logits, loss) = _port_build(fn)
    feed = _mlp_feed(0)
    exe = tst.Executor(tp.CPUPlace())
    with scope_guard(Scope()):
        exe.run(startup)
        for i in range(3):
            exe.run(main, feed=_mlp_feed(i), fetch_list=[loss])
        infer = tst.normalize_program(main.clone(for_test=True), [x],
                                      [logits])
        (want,) = exe.run(infer, feed={"x": feed["x"]}, fetch_list=[logits])
        prefix = str(tmp_path / "mlp")
        tst.save_inference_model(prefix, [x], [logits], exe, program=main)
        tst.save(main, str(tmp_path / "full"))
        tst.save_vars(exe, str(tmp_path / "vars"), main)
        blob = tst.serialize_program([x], [logits], program=main)
        params = tst.serialize_persistables([x], [logits], exe, program=main)
    with scope_guard(Scope()):
        prog, feeds, fetches = tst.load_inference_model(prefix, exe)
        assert feeds == ["x"] and fetches == [logits.name]
        types = {o.type for o in prog.global_block().ops}
        assert not any(t.endswith("_grad") or t == "adam" for t in types)
        (got,) = exe.run(prog, feed={"x": feed["x"]}, fetch_list=fetches)
        np.testing.assert_array_equal(got, want)
    for load in (
            lambda: tst.load(main, str(tmp_path / "full"), exe),
            lambda: tst.set_program_state(
                main, tst.load_program_state(str(tmp_path / "full"))),
            lambda: tst.load_vars(exe, str(tmp_path / "vars"), main),
            lambda: tst.deserialize_persistables(
                tst.deserialize_program(blob), params, exe)):
        with scope_guard(Scope()):
            load()
            (got,) = exe.run(infer, feed={"x": feed["x"]},
                             fetch_list=[logits])
            np.testing.assert_array_equal(got, want)


def test_feeds_fetches_and_errors():
    """Feeds take numpy or tensors of the executor's device; a parameter
    no op reads is fetched from the scope; ``return_numpy=False`` gives
    Tensors; a missing persistable and a NaN name their variable and op;
    a random op's draws repeat for the same seed and step."""
    def fn(P, st):
        x = st.data("x", [2, 3], "float32")
        w = P.create_parameter([3], "float32", name="w")
        out = P.log(x) * w
        noise = P.uniform([2], min=0.0, max=1.0)
        return out, w, noise

    main, startup, (out, w, noise) = _port_build(fn)
    exe = tst.Executor(tp.CPUPlace())
    with scope_guard(Scope()):
        with pytest.raises(RuntimeError, match="not initialized"):
            exe.run(main, feed={"x": np.ones((2, 3), "float32")},
                    fetch_list=[out])
        exe.run(startup)
        a = exe.run(main, feed={"x": torch.ones(2, 3)}, fetch_list=[out, w])
        b = exe.run(main, feed={"x": np.ones((2, 3))}, fetch_list=[out, w],
                    return_numpy=False)
        assert isinstance(b[0], tp.Tensor)
        np.testing.assert_array_equal(a[0], b[0].numpy())
        n1 = tst.Executor(tp.CPUPlace()).run(main, feed={
            "x": np.ones((2, 3))}, fetch_list=[noise])[0]
        n2 = tst.Executor(tp.CPUPlace()).run(main, feed={
            "x": np.ones((2, 3))}, fetch_list=[noise])[0]
        np.testing.assert_array_equal(n1, n2)
        tp.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(RuntimeError, match="log"):
                exe.run(main, feed={"x": -np.ones((2, 3), "float32")},
                        fetch_list=[out])
        finally:
            tp.set_flags({"FLAGS_check_nan_inf": False})


# -- on the card --------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_run(place, state=None, steps=3, amp=False):
    from paddle_tpu_torch.static.io import _host

    main, startup, (loss, _) = _port_build(lambda P, st: _bert(P, st, amp))
    exe = tst.Executor(place)
    with scope_guard(Scope()):
        exe.run(startup)
        if state is not None:
            tst.set_program_state(main, state)
        init = {p.name: _host(tst.global_scope().find_var(p.name))
                for p in main.all_parameters()}
        losses = [float(exe.run(main, feed=_bert_feed(i),
                                fetch_list=[loss])[0]) for i in range(steps)]
    return init, losses


@pytest.mark.cuda
def test_static_bert_on_card_matches_cpu(dev):
    """The small static BERT, fp32: the card (flash kernels) against the
    CPU (their plain versions) from the CPU's weights, losses within
    1e-5 relative over 3 steps."""
    init, cpu = _card_run(tp.CPUPlace())
    tp.set_device("gpu")
    _, card = _card_run(tp.CUDAPlace(0), state=init)
    assert _rel(card, cpu) <= 1e-5, (card, cpu)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
@pytest.mark.cuda
def test_static_flash_launches_one_forward_a_layer(dev, amp):
    """A static step launches each flash kernel once a layer: the grad
    op reads the forward's kept graph."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    tp.set_device("gpu")
    reset_launch_counts()
    _card_run(tp.CUDAPlace(0), steps=2, amp=amp)
    want = 2 * BERT["num_layers"]
    assert {k: KERNELS[k] for k in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")} == \
        {"flash_fwd": want, "flash_bwd_dq": want, "flash_bwd_dkv": want}

"""Int8 inference in the port against the reference, on the CPU.

* the seven cases of ``tests/test_int8_inference.py``, each held to the
  reference: the rewritten op lists, ``_n_int8``, the scope's ``@int8`` /
  ``@wscale`` arrays bit for bit and the Predictors' outputs (1e-6);
* the registered quant ops against the reference's kernels: the
  fake-quant ops (their outputs and scales bit for bit), and
  ``quantized_matmul`` / ``quantized_conv2d``, whose activations quantize
  with the reference's decisions: per tensor, with ``XScale`` and the
  batched form bit for bit, ``per_token`` within 1e-6 (the port rescales
  ``float(acc) * sx * ws`` one product at a time, as its GEMM does);
* ``ImperativePTQ`` and ``ImperativeQuantAware`` scales against the
  reference's;
* the W8A8 GPT layers record the registered ``w8a8_matmul`` op, and a
  small int8 GPT program survives ``jit.save`` / ``jit.load``;
* ``infer_int8.py`` and ``fluid_word2vec.py`` against the reference's
  scripts;
* the registry holds every op the reference's ``ops/quant_ops.py``
  registers.
"""

import importlib.util
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.weights import load_paddle_state_dict

PKGS = {"ref": (jp, jnames), "port": (tp, tnames)}


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    tp.disable_static()
    jp.disable_static()


def _config(P, prefix, **int8):
    cfg = P.inference.Config(prefix)
    if P is tp:
        cfg.disable_gpu()
    if int8.pop("trt", False):
        cfg.enable_tensorrt_engine(
            precision_mode=P.inference.PrecisionType.Int8)
    elif int8:
        cfg.enable_int8(**int8)
    return cfg


def _both(prefix, x, **int8):
    """Both packages' Predictors on one saved model: {name: (predictor,
    output)}."""
    out = {}
    for name, (P, _) in PKGS.items():
        pred = P.inference.create_predictor(_config(P, prefix, **int8))
        out[name] = (pred, np.asarray(pred.run([x])[0]))
    return out


def _ops(pred):
    return [op.type for op in pred._program.global_block().ops]


def _held(got, int8=True):
    """The port's rewrite and outputs against the reference's."""
    (jpred, jout), (tpred, tout) = got["ref"], got["port"]
    assert _ops(tpred) == _ops(jpred)
    if int8:
        assert tpred._n_int8 == jpred._n_int8
        names = [n for n in jpred._scope.local_names()
                 if n.endswith(("@int8", "@wscale"))]
        assert names and sorted(names) == sorted(
            n for n in tpred._scope.local_names()
            if n.endswith(("@int8", "@wscale")))
        for n in names:
            want = np.asarray(jpred._scope.find_var(n))
            got_n = tpred._scope.find_var(n).numpy()
            assert got_n.dtype == want.dtype, n
            np.testing.assert_array_equal(got_n, want, err_msg=n)
    np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-6)


def _mlp_model(tmp_path, train_steps=30):
    """The reference test's static MLP, trained and saved by the
    reference: both packages' Predictors load the same file."""
    jp.enable_static()
    try:
        st = jp.static
        main, startup = st.Program(), st.Program()
        with st.program_guard(main, startup), jnames.guard():
            x = st.data("x", [None, 16], "float32")
            y = st.data("y", [None, 1], "float32")
            h = st.nn.fc(x, 32, activation="relu")
            pred = st.nn.fc(h, 1)
            loss = jp.mean((pred - y) ** 2)
            jp.optimizer.SGD(learning_rate=0.05).minimize(loss)
        with st.scope_guard(st.Scope()):
            exe = st.Executor()
            exe.run(startup)
            rng = np.random.RandomState(0)
            xs = rng.randn(64, 16).astype("float32")
            ys = xs[:, :4].sum(1, keepdims=True).astype("float32")
            for _ in range(train_steps):
                exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
            prefix = str(tmp_path / "mlp")
            st.save_inference_model(prefix, [x], [pred], exe, program=main)
    finally:
        jp.disable_static()
    return prefix, xs


def test_int8_predictor_rewrites_and_matches(tmp_path):
    prefix, xs = _mlp_model(tmp_path)
    fp = _both(prefix, xs)
    _held(fp, int8=False)
    got = _both(prefix, xs, min_weight_elements=0)
    _held(got)
    tpred, out = got["port"]
    assert tpred._n_int8 == 2 and _ops(tpred).count("quantized_matmul") == 2
    ref = fp["port"][1]
    assert np.all(np.abs(out - ref) < 0.05 + 0.03 * np.abs(ref))


def test_int8_via_tensorrt_engine_precision_flag(tmp_path):
    prefix, xs = _mlp_model(tmp_path, train_steps=5)
    got = _both(prefix, xs, trt=True)
    _held(got)
    assert got["port"][0]._n_int8 == 2
    assert got["port"][0]._config.summary()["int8"] is True


def test_int8_size_gate_keeps_small_layers_float(tmp_path):
    prefix, xs = _mlp_model(tmp_path, train_steps=5)
    got = _both(prefix, xs, min_weight_elements=1 << 16)
    _held(got, int8=False)
    assert got["port"][0]._n_int8 == 0
    assert "quantized_matmul" not in _ops(got["port"][0])


def _models(make):
    out = {}
    for name, (P, names) in PKGS.items():
        with names.guard():
            out[name] = make(P)
    load_paddle_state_dict(out["port"], {k: v.numpy() for k, v in
                                         out["ref"].state_dict().items()})
    return out


def _save_both(models, tmp_path, shape, name="model"):
    paths = {}
    for pkg, (P, _) in PKGS.items():
        paths[pkg] = str(tmp_path / pkg / name)
        P.jit.save(models[pkg], paths[pkg],
                   input_spec=[P.static.InputSpec(shape, "float32", "x")])
    return paths


def _each(paths, x, **int8):
    out = {}
    for name, (P, _) in PKGS.items():
        pred = P.inference.create_predictor(_config(P, paths[name], **int8))
        out[name] = (pred, np.asarray(pred.run([x])[0]))
    return out


def _ptq(P, calib):
    from importlib import import_module

    quant = import_module(P.__name__ + ".incubate.quant")
    P.seed(3)
    model = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                            P.nn.Linear(16, 4))
    return model, quant.ImperativePTQ()


def test_int8_uses_calibrated_activation_scales(tmp_path):
    """A PTQ'd model (frozen fake-quant ops in the graph): the calibrated
    scales as XScale, the fake-quant ops bypassed, as in the reference."""
    calib = np.random.RandomState(1).randn(32, 8).astype("float32") * 2.0
    models, ptqs = {}, {}
    for name, (P, names) in PKGS.items():
        with names.guard():
            models[name], ptqs[name] = _ptq(P, calib)
    load_paddle_state_dict(models["port"], {
        k: v.numpy() for k, v in models["ref"].state_dict().items()})
    refs = {}
    for name, (P, names) in PKGS.items():
        with names.guard():
            m = ptqs[name].quantize(models[name])
            m(P.to_tensor(calib))
            m = ptqs[name].convert(m)
        m.eval()
        models[name] = m
        refs[name] = m(P.to_tensor(calib)).numpy()
    np.testing.assert_allclose(refs["port"], refs["ref"], rtol=1e-6,
                               atol=1e-6)
    got = _each(_save_both(models, tmp_path, [32, 8]), calib,
                min_weight_elements=0)
    _held(got)
    tpred, out = got["port"]
    q_ops = [op for op in tpred._program.global_block().ops
             if op.type == "quantized_matmul"]
    assert len(q_ops) == 2 and any("XScale" in op.inputs for op in q_ops)
    denom = np.maximum(np.abs(refs["port"]), 1e-2)
    assert np.max(np.abs(out - refs["port"]) / denom) < 0.08


def _convnet(P):
    m = P.nn.Sequential(P.nn.Conv2D(3, 8, 3, padding=1), P.nn.ReLU(),
                        P.nn.Conv2D(8, 4, 1), P.nn.ReLU(), P.nn.Flatten(),
                        P.nn.Linear(4 * 8 * 8, 5))
    m.eval()
    return m


def test_int8_conv_rewrite_and_numerics(tmp_path):
    models = _models(_convnet)
    x = np.random.RandomState(2).randn(2, 3, 8, 8).astype("float32")
    got = _each(_save_both(models, tmp_path, [2, 3, 8, 8]), x,
                min_weight_elements=0, quantize_convs=True)
    _held(got)
    assert _ops(got["port"][0]).count("quantized_conv2d") == 2


def test_int8_convs_default_off(tmp_path):
    def small(P):
        m = P.nn.Sequential(P.nn.Conv2D(3, 8, 3, padding=1), P.nn.Flatten(),
                            P.nn.Linear(8 * 4 * 4, 2))
        m.eval()
        return m

    models = _models(small)
    x = np.random.RandomState(4).randn(1, 3, 4, 4).astype("float32")
    got = _each(_save_both(models, tmp_path, [1, 3, 4, 4]), x,
                min_weight_elements=0)
    _held(got)
    types = _ops(got["port"][0])
    assert "conv2d" in types and "quantized_conv2d" not in types


# -- the registered quant ops against the reference's kernels ----------------


def _run_both(op, ins, attrs):
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg

    jouts = jreg.get_op_def(op).kernel(
        {k: jnp.asarray(v) for k, v in ins.items()}, dict(attrs))
    touts = treg.get_op_def(op).kernel(
        {k: torch.as_tensor(v) for k, v in ins.items()}, dict(attrs))
    return ({k: np.asarray(v) for k, v in jouts.items()},
            {k: v.numpy() for k, v in touts.items()})


_R = np.random.RandomState(11)
_X = (_R.randn(6, 24) * 3).astype("float32")
_X4 = (_R.randn(2, 3, 6, 6)).astype("float32")
_W = np.clip(np.round(_R.randn(24, 20) * 40), -127, 127).astype("int8")
_WS = (_R.rand(20) * 0.01 + 1e-3).astype("float32")
_WB = np.clip(np.round(_R.randn(2, 24, 20) * 40), -127, 127).astype("int8")
_WSB = (_R.rand(2, 20) * 0.01 + 1e-3).astype("float32")
_WC = np.clip(np.round(_R.randn(5, 3, 3, 3) * 40), -127, 127).astype("int8")
_WCS = (_R.rand(5) * 0.01 + 1e-3).astype("float32")
_ONE = np.asarray([1.7], "float32")

QUANT_OP_CASES = [
    ("fake_quantize_dequantize_abs_max", {"X": _X}, {"bit_length": 8}, 0),
    ("fake_quantize_dequantize_abs_max", {"X": _X}, {"bit_length": 4}, 0),
    ("fake_channel_wise_quantize_dequantize_abs_max", {"X": _X},
     {"quant_axis": 1}, 0),
    ("fake_channel_wise_quantize_dequantize_abs_max", {"X": _X4},
     {"quant_axis": 0}, 0),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"X": _X, "InScale": _ONE}, {"moving_rate": 0.9}, 0),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"X": _X, "InScale": _ONE, "InState": np.asarray([2.0], "float32"),
      "InAccum": np.asarray([5.0], "float32")}, {"moving_rate": 0.9}, 0),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"X": _X, "InScale": _ONE}, {"is_test": True}, 0),
    ("quantized_matmul", {"X": _X, "Y": _W, "WScale": _WS}, {}, 0),
    ("quantized_matmul", {"X": _X, "Y": _W, "WScale": _WS,
                          "XScale": np.asarray([4.0], "float32")}, {}, 0),
    ("quantized_matmul", {"X": _X.reshape(2, 3, 24), "Y": _WB,
                          "WScale": _WSB}, {}, 0),
    ("quantized_matmul", {"X": _X.reshape(2, 3, 24), "Y": _WB,
                          "WScale": _WS}, {}, 0),
    ("quantized_matmul", {"X": _X, "Y": _W, "WScale": _WS},
     {"per_token": True}, 1e-6),
    ("quantized_conv2d", {"Input": _X4, "Filter": _WC, "WScale": _WCS},
     {"paddings": [1, 1]}, 0),
    ("quantized_conv2d", {"Input": _X4, "Filter": _WC, "WScale": _WCS,
                          "XScale": np.asarray([2.0], "float32")},
     {"strides": [2, 2]}, 0),
]


@pytest.mark.parametrize(
    "op,ins,attrs,rtol", QUANT_OP_CASES,
    ids=[f"{c[0]}-{i}" for i, c in enumerate(QUANT_OP_CASES)])
def test_quant_op_matches_reference_kernel(op, ins, attrs, rtol):
    jouts, touts = _run_both(op, ins, attrs)
    assert sorted(touts) == sorted(jouts)
    for k, want in jouts.items():
        got = touts[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if rtol:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_fake_quant_gradient_is_straight_through():
    x = tp.to_tensor(_X, stop_gradient=False)
    out = tp.ops.dispatch("fake_quantize_dequantize_abs_max", {"X": [x]},
                          {})["Out"][0]
    (out * 3.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.full_like(_X, 3.0))


def test_quant_ops_registered_as_in_the_reference():
    """Every op the reference's ops/quant_ops.py registers is registered
    in the port (the port adds the straight-through grad op)."""
    import paddle_tpu.ops.quant_ops as jq
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg

    ref = {n for n, od in jreg._REGISTRY.items()
           if od.kernel.__module__ == jq.__name__}
    port = {n for n, od in treg._REGISTRY.items()
            if od.kernel.__module__ == "paddle_tpu_torch.ops.quant_ops"}
    assert len(ref) == 6
    assert port - ref == {"fake_quantize_dequantize_grad"}
    assert ref <= port


# -- imperative quantization --------------------------------------------------


def _qat_lenet(P):
    m = P.nn.Sequential(P.nn.Conv2D(1, 4, 3, padding=1), P.nn.ReLU(),
                        P.nn.Flatten(), P.nn.Linear(4 * 6 * 6, 3))
    return m


def test_quant_aware_and_ptq_scales_match_reference():
    """QAT: 3 SGD steps through the fake-quant wrappers, each layer's
    moving-average scale, state and accumulator and the losses against the
    reference's; PTQ: the calibrated scales of both observers."""
    from paddle_tpu.incubate import quant as jquant
    from paddle_tpu_torch.incubate import quant as tquant

    quants = {"ref": jquant, "port": tquant}
    models = _models(_qat_lenet)
    r = np.random.RandomState(6)
    xs = [r.randn(4, 1, 6, 6).astype("float32") for _ in range(3)]
    ys = [r.randint(0, 3, (4,)).astype("int64") for _ in range(3)]
    losses, bufs = {}, {}
    for name, (P, names) in PKGS.items():
        with names.guard():
            m = quants[name].ImperativeQuantAware().quantize(models[name])
            opt = P.optimizer.SGD(learning_rate=0.1,
                                  parameters=m.parameters())
            losses[name] = []
            for x, y in zip(xs, ys):
                loss = P.nn.functional.cross_entropy(m(P.to_tensor(x)),
                                                     P.to_tensor(y))
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses[name].append(float(loss.numpy()))
        bufs[name] = {k: v.numpy() for k, v in m.state_dict().items()
                      if "_in_scale" in k}
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5)
    assert sorted(bufs["port"]) == sorted(bufs["ref"]) and len(bufs["ref"]) == 6
    for k, want in bufs["ref"].items():
        np.testing.assert_allclose(bufs["port"][k], want, rtol=1e-5,
                                   err_msg=k)

    for algo in ("abs_max", "avg_abs_max"):
        models = _models(_qat_lenet)
        scales = {}
        for name, (P, names) in PKGS.items():
            ptq = quants[name].ImperativePTQ(algo=algo)
            m = ptq.quantize(models[name])
            for x in xs:
                m(P.to_tensor(x))
            m = ptq.convert(m)
            scales[name] = [v.numpy() for k, v in m.state_dict().items()
                            if k.endswith("_in_scale")]
        assert len(scales["ref"]) == 2
        np.testing.assert_allclose(scales["port"], scales["ref"], rtol=1e-6)


# -- W8A8 layers record the registered op (C.7) ------------------------------


def test_w8a8_layer_records_the_registered_op():
    from paddle_tpu_torch.models.gpt_layers import w8a8_linear

    tp.enable_static()
    try:
        main, startup = tp.static.Program(), tp.static.Program()
        with tp.static.program_guard(main, startup):
            x = tp.static.data("x", [4, 64], "float32")
            w8a8_linear(x, tp.nn.Linear(64, 32))
    finally:
        tp.disable_static()
    assert [op.type for op in main.global_block().ops] == \
        ["w8a8_matmul", "elementwise_add"]


GPT = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=32, int8=True, int8_lm_head=True)


def _gpt(P):
    from importlib import import_module

    mod = import_module(P.__name__ + (".models.gpt_layers"
                                      if P is tp else ".models.gpt"))
    m = mod.GPTForPretraining(mod.GPTConfig(**GPT))
    m.eval()
    return m


def test_int8_gpt_program_saves_and_loads(tmp_path):
    """A small int8 GPT through to_static: 2 * 4 + 1 w8a8_matmul ops and no
    one-off op; its logits match the reference's eager forward (1e-5) and
    the port's eager forward; jit.save / jit.load reloads the op by name
    and gives the same logits bit for bit."""
    models = _models(_gpt)
    ids = np.random.RandomState(8).randint(0, 128, (2, 16)).astype("int64")
    want = models["ref"](jp.to_tensor(ids)).numpy()
    m = models["port"]
    eager = m(tp.to_tensor(ids)).numpy()
    tp.jit.to_static(m, input_spec=[tp.static.InputSpec([None, 16],
                                                        "int64")])
    got = m(tp.to_tensor(ids)).numpy()
    main = m.forward.concrete_program[0]
    types = [op.type for op in main.global_block().ops]
    assert types.count("w8a8_matmul") == 9
    assert not any(t.startswith("__") for t in types), types
    np.testing.assert_allclose(got, eager, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    path = str(tmp_path / "gpt_int8")
    tp.jit.save(m, path)
    loaded = tp.jit.load(path)
    assert [op.type for op in loaded._program.global_block().ops
            ].count("w8a8_matmul") == 9
    np.testing.assert_array_equal(loaded(tp.to_tensor(ids)).numpy(), got)


# -- the examples against the reference's scripts ----------------------------


def _reference_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", f"examples/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_infer_int8_example_matches_reference_script(capsys, monkeypatch):
    """The port's infer_int8.py on the CPU from the reference script's
    initial weights (its seed, its model): the fp32 and int8 accuracies
    within one of the 256 samples of the script's."""
    from paddle_tpu_torch.examples import infer_int8

    ref = _reference_script("infer_int8")
    monkeypatch.setattr(sys, "argv", ["infer_int8.py"])
    ref.main()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("accuracy")][0]
    want = [float(t.split("=")[1]) for t in line.split()[1:3]]
    jp.seed(0)
    init = jp.nn.Sequential(jp.nn.Linear(16, 64), jp.nn.ReLU(),
                            jp.nn.Linear(64, 2))
    state = {k: v.numpy() for k, v in init.state_dict().items()}
    acc_fp32, acc_int8, n_int8, _ = infer_int8.run(
        infer_int8.parse_args(["--device", "cpu"]), init_state=state,
        log=lambda s: None)
    assert n_int8 == 2
    assert abs(acc_fp32 - want[0]) <= 1 / 256 + 1e-9
    assert abs(acc_int8 - want[1]) <= 1 / 256 + 1e-9
    assert acc_int8 >= acc_fp32 - 0.02


def test_fluid_word2vec_example_matches_reference_script():
    """The port's fluid_word2vec.py, 3 steps on the CPU from the reference
    script's initial weights: the losses within 1e-5 relative of the
    reference script's program run on the same batches."""
    from paddle_tpu_torch.examples import fluid_word2vec as ex

    ref = _reference_script("fluid_word2vec")
    fluid = ref.fluid
    jp.enable_static()
    try:
        with fluid.program_guard(fluid.Program(), fluid.Program()), \
                jnames.guard(), jp.static.scope_guard(jp.static.Scope()):
            jp.seed(0)
            words = [fluid.layers.data(name=n, shape=[1], dtype="int64")
                     for n in ["firstw", "secondw", "thirdw", "nextw"]]
            _, avg_cost = ref.train_program(words)
            fluid.optimizer.SGDOptimizer(learning_rate=0.5).minimize(
                avg_cost)
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(fluid.default_startup_program())
            main = fluid.default_main_program()
            scope = jp.static.global_scope()
            init = {v.name: np.asarray(scope.find_var(v.name))
                    for v in main.list_vars() if v.persistable
                    and scope.find_var(v.name) is not None}
            feeder = fluid.DataFeeder(feed_list=words,
                                      place=fluid.CPUPlace())
            batches = jp.batch(ref.synthetic_corpus_reader(), 64)()
            want = [float(np.asarray(exe.run(
                main, feed=feeder.feed(next(batches)),
                fetch_list=[avg_cost])[0])) for _ in range(3)]
    finally:
        jp.disable_static()
    losses, _, shape = ex.run(ex.parse_args(["--steps", "3", "--device",
                                             "cpu"]),
                              init_state=init, log=lambda s: None)
    assert shape == (ex.DICT_SIZE, ex.EMBED_SIZE)
    np.testing.assert_allclose(losses, want, rtol=1e-5)


def test_bert_int8_rewrite_takes_four_matmuls_a_layer_and_the_pooler(
        tmp_path, monkeypatch):
    """A 2-layer BertModel (hidden 256: every projection at least 1 << 16
    values) saved by jit.save and rewritten by enable_int8()'s default
    gate: 4 L + 1 quantized_matmul ops in both packages (the smoke's
    phase 14 holds BERT-base to the same count), the scopes' int8 arrays
    and the outputs as the reference's."""
    import torch_static_parity as sp
    from importlib import import_module

    sp.give_reference_variable_indexing(monkeypatch)

    def bert(P):
        mod = import_module(P.__name__ + ".models.bert")
        m = mod.BertModel(mod.BertConfig(vocab_size=64, hidden_size=256,
                                         num_layers=2, num_heads=4,
                                         max_seq_len=16))
        m.eval()
        return m

    models = _models(bert)
    r = np.random.RandomState(9)
    ids = r.randint(0, 64, (2, 16)).astype("int64")
    paths = {}
    for name, (P, _) in PKGS.items():
        paths[name] = str(tmp_path / name / "bert")
        P.jit.save(models[name], paths[name],
                   input_spec=[P.static.InputSpec([None, 16], "int64")])
    got = {}
    for name, (P, _) in PKGS.items():
        pred = P.inference.create_predictor(_config(P, paths[name],
                                                    min_weight_elements=1 << 16))
        got[name] = (pred, np.asarray(pred.run([ids])[0]))
    _held(got)
    assert _ops(got["port"][0]).count("quantized_matmul") == 4 * 2 + 1
    assert got["port"][0]._n_int8 == 4 * 2 + 1

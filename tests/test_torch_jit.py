"""``paddle.jit`` in the port against the reference, on the CPU.

* the four cases of ``tests/test_jit.py``, run in both packages on the
  same weights and inputs and held to each other (1e-6);
* the saved model crosses packages: the reference's ``jit.save`` loaded by
  the port's ``jit.load`` and ``Predictor``, and the reverse (1e-6);
* a 2-layer BERT (hidden 64, 4 heads, seq 16) through ``to_static``
  against both packages' eager forwards (1e-5; the reference's static
  Variable takes ``tests/torch_static_parity.py``'s indexing), then saved
  and run by a fresh process, which loads the program cold;
* ``TracedLayer``, ``declarative`` and ``ProgramTranslator``;
* ``to_static`` and ``inference.Config()`` resolve to the card (``gpu:0``)
  without a CUDA call.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.weights import load_paddle_state_dict

PKGS = {"ref": (jp, jnames), "port": (tp, tnames)}
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    tp.disable_static()
    jp.disable_static()


def _models(make):
    """``make(P)`` in both packages under fresh unique names; the port's
    model takes the reference's weights."""
    out = {}
    for name, (P, names) in PKGS.items():
        with names.guard():
            out[name] = make(P)
    load_paddle_state_dict(out["port"], {k: v.numpy() for k, v in
                                         out["ref"].state_dict().items()})
    return out


def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(4, 8), P.nn.ReLU(), P.nn.Linear(8, 2))


def test_to_static_function_matches_reference():
    rng = np.random.RandomState(0)
    a = rng.randn(3, 4).astype("float32")
    b = rng.randn(4, 5).astype("float32")
    got = {}
    for name, (P, _) in PKGS.items():
        @P.jit.to_static
        def f(x, y):
            return P.matmul(x, y) + 1.0
        got[name] = f(P.to_tensor(a), P.to_tensor(b)).numpy()
    np.testing.assert_allclose(got["port"], got["ref"], **TOL)
    np.testing.assert_allclose(got["port"], a @ b + 1.0, rtol=1e-5)


def test_to_static_layer_matches_reference():
    models = _models(_mlp)
    x = np.random.RandomState(1).randn(5, 4).astype("float32")
    got = {}
    for name, (P, _) in PKGS.items():
        eager = models[name](P.to_tensor(x)).numpy()
        got[name] = P.jit.to_static(models[name])(P.to_tensor(x)).numpy()
        np.testing.assert_allclose(got[name], eager, **TOL)
    np.testing.assert_allclose(got["port"], got["ref"], **TOL)


def _tanh_mlp(P):
    net = P.nn.Sequential(P.nn.Linear(6, 12), P.nn.Tanh(),
                          P.nn.Linear(12, 3))
    net.eval()
    return net


def _save(P, model, path):
    P.jit.save(model, path, input_spec=[P.static.InputSpec([-1, 6],
                                                           "float32")])


def test_jit_save_load_roundtrip_matches_reference(tmp_path):
    models = _models(_tanh_mlp)
    x = np.random.RandomState(2).randn(2, 6).astype("float32")
    got = {}
    for name, (P, _) in PKGS.items():
        want = models[name](P.to_tensor(x)).numpy()
        path = str(tmp_path / name / "model")
        _save(P, models[name], path)
        got[name] = P.jit.load(path)(P.to_tensor(x)).numpy()
        np.testing.assert_allclose(got[name], want, **TOL)
    np.testing.assert_allclose(got["port"], got["ref"], **TOL)


@pytest.mark.parametrize("saver,loader", [("ref", "port"), ("port", "ref")])
def test_saved_model_crosses_packages(tmp_path, saver, loader):
    """What one package's ``jit.save`` writes, the other's ``jit.load`` and
    ``Predictor`` run, with the saver's outputs (1e-6)."""
    models = _models(_tanh_mlp)
    x = np.random.RandomState(3).randn(4, 6).astype("float32")
    P, _ = PKGS[saver]
    path = str(tmp_path / "model")
    _save(P, models[saver], path)
    want = models[saver](P.to_tensor(x)).numpy()
    L, _ = PKGS[loader]
    np.testing.assert_allclose(L.jit.load(path)(L.to_tensor(x)).numpy(),
                               want, **TOL)
    cfg = L.inference.Config(path)
    if loader == "port":
        cfg.disable_gpu()
    (out,) = L.inference.create_predictor(cfg).run([x])
    np.testing.assert_allclose(np.asarray(out), want, **TOL)


def _static_linear(P, st):
    x = st.data("x", [-1, 4], "float32")
    return x, P.nn.Linear(4, 2)(x)


def test_save_inference_model_static_matches_reference(tmp_path):
    import torch_static_parity as sp

    xv = np.random.RandomState(0).randn(3, 4).astype("float32")
    (jm, js, (jx, jout)), (tm, ts, (tx, tout)) = (
        sp.build("ref", _static_linear), sp.build("port", _static_linear))
    with sp.jscope_guard(sp.JScope()):
        jexe = sp.jst.Executor(jp.CPUPlace())
        jexe.run(js)
        state = sp.scope_arrays(sp.jst.global_scope())
        (jwant,) = jexe.run(jm, feed={"x": xv}, fetch_list=[jout])
        sp.jst.save_inference_model(str(tmp_path / "j" / "m"), [jx], [jout],
                                    program=jm)
    with sp.tscope_guard(sp.TScope()):
        texe = sp.tst.Executor(tp.CPUPlace())
        texe.run(ts)
        sp.tst.set_program_state(tm, state)
        (twant,) = texe.run(tm, feed={"x": xv}, fetch_list=[tout])
        sp.tst.save_inference_model(str(tmp_path / "t" / "m"), [tx], [tout],
                                    program=tm)
    np.testing.assert_allclose(twant, jwant, **TOL)
    for d in ("j", "t"):  # each package's file, reloaded by the port
        scope = sp.TScope()
        prog, feeds, fetches = sp.tst.load_inference_model(
            str(tmp_path / d / "m"), scope=scope)
        (got,) = sp.tst.Executor(tp.CPUPlace()).run(
            prog, feed={feeds[0]: xv}, fetch_list=fetches, scope=scope)
        np.testing.assert_allclose(got, jwant, **TOL)


BERT = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=16)


def _bert(P):
    from importlib import import_module

    bert = import_module(P.__name__ + ".models.bert")
    m = bert.BertModel(bert.BertConfig(**BERT))
    m.eval()
    return m


@pytest.fixture
def bert_models(monkeypatch):
    import torch_static_parity as sp
    from paddle_tpu.jit import dy2static as jdy2static

    sp.give_reference_variable_indexing(monkeypatch)
    # the reference's dy2static caches a method that needs no conversion as
    # the bound method it first saw, per code object: a BertModel that
    # another test file converted in this process would run in place of
    # this one, so the reference converts from an empty cache here
    monkeypatch.setattr(jdy2static, "_CONVERT_CACHE", {})
    return _models(_bert)


def _bert_ids(b=2):
    r = np.random.RandomState(5)
    return (r.randint(0, 64, (b, 16)).astype("int64"),
            (r.rand(b, 16) > 0.5).astype("int64"))


def test_bert_to_static_matches_both_eager_forwards(bert_models):
    ids, tt = _bert_ids()
    eager, static = {}, {}
    for name, (P, _) in PKGS.items():
        m = bert_models[name]
        args = (P.to_tensor(ids), P.to_tensor(tt))
        eager[name] = [o.numpy() for o in m(*args)]
        P.jit.to_static(m, input_spec=[P.static.InputSpec([None, 16],
                                                          "int64"),
                                       P.static.InputSpec([None, 16],
                                                          "int64")])
        static[name] = [o.numpy() for o in m(*args)]
    for got in (static["port"], eager["port"], static["ref"]):
        for g, w in zip(got, eager["ref"]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    # the port's own program and its eager forward: same kernels, same order
    for g, w in zip(static["port"], eager["port"]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


_FRESH = textwrap.dedent("""
    import sys
    import numpy as np
    import paddle_tpu_torch as tp
    tp.set_device("cpu")
    from paddle_tpu_torch import inference
    cfg = inference.Config(sys.argv[1])
    cfg.disable_gpu()
    ids = np.load(sys.argv[2])
    outs = inference.create_predictor(cfg).run([ids["ids"], ids["tt"]])
    np.savez(sys.argv[3], *outs)
""")


def test_saved_bert_program_loads_in_a_fresh_process(bert_models, tmp_path):
    """A to_static BERT saved by jit.save, run by a Predictor in a new
    process (nothing of the saving process alive): the outputs of the
    saving process, bit for bit."""
    ids, tt = _bert_ids()
    m = bert_models["port"]
    spec = [tp.static.InputSpec([None, 16], "int64")] * 2
    path = str(tmp_path / "bert")
    tp.jit.save(m, path, input_spec=spec)
    want = [o.numpy() for o in tp.jit.load(path)(tp.to_tensor(ids),
                                                 tp.to_tensor(tt))]
    np.savez(tmp_path / "ids.npz", ids=ids, tt=tt)
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH, path, str(tmp_path / "ids.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = np.load(tmp_path / "out.npz")
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[f"arr_{i}"], w)


def test_traced_layer_declarative_and_program_translator(tmp_path):
    models = _models(_mlp)
    x = np.random.RandomState(4).randn(3, 4).astype("float32")
    P, net = tp, models["port"]
    want = models["ref"](jp.to_tensor(x)).numpy()
    out, traced = P.jit.TracedLayer.trace(net, [P.to_tensor(x)])
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    np.testing.assert_allclose(traced(P.to_tensor(x)).numpy(), want, **TOL)
    path = str(tmp_path / "traced")
    traced.save_inference_model(path)
    np.testing.assert_allclose(P.jit.load(path)(P.to_tensor(x)).numpy(),
                               want, **TOL)
    assert P.fluid.dygraph.TracedLayer is P.jit.TracedLayer

    @P.fluid.dygraph.declarative
    def f(a):
        return a * 2.0 + 1.0

    assert isinstance(f, P.jit.StaticFunction)
    np.testing.assert_allclose(f(P.to_tensor(x)).numpy(), x * 2.0 + 1.0,
                               **TOL)
    pt = P.fluid.dygraph.ProgramTranslator.get_instance()
    assert pt is P.jit.ProgramTranslator.get_instance()
    calls = []

    def g(a):
        calls.append(1)
        return a + 1.0

    sg = P.jit.to_static(g)
    sg(P.to_tensor(x))
    sg(P.to_tensor(x))
    assert len(calls) == 1  # traced once, then the cached program runs
    pt.enable(False)
    try:
        np.testing.assert_allclose(sg(P.to_tensor(x)).numpy(), x + 1.0)
        assert len(calls) == 2  # eager while conversion is off
    finally:
        pt.enable(True)


def test_to_static_and_config_resolve_to_the_card_without_cuda(monkeypatch):
    from paddle_tpu_torch.framework import place

    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call was made")

    monkeypatch.setattr(place._state, "place", None, raising=False)
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "current_device", no_cuda)
    sf = tp.jit.to_static(lambda a: a + 1.0)
    assert isinstance(sf._exe.place, tp.CUDAPlace)
    assert sf._exe.place.get_device_id() == 0
    cfg = tp.inference.Config("model")
    assert cfg.use_gpu() and cfg.summary()["device"] == "gpu"
    with pytest.raises(RuntimeError, match="GPU"):
        cfg.enable_tpu()
    cfg.disable_gpu()
    assert not cfg.use_gpu()

"""The port's ONNX export and runner against the JAX package's, on the CPU.

Mirrors ``tests/test_onnx_export.py`` (12 cases).  Each model is built in
both packages under fresh unique-name counters, the JAX package's
weights carried into the port's, and exported by both (the JAX package's
trace under a fresh counter too, as the port's export always traces).
The two files must hold the same graph: the same nodes (op types,
inputs, outputs, names and attributes), the same initializers bit for
bit and the same inputs and outputs.  Each file runs in both packages'
runners: the outputs agree with the port's eager forward at the JAX
test's tolerances (1e-4 relative, 1e-5 absolute; LeNet 1e-3 / 1e-4), and
the port's runner agrees with the JAX package's on the same file at
1e-5 relative (its Conv sums windows in another order).
"""

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.onnx import export as jexport
from paddle_tpu.onnx import runner as jrunner

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.onnx import export as texport
from paddle_tpu_torch.onnx import proto, runner as trunner
from paddle_tpu_torch.weights import load_paddle_state_dict


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _pair(factory):
    with jnames.guard():
        jp.seed(0)
        jm = factory(jp)
    with tnames.guard():
        tp.seed(0)
        tm = factory(tp)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    if state:
        load_paddle_state_dict(tm, state)
    return jm, tm


def _export_both(factory, shape, tmp_path, **kw):
    jm, tm = _pair(factory)
    with jnames.guard():
        jpath = jexport(jm, str(tmp_path / "j"),
                        input_spec=[jp.jit.InputSpec(shape, "float32", "x")],
                        **kw)
    tpath = texport(tm, str(tmp_path / "t"),
                    input_spec=[tp.jit.InputSpec(shape, "float32", "x")],
                    **kw)
    return jm, tm, jpath, tpath


def _roundtrip(factory, x, tmp_path, rtol=1e-4, atol=1e-5):
    jm, tm, jpath, tpath = _export_both(factory, list(x.shape), tmp_path)
    tm.eval()
    ref = tm(tp.to_tensor(x)).numpy()
    gj, gt = jrunner.load(jpath), trunner.load(tpath)
    assert gt.nodes == gj.nodes
    assert sorted(gt.inits) == sorted(gj.inits)
    for name, a in gj.inits.items():
        assert gt.inits[name].dtype == a.dtype
        np.testing.assert_array_equal(gt.inits[name], a)
    assert (gt.input_names, gt.output_names) == (gj.input_names,
                                                 gj.output_names)
    feed = {gt.input_names[0]: x}
    outs = {}
    for rname, run, load in (("j", jrunner.run, jrunner.load),
                             ("t", trunner.run, trunner.load)):
        for fname, path in (("j", jpath), ("t", tpath)):
            (outs[rname + fname],) = run(load(path), feed)
    for out in outs.values():
        np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)
    np.testing.assert_allclose(outs["tt"], outs["jt"], rtol=1e-5, atol=1e-6)
    return gt


def test_proto_roundtrip():
    t = proto.tensor("w", (2, 3), proto.DTYPE["float32"],
                     np.arange(6, dtype="float32").tobytes())
    msg = proto.parse_message(t)
    assert [int(v) for v in msg[1]] == [2, 3]
    assert int(msg[2][0]) == 1 and msg[8][0] == b"w"
    np.testing.assert_array_equal(np.frombuffer(msg[9][0], "float32"),
                                  np.arange(6, dtype="float32"))
    import paddle_tpu.onnx.proto as jproto

    for value in (-1, 3, 2.5, "same", [1, -2], [0.5, 1.5], True):
        assert proto.attribute("a", value) == jproto.attribute("a", value)
    assert int(proto.parse_message(proto.attribute("axis", -1))[3][0]) \
        - (1 << 64) == -1


def test_mlp_export_parity(tmp_path):
    x = np.random.RandomState(0).randn(3, 8).astype("float32")
    g = _roundtrip(lambda P: P.nn.Sequential(
        P.nn.Linear(8, 16), P.nn.ReLU(), P.nn.Linear(16, 4),
        P.nn.Softmax()), x, tmp_path)
    ops = [n["op"] for n in g.nodes]
    assert "MatMul" in ops and "Relu" in ops and "Softmax" in ops
    assert any(v.shape == (8, 16) for v in g.inits.values())


def test_conv_bn_pool_export_parity(tmp_path):
    x = np.random.RandomState(1).randn(2, 2, 8, 8).astype("float32")
    g = _roundtrip(lambda P: P.nn.Sequential(
        P.nn.Conv2D(2, 4, 3, padding=1), P.nn.BatchNorm2D(4), P.nn.ReLU(),
        P.nn.MaxPool2D(2, 2), P.nn.Flatten(), P.nn.Linear(4 * 4 * 4, 5)),
        x, tmp_path)
    ops = [n["op"] for n in g.nodes]
    assert "Conv" in ops and "BatchNormalization" in ops and "MaxPool" in ops


def _block(P):
    class Block(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = P.nn.LayerNorm(16)
            self.fc = P.nn.Linear(16, 16)

        def forward(self, x):
            return P.nn.functional.gelu(self.fc(self.ln(x)))

    return Block()


def test_gelu_layernorm_export_parity(tmp_path):
    x = np.random.RandomState(2).randn(2, 4, 16).astype("float32")
    g = _roundtrip(_block, x, tmp_path)
    ops = [n["op"] for n in g.nodes]
    assert "LayerNormalization" in ops and "Erf" in ops


def test_lenet_export_parity(tmp_path):
    x = np.random.RandomState(3).randn(1, 1, 28, 28).astype("float32")
    _roundtrip(lambda P: P.vision.models.LeNet(num_classes=10), x, tmp_path,
               rtol=1e-3, atol=1e-4)


def test_unmapped_op_raises(tmp_path):
    class Odd(tp.nn.Layer):
        def forward(self, x):
            return tp.cumsum(x, axis=1)

    with pytest.raises(NotImplementedError, match="cumsum"):
        texport(Odd(), str(tmp_path / "odd"),
                input_spec=[tp.jit.InputSpec([2, 3], "float32", "x")])
    with pytest.raises(ValueError, match="input_spec"):
        texport(Odd(), str(tmp_path / "odd"))


def _fn_layer(fn):
    def factory(P):
        class L(P.nn.Layer):
            def forward(self, x):
                return fn(P, x)

        return L()

    return factory


def test_flatten_variants_export_parity(tmp_path):
    x = np.random.RandomState(4).randn(2, 3, 4, 5).astype("float32")
    _roundtrip(_fn_layer(lambda P, x: P.flatten(x)), x, tmp_path)
    _roundtrip(_fn_layer(lambda P, x: P.flatten(x, start_axis=2)), x,
               tmp_path)


def test_scale_bias_order_export_parity(tmp_path):
    x = np.random.RandomState(5).randn(2, 3).astype("float32")
    for after in (True, False):
        _roundtrip(_fn_layer(lambda P, x: P.scale(
            x, scale=2.0, bias=1.0, bias_after_scale=after)), x, tmp_path)


def test_padded_avgpool_export_parity(tmp_path):
    x = np.random.RandomState(6).randn(1, 1, 4, 4).astype("float32")
    g = _roundtrip(lambda P: P.nn.Sequential(
        P.nn.AvgPool2D(2, stride=2, padding=1)), x, tmp_path)
    assert g.nodes[0]["op"] == "AveragePool"


def test_asymmetric_padding_export_parity(tmp_path):
    x = np.random.RandomState(2).randn(1, 1, 6, 6).astype("float32")
    g = _roundtrip(lambda P: P.nn.Sequential(
        P.nn.Conv2D(1, 2, 3, padding=[1, 0, 2, 0]), P.nn.ReLU()), x,
        tmp_path)
    conv = next(n for n in g.nodes if n["op"] == "Conv")
    assert list(conv["attrs"]["pads"]) == [1, 2, 0, 0]  # t, l, b, r


def test_approximate_gelu_export_parity(tmp_path):
    x = np.random.RandomState(5).randn(2, 8).astype("float32") * 2
    g = _roundtrip(_fn_layer(lambda P, x: P.nn.functional.gelu(
        x, approximate=True)), x, tmp_path)
    assert any(n["op"] == "Tanh" for n in g.nodes)


def test_opset_validation(tmp_path):
    with pytest.raises(ValueError, match="opset"):
        texport(tp.nn.Sequential(tp.nn.LayerNorm(8)), str(tmp_path / "a"),
                input_spec=[tp.jit.InputSpec([2, 8], "float32", "x")],
                opset_version=13)
    with pytest.raises(ValueError, match="opset"):
        texport(tp.nn.Linear(4, 4), str(tmp_path / "b"),
                input_spec=[tp.jit.InputSpec([2, 4], "float32", "x")],
                opset_version=9)


def test_export_bytes_do_not_depend_on_earlier_names(tmp_path):
    """The same weights give the same file, whatever names the process
    handed out before (the trace runs under fresh counters)."""
    _, tm = _pair(lambda P: P.vision.models.LeNet(num_classes=10))
    spec = [tp.jit.InputSpec([1, 1, 28, 28], "float32", "x")]
    first = open(texport(tm, str(tmp_path / "a"), input_spec=spec),
                 "rb").read()
    for _ in range(3):
        tnames.generate("tmp")
        tp.nn.Linear(3, 3)
    again = open(texport(tm, str(tmp_path / "b"), input_spec=spec),
                 "rb").read()
    assert again == first

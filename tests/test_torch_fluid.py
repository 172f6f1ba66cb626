"""``paddle.fluid`` (the v2.1 namespace) and BASELINE config 0's script
against the reference, on the CPU.

``paddle_tpu_torch/examples/fluid_mnist.py`` (the reference's
``examples/fluid_mnist.py`` with ``--device``): its first three losses
from the reference script's initial weights (carried with
``fluid.io.set_program_state``) within 1e-5 relative of the reference's,
and its CLI.  The namespace's public names module by module; a program
of fluid.layers / fluid.nets builders (``nets.scaled_dot_product_attention``
records the attention op) and the ``fluid.dygraph`` layers on the same
weights; fluid's save / load forms; ``lstm``, ``image_resize``,
``pool3d``, ``conv3d`` and ``sequence_pool`` in static programs run by
both Executors; the names that wait for a later slice raise naming their
ROADMAP item.
"""

import importlib
import os
import sys
import types

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.fluid as jfluid
from paddle_tpu.static import executor as jexecutor

import paddle_tpu_torch as tp
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.examples import fluid_mnist as ex
from paddle_tpu_torch.weights import load_paddle_state_dict

from torch_static_parity import (  # noqa: F401
    reference_variable_indexing, run_both, scope_arrays)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    tp.disable_static()


def _reference_mnist(monkeypatch, steps):
    """The reference script's losses, and its scope right after its
    startup program."""
    spec = importlib.util.spec_from_file_location(
        "ref_fluid_mnist", os.path.join(ROOT, "examples", "fluid_mnist.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    start = {}
    real = jexecutor.Executor.run

    def run(self, program=None, *a, **k):
        out = real(self, program, *a, **k)
        if not start:
            start.update(scope_arrays(jp.static.global_scope()))
        return out

    monkeypatch.setattr(jexecutor.Executor, "run", run)
    monkeypatch.setattr(sys, "argv", ["fluid_mnist.py", "--steps",
                                      str(steps)])
    return script.main(), start


def test_fluid_mnist_first_losses_match_reference(monkeypatch, capsys):
    want, start = _reference_mnist(monkeypatch, 3)
    monkeypatch.undo()
    got, _, carried = ex.run(ex.parse_args(["--steps", "3", "--device",
                                            "cpu"]), init_state=start,
                             log=lambda m: None)
    assert set(carried) == set(start)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the CLI: its own weights, the loss falls (it asserts so)
    losses = ex.main(["--steps", "3", "--device", "cpu"])
    assert len(losses) == 3 and "OK: loss" in capsys.readouterr().out


FLUID_MODULES = ("", ".layers", ".nets", ".io", ".dygraph", ".dygraph.nn",
                 ".dygraph.base", ".optimizer", ".initializer", ".framework",
                 ".metrics", ".clip", ".regularizer", ".executor",
                 ".backward", ".param_attr", ".contrib",
                 ".contrib.mixed_precision", ".contrib.slim.quantization",
                 ".core")


@pytest.mark.parametrize("sub", FLUID_MODULES)
def test_fluid_names_match_reference(sub):
    def public(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and not isinstance(v, types.ModuleType)}

    ref = importlib.import_module("paddle_tpu.fluid" + sub)
    port = importlib.import_module("paddle_tpu_torch.fluid" + sub)
    assert public(port) == public(ref)


def _layers_program(P, st):
    fluid = importlib.import_module(P.__name__ + ".fluid")
    L, nets = fluid.layers, fluid.nets
    img = L.data("img", shape=[4, 1, 8, 8], append_batch_size=False)
    x = L.data("x", shape=[4, 6], append_batch_size=False)
    seq = L.data("seq", shape=[4, 8], append_batch_size=False)
    label = L.data("label", shape=[4, 1], dtype="int64",
                   append_batch_size=False)
    conv = nets.simple_img_conv_pool(img, num_filters=4, filter_size=3,
                                     pool_size=2, pool_stride=2, act="relu")
    pred = L.fc(conv, size=3, act="softmax")
    h = L.fc(x, size=6, act="tanh")
    att = nets.scaled_dot_product_attention(
        L.reshape(seq, [1, 4, 8]), L.reshape(seq, [1, 4, 8]),
        L.reshape(seq, [1, 4, 8]), num_heads=2)
    return [
        L.cross_entropy(pred, label),
        L.pool2d(conv, global_pooling=True, pool_type="avg"),
        L.elementwise_add(h, x, act="relu"),
        L.reduce_sum(h, dim=1, keep_dim=True),
        L.matmul(h, x, transpose_y=True, alpha=0.5),
        L.fill_constant([2, 3], "float32", 1.5),
        L.smooth_l1(h, x),
        L.sigmoid_cross_entropy_with_logits(h, L.sigmoid(x)),
        L.dice_loss(pred, label),
        L.bpr_loss(pred, label),
        L.clip_by_norm(h, 1.0),
        L.sums([h, x]),
        L.soft_relu(h),
        L.l2_normalize(h, axis=1),
        L.cos_sim(h, x),
        nets.glu(h, dim=1),
        att,
        L.space_to_depth(img, 2),
        L.accuracy(pred, label),
    ]


def test_fluid_layers_program_matches_reference(reference_variable_indexing):
    """One forward of a program of fluid.layers / fluid.nets builders
    from the same parameters."""
    r = np.random.RandomState(0)
    feed = {"img": r.rand(4, 1, 8, 8).astype("float32"),
            "x": r.randn(4, 6).astype("float32"),
            "seq": r.randn(4, 8).astype("float32"),
            "label": r.randint(0, 3, (4, 1)).astype("int64")}
    got_j, got_t = run_both(_layers_program, lambda i: feed, lambda o: o)
    for k, (a, b) in enumerate(zip(got_t[0], got_j[0])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                   err_msg=f"output {k}")


def test_fluid_host_side_layers_match_reference():
    """``unique_with_counts`` (first-appearance order) and ``mean_iou``,
    eagerly."""
    data = np.array([2, 3, 3, 1, 5, 3], "int64")
    with jfluid.dygraph.guard():
        want = jfluid.layers.unique_with_counts(jp.to_tensor(data))
        miou_want = jfluid.layers.mean_iou(
            jp.to_tensor(np.array([0, 1, 2, 2])),
            jp.to_tensor(np.array([0, 2, 2, 1])), 3)
    got = tfluid.layers.unique_with_counts(tp.to_tensor(data))
    miou = tfluid.layers.mean_iou(tp.to_tensor(np.array([0, 1, 2, 2])),
                                  tp.to_tensor(np.array([0, 2, 2, 1])), 3)
    for a, b in zip(got + miou, list(want) + list(miou_want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()),
                                   rtol=1e-6)


def _dygraph_model(fluid):
    D = fluid.dygraph

    class Net(D.Layer):
        def __init__(self):
            super().__init__()
            self.conv = D.Conv2D(1, 3, 3, act="relu")
            self.pool = D.Pool2D(pool_size=2, pool_stride=2)
            self.bn = D.BatchNorm(3, act="tanh")
            self.fc = D.Linear(3 * 3 * 3, 4, act="relu")
            self.ln = D.LayerNorm([4])
            self.prelu = D.PRelu("all")
            self.emb = D.Embedding(size=[10, 4])
            self.bil = D.BilinearTensorProduct(4, 4, 2)

        def forward(self, img, ids):
            h = self.bn(self.pool(self.conv(img)))
            h = self.prelu(self.ln(self.fc(fluid.layers.reshape(
                h, [-1, 27]))))
            e = fluid.layers.reduce_mean(self.emb(ids), dim=1)
            return self.bil(h, e)

    return Net()


def test_fluid_dygraph_layers_match_reference():
    """The fluid.dygraph layer classes (their ``act=``) on the same
    weights, forward and one SGD step."""
    r = np.random.RandomState(1)
    img = r.rand(2, 1, 8, 8).astype("float32")
    ids = r.randint(0, 10, (2, 5)).astype("int64")
    outs = {}
    for P, fluid, names in ((jp, jfluid, None), (tp, tfluid, None)):
        un = importlib.import_module(P.__name__ + ".framework.unique_name")
        with fluid.dygraph.guard(), un.guard():
            model = _dygraph_model(fluid)
            if P is jp:
                state = {k: np.asarray(v.numpy())
                         for k, v in model.state_dict().items()}
            else:
                load_paddle_state_dict(model, state)
            opt = fluid.optimizer.SGDOptimizer(
                learning_rate=0.1, parameter_list=model.parameters())
            out = model(fluid.dygraph.to_variable(img),
                        fluid.dygraph.to_variable(ids))
            loss = fluid.layers.mean(out)
            loss.backward()
            opt.minimize(loss)
            outs[P.__name__] = (np.asarray(out.numpy()), {
                k: np.asarray(v.numpy())
                for k, v in model.state_dict().items()})
    (oj, sj), (ot, st) = outs["paddle_tpu"], outs["paddle_tpu_torch"]
    np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-6)
    assert set(st) == set(sj)
    for k in sj:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_fluid_save_load_forms(tmp_path):
    """fluid.io's v2.1 forms (params, persistables, the inference model
    by directory and feed names), fluid.save / load and DataFeeder give
    back the trained program's values."""
    def fn(P, st):
        fluid = importlib.import_module(P.__name__ + ".fluid")
        x = fluid.layers.data("x", shape=[5])
        y = fluid.layers.data("y", shape=[1])
        pred = fluid.layers.fc(x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
        return x, y, pred, loss

    main, startup = tfluid.Program(), tfluid.Program()
    tp.enable_static()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x, y, pred, loss = fn(tp, tp.static)
    tp.disable_static()
    feeder = tfluid.DataFeeder([x, y])
    r = np.random.RandomState(2)
    rows = [(r.randn(5).astype("float32"), r.randn(1).astype("float32"))
            for _ in range(8)]
    feed = feeder.feed(rows)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss])
        test = main.clone(for_test=True)
        tp.static.normalize_program(test, [x], [pred])
        (want,) = exe.run(test, feed={"x": feed["x"]}, fetch_list=[pred])
        tfluid.io.save_params(exe, str(tmp_path / "p"), main)
        tfluid.io.save_persistables(exe, str(tmp_path / "s"), main)
        tfluid.io.save_inference_model(str(tmp_path / "m"), ["x"], [pred],
                                       exe, main_program=main)
        tfluid.save(main, str(tmp_path / "f"))
    for load in (lambda: tfluid.io.load_params(exe, str(tmp_path / "p"),
                                               main),
                 lambda: tfluid.io.load_persistables(exe, str(tmp_path / "s"),
                                                     main),
                 lambda: tfluid.load(main, str(tmp_path / "f"), exe)):
        with tfluid.scope_guard(tfluid.Scope()):
            load()
            (got,) = exe.run(test, feed={"x": feed["x"]}, fetch_list=[pred])
            np.testing.assert_array_equal(got, want)
    with tfluid.scope_guard(tfluid.Scope()):
        prog, feeds, fetches = tfluid.io.load_inference_model(
            str(tmp_path / "m"), exe)
        (got,) = exe.run(prog, feed={"x": feed["x"]}, fetch_list=fetches)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("call,item", [
    (lambda L: L.Uniform(0.0, 1.0), "Uniform"),
    (lambda L: L.Normal(0.0, 1.0), "Normal"),
], ids=["<lambda>-A.12_0", "<lambda>-A.12_1"])
def test_fluid_names_that_wait_raise(call, item):
    """The distributions that waited for ROADMAP A.12 are bound now, as
    the reference binds them (``fluid.layers`` re-exports
    ``paddle.distribution``'s classes); the deprecated names still raise
    naming their replacement."""
    import paddle_tpu_torch.distribution as D

    d = call(tfluid.layers)
    assert type(d) is getattr(D, item)
    assert getattr(tfluid.layers, item) is getattr(D, item)
    with pytest.raises(NotImplementedError, match="instead"):
        tfluid.layers.dynamic_lstm()


def _data(name, shape, dtype="float32"):
    return name, shape, dtype


# fluid.layers calls that the 3-D, interpolation, sequence and RNN ops
# back: (the program's data, the call)
FLUID_CALLS = {
    "lstm": ([_data("x", [2, 4, 5]), _data("h0", [1, 2, 6]),
              _data("c0", [1, 2, 6])],
             lambda L, x, h0, c0: list(L.lstm(x, h0, c0, 4, 6, 1))),
    "image_resize": ([_data("x", [2, 3, 4, 5])],
                     lambda L, x: L.image_resize(x, out_shape=[6, 8])),
    "pool3d": ([_data("x", [2, 3, 4, 4, 4])],
               lambda L, x: L.pool3d(x, pool_size=2, pool_type="avg",
                                     pool_stride=2)),
    "conv3d": ([_data("x", [2, 3, 4, 5, 4])],
               lambda L, x: L.conv3d(x, 4, 3, padding=1, act="relu")),
    "sequence_pool": ([_data("x", [3, 5, 2]), _data("len", [3], "int64")],
                      lambda L, x, ln: L.sequence_pool(x, "sum",
                                                       length=ln)),
}


@pytest.mark.parametrize("name", sorted(FLUID_CALLS))
def test_fluid_layer_matches_reference(name):
    """The call in a static program, run by both Executors from the
    reference's startup values."""
    data, call = FLUID_CALLS[name]

    def program(P, st):
        L = importlib.import_module(P.__name__ + ".fluid").layers
        ins = [L.data(n, shape=s, dtype=d, append_batch_size=False)
               for n, s, d in data]
        out = call(L, *ins)
        return out if isinstance(out, list) else [out]

    r = np.random.RandomState(0)
    feed = {n: (np.array([5, 0, 3], d) if d == "int64"
                else r.randn(*s).astype(d)) for n, s, d in data}
    got_j, got_t = run_both(program, lambda i: feed, lambda o: o)
    for k, (a, b) in enumerate(zip(got_t[0], got_j[0])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                   err_msg=f"output {k}")

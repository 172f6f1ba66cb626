"""The port's ``paddle.Model`` (``paddle_tpu_torch.hapi``), its callbacks
and ``paddle.flops`` against the reference's on the CPU.

Mirrors ``tests/test_io_vision_hapi.py``'s Model test,
``tests/test_hapi_static.py`` and ``tests/test_flops_tensor_array.py``.
Both packages build their networks under fresh unique-name counters and
the reference's weights are carried into the port's, so every number can
be compared:

* ``fit`` / ``evaluate`` / ``predict`` of a LeNet on ``FakeData``, eager:
  each batch's loss and metric, the eval logs and the predictions within
  1e-5 relative (fp32 convolutions summed in another order, four Adam
  steps);
* the static adapter: its losses against the port's eager engine and the
  reference's static adapter over 5 steps at ``test_hapi_static.py``'s
  tolerance (2e-5), its fit / evaluate / predict, save in one engine and
  load in the other, the ``InputSpec`` errors, metrics without a loss;
* the callbacks: the order of every ``on_*`` call through ``fit`` with
  evaluation equal to the reference's, ``ModelCheckpoint``'s files,
  ``EarlyStopping``'s stop, ``LRScheduler``'s steps, ``ReduceLROnPlateau``
  and ``VisualDL``'s event files, ``ProgressBar``'s text;
* ``flops`` and ``summary`` counts equal to the reference's for LeNet,
  ResNet-18 and ViT-base/16.
"""

import contextlib
import io
import os

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.weights import load_paddle_state_dict

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _pair(factory):
    """``factory(P)``'s network in both packages, the reference's state
    carried into the port's."""
    with jnames.guard():
        jp.seed(0)
        jnet = factory(jp)
    with tnames.guard():
        tp.seed(0)
        tnet = factory(tp)
    load_paddle_state_dict(tnet, {k: np.asarray(v.numpy())
                                  for k, v in jnet.state_dict().items()})
    return jnet, tnet


class Recorder:
    """Records every callback call (name, epoch or step, logs); a mixin
    of each package's ``Callback``."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __getattribute__(self, name):
        if name.startswith("on_"):
            calls = object.__getattribute__(self, "calls")

            def record(*args, **kw):
                logs = kw.get("logs", args[-1] if args and isinstance(
                    args[-1], (dict, type(None))) else None)
                head = [a for a in args if isinstance(a, int)]
                calls.append((name, tuple(head),
                              None if logs is None else dict(logs)))
            return record
        return object.__getattribute__(self, name)


def _recorder(P):
    return type("Rec", (Recorder, P.hapi.callbacks.Callback), {})()


def _lenet_model(P, net):
    from_metric = P.metric.Accuracy()
    model = P.Model(net)
    model.prepare(P.optimizer.Adam(0.001, parameters=model.parameters()),
                  P.nn.CrossEntropyLoss(), from_metric)
    return model


def _logs_close(want, got):
    assert [k for k in want] == [k for k in got]
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], "float64"),
                                   np.asarray(want[k], "float64"), **TOL)


def test_fit_evaluate_predict_match_reference(tmp_path):
    jnet, tnet = _pair(lambda P: P.vision.LeNet())
    res = {}
    for P, net in ((jp, jnet), (tp, tnet)):
        ds = P.vision.datasets.FakeData(num_samples=64,
                                        image_shape=(1, 28, 28))
        model = _lenet_model(P, net)
        rec = _recorder(P)
        model.fit(ds, epochs=1, batch_size=16, verbose=0, shuffle=False,
                  callbacks=[rec])
        logs = model.evaluate(ds, batch_size=16, verbose=0)
        preds = model.predict(ds, batch_size=16, stack_outputs=True)
        path = str(tmp_path / f"{P.__name__}_ckpt")
        model.save(path)
        again = _lenet_model(P, P.vision.LeNet())
        again.load(path)
        np.testing.assert_array_equal(
            again.predict(ds, batch_size=32, stack_outputs=True)[0],
            preds[0])
        res[P] = ([c[2] for c in rec.calls if c[0] == "on_train_batch_end"],
                  logs, preds[0])
    (jb, jl, jpred), (tb, tl, tpred) = res[jp], res[tp]
    assert len(tb) == len(jb) == 4 and "acc" in tl
    for a, b in zip(jb, tb):
        _logs_close(a, b)
    _logs_close(jl, tl)
    assert tpred.shape == (64, 10)
    np.testing.assert_allclose(tpred, jpred, rtol=1e-5, atol=1e-5)


def _toy_data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype("float32")
    y = (x[:, :4].sum(1) > 0).astype("int64")[:, None]
    return x, y


def _toy(P, metrics=True, loss=True, opt=True):
    with (jnames if P is jp else tnames).guard():
        P.seed(0)
        net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                              P.nn.Linear(16, 2))
    spec = P.static.InputSpec
    model = P.Model(net, inputs=[spec([None, 8], "float32", "x")],
                    labels=[spec([None, 1], "int64", "label")])
    model.prepare(
        optimizer=(P.optimizer.Adam(learning_rate=0.05,
                                    parameters=net.parameters())
                   if opt else None),
        loss=P.nn.CrossEntropyLoss() if loss else None,
        metrics=P.metric.Accuracy() if metrics else None)
    return model, net


def _carry(jnet, tnet):
    load_paddle_state_dict(tnet, {k: np.asarray(v.numpy())
                                  for k, v in jnet.state_dict().items()})


@contextlib.contextmanager
def _static(P):
    P.enable_static()
    try:
        yield
    finally:
        P.disable_static()


def test_static_adapter_trajectory_matches_eager_and_reference():
    x, y = _toy_data()
    jm, jnet = _toy(jp)
    with _static(jp):
        want = [float(jm.train_batch([x], [y]).numpy()) for _ in range(5)]
    losses = {}
    for mode in ("eager", "static"):
        tm, tnet = _toy(tp)
        _carry(_toy(jp)[1], tnet)
        with (_static(tp) if mode == "static" else contextlib.nullcontext()):
            losses[mode] = [float(tm.train_batch([x], [y]).numpy())
                            for _ in range(5)]
    np.testing.assert_allclose(losses["static"], losses["eager"],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(losses["static"], want, rtol=2e-5, atol=2e-5)
    assert losses["static"][-1] < losses["static"][0]


def test_static_fit_evaluate_predict():
    x, y = _toy_data()
    model, _ = _toy(tp)
    _carry(_toy(jp)[1], model.network)
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    with _static(tp):
        losses = [float(model.train_batch([bx], [by]).numpy())
                  for _ in range(8) for bx, by in batches]
        res = model.evaluate(batches, verbose=0)
        out = model.predict_batch([x[:8]])
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert res["acc"] > 0.9, res
    assert tuple(out.numpy().shape) == (8, 2)


@pytest.mark.parametrize("first", ["static", "eager"])
def test_save_in_one_engine_load_in_the_other(tmp_path, first):
    x, y = _toy_data()
    model, _ = _toy(tp)
    with (_static(tp) if first == "static" else contextlib.nullcontext()):
        for _ in range(10):
            model.train_batch([x], [y])
        pred = np.asarray(model.predict_batch([x[:4]]).numpy())
        model.save(str(tmp_path / "ckpt"))
    other, _ = _toy(tp)
    with (_static(tp) if first == "eager" else contextlib.nullcontext()):
        other.load(str(tmp_path / "ckpt"))
        got = np.asarray(other.predict_batch([x[:4]]).numpy())
        # the loaded optimizer state goes on training in this engine
        other.train_batch([x], [y])
    np.testing.assert_allclose(got, pred, rtol=1e-5, atol=1e-6)
    assert os.path.exists(str(tmp_path / "ckpt.pdopt"))


def test_static_requires_input_specs():
    model = tp.Model(tp.nn.Linear(4, 2))
    model.prepare(loss=tp.nn.CrossEntropyLoss())
    with _static(tp), pytest.raises(RuntimeError, match="InputSpec"):
        model.train_batch([np.zeros((2, 4), "float32")],
                          [np.zeros((2, 1), "int64")])


def test_static_metrics_without_loss_evaluates():
    x, y = _toy_data()
    res = {}
    for P in (jp, tp):
        model, net = _toy(P, loss=False, opt=False)
        if P is tp:
            _carry(_toy(jp)[1], net)
        batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
        with _static(P):
            res[P] = model.evaluate(batches, verbose=0)
    assert 0.0 <= float(res[tp]["acc"]) <= 1.0
    _logs_close(res[jp], res[tp])


def _fit_with(P, net, callbacks, tmp_path=None, epochs=3, opt=None, **kw):
    x, y = _toy_data(32)
    model = P.Model(net)
    model.prepare(opt or P.optimizer.SGD(0.1, parameters=net.parameters()),
                  P.nn.CrossEntropyLoss(), P.metric.Accuracy())
    train = [(x[i:i + 8], y[i:i + 8]) for i in range(0, 32, 8)]
    model.fit(train, train[:2], epochs=epochs, verbose=0,
              save_dir=None if tmp_path is None else str(tmp_path),
              callbacks=callbacks, **kw)
    return model


def test_callbacks_are_called_in_the_reference_order():
    calls = {}
    for P in (jp, tp):
        rec = _recorder(P)
        _fit_with(P, _toy(P)[1], [rec], eval_freq=2)
        calls[P] = rec.calls
    assert [c[:2] for c in calls[tp]] == [c[:2] for c in calls[jp]]
    names = [c[0] for c in calls[tp]]
    assert names[0] == "on_train_begin" and names[-1] == "on_train_end"
    assert names.count("on_eval_end") == 1
    for a, b in zip(calls[jp], calls[tp]):
        if a[2] is not None:
            assert set(a[2]) == set(b[2])


def test_model_checkpoint_and_early_stopping(tmp_path):
    ran = {}
    for P in (jp, tp):
        d = tmp_path / P.__name__
        stop = P.callbacks.EarlyStopping(monitor="acc", patience=0,
                                         mode="max", baseline=None)
        rec = _recorder(P)
        # lr 0: the accuracy cannot improve, so the stop comes after the
        # second evaluation
        net = _toy(P)[1]
        _fit_with(P, net, [stop, rec], tmp_path=d, epochs=5,
                  opt=P.optimizer.SGD(0.0, parameters=net.parameters()))
        ran[P] = ([c[1] for c in rec.calls if c[0] == "on_epoch_end"],
                  sorted(os.listdir(d)), stop.stop_training)
    assert ran[tp] == ran[jp]
    epochs, files, stopped = ran[tp]
    assert stopped and epochs == [(0,), (1,)]
    assert files == ["0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams",
                     "final.pdopt", "final.pdparams"]


def test_lr_scheduler_steps_by_batch_and_by_epoch():
    lrs = {}
    for P in (jp, tp):
        out = []
        for by_step in (True, False):
            net = _toy(P)[1]
            sched = P.optimizer.lr.StepDecay(0.1, step_size=3, gamma=0.5)
            opt = P.optimizer.SGD(sched, parameters=net.parameters())
            cb = P.callbacks.LRScheduler(by_step=by_step,
                                         by_epoch=not by_step)
            _fit_with(P, net, [cb], epochs=2, opt=opt)
            out.append((sched.last_epoch, opt.get_lr()))
        lrs[P] = out
    assert lrs[tp] == lrs[jp] == [(8, 0.025), (2, 0.1)]


def test_reduce_lr_on_plateau():
    got = {}
    for P in (jp, tp):
        net = P.nn.Linear(2, 1)
        o = P.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())

        class FakeModel:
            _optimizer = o

        cb = P.callbacks.ReduceLROnPlateau(monitor="loss", factor=0.5,
                                           patience=2, verbose=0, cooldown=1)
        cb.model = FakeModel()
        cb.on_train_begin()
        seen = []
        for v in (1.0, 1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5):
            cb.on_eval_end({"loss": v})
            seen.append(o.get_lr())
        got[P] = seen
    assert got[tp] == got[jp]
    assert got[tp][2] == 0.05 and got[tp][-1] < 0.05
    with pytest.raises(ValueError):
        tp.callbacks.ReduceLROnPlateau(factor=1.0)


def test_visualdl_writes_event_files(tmp_path):
    files = {}
    for P in (jp, tp):
        d = tmp_path / P.__name__
        _fit_with(P, _toy(P)[1], [P.callbacks.VisualDL(str(d))], epochs=1)
        files[P] = sorted((os.path.relpath(r, d), len(fs))
                          for r, _, fs in os.walk(d) if fs)
    assert files[tp] == files[jp] == [("eval", 1), ("train", 1)]


def test_progress_bar_prints_the_reference_text():
    text = {}
    for P in (jp, tp):
        buf = io.StringIO()
        bar = P.hapi.ProgressBar(num=3, file=buf)
        bar.update(1, [("loss", 0.5), ("acc", [0.25]), ("n", 3)])
        bar.update(3, [("loss", 0.125)])
        text[P] = buf.getvalue()
    assert text[tp] == text[jp] and text[tp].endswith("\n")


@pytest.mark.parametrize("name,shape", [
    ("LeNet", [1, 1, 28, 28]), ("resnet18", [1, 3, 64, 64]),
    ("vit_b_16", [1, 3, 224, 224])])
def test_flops_and_summary_match_reference(name, shape, capsys):
    counts = {}
    for P in (jp, tp):
        with (jnames if P is jp else tnames).guard():
            P.seed(0)
            net = getattr(P.vision.models, name)()
        n = P.flops(net, shape)
        detail = P.flops(net, shape, print_detail=True)
        table = capsys.readouterr().out
        custom = P.flops(net, shape, custom_ops={P.nn.Linear:
                                                 lambda m, x, y: 0})
        total = P.summary(net)["total_params"]
        model_total = P.Model(net).summary()["total_params"]
        capsys.readouterr()
        counts[P] = (n, detail, custom, total, model_total, table)
    assert counts[tp] == counts[jp]
    n, detail, custom, total, model_total, _ = counts[tp]
    assert n == detail and custom < n and total == model_total
    if name == "LeNet":
        assert 3e5 < n < 4e5
    if name == "vit_b_16":
        assert total == 86567656

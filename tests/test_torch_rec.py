"""The port's DeepFM, wide&deep and ``paddle.metric`` against the
reference's, on the CPU (BASELINE config 4).

Each model is built in both packages under fresh unique-name counters
and the reference's ``state_dict()`` is carried into the port's
(``weights.load_paddle_state_dict``, through
``tests/torch_step_parity.py``'s ``pair``).  The geometry is small (8 fields
of 50 rows, dim 8, tower 32-16) so that every check stays cheap.
Compared (fp32): ``synthetic_click_batch``'s arrays bit for bit; the
forward logits (1e-5 relative to the largest); 5 eager Adam steps of
losses (1e-5 relative) and the parameters after them (1e-4 of each
tensor's largest value: Adam's first steps move by ~lr whatever the
gradient's size, so a rounding where a gradient is near 0 moves the
parameter by a fraction of lr); every metric class on the same inputs
(exact, the states are counts); the table split over mp = 2 on gloo
ranks against the whole table's trajectory in this process (losses to
1e-5); and ``train_deepfm.py``'s loop and CLI.
"""

import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.metric  # noqa: F401
import paddle_tpu.models  # noqa: F401

import paddle_tpu_torch as tp
import paddle_tpu_torch.models  # noqa: F401
import torch_dist_workers as workers
from torch_step_parity import pair

TOL = 1e-5
SMALL = dict(field_vocab_sizes=(50,) * 8, dense_dim=4, embedding_dim=8,
             hidden_sizes=(32, 16), shard_axis=None)


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _pair(name):
    """The model in both packages, the reference's weights carried into the
    port's, and those weights."""
    jm, tm = pair(lambda P: getattr(P.models, name)(P.models.RecConfig(
        **SMALL)))
    return jm, tm, {k: np.asarray(v.numpy())
                    for k, v in jm.state_dict().items()}


def _logits(P, model, batch):
    ids, dense, _ = batch
    return np.asarray(model(P.to_tensor(ids), P.to_tensor(dense)).numpy())


@pytest.mark.parametrize("cfg,batch,seed", [
    (SMALL, 64, 0),
    (dict(SMALL, field_vocab_sizes=(7, 1000, 3, 50000)), 33, 5),
    ({}, 16, 123),
], ids=["small", "ragged-vocab", "default"])
def test_synthetic_click_batch_is_the_references(cfg, batch, seed):
    want = jp.models.synthetic_click_batch(jp.models.RecConfig(**cfg),
                                           batch, seed=seed)
    got = tp.models.synthetic_click_batch(tp.models.RecConfig(**cfg), batch,
                                          seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert list(tp.models.RecConfig(**cfg).offsets()) == list(
        jp.models.RecConfig(**cfg).offsets())


@pytest.mark.parametrize("name", ["DeepFM", "WideDeep"])
def test_rec_forward_and_adam_steps_match_reference(name):
    """The forward on carried weights, then 5 eager Adam steps (the
    example's loop) in each package from the same weights."""
    jm, tm, _ = _pair(name)
    cfg = tp.models.RecConfig(**SMALL)
    batch = tp.models.synthetic_click_batch(cfg, 64, seed=9)
    want = _logits(jp, jm, batch)
    got = _logits(tp, tm, batch)
    assert got.shape == (64, 1)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())

    def run(P, model):
        F = P.nn.functional
        o = P.optimizer.Adam(0.02, parameters=model.parameters())
        out = []
        for i in range(5):
            ids, dense, label = tp.models.synthetic_click_batch(cfg, 128,
                                                                seed=i)
            loss = F.binary_cross_entropy_with_logits(
                model(P.to_tensor(ids), P.to_tensor(dense)),
                P.to_tensor(label))
            loss.backward()
            o.step()
            o.clear_grad()
            out.append(float(loss.numpy()))
        return out

    jl, tl = run(jp, jm), run(tp, tm)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[-1] < tl[0]
    js = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        w = js[k]
        np.testing.assert_allclose(v.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-3),
                                   err_msg=k)


def test_deepfm_second_order_is_the_pairwise_sum():
    """The sum-square identity equals the explicit pairwise dots."""
    _, tm, _ = _pair("DeepFM")
    cfg = tp.models.RecConfig(**SMALL)
    ids, dense, _ = tp.models.synthetic_click_batch(cfg, 16, seed=3)
    emb = tm.embedding(tp.to_tensor(ids)).numpy()
    dvec = tm.dense_emb(tp.to_tensor(dense)).numpy()[:, None, :]
    allv = np.concatenate([emb, dvec], axis=1).astype(np.float64)
    f = allv.shape[1]
    pairwise = sum((allv[:, i] * allv[:, j]).sum(-1)
                   for i in range(f) for j in range(i + 1, f))
    s = allv.sum(1)
    ident = 0.5 * ((s * s).sum(-1) - (allv * allv).sum(1).sum(-1))
    np.testing.assert_allclose(ident, pairwise, rtol=1e-9)


def test_metrics_match_reference():
    """Accuracy (top 1 and top 1, 3), Precision, Recall and Auc (2-column,
    1-column and 1-D predictions) of both packages on the same inputs,
    their states included; ``accuracy`` the functional."""
    r = np.random.RandomState(0)
    pred = r.rand(200, 10).astype("float32")
    label = r.randint(0, 10, (200, 1)).astype("int64")
    prob = r.rand(300).astype("float32")
    yes = (r.rand(300) < prob).astype("float32")
    for topk in (1, (1, 3)):
        jm, tm = jp.metric.Accuracy(topk), tp.metric.Accuracy(topk)
        for lo in (0, 100):
            jc = jm.compute(pred[lo:lo + 100], label[lo:lo + 100])
            tc = tm.compute(tp.to_tensor(pred[lo:lo + 100]),
                            tp.to_tensor(label[lo:lo + 100]))
            np.testing.assert_array_equal(tc, jc)
            assert tm.update(tc) == jm.update(jc)
        assert tm.accumulate() == jm.accumulate()
        assert tm.name() == jm.name()
    for cls in ("Precision", "Recall"):
        jm, tm = getattr(jp.metric, cls)(), getattr(tp.metric, cls)()
        for lo in (0, 150):
            jm.update(prob[lo:lo + 150], yes[lo:lo + 150])
            tm.update(tp.to_tensor(prob[lo:lo + 150]),
                      tp.to_tensor(yes[lo:lo + 150]))
        assert (tm.tp, tm.accumulate()) == (jm.tp, jm.accumulate())
        assert tm.name() == jm.name()
    for p in (np.stack([1 - prob, prob], 1), prob[:, None], prob):
        jm, tm = jp.metric.Auc(), tp.metric.Auc(num_thresholds=4095)
        jm.update(p, yes)
        tm.update(tp.to_tensor(p), yes)
        np.testing.assert_array_equal(tm._stat_pos, jm._stat_pos)
        np.testing.assert_array_equal(tm._stat_neg, jm._stat_neg)
        assert tm.accumulate() == jm.accumulate()
        tm.reset()
        assert tm.accumulate() == 0.0
    want = np.asarray(jp.metric.accuracy(jp.to_tensor(pred),
                                         jp.to_tensor(label), k=3).numpy())
    got = tp.metric.accuracy(tp.to_tensor(pred), tp.to_tensor(label),
                             k=3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_rec_table_split_over_mp2_matches_the_whole_table(tmp_path):
    """DeepFM with its tables split over mp = 2 (gloo ranks, each holding
    half the rows, an all-reduce summing the looked-up rows) against the
    whole tables in this process: 5 Adam steps of losses, and each rank's
    rows after them against the same rows of the whole table."""
    _, tm, state = _pair("DeepFM")
    cfg = tp.models.RecConfig(**SMALL)
    batches = [tp.models.synthetic_click_batch(cfg, 64, seed=i)
               for i in range(5)]
    o = tp.optimizer.Adam(0.02, parameters=tm.parameters())
    want = []
    for ids, dense, label in batches:
        loss = tp.nn.functional.binary_cross_entropy_with_logits(
            tm(tp.to_tensor(ids), tp.to_tensor(dense)), tp.to_tensor(label))
        loss.backward()
        o.step()
        o.clear_grad()
        want.append(float(loss.numpy()))
    whole = {k: v.numpy() for k, v in tm.state_dict().items()}
    ranks = workers.run(tmp_path, 2, "rec_mp_train",
                        {"cfg": dict(SMALL, shard_axis="mp"),
                         "state": state, "batches": batches})
    per = cfg.total_vocab // 2
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], want, rtol=TOL)
        assert got["distributed"] == [True, True]
        for k in ("embedding.weight", "fo_weight.weight"):
            assert got["state"][k].shape[0] == per
            np.testing.assert_allclose(
                got["state"][k], whole[k][r * per:(r + 1) * per],
                rtol=0, atol=1e-6)


def test_train_deepfm_loop_and_cli():
    """The example's loop (12 steps, the loss falls) and its CLI with
    ``--device cpu``."""
    from paddle_tpu_torch.examples import train_deepfm as ex

    losses, auc = ex.main(["--device", "cpu", "--steps", "12", "--batch",
                           "256", "--vocab", "100"])
    assert len(losses) == 12 and np.mean(losses[-5:]) < np.mean(losses[:5])
    assert 0.5 < auc <= 1.0
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.examples.train_deepfm",
         "--device", "cpu", "--steps", "12", "--model", "wide_deep",
         "--batch", "256", "--vocab", "100"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "held-out AUC" in out.stdout

"""``fleet`` on ``nn.Layer`` in the port against the reference, on the CPU.

Two gloo ranks (``tests/torch_dist_workers.py``: ``fleet_checks``, one
spawn) run every multi-rank case; the reference runs in this process,
single-device, from the same weights:

* ``DataParallel`` at dp=2 (each rank half the batch, gradients averaged
  in the backward): the reference's ``test_dp_matches_single_device``
  (Linear(4, 1), SGD 0.1, 5 steps) at its tolerances, rtol 1e-5 / atol
  1e-6;
* ``DygraphShardingOptimizer`` at sharding=2 under ``distributed_model``
  / ``distributed_optimizer`` (AdamW with a clip that bites, 3 steps):
  each rank keeps the moments of its greedy partition only (together all
  of them), and the trajectory equals the unsharded dp=2 run's (1e-6)
  and the reference's single-device one (1e-5);
* ``HybridParallelOptimizer``'s clip at mp=2 (column -> row parallel
  linear, one AdamW step with clip 0.05 on a gradient of global norm
  above it): the parameters, gathered from the ranks' slices, equal the
  single-device step's (1e-5);
* ``LocalSGDOptimizer`` (k_steps 2, each rank its own data): the
  parameters average at step 2 and drift apart again at step 3, as two
  reference runs averaged (1e-6);
* DGC's sparse exchange: ``tests/dgc_train_script.py``'s two ranks and
  its expected parameters and residual;
* the paddle-shaped GPT with ``use_parallel`` at mp=2 through
  ``distributed_model`` / ``distributed_optimizer``, 2 AdamW steps:
  losses to 1e-5 relative of the reference's single-device run, the
  parameters gathered by ``weights.gather_shards`` to 1e-4;
* ``distributed_model`` / ``distributed_optimizer`` return the
  reference's wrapper types for each parallel mode.

In this process: ``fleet.utils.recompute`` against the reference's
``tests/test_autograd.py`` cases (a block's gradients with and without
recompute; dropout replayed), and a ``GPTBlock`` recomputed with
gradients bit for bit the plain block's.
"""

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu import nn as jnn, optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet.utils import recompute as jrecompute
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn import functional as jF

import torch_dist_workers as W

import paddle_tpu_torch as tp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.fleet.utils import recompute as trecompute
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.models import gpt_layers as tgpt
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.weights import gather_shards, load_paddle_state_dict

from torch_parity import interpretable  # noqa: F401  (fixture)

GPT_CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=2,
               max_seq_len=32, dropout=0.0)
MODES = {"data_parallel": {"dp": 2}, "tensor_parallel": {"mp": 2},
         "sharding_parallel": {"sharding": 2}, "pipeline_parallel": {"pp": 2}}


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _adamw(params, clip, lr):
    return jopt.AdamW(learning_rate=lr, parameters=params, weight_decay=0.01,
                      grad_clip=jnn.ClipGradByGlobalNorm(clip))


class _Net(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.col = jnn.Linear(8, 16)
        self.row = jnn.Linear(16, 8)

    def forward(self, x):
        return self.row(jF.gelu(self.col(x)))


def _train(model, opt, batches, loss_fn):
    losses = []
    for x, y in batches:
        loss = loss_fn(model(jp.to_tensor(x)), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses


def _mse(out, y):
    return jF.mse_loss(out, jp.to_tensor(y))


def _reference():
    """Payload (initial weights and data) and the single-device results."""
    rng = np.random.RandomState(3)
    pay, ref = {}, {}
    jp.seed(42)
    net = jnn.Linear(4, 1)
    pay["dp_state"] = _state(net)
    pay["dp_x"] = rng.randn(16, 4).astype("float32")
    pay["dp_y"] = rng.randn(16, 1).astype("float32")
    _train(net, jopt.SGD(0.1, parameters=net.parameters()),
           [(pay["dp_x"], pay["dp_y"])] * 5, _mse)
    ref["dp"] = _state(net)

    with jnames.guard():
        jp.seed(3)
        mlp = jnn.Sequential(jnn.Linear(8, 16), jnn.GELU(),
                             jnn.Linear(16, 4))
    pay["mlp_state"] = _state(mlp)
    pay["mlp_x"] = rng.randn(8, 8).astype("float32")
    pay["mlp_y"] = rng.randn(8, 4).astype("float32")
    ref["mlp_losses"] = _train(mlp, _adamw(mlp.parameters(), 0.5, 1e-2),
                               [(pay["mlp_x"], pay["mlp_y"])] * 3, _mse)
    ref["mlp"] = _state(mlp)

    jp.seed(5)
    net = _Net()
    pay["tp_state"] = _state(net)
    pay["tp_x"] = rng.randn(4, 8).astype("float32")
    loss = (net(jp.to_tensor(pay["tp_x"])) ** 2).mean()
    loss.backward()
    ref["tp_norm"] = float(np.sqrt(sum(
        (p.grad.numpy().astype("float64") ** 2).sum()
        for p in net.parameters())))
    o = _adamw(net.parameters(), 0.05, 1e-2)
    o.step()
    ref["tp"] = _state(net)

    pay["local_x"] = rng.randn(2, 3, 4, 4).astype("float32")
    pay["local_y"] = rng.randn(2, 3, 4, 1).astype("float32")
    nets = []
    for r in range(2):
        net = jnn.Linear(4, 1)
        load = {k: jp.to_tensor(v) for k, v in pay["dp_state"].items()}
        net.set_state_dict(load)
        nets.append(net)
    after = [[], []]
    for i in range(3):
        for r, net in enumerate(nets):
            _train(net, jopt.SGD(0.1, parameters=net.parameters()),
                   [(pay["local_x"][r][i], pay["local_y"][r][i])], _mse)
        if i == 1:
            mean = {k: (_state(nets[0])[k] + _state(nets[1])[k]) / 2
                    for k in pay["dp_state"]}
            for net in nets:
                net.set_state_dict({k: jp.to_tensor(v)
                                    for k, v in mean.items()})
        for r, net in enumerate(nets):
            after[r].append(_state(net))
    ref["localsgd"] = after

    with jnames.guard():
        jp.seed(0)
        gpt = jgpt.GPTForPretraining(jgpt.GPTConfig(**GPT_CFG))
        crit = jgpt.GPTPretrainingCriterion()
    pay["gpt_cfg"] = GPT_CFG
    pay["gpt_state"] = _state(gpt)
    pay["gpt_ids"] = rng.randint(0, 128, (4, 16)).astype("int64")
    pay["gpt_labels"] = rng.randint(0, 128, (4, 16)).astype("int64")
    ref["gpt_losses"] = _train(
        gpt, _adamw(gpt.parameters(), 1.0, 1e-3),
        [(pay["gpt_ids"], pay["gpt_labels"])] * 2,
        lambda out, y: crit(out, jp.to_tensor(y)))
    ref["gpt"] = _state(gpt)

    ref["wrappers"] = {}
    for mode, dims in MODES.items():
        s = jfleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": dims.get("dp", 1),
                            "mp_degree": dims.get("mp", 1),
                            "pp_degree": dims.get("pp", 1),
                            "sharding_degree": dims.get("sharding", 1)}
        jfleet.init(is_collective=True, strategy=s)
        net = jnn.Linear(4, 4)
        ref["wrappers"][mode] = (
            type(jfleet.distributed_model(net)).__name__,
            type(jfleet.distributed_optimizer(
                jopt.SGD(0.1, parameters=net.parameters()))).__name__)
    jmesh._MESH = None
    pay["modes"] = MODES
    return pay, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pay, ref = _reference()
    got = W.run(tmp_path_factory.mktemp("fleet"), 2, "fleet_checks", pay)
    return pay, ref, got


def _halves(a, dim, r):
    return np.split(a, 2, axis=dim)[r]


def test_data_parallel_matches_single_device(runs):
    _, ref, got = runs
    for res in got:
        for k, a in ref["dp"].items():
            np.testing.assert_allclose(res["dp"][k], a, rtol=1e-5, atol=1e-6)


def test_sharding_optimizer_holds_its_partition_and_keeps_the_trajectory(
        runs):
    pay, ref, got = runs
    total = sum(a.size for a in pay["mlp_state"].values())
    sharded = [r["sharding"]["sharded"] for r in got]
    # greedy, largest first: 8x16 on rank 0, then 16x4, 16 and 4 on rank 1
    assert [s["moments"] for s in sharded] == [128, 84]
    assert sum(s["moments"] for s in sharded) == total
    assert [r["sharding"]["unsharded"]["moments"] for r in got] == [total] * 2
    assert sharded[0]["model"] == "ShardingParallel"
    assert sharded[0]["opt"] == "DygraphShardingOptimizer"
    # each rank's loss is its half's; their mean is the batch's
    mean = np.mean([s["losses"] for s in sharded], axis=0)
    np.testing.assert_allclose(mean, ref["mlp_losses"], rtol=1e-5)
    for r in got:
        s, u = r["sharding"]["sharded"], r["sharding"]["unsharded"]
        np.testing.assert_allclose(s["losses"], u["losses"], rtol=1e-6)
        for k, a in ref["mlp"].items():
            np.testing.assert_allclose(s["state"][k], u["state"][k],
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(s["state"][k], a, rtol=1e-5,
                                       atol=1e-6)


def test_hybrid_clip_at_mp2_is_the_single_device_clip(runs):
    _, ref, got = runs
    assert ref["tp_norm"] > 0.05            # the clip bites
    split = {"col.weight": 1, "col.bias": 0, "row.weight": 0}
    for r, res in enumerate(got):
        assert res["mp_clip"]["model"] == "TensorParallel"
        for k, a in ref["tp"].items():
            want = _halves(a, split[k], r) if k in split else a
            np.testing.assert_allclose(res["mp_clip"]["state"][k], want,
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_localsgd_averages_every_k_steps(runs):
    _, ref, got = runs
    for r, res in enumerate(got):
        for i in range(3):
            for k, a in ref["localsgd"][r][i].items():
                np.testing.assert_allclose(res["localsgd"][i][k], a,
                                           rtol=1e-6, atol=1e-6)
    for k in ref["localsgd"][0][1]:
        np.testing.assert_array_equal(got[0]["localsgd"][1][k],
                                      got[1]["localsgd"][1][k])
        assert not np.array_equal(got[0]["localsgd"][2][k],
                                  got[1]["localsgd"][2][k])


def test_dgc_sparse_exchange(runs):
    _, _, got = runs
    expect = np.zeros((16,), "float32")
    expect[2], expect[3] = -10.0 / 2, -20.0 / 2
    for res in got:
        w, resid = res["dgc"]
        np.testing.assert_allclose(w, expect, rtol=1e-6, atol=1e-7)
        assert abs(resid.reshape(-1)[8] - 0.1) < 1e-6
    np.testing.assert_array_equal(got[0]["dgc"][0], got[1]["dgc"][0])


def test_gpt_at_mp2_through_fleet_matches_single_device(runs):
    _, ref, got = runs
    for res in got:
        np.testing.assert_allclose(res["gpt_mp"]["losses"],
                                   ref["gpt_losses"], rtol=1e-5)
    whole = gather_shards([(r["gpt_mp"]["coord"], r["gpt_mp"]["state"])
                           for r in got], tgpt.GPTConfig(**GPT_CFG),
                          {"mp": 2})
    assert sorted(whole) == sorted(ref["gpt"])
    for k, a in ref["gpt"].items():
        np.testing.assert_allclose(whole[k], a, rtol=0, atol=1e-4, err_msg=k)


def test_distributed_model_picks_the_wrapper_by_mode(runs):
    _, ref, got = runs
    for res in got:
        assert res["wrappers"] == ref["wrappers"]


# -- recompute ---------------------------------------------------------------


def _block(P, nn, names):
    with names.guard():
        P.seed(7)
        return nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.Linear(16, 8))


def _run_block(P, block, xb, use, recompute):
    for p in block.parameters():
        p.clear_grad()
    x = P.to_tensor(xb, stop_gradient=False)
    h = recompute(block, x) if use else block(x)
    h.sum().backward()
    return [p.grad.numpy().copy() for p in block.parameters()], \
        x.grad.numpy().copy()


def test_recompute_matches_plain_backward_and_reference(interpretable):
    """The reference's ``test_recompute_matches_plain_backward``: the
    recomputed block's gradients equal the plain block's (here bit for
    bit) and the reference's (1e-5 / 1e-6)."""
    tp.set_device("cpu")
    xb = np.random.RandomState(2).randn(4, 8).astype("float32")
    jblock = _block(jp, jnn, jnames)
    tblock = _block(tp, tnn, tnames)
    load_paddle_state_dict(tblock, _state(jblock))
    jg, jx = _run_block(jp, jblock, xb, True, jrecompute)
    plain_g, plain_x = _run_block(tp, tblock, xb, False, trecompute)
    tg, tx = _run_block(tp, tblock, xb, True, trecompute)
    np.testing.assert_array_equal(tx, plain_x)
    for a, b in zip(tg, plain_g):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_recompute_replays_dropout(interpretable):
    """The reference's ``test_recompute_with_dropout_rng_replay``: the
    backward's replay draws the forward's mask, so the gradients are those
    of the forward's mask: d(sum out)/dW = x^T (mask / (1 - p))."""
    tp.set_device("cpu")
    tp.seed(11)
    lin = tnn.Linear(16, 16)

    def block(x):
        return tF.dropout(lin(x), p=0.5, training=True)

    xb = np.random.RandomState(4).randn(4, 16).astype("float32")
    x = tp.to_tensor(xb, stop_gradient=False)
    out = trecompute(block, x)
    out.sum().backward()
    kept = (out.numpy() != 0.0).astype("float32") * 2.0
    np.testing.assert_allclose(lin.weight.grad.numpy(), xb.T @ kept,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), kept @ lin.weight.numpy().T,
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(x.grad.numpy()).all()


def test_recompute_gpt_block_is_bit_identical(interpretable):
    """One paddle GPTBlock (dropout 0.1 in training mode) through
    ``recompute``: its input's and its parameters' gradients bit for bit
    the plain block's (the smoke checks the same at full width on the
    card)."""
    tp.set_device("cpu")
    with tnames.guard():
        tp.seed(1)
        blk = tgpt.GPTBlock(tgpt.GPTConfig(**{**GPT_CFG, "dropout": 0.1}))
    xb = np.random.RandomState(5).randn(2, 16, 32).astype("float32")
    runs = []
    for use in (False, True):
        tp.seed(9)
        grads, xg = _run_block(tp, blk, xb, use, trecompute)
        runs.append((grads, xg))
    (pg, px), (rg, rx) = runs
    np.testing.assert_array_equal(rx, px)
    for a, b in zip(rg, pg):
        np.testing.assert_array_equal(a, b)


def test_batchnorm_at_dp2_normalises_by_the_global_batch(tmp_path):
    """ROADMAP C.4: BatchNorm2D at dp=2 through ``fleet.distributed_model``
    (two gloo ranks, an 8 x 4 x 3 x 3 batch whose second half, rank 1's,
    is shifted by +3) against the reference's BatchNorm2D over the whole
    batch on one CPU device: the output, the parameters' gradients (the
    wrapper's average of the ranks' ``mean(out * g)`` on their rows is the
    gradient of the global ``mean(out * g)``), the input's gradient (a
    rank's is the gradient of its own loss on its rows: 2x the global
    one's there, 0 elsewhere) and both running statistics, within 1e-5
    relative to each tensor's largest value (the reference on two virtual
    devices agrees with itself within 1.2e-7)."""
    r = np.random.RandomState(0)
    x = r.randn(8, 4, 3, 3).astype("float32")
    x[4:] += 3.0
    g = r.randn(*x.shape).astype("float32")
    # one fresh name generator for the whole reference run: its tape
    # tells tensors apart by name
    old = jnames.switch()
    try:
        jp.seed(0)
        bn = jnn.BatchNorm2D(4, momentum=0.8)
        state = {k: np.asarray(v.numpy())
                 for k, v in bn.state_dict().items()}
        jx = jp.to_tensor(x, stop_gradient=False)
        out = bn(jx)
        jp.mean(out * jp.to_tensor(g)).backward()
        want = {"out": out.numpy(), "dx": jx.grad.numpy(),
                "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
                "mean": bn._mean.numpy(), "var": bn._variance.numpy()}
    finally:
        jnames.switch(old)
    ranks = W.run(tmp_path, 2, "bn_dp", {"x": x, "g": g, "state": state})
    got = {"out": np.concatenate([rk["out"] for rk in ranks]),
           "dx": (ranks[0]["dx"] + ranks[1]["dx"]) / 2}
    for k in ("dw", "db", "mean", "var"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        got[k] = ranks[0][k]
    assert np.abs(ranks[0]["dx"][4:]).max() == 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5 * max(
            1.0, float(np.abs(w).max())), err_msg=k)

"""Tensor parallelism in the port, on two or four gloo ranks spawned on
the CPU, against the reference.

* The Megatron layers on the reference's own setups
  (``tests/test_distributed.py``: column -> row parallel linear at mp=4,
  the vocab-parallel embedding and the parallel cross-entropy), on the
  reference layers' global weights: outputs and gradients (1e-5: fp32
  products in another order).
* The GPT train step at mp=2 (the reference's CFG of
  ``tests/test_pipeline_gpt.py``, 3 steps at lr 1e-4): fp32 (chunked and
  dense cross-entropy, seq-major, GQA with a window) and W8A8, against
  the reference's step on its mp=2 mesh from the same weights: losses to
  1e-5 relative, every parameter gathered back from the ranks' slices to
  2e-5 absolute (fp32: ``tests/test_torch_train.py``'s tolerance at this
  lr, where AdamW's normalised update turns a last-bit difference of a
  near-zero gradient into up to ~lr of a weight) or 1e-4 (W8A8: a
  last-bit difference now and then rounds an activation to the other
  int8 value); and against the port's one-device step, to the same
  tolerances.  Tensor parallelism with pp=2, with ZeRO stage 3 and with
  dp=2 under dropout (the masks injected) on four ranks, the same way.
"""

import numpy as np
import pytest
import torch

import jax

import torch_dist_workers as W

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import meta_parallel as jmpp
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTParams,
                                         build_functional_train_step)
from paddle_tpu_torch.weights import (gather_shards, load_jax_named_params,
                                      params_to_numpy, port_name)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=2,
           max_seq_len=32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _strategy(dp=1, mp=1, pp=1, sharding=1):
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding}
    return s


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    """The reference's two setups at mp=4 (its layers, seeds and inputs),
    and the port's four ranks on the same global weights."""
    jfleet.init(is_collective=True, strategy=_strategy(mp=4, dp=2))
    rng = np.random.RandomState(1)
    paddle.seed(1)
    x = paddle.to_tensor(rng.randn(4, 8).astype("float32"),
                         stop_gradient=False)
    col = jmpp.ColumnParallelLinear(8, 16, gather_output=False, has_bias=True)
    row = jmpp.RowParallelLinear(16, 8, input_is_parallel=True, has_bias=True)
    gy = rng.randn(4, 8).astype("float32")
    out = row(col(x))
    (out * paddle.to_tensor(gy)).sum().backward()
    ref = {"col_out": x.numpy() @ col.weight.numpy() + col.bias.numpy(),
           "linear": [out.numpy(), x.grad.numpy(), col.weight.grad.numpy(),
                      col.bias.grad.numpy(), row.weight.grad.numpy(),
                      row.bias.grad.numpy()]}
    paddle.seed(2)
    emb = jmpp.VocabParallelEmbedding(32, 16)
    ids = np.array([[1, 5, 31], [0, 7, 2]], dtype="int64")
    ge = rng.randn(2, 3, 16).astype("float32")
    e = emb(paddle.to_tensor(ids))
    (e * paddle.to_tensor(ge)).sum().backward()
    ref["embedding"] = [e.numpy(), emb.weight.grad.numpy()]
    ce = jmpp.ParallelCrossEntropy()
    logits = paddle.to_tensor(np.random.RandomState(0).randn(4, 32)
                              .astype("float32"), stop_gradient=False)
    labels = np.array([1, 30, 7, 0], dtype="int64")
    loss = ce(logits, paddle.to_tensor(labels))
    loss.sum().backward()
    ref["xent"] = [loss.numpy().reshape(-1), logits.grad.numpy()]
    payload = {"mp": 4, "wc": col.weight.numpy(), "bc": col.bias.numpy(),
               "wr": row.weight.numpy(), "br": row.bias.numpy(),
               "x": x.numpy(), "gy": gy, "emb": emb.weight.numpy(),
               "ids": ids, "ge": ge, "logits": logits.numpy(),
               "labels": labels}
    got = W.run(tmp_path_factory.mktemp("tp_layers"), 4, "tp_layers",
                payload)
    return ref, got


def _slices(a, n, dim):
    return np.split(a, n, axis=dim)


def test_tensor_parallel_layers_match_serial(layers):
    ref, got = layers
    y, dx, dwc, dbc, dwr, dbr = ref["linear"]
    for r, res in enumerate(got):
        ly, ldx, ldwc, ldbc, ldwr, ldbr = res["linear"]
        np.testing.assert_allclose(ly, y, **TOL)
        np.testing.assert_allclose(ldx, dx, **TOL)
        np.testing.assert_allclose(ldwc, _slices(dwc, 4, 1)[r], **TOL)
        np.testing.assert_allclose(ldbc, _slices(dbc, 4, 0)[r], **TOL)
        np.testing.assert_allclose(ldwr, _slices(dwr, 4, 0)[r], **TOL)
        np.testing.assert_allclose(ldbr, dbr, **TOL)


def test_column_parallel_gather_output_is_the_whole_product(layers):
    ref, got = layers
    for res in got:
        np.testing.assert_allclose(res["gather_output"], ref["col_out"],
                                   **TOL)


def test_vocab_parallel_embedding_and_parallel_ce(layers):
    ref, got = layers
    e, dw = ref["embedding"]
    loss, dlogits = ref["xent"]
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["embedding"][0], e, rtol=1e-6)
        np.testing.assert_allclose(res["embedding"][1],
                                   _slices(dw, 4, 0)[r], **TOL)
        np.testing.assert_allclose(res["xent"][0][:, 0], loss, **TOL)
        # the gradient reaches this rank's vocabulary slice only
        want = np.zeros_like(dlogits)
        want[:, 8 * r:8 * r + 8] = dlogits[:, 8 * r:8 * r + 8]
        np.testing.assert_allclose(res["xent"][1], want, **TOL)


def test_layers_hold_the_slices_of_the_one_rank_initialisation(layers):
    _, got = layers
    gen = torch.Generator().manual_seed(5)
    lim = np.sqrt(6.0 / 24)
    wc = torch.empty(8, 16).uniform_(-lim, lim, generator=gen).numpy()
    gen = torch.Generator().manual_seed(5)
    wr = torch.empty(16, 8).uniform_(-lim, lim, generator=gen).numpy()
    gen = torch.Generator().manual_seed(5)
    we = torch.empty(32, 16).normal_(0.0, 0.02, generator=gen).numpy()
    for r, res in enumerate(got):
        c, rw, e = res["init"]
        np.testing.assert_array_equal(c, _slices(wc, 4, 1)[r])
        np.testing.assert_array_equal(rw, _slices(wr, 4, 0)[r])
        np.testing.assert_array_equal(e, _slices(we, 4, 0)[r])


def test_parallel_layers_are_paddle_layers_an_optimizer_trains(tmp_path):
    """The layers are paddle ``nn.Layer``s: a paddle model holds a
    ColumnParallelLinear and a RowParallelLinear as sublayers (their
    parameters named as the reference names them), the port's AdamW
    trains it one step at mp=1 (one gloo rank), and the loss and the
    parameters after the step equal the reference's same layers'
    (1e-5 relative, 1e-6 absolute)."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.framework import unique_name as jnames
    from paddle_tpu.nn import functional as jF

    saved, jmesh._MESH = jmesh._MESH, None
    try:
        class Net(paddle.nn.Layer):
            def __init__(self):
                super().__init__()
                self.col = jmpp.ColumnParallelLinear(8, 16,
                                                     gather_output=False)
                self.row = jmpp.RowParallelLinear(16, 8,
                                                  input_is_parallel=True)

            def forward(self, x):
                return self.row(jF.gelu(self.col(x)))

        with jnames.guard():
            paddle.seed(3)
            net = Net()
        state = {k: v.numpy() for k, v in net.state_dict().items()}
        x = np.random.RandomState(4).randn(4, 8).astype("float32")
        loss = (net(paddle.to_tensor(x)) ** 2).mean()
        loss.backward()
        jopt.AdamW(learning_rate=1e-2, parameters=net.parameters(),
                   weight_decay=0.01).step()
    finally:
        jmesh._MESH = saved
    res, = W.run(tmp_path, 1, "tp_layer_train", {"state": state, "x": x})
    assert res["layer"] == [True, True]
    assert res["names"] == [p.name for p in net.parameters()]
    np.testing.assert_allclose(res["loss"], float(loss.numpy()), rtol=1e-5)
    for k, v in net.state_dict().items():
        np.testing.assert_allclose(res["state"][k], v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

# id, config overrides, step options, parameter atol
RUNS = [
    ("fp32", {}, {"lr": 1e-4}, 2e-5),
    ("fp32_dense", {}, {"lr": 1e-4, "remat": False, "ce_chunk_rows": 0},
     2e-5),
    ("seq_major", {"seq_major": True}, {"lr": 1e-4, "remat": "dots"}, 2e-5),
    ("int8", {"int8": True}, {"lr": 1e-4, "remat": False,
                              "ce_chunk_rows": 0}, 1e-4),
    ("gqa_window", {"num_heads": 4, "num_kv_heads": 2, "attn_window": 5},
     {"lr": 1e-4, "remat": False}, 2e-5),
    # fewer K/V heads than ranks: both ranks hold the one K/V head
    ("kv_heads_1", {"num_heads": 2, "num_kv_heads": 1}, {"lr": 1e-4},
     2e-5),
    # mp does not divide the heads: attention whole on both ranks
    ("heads_1", {"num_heads": 1}, {"lr": 1e-4}, 2e-5),
]


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 128, (8, 16)).astype("int32"),
            rng.randint(0, 128, (8, 16)).astype("int64"))


def _reference(over, opts, mp, steps=3, dp=1, pp=1, sharding=1,
               dropout=0.0):
    """The reference's step on its mesh: (named global weights before,
    losses, port-named parameters after)."""
    jmesh.build_hybrid_mesh(dp=dp, mp=mp, pp=pp, sharding=sharding)
    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**{**CFG, **over},
                                               dropout=dropout,
                                               use_parallel=mp > 1))
    named = [(n, np.asarray(p._array)) for n, p in jm.named_parameters()]
    step, params, opt = jgpt.build_functional_train_step(jm, **opts)
    ids, labels = _batch()
    ids, labels = jmesh.shard_batch(ids), jmesh.shard_batch(labels)
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, ids, labels)
        losses.append(float(np.asarray(loss)))
    names = [port_name(n) for n, _ in named]
    if pp > 1:
        other, stacked = params
        after = dict(zip([n for n in names if not n.startswith("blocks.")],
                         (np.asarray(a, np.float32) for a in other)))
        keys = [n.split(".", 2)[2] for n in names[2:14]]
        for key, st in zip(keys, stacked):
            for layer, a in enumerate(np.asarray(st, np.float32)):
                after[f"blocks.{layer}.{key}"] = a
    else:
        after = dict(zip(names, (np.asarray(a, np.float32) for a in
                                 jax.tree_util.tree_leaves(params))))
    jmesh.set_mesh(None)
    return named, losses, after


def _port_single(named, over, opts, steps=3):
    tm = GPTParams(GPTConfig(**{**CFG, **over}), device="cpu")
    load_jax_named_params(tm, named)
    step, params, opt = build_functional_train_step(tm, **opts)
    ids, labels = _batch()
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, ids, labels)
        losses.append(float(loss))
    names = [n for n, _ in tm.named_parameters()]
    ptr = {p.data_ptr(): n for n, p in tm.named_parameters()}
    return losses, {ptr[p.data_ptr()]: a for p, a in
                    zip(params, params_to_numpy(params))}


@pytest.fixture(scope="module")
def tp_train(tmp_path_factory):
    refs = {}
    runs = []
    for name, over, opts, _ in RUNS:
        refs[name] = _reference(over, opts, mp=2)
        runs.append({"dims": {"mp": 2}, "over": {**over,
                                                 "use_parallel": True},
                     "step": opts, "named": refs[name][0]})
    ids, labels = _batch()
    got = W.run(tmp_path_factory.mktemp("tp_train"), 2, "train",
                {"cfg": CFG, "named": None, "ids": ids, "labels": labels,
                 "runs": runs})
    return refs, got


@pytest.mark.parametrize("case", RUNS, ids=[r[0] for r in RUNS])
def test_tp2_train_step_matches_reference(tp_train, case):
    name, over, opts, atol = case
    refs, got = tp_train
    named, ref_losses, ref_after = refs[name]
    i = [r[0] for r in RUNS].index(name)
    ranks = [g[i] for g in got]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], ref_losses, rtol=1e-5)
        assert res["losses"][-1] < res["losses"][0]
        assert res["in_place"]
    whole = gather_shards([(r["coord"], r["params"]) for r in ranks],
                          GPTConfig(**{**CFG, **over}), {"mp": 2})
    assert sorted(whole) == sorted(ref_after)
    for n, a in whole.items():
        np.testing.assert_allclose(a, ref_after[n], rtol=0, atol=atol,
                                   err_msg=n)
    # each rank holds its half of every split leaf, and its heads of QKV
    cfg = GPTConfig(**{**CFG, **over})
    for res in ranks:
        nq, nkv = res["heads"]
        assert res["params"]["wte"].shape == (64, 32)
        assert res["params"]["blocks.0.qkv_w"].shape == (
            32, (nq + 2 * nkv) * cfg.head_dim)
        assert res["params"]["blocks.0.fc2_w"].shape == (64, 32)
    assert [r["heads"] for r in ranks] == [
        {"kv_heads_1": (1, 1), "heads_1": (1, 1)}.get(
            name, (cfg.num_heads // 2, cfg.num_kv_heads // 2))] * 2
    # and the port's one-device step agrees
    losses, single = _port_single(named, over, opts)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    for n, a in whole.items():
        np.testing.assert_allclose(a, single[n], rtol=0, atol=atol,
                                   err_msg=n)


def test_kernel_int32_products_are_the_integer_sums():
    """The card's path to row-parallel W8A8's int32 partial sums (the
    ``w8a8_gemm`` kernel given a 127 column and unit scales, K in chunks
    of 1024 whose sums fp32 holds exactly), run here through the
    kernel's plain version: equal to the integer product, extremes and
    a ragged last chunk included."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import (
        _int8_products, _kernel_products)

    g = torch.Generator().manual_seed(0)
    for m, k, n in ((3, 2500, 7), (4, 1024, 16), (2, 10, 5)):
        xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        xq[0], wq[0] = 127, -127
        want = (xq.long() @ wq.long().t()).to(torch.int32)
        assert torch.equal(_kernel_products(xq, wq), want)
        assert torch.equal(_int8_products(xq, wq), want)


def test_rank_shards_and_gather_shards_round_trip():
    """Every rank's shards of a (dp=2, pp=2, sharding=1, mp=2) topology
    put back together are the global weights; each rank holds its stage's
    blocks, its heads' QKV columns (q, then k, then v) and its vocabulary
    rows."""
    from paddle_tpu_torch.weights import rank_shards

    cfg = GPTConfig(**CFG)
    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**CFG, dropout=0.0))
    named = [(n, np.asarray(p._array)) for n, p in jm.named_parameters()]
    dims = {"dp": 2, "pp": 2, "sharding": 1, "mp": 2}
    ranks = []
    for dp in range(2):
        for pp in range(2):
            for mp in range(2):
                coord = {"dp": dp, "pp": pp, "sharding": 0, "mp": mp}
                shards = rank_shards(named, cfg, coord, dims)
                blocks = {int(n.split(".")[1]) for n in shards
                          if n.startswith("blocks.")}
                assert blocks == {2 * pp, 2 * pp + 1}
                qkv = shards[f"blocks.{2 * pp}.qkv_w"]
                full = dict(named)[f"gpt.blocks.{2 * pp}.attn.qkv.weight"]
                hd = cfg.head_dim
                np.testing.assert_array_equal(
                    qkv, np.concatenate([full[:, mp * hd:(mp + 1) * hd],
                                         full[:, (2 + mp) * hd:
                                              (3 + mp) * hd],
                                         full[:, (4 + mp) * hd:
                                              (5 + mp) * hd]], axis=1))
                np.testing.assert_array_equal(
                    shards["wte"], dict(named)[
                        "gpt.embeddings.word_embeddings.weight"][
                            64 * mp:64 * (mp + 1)])
                ranks.append((coord, shards))
    whole = gather_shards(ranks, cfg, dims)
    assert sorted(whole) == sorted(port_name(n) for n, _ in named)
    for n, a in named:
        np.testing.assert_array_equal(whole[port_name(n)], a)


def test_tensor_parallel_needs_even_splits():
    from paddle_tpu_torch.models.gpt import TensorParallel

    class Mesh:
        shape = {"mp": 2}
        coord = {"mp": 0}

        def group(self, axes):
            return None

    TensorParallel(GPTConfig(**CFG), Mesh())
    # head counts that mp does not divide run, as the reference's GSPMD
    # split runs them: one query head keeps attention whole, one K/V head
    # is held by both ranks
    assert TensorParallel(GPTConfig(**{**CFG, "num_heads": 1}),
                          Mesh()).heads == (1, 1)
    assert TensorParallel(GPTConfig(**{**CFG, "num_kv_heads": 1}),
                          Mesh()).heads == (1, 1)
    for over in ({"vocab_size": 129}, {"ffn_hidden": 65}):
        with pytest.raises(ValueError, match="multiple"):
            TensorParallel(GPTConfig(**{**CFG, **over}), Mesh())



# ---------------------------------------------------------------------------
# tensor parallelism with the other axes, and dropout
# ---------------------------------------------------------------------------

OPTS = {"lr": 1e-4, "remat": False, "ce_chunk_rows": 0}


def _uniforms():
    rng = np.random.RandomState(11)
    return ([rng.rand(8, 16, 32).astype(np.float32)]
            + [rng.rand(8, 2, 16, 16).astype(np.float32) for _ in range(4)])


@pytest.fixture(scope="module")
def combos(tmp_path_factory, request):
    """On four ranks: mp=2 x pp=2; mp=2 x sharding=2 at ZeRO stage 3 with
    remat; mp=2 x dp=2 with dropout 0.1 for one step, both packages
    given the same uniforms (the reference under ``jax.disable_jit()``,
    its draws concrete, one per site: the embedding's, then each block's;
    each port rank slices its batch rows and heads out of them)."""
    refs = {"mp2_pp2": _reference({}, OPTS, mp=2, pp=2),
            "mp2_zero3": _reference({}, {**OPTS, "sharding_stage": 3}, mp=2,
                                    sharding=2)}
    arrays = _uniforms()
    calls = []

    def uniform(key, shape=(), dtype=jax.numpy.float32, *a, **kw):
        calls.append(tuple(shape))
        return jax.numpy.asarray(arrays[len(calls) - 1])

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", uniform)
    try:
        with jax.disable_jit():
            refs["mp2_dp2_dropout"] = _reference({}, OPTS, mp=2, dp=2,
                                                 dropout=0.1, steps=1)
    finally:
        mp.undo()
    assert calls == [a.shape for a in arrays]
    named = refs["mp2_pp2"][0]
    ids, labels = _batch()
    runs = [{"dims": {"mp": 2, "pp": 2}, "over": {"use_parallel": True},
             "step": OPTS},
            {"dims": {"mp": 2, "sharding": 2},
             "over": {"use_parallel": True},
             "step": {**OPTS, "sharding_stage": 3, "remat": True}},
            {"dims": {"mp": 2, "dp": 2},
             "over": {"use_parallel": True, "dropout": 0.1},
             "step": OPTS, "steps": 1, "uniforms": arrays}]
    got = W.run(tmp_path_factory.mktemp("tp_combos"), 4, "train",
                {"cfg": CFG, "named": named, "ids": ids, "labels": labels,
                 "runs": runs})
    return refs, got


@pytest.mark.parametrize("i,name,dims", [
    (0, "mp2_pp2", {"mp": 2, "pp": 2}),
    (1, "mp2_zero3", {"mp": 2, "sharding": 2}),
    (2, "mp2_dp2_dropout", {"mp": 2, "dp": 2})])
def test_tensor_parallel_composes_with_the_other_axes(combos, i, name, dims):
    refs, got = combos
    _, losses, after = refs[name]
    ranks = [g[i] for g in got]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    whole = gather_shards([(r["coord"], r["params"]) for r in ranks],
                          GPTConfig(**CFG), dims)
    assert sorted(whole) == sorted(after)
    for n, a in whole.items():
        np.testing.assert_allclose(a, after[n], rtol=0, atol=2e-5,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# the layers in a static program (ROADMAP C.13)
# ---------------------------------------------------------------------------


def _tp_weights(seed=7):
    rng = np.random.RandomState(seed)
    return {"wc": rng.randn(8, 16).astype("float32") * 0.3,
            "bc": rng.randn(16).astype("float32"),
            "wr": rng.randn(16, 8).astype("float32") * 0.3,
            "br": rng.randn(8).astype("float32"),
            "emb": rng.randn(32, 16).astype("float32"),
            "x": rng.randn(4, 8).astype("float32"),
            "ids": np.array([[1, 5, 31], [0, 17, 16]], "int64"),
            "gy": rng.randn(4, 8).astype("float32"),
            "gz": rng.randn(4, 8).astype("float32"),
            "ge": rng.randn(2, 3, 16).astype("float32")}


def _reference_full(w):
    """The reference's layers at mp 1 (no fleet.init) on the global
    weights: outputs y, z, e and the gradients of the parameters in the
    worker's order."""
    from paddle_tpu.framework import unique_name as jnames

    with jnames.guard():
        col = jmpp.ColumnParallelLinear(8, 16, gather_output=False)
        row = jmpp.RowParallelLinear(16, 8, input_is_parallel=True)
        gcol = jmpp.ColumnParallelLinear(8, 16, gather_output=True)
        row2 = jmpp.RowParallelLinear(16, 8, input_is_parallel=False)
        emb = jmpp.VocabParallelEmbedding(32, 16)
    for layer, (a, b) in ((col, ("wc", "bc")), (row, ("wr", "br")),
                          (gcol, ("wc", "bc")), (row2, ("wr", "br"))):
        layer.weight.set_value(w[a])
        layer.bias.set_value(w[b])
    emb.weight.set_value(w["emb"])
    x = paddle.to_tensor(w["x"])
    y, z, e = row(col(x)), row2(gcol(x)), emb(paddle.to_tensor(w["ids"]))
    loss = ((y * paddle.to_tensor(w["gy"])).sum()
            + (z * paddle.to_tensor(w["gz"])).sum()
            + (e * paddle.to_tensor(w["ge"])).sum())
    loss.backward()
    params = [p for m in (col, row, gcol, row2, emb) for p in m.parameters()]
    return ([y.numpy(), z.numpy(), e.numpy()],
            [np.asarray(p.grad.numpy()) for p in params])


def test_tp_layers_build_in_a_static_program_at_mp1_without_fleet_init():
    """Without fleet.init the three layers are one rank's: a static program
    records the reference's ops (``matmul_v2``, ``elementwise_add``,
    ``lookup_table_v2``) and gives its outputs on the same weights; the
    eager layers give them too."""
    import paddle_tpu_torch as tp
    from paddle_tpu.framework import unique_name as jnames
    from paddle_tpu_torch.distributed.fleet import meta_parallel as tmpp
    from paddle_tpu_torch.framework import unique_name as tnames

    tp.set_device("cpu")
    w = _tp_weights()
    runs = {}
    for P, mpp, names in ((paddle, jmpp, jnames), (tp, tmpp, tnames)):
        main, startup = P.static.Program(), P.static.Program()
        P.enable_static()
        try:
            with P.static.program_guard(main, startup), names.guard():
                x = P.static.data("x", [4, 8], "float32")
                ids = P.static.data("ids", [2, 3], "int64")
                col = mpp.ColumnParallelLinear(8, 16, gather_output=False)
                row = mpp.RowParallelLinear(16, 8, input_is_parallel=True)
                emb = mpp.VocabParallelEmbedding(32, 16)
                y, e = row(col(x)), emb(ids)
                s = P.mean(y) + P.mean(e)
        finally:
            P.disable_static()
        exe = P.static.Executor(P.CPUPlace())
        scope = P.static.global_scope()
        exe.run(startup)
        values = {col.weight.name: w["wc"], col.bias.name: w["bc"],
                  row.weight.name: w["wr"], row.bias.name: w["br"],
                  emb.weight.name: w["emb"]}
        if P is tp:
            for name, v in values.items():
                scope.set(name, torch.as_tensor(v))
        else:
            P.static.set_program_state(main, values)
        got = exe.run(main, feed={"x": w["x"], "ids": w["ids"]},
                      fetch_list=[y, e, s])
        runs[P] = ([o.type for o in main.global_block().ops], got,
                   sorted(values))
    (jops, jgot, jnames_), (tops, tgot, tnames_) = runs[paddle], runs[tp]
    assert tops == jops == ["matmul_v2", "elementwise_add", "matmul_v2",
                            "elementwise_add", "lookup_table_v2",
                            "reduce_mean", "reduce_mean", "elementwise_add"]
    assert tnames_ == jnames_
    for a, b in zip(jgot, tgot):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **TOL)
    # eagerly, without a mesh, the same layers give the same values
    with tnames.guard():
        col = tmpp.ColumnParallelLinear(8, 16, gather_output=False)
        row = tmpp.RowParallelLinear(16, 8, input_is_parallel=True)
        emb = tmpp.VocabParallelEmbedding(32, 16)
    col.set_global(w["wc"], w["bc"])
    row.set_global(w["wr"], w["br"])
    emb.set_global(w["emb"])
    y = row(col(tp.to_tensor(w["x"])))
    np.testing.assert_allclose(y.numpy(), np.asarray(tgot[0]), **TOL)
    np.testing.assert_array_equal(emb(tp.to_tensor(w["ids"])).numpy(),
                                  np.asarray(tgot[1]))
    ce = tmpp.ParallelCrossEntropy()(y, tp.to_tensor(
        np.array([1, 0, 7, 3], "int64")))
    assert ce.shape == [4, 1]


def test_tp_layers_static_program_at_mp2_equals_eager_and_reference(
        tmp_path):
    """At mp 2 on two gloo ranks a static program of the layers records
    the collectives on the mp axis, and its outputs and gradients equal
    the eager layers' and the reference's one-rank layers' on the global
    weights (each rank's gradient its slice)."""
    w = _tp_weights()
    want_out, want_grad = _reference_full(w)
    got = W.run(tmp_path, 2, "static_tp_layers", dict(w, mp=2))
    # the split dim of each parameter (col w, b; row w, b; gather-col w,
    # b; row2 w, b; emb w); None for a whole one
    splits = [1, 0, 0, None, 1, 0, 0, None, 0]
    for r, res in enumerate(got):
        ops = res["ops"]
        for t in ("c_identity", "c_concat", "c_split", "mp_allreduce_sum",
                  "c_embedding"):
            assert t in ops, (t, ops)
        for run in ("static", "eager"):
            outs, grads = res[run]
            assert len(outs) == 3 and len(grads) == len(want_grad) == 9
            for a, b in zip(want_out, outs):
                np.testing.assert_allclose(b, a, **TOL)
            for g, full, dim in zip(grads, want_grad, splits):
                if dim is not None:
                    full = _slices(full, 2, dim)[r]
                np.testing.assert_allclose(g, full, **TOL)
        for a, b in zip(res["static"][0] + res["static"][1],
                        res["eager"][0] + res["eager"][1]):
            np.testing.assert_array_equal(a, b)

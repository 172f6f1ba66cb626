"""Pipeline parallelism in the port's train step, on gloo ranks spawned on
the CPU, against the reference's step on the same mesh (its blocks stacked
and scanned over the pp axis), from the same weights: the reference's CFG
of ``tests/test_pipeline_gpt.py`` (4 layers), batch 8 x 16, lr 1e-3, 3
steps.

pp=2 and pp=2 x dp=2: losses to 1e-5 relative, parameters to 2e-5
absolute (fp32 in another order), each stage holding only its own two
blocks.  Dropout under pp: the reference's scanned block body draws one
mask for every block of a step, and so does the port's pipeline; both get
the same injected uniforms (the reference's ``jax.random.uniform``
replaced, in its jitted step, by the arrays in draw order: the
embedding's, then the blocks'), one step at dropout 0.1, remat off, the
fp32 tolerances above.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_dist_workers as W

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.weights import gather_shards, port_name

CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=2,
           max_seq_len=32)
OPTS = dict(lr=1e-3, remat=False, ce_chunk_rows=0)


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 128, (8, 16)).astype("int32"),
            rng.randint(0, 128, (8, 16)).astype("int64"))


def _uniforms():
    rng = np.random.RandomState(7)
    return [rng.rand(8, 16, 32).astype(np.float32),
            rng.rand(8, 2, 16, 16).astype(np.float32)]


def _reference(dp, pp, dropout=0.0, steps=3, opts=OPTS, monkeypatch=None):
    jmesh.build_hybrid_mesh(dp=dp, mp=1, pp=pp, sharding=1)
    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**CFG, dropout=dropout))
    named = [(n, np.asarray(p._array)) for n, p in jm.named_parameters()]
    if dropout:
        arrays = _uniforms()
        calls = []

        def uniform(key, shape=(), dtype=jnp.float32, *a, **kw):
            calls.append(tuple(shape))
            return jnp.asarray(arrays[len(calls) - 1])

        monkeypatch.setattr(jax.random, "uniform", uniform)
    step, params, opt = jgpt.build_functional_train_step(jm, **opts)
    ids, labels = _batch()
    ids, labels = jmesh.shard_batch(ids), jmesh.shard_batch(labels)
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, ids, labels)
        losses.append(float(np.asarray(loss)))
    other, stacked = params
    names = [port_name(n) for n, _ in named]
    block_names = [n for n in names if n.startswith("blocks.")]
    after = dict(zip([n for n in names if not n.startswith("blocks.")],
                     (np.asarray(a, np.float32) for a in other)))
    keys = [n.split(".", 2)[2] for n in block_names[:12]]
    for key, st in zip(keys, stacked):
        for layer, a in enumerate(np.asarray(st, np.float32)):
            after[f"blocks.{layer}.{key}"] = a
    jmesh.set_mesh(None)
    if dropout:
        assert calls == [(8, 16, 32), (8, 2, 16, 16)], calls
    return named, losses, after


@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    ref = _reference(dp=1, pp=2)
    ids, labels = _batch()
    got = W.run(tmp_path_factory.mktemp("pp2"), 2, "train",
                {"cfg": CFG, "named": ref[0], "ids": ids, "labels": labels,
                 "runs": [{"dims": {"pp": 2}, "step": OPTS}]})
    return ref, [g[0] for g in got]


@pytest.fixture(scope="module")
def pp2_dp2(tmp_path_factory):
    ref = _reference(dp=2, pp=2)
    ids, labels = _batch()
    got = W.run(tmp_path_factory.mktemp("pp2dp2"), 4, "train",
                {"cfg": CFG, "named": ref[0], "ids": ids, "labels": labels,
                 "runs": [{"dims": {"pp": 2, "dp": 2}, "step": OPTS}]})
    return ref, [g[0] for g in got]


def _check(ref, ranks, steps=3):
    _, losses, after = ref
    for res in ranks:
        np.testing.assert_allclose(res["losses"], losses[:steps], rtol=1e-5)
    whole = gather_shards([(r["coord"], r["params"]) for r in ranks],
                          GPTConfig(**CFG), {"pp": 2})
    assert sorted(whole) == sorted(after)
    for n, a in whole.items():
        np.testing.assert_allclose(a, after[n], rtol=0, atol=2e-5,
                                   err_msg=n)


@pytest.mark.parametrize("which", ["pp2", "pp2_dp2"])
def test_pipeline_step_matches_reference(which, request):
    ref, ranks = request.getfixturevalue(which)
    _check(ref, ranks)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


@pytest.mark.parametrize("which", ["pp2", "pp2_dp2"])
def test_each_stage_holds_only_its_blocks(which, request):
    _, ranks = request.getfixturevalue(which)
    for res in ranks:
        stage = res["coord"]["pp"]
        blocks = sorted({int(n.split(".")[1]) for n in res["params"]
                         if n.startswith("blocks.")})
        assert blocks == [2 * stage, 2 * stage + 1]
        assert {"wte", "wpe", "lnf_g", "lnf_b"} <= set(res["params"])
        assert len(res["numel"]["m"]) == 2 * 12 + 4
        assert res["in_place"]


def test_dropout_under_pp_shares_one_mask_across_blocks(tmp_path,
                                                        monkeypatch):
    ref = _reference(dp=1, pp=2, dropout=0.1, steps=1, monkeypatch=monkeypatch)
    ids, labels = _batch()
    got = W.run(tmp_path, 2, "train",
                {"cfg": CFG, "named": ref[0], "ids": ids, "labels": labels,
                 "runs": [{"dims": {"pp": 2}, "step": OPTS, "steps": 1,
                           "over": {"dropout": 0.1},
                           "uniforms": _uniforms()}]})
    _check(ref, [g[0] for g in got], steps=1)

"""ZeRO over the sharding axis and data parallelism in the port's train
step, on four gloo ranks (dp=2 x sharding=2) spawned on the CPU, against
the reference's step on the same mesh (``tests/test_zero_sharding.py``:
its 1-layer CFG, lr 1e-3, no remat, dense cross-entropy, 3 steps).

Losses agree to 2e-5 (the reference test's tolerance between stages);
parameters to 2e-5 absolute (fp32 sums in another order: AdamW's
normalised first steps turn a last-bit difference of a near-zero
gradient into a few 1e-6 of a weight).  The optimizer state is held 1/N
(N = 2 sharding ranks) from stage 1, the parameters too at stage 3.
"""

import numpy as np
import pytest

import jax

import torch_dist_workers as W

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.weights import gather_shards, port_name

CFG = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
           max_seq_len=32)
OPTS = dict(lr=1e-3, remat=False, ce_chunk_rows=0)
DIMS = {"dp": 2, "sharding": 2}

# id, step options beyond OPTS, the strategy's stage, the stage it runs
RUNS = [
    ("stage0", {"sharding_stage": 0}, None, 0),
    ("stage1", {"sharding_stage": 1}, None, 1),
    ("stage2", {"sharding_stage": 2}, None, 2),
    ("stage3", {"sharding_stage": 3}, None, 3),
    ("stage3_remat", {"sharding_stage": 3, "remat": True}, None, 3),
    ("dots", {"sharding_stage": 0, "remat": "dots"}, None, 0),
    ("from_strategy", {}, 3, 3),
    # fleet.init's default strategy says stage 1 (its sharding_configs),
    # which the reference takes when the sharding axis is above 1
    ("default", {}, None, 1),
]
# bf16 parameters with fp32 masters held 1/N, against the same stages'
# fp32 runs: one bf16 rounding of a weight near 1 is 7.8e-3 (the
# tolerances of tests/test_torch_train.py's bf16 cases: losses 1e-3,
# parameters 1e-2)
BF16_RUNS = [("stage2_bf16", {"sharding_stage": 2}, None, 2),
             ("stage3_bf16", {"sharding_stage": 3, "remat": True}, None, 3)]


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 128, (8, 16)).astype("int32"),
            rng.randint(0, 128, (8, 16)).astype("int64"))


def _reference(stage):
    s = jfleet.DistributedStrategy()
    s.sharding = True
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 2}
    s.sharding_configs = {"sharding_degree": 2, "stage": 2}
    jfleet.init(is_collective=True, strategy=s)
    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**CFG, dropout=0.0))
    named = [(n, np.asarray(p._array)) for n, p in jm.named_parameters()]
    step, params, opt = jgpt.build_functional_train_step(
        jm, sharding_stage=stage, **OPTS)
    ids, labels = _batch()
    ids, labels = jmesh.shard_batch(ids), jmesh.shard_batch(labels)
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, ids, labels)
        losses.append(float(np.asarray(loss)))
    after = {port_name(n): np.asarray(a, np.float32) for (n, _), a in
             zip(named, jax.tree_util.tree_leaves(params))}
    return named, losses, after


@pytest.fixture(scope="module")
def zero(tmp_path_factory):
    refs = {stage: _reference(stage) for stage in (0, 2, 3)}
    ids, labels = _batch()
    runs = [{"dims": DIMS, "strategy_stage": strat,
             "step": {**OPTS, **opts}} for _, opts, strat, _ in RUNS]
    runs += [{"dims": DIMS, "step": {**OPTS, **opts}, "dtype": "bfloat16"}
             for _, opts, _, _ in BF16_RUNS]
    got = W.run(tmp_path_factory.mktemp("zero"), 4, "train",
                {"cfg": CFG, "named": refs[0][0], "ids": ids,
                 "labels": labels, "runs": runs})
    return refs, got


@pytest.mark.parametrize("case", RUNS, ids=[r[0] for r in RUNS])
def test_zero_stage_matches_reference(zero, case):
    name, _, _, stage = case
    refs, got = zero
    _, losses, after = refs[stage if stage in refs else 0]
    i = [r[0] for r in RUNS].index(name)
    ranks = [g[i] for g in got]
    for res in ranks:
        assert res["stage"] == stage
        np.testing.assert_allclose(res["losses"], losses, rtol=2e-5,
                                   atol=2e-5)
    whole = gather_shards([(r["coord"], r["params"]) for r in ranks],
                          GPTConfig(**CFG), {})
    for n, a in whole.items():
        np.testing.assert_allclose(a, after[n], rtol=0, atol=2e-5,
                                   err_msg=n)
    # every data-parallel and sharding rank ends with the same weights
    for res in ranks[1:]:
        for n, a in res["params"].items():
            np.testing.assert_array_equal(a, ranks[0]["params"][n])


@pytest.mark.parametrize("case", RUNS, ids=[r[0] for r in RUNS])
def test_zero_state_is_held_one_nth_per_rank(zero, case):
    """Stage 0 holds everything whole; from stage 1 ``m`` and ``v`` are
    ceil(numel / 2) per rank, and from stage 3 the parameters too; the
    stages below 3 train the model's own tensors in place."""
    name, _, _, stage = case
    _, got = zero
    i = [r[0] for r in RUNS].index(name)
    for res in (g[i] for g in got):
        sizes = res["numel"]
        half = [-(-n // 2) for n in sizes["whole"]]
        assert sizes["m"] == sizes["v"] == (sizes["whole"] if stage == 0
                                            else half)
        assert sizes["params"] == (half if stage == 3 else sizes["whole"])
        assert sizes["master"] == []          # fp32 parameters
        assert res["in_place"] == (stage < 3)


@pytest.mark.parametrize("case", BF16_RUNS, ids=[r[0] for r in BF16_RUNS])
def test_zero_bf16_masters_are_held_one_nth(zero, case):
    name, _, _, stage = case
    refs, got = zero
    _, losses, after = refs[stage]
    i = len(RUNS) + [r[0] for r in BF16_RUNS].index(name)
    ranks = [g[i] for g in got]
    for res in ranks:
        assert res["stage"] == stage
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-3)
        sizes = res["numel"]
        assert sizes["master"] == [-(-n // 2) for n in sizes["whole"]]
    whole = gather_shards([(r["coord"], r["params"]) for r in ranks],
                          GPTConfig(**CFG), {})
    for n, a in whole.items():
        np.testing.assert_allclose(a, after[n], rtol=0, atol=1e-2,
                                   err_msg=n)

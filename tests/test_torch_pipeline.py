"""The port's pipeline (``PipelineLayer``, ``PipelineParallel`` and the
1F1B engine) against the reference's, on the CPU.

The port runs one gloo rank a stage (``tests/torch_dist_workers.py``:
``pipeline``); the reference runs in this process on its 8-device mesh.
Both start from the same weights (the reference pipeline's initial
parameters, carried by ``weights.load_paddle_state_dict`` as a
``GPTForPretraining`` state dict).  The reference's own checks of
``tests/test_pipeline_gpt.py`` (its CFG: vocab 128, hidden 32, 4 layers,
2 heads; batch 8, seq 16):

* pp=2, 4 microbatches, AdamW with the global-norm clip, 4 steps: losses
  within 1e-5 relative of the reference's ``PipelineParallel`` and within
  2e-4 of single-device training (the reference's bound); the trained
  parameters, gathered from the two ranks by ``weights.gather_shards``,
  within 1e-4 of the reference pipeline's (AdamW at lr 1e-3 turns a
  last-bit difference of a near-zero gradient into a step of up to lr);
* each stage holds only its blocks, and the prologue / epilogue
  parameters and their optimizer state 1/S per rank (the layers' whole
  copies released between steps);
* the scheduled Momentum case (3 steps, ``StepDecay`` stepped by
  ``train_batch``) and its pipelined eval, against the reference's (1e-5
  relative; eval 1e-5);
* fresh dropout masks every step (SGD at lr 0: the two losses differ).

And in this process, one stage without a process group: the engine at
S=1 over 4 microbatches against the port's plain eager training from the
same weights, within 2e-4 (the smoke's bound on the card).
"""

import concurrent.futures

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu import nn as jnn, optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import meta_parallel as jmpp
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt

import torch_dist_workers as W

import paddle_tpu_torch as tp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed.fleet import meta_parallel as tmpp
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.models import gpt_layers as tgpt
from paddle_tpu_torch.weights import gather_shards, load_paddle_state_dict

from torch_parity import interpretable  # noqa: F401  (fixture)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=2,
           max_seq_len=32, dropout=0.0)


def _strategy(pp, acc):
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": pp,
                        "sharding_degree": 1}
    s.pipeline_configs = {"accumulate_steps": acc, "micro_batch_size": 2}
    return s


def _unique(layer):
    seen, out = set(), []
    for p in layer.parameters():
        if id(p) not in seen:
            seen.add(id(p))
            out.append(p)
    return out


def _adamw(P, nn, params):
    return P.optimizer.AdamW(learning_rate=1e-3, parameters=params,
                             weight_decay=0.01,
                             grad_clip=nn.ClipGradByGlobalNorm(1.0))


def _batch(seed, b):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, CFG["vocab_size"], (b, 16)).astype("int32"),
            rng.randint(0, CFG["vocab_size"], (b, 16)).astype("int64"))


def _gpt_state(seed):
    """The reference GPTForPretraining of ``seed``: (model, its state)."""
    with jnames.guard():
        jp.seed(seed)
        m = jgpt.GPTForPretraining(jgpt.GPTConfig(**CFG))
    return m, {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _reference(ids, labels, ids2, labels2):
    """The reference's single-device run, its pipelined runs (AdamW and
    the scheduled Momentum), and the initial states they start from."""
    out = {}
    ref, _ = _gpt_state(0)
    crit = jgpt.GPTPretrainingCriterion()
    o = _adamw(jp, jnn, _unique(ref))
    losses = []
    for _ in range(4):
        loss = crit(ref(jp.to_tensor(ids)), jp.to_tensor(labels))
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss.numpy()))
    out["single"] = losses

    jfleet.init(is_collective=True, strategy=_strategy(2, 4))
    jp.seed(0)
    pipe = jgpt.GPTForPretrainingPipe(jgpt.GPTConfig(**CFG), num_stages=2)
    ref2, state = _gpt_state(0)
    for p, q in zip(_unique(pipe), _unique(ref2)):
        p._array = q._array
    model = jmpp.PipelineParallel(pipe, jfleet.get_hybrid_communicate_group(),
                                  _strategy(2, 4))
    model.accumulate_steps = 4
    o = _adamw(jp, jnn, _unique(pipe))
    out["pipe"] = [float(model.train_batch(
        (jp.to_tensor(ids), jp.to_tensor(labels)), optimizer=o).numpy())
        for _ in range(4)]
    model.state_dict()
    out["trained"] = {k: np.asarray(p._array) for k, p in
                      zip(state, _unique(pipe))}

    jfleet.init(is_collective=True, strategy=_strategy(2, 2))
    jp.seed(1)
    pipe = jgpt.GPTForPretrainingPipe(jgpt.GPTConfig(**CFG), num_stages=2)
    sched = jopt.lr.StepDecay(learning_rate=0.05, step_size=1, gamma=0.5)
    o = jopt.Momentum(learning_rate=sched, momentum=0.9,
                      parameters=_unique(pipe))
    model = jmpp.PipelineParallel(pipe, jfleet.get_hybrid_communicate_group(),
                                  _strategy(2, 2))
    model.accumulate_steps = 2
    out["momentum"] = [float(model.train_batch(
        (jp.to_tensor(ids2), jp.to_tensor(labels2)), optimizer=o,
        lr_scheduler=sched).numpy()) for _ in range(3)]
    out["eval"] = float(model.eval_batch(
        (jp.to_tensor(ids2), jp.to_tensor(labels2))).numpy())
    jmesh._MESH = None
    return out


def _state2():
    """The initial weights of the reference's seed-1 pipeline, as a
    GPTForPretraining state dict (same parameter order)."""
    jp.seed(1)
    pipe = jgpt.GPTForPretrainingPipe(jgpt.GPTConfig(**CFG), num_stages=2)
    _, keys = _gpt_state(1)
    return {k: np.asarray(p._array) for k, p in zip(keys, _unique(pipe))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ids, labels = _batch(0, 8)
    ids2, labels2 = _batch(1, 4)
    _, state = _gpt_state(0)
    jfleet.init(is_collective=True, strategy=_strategy(2, 2))
    state2 = _state2()
    jmesh._MESH = None
    payload = {"cfg": CFG, "state": state, "state2": state2, "ids": ids,
               "labels": labels, "ids2": ids2, "labels2": labels2}
    # the port's ranks train while the reference does, in this process
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        got = pool.submit(W.run, tmp_path_factory.mktemp("pipeline"), 2,
                          "pipeline", payload)
        ref = _reference(ids, labels, ids2, labels2)
        return ref, got.result()


def test_pipeline_matches_reference_and_single_device(runs):
    ref, got = runs
    for res in got:
        losses = res["adamw"]["losses"]
        np.testing.assert_allclose(losses, ref["pipe"], rtol=1e-5)
        np.testing.assert_allclose(losses, ref["single"], rtol=2e-4,
                                   atol=2e-4)
        assert losses[-1] < losses[0]


def test_gathered_parameters_match_reference_pipeline(runs):
    ref, got = runs
    whole = gather_shards([({"pp": r["adamw"]["stage"]}, r["adamw"]["state"])
                           for r in got], tgpt.GPTConfig(**CFG), {"pp": 2})
    assert sorted(whole) == sorted(ref["trained"])
    for k, a in ref["trained"].items():
        np.testing.assert_allclose(whole[k], a, rtol=0, atol=1e-4,
                                   err_msg=k)


def test_each_stage_holds_only_its_blocks(runs):
    _, got = runs
    # run_functions: 0 the embedding, 1-4 the blocks, 5 the final LN
    assert [r["adamw"]["blocks"] for r in got] == [[0, 1, 2, 5],
                                                   [0, 3, 4, 5]]
    h = CFG["hidden_size"]
    for r in got:
        # two blocks of 12 parameters: 12 h^2 weights, 13 h biases and
        # LayerNorm gains
        assert len(r["adamw"]["mid_numel"]) == 2 * 12
        assert sum(r["adamw"]["mid_numel"]) == 2 * (12 * h * h + 13 * h)


def test_prologue_epilogue_state_is_held_one_half_per_rank(runs):
    _, got = runs
    for r in got:
        a = r["adamw"]
        # word and position embeddings, the final LayerNorm
        assert len(a["other_numel"]) == 4
        assert a["chunks"] == [-(-n // 2) for n in a["other_numel"]]
        assert a["released"] == [0] * 4
        # AdamW's moments: the blocks' whole, the rest as chunks
        assert a["moments"] == a["mid_numel"] + a["chunks"]
    emb = CFG["vocab_size"] * CFG["hidden_size"]
    assert emb in got[0]["adamw"]["other_numel"]


def test_scheduler_and_momentum(runs):
    ref, got = runs
    for r in got:
        m = r["momentum"]
        np.testing.assert_allclose(m["losses"], ref["momentum"], rtol=1e-5)
        assert m["last_epoch"] == 3
        assert m["losses"][-1] < m["losses"][0]
        np.testing.assert_allclose(m["eval"], ref["eval"], rtol=1e-5)


def test_dropout_draws_fresh_masks_every_step(runs):
    _, got = runs
    l1, l2 = got[0]["dropout"]
    assert np.isfinite(l1) and np.isfinite(l2)
    assert l1 != l2
    assert got[1]["dropout"] == [l1, l2]


def test_one_stage_engine_matches_plain_training(interpretable):
    """S=1 without a process group: each microbatch's backward follows its
    forward, the prologue and epilogue are the layers' own tensors."""
    tp.set_device("cpu")
    ids, labels = _batch(0, 8)
    _, state = _gpt_state(0)
    cfg = tgpt.GPTConfig(**CFG)
    with tnames.guard():
        tp.seed(0)
        plain = tgpt.GPTForPretraining(cfg)
        crit = tgpt.GPTPretrainingCriterion()
        pipe = tgpt.GPTForPretrainingPipe(cfg, num_stages=1)
    load_paddle_state_dict(plain, state)
    load_paddle_state_dict(pipe, state)
    o = _adamw(tp, tnn, plain.parameters())
    want = []
    for _ in range(4):
        loss = crit(plain(tp.to_tensor(ids)), tp.to_tensor(labels))
        loss.backward()
        o.step()
        o.clear_grad()
        want.append(float(loss.numpy()))
    s = W._strategy(acc=4)
    model = tmpp.PipelineParallel(pipe, None, s)
    o = _adamw(tp, tnn, pipe.parameters())
    got = [float(model.train_batch((tp.to_tensor(ids), tp.to_tensor(labels)),
                                   optimizer=o).numpy()) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert got[-1] < got[0]

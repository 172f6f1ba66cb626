"""BERT pretraining through the port's eager paddle API against the
reference, on the CPU.

The config is ``tests/test_models_bert_vit.py``'s (vocab 256, hidden 32,
2 layers, 2 heads; batch 2, seq 16, 4 masked tokens a sequence).  The
port's model takes the reference model's ``state_dict()`` (carried
weights); both are built under fresh unique-name counters, so parameter
names and optimizer state keys agree.  Compared: the MLM and NSP logits
and the criterion's loss (1e-5 relative), and 3 steps of
``examples/pretrain_bert.py``'s loop (AdamW over
``LinearWarmup(PolynomialDecay)``, the global-norm clip): losses to 1e-5
relative, parameters and optimizer state to 2e-5 absolute.  Also the
port's CLI with ``--device cpu --steps 3``.
"""

import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu import nn as jnn, optimizer as jopt
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as tp
from paddle_tpu_torch.examples import pretrain_bert as ex
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.weights import (load_paddle_state_dict,
                                      optimizer_state_to_numpy,
                                      state_dict_to_numpy)

CFG = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=32, dropout=0.0)
B, S, M = 2, 16, 4
STEPS = 3
LR = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _batch():
    return ex.make_batch(tbert.BertConfig(**CFG), B, S, M, 0)


def _reference_run(steps=STEPS, amp=False):
    with jnames.guard():
        jp.seed(0)
        model = jbert.BertForPretraining(jbert.BertConfig(**CFG))
        crit = jbert.BertPretrainingCriterion()
        sched = jopt.lr.LinearWarmup(
            jopt.lr.PolynomialDecay(learning_rate=LR,
                                    decay_steps=max(steps, 10)),
            warmup_steps=min(5, steps), start_lr=0.0, end_lr=LR)
        opt = jopt.AdamW(learning_rate=sched, parameters=model.parameters(),
                         weight_decay=0.01,
                         grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    state = {k: np.asarray(v.numpy()) for k, v in
             model.state_dict().items()}
    ids, tt, pos, mlm, nsp = _batch()
    mlm_logits, nsp_logits = model(jp.to_tensor(ids), jp.to_tensor(tt),
                                   masked_positions=jp.to_tensor(pos))
    first = {"mlm": mlm_logits.numpy(), "nsp": nsp_logits.numpy()}
    losses = []
    for _ in range(steps):
        mlm_logits, nsp_logits = model(jp.to_tensor(ids), jp.to_tensor(tt),
                                       masked_positions=jp.to_tensor(pos))
        loss = crit(mlm_logits, nsp_logits, jp.to_tensor(mlm),
                    jp.to_tensor(nsp), masked_lm_scale=float(pos.size))
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.numpy()))
    after = {k: np.asarray(v.numpy()) for k, v in
             model.state_dict().items()}
    opt_state = {k: np.asarray(v.numpy()) for k, v in opt.state_dict().items()
                 if k != "LR_Scheduler"}
    return state, first, losses, after, opt_state


def _port_run(state, steps=STEPS):
    args = ex.parse(["--steps", str(steps), "--hidden", "32", "--layers",
                     "2", "--heads", "2", "--vocab", "256", "--seq", "32",
                     "--lr", str(LR), "--device", "cpu"])
    with tnames.guard():
        cfg, model, crit, sched, opt = ex.build(args)
    load_paddle_state_dict(model, state)
    ids, tt, pos, mlm, nsp = _batch()
    mlm_logits, nsp_logits = model(tp.to_tensor(ids), tp.to_tensor(tt),
                                   masked_positions=tp.to_tensor(pos))
    first = {"mlm": mlm_logits.numpy(), "nsp": nsp_logits.numpy()}
    losses = [float(ex.train_step(model, crit, opt, sched, _batch()).numpy())
              for _ in range(steps)]
    return first, losses, state_dict_to_numpy(model), {
        k: v for k, v in optimizer_state_to_numpy(opt).items()
        if k != "LR_Scheduler"}


@pytest.fixture(scope="module")
def runs():
    tp.set_device("cpu")
    ref = _reference_run()
    return ref, _port_run(ref[0])


def test_logits_match_reference(runs):
    (_, jfirst, _, _, _), (tfirst, _, _, _) = runs
    assert tfirst["mlm"].shape == (B * M, CFG["vocab_size"])
    for k in ("mlm", "nsp"):
        np.testing.assert_allclose(tfirst[k], jfirst[k], rtol=1e-5,
                                   atol=1e-6)


def test_criterion_matches_reference():
    tp.set_device("cpu")
    rng = np.random.RandomState(3)
    scores = rng.randn(B * M, 256).astype("float32")
    nsp_scores = rng.randn(B, 2).astype("float32")
    labels = rng.randint(0, 256, (B * M,)).astype("int64")
    labels[1] = -1  # ignored
    nsp = rng.randint(0, 2, (B,)).astype("int64")
    want = jbert.BertPretrainingCriterion()(
        jp.to_tensor(scores), jp.to_tensor(nsp_scores), jp.to_tensor(labels),
        jp.to_tensor(nsp), masked_lm_scale=float(B * M))
    got = tbert.BertPretrainingCriterion()(
        tp.to_tensor(scores), tp.to_tensor(nsp_scores), tp.to_tensor(labels),
        tp.to_tensor(nsp), masked_lm_scale=float(B * M))
    np.testing.assert_allclose(float(got.numpy()), float(want.numpy()),
                               rtol=1e-5)


def test_three_pretraining_steps_match_reference(runs):
    (_, _, jlosses, jafter, jopt_state), (_, tlosses, tafter, topt) = runs
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert sorted(tafter) == sorted(jafter)
    for k in jafter:
        np.testing.assert_allclose(tafter[k], jafter[k], rtol=0, atol=2e-5,
                                   err_msg=k)
    assert sorted(topt) == sorted(jopt_state)
    for k in jopt_state:
        np.testing.assert_allclose(topt[k], jopt_state[k], rtol=0,
                                   atol=2e-5, err_msg=k)


def test_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.examples.pretrain_bert",
         "--device", "cpu", "--steps", "3", "--hidden", "32", "--layers",
         "2", "--heads", "2", "--vocab", "256", "--seq", "16", "--batch",
         "2", "--masked", "4"], capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK: loss" in out.stdout

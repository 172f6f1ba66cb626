"""The port's ERNIE family against the reference's, on the CPU.

The geometry is ``ernie_3_0_micro``'s (hidden 384, 4 layers, 12 heads)
with a 1000-word vocabulary and 32 positions, to stay cheap.  Each model
is built in both packages under fresh unique-name counters and the
reference's ``state_dict()`` is carried into the port's.  The ids of
each row end in a tail of pad id 0 of its own length (0-6 of 16), so
the default pad mask ([B, 1, 1, S], -1e4 on pad keys) is not trivial;
the task-type ids are not all zero.  Compared (fp32): the pad mask and
the encoder's outputs, the pretraining logits and loss and every
parameter's gradient (1e-5 relative to each tensor's largest value:
summation order only), 2 steps of ``build_model_train_step`` (AdamW)
from the reference's state (losses to 1e-5, updates and moments to
2e-3, as ``tests/test_torch_step_builder.py``), the two fine-tuning
heads' logits and gradients, and ``pretrain_bert.py --model ernie``'s
loop (3 steps, losses to 1e-5) and CLI.
"""

import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames

import paddle_tpu_torch as tp
from paddle_tpu_torch.examples import pretrain_bert as ex
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.weights import load_paddle_state_dict
from torch_step_parity import loss_rel, pair, run_both

B, S, M = 2, 16, 4
V = 1000
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _cfg(P):
    return P.models.ernie_3_0_micro(vocab_size=V, max_seq_len=32)


def _inputs():
    """ids with pad tails of 0-6 tokens (pad id 0; no 0 before the tail),
    token types, task types, masked positions and labels."""
    r = np.random.RandomState(0)
    ids = r.randint(1, V, (B, S)).astype("int64")
    for row, pad in zip(ids, (0, 6)):
        row[S - pad:] = 0
    tt = (r.rand(B, S) > 0.5).astype("int64")
    task = r.randint(0, 3, (B, S)).astype("int64")
    pos = np.stack([r.choice(S - 6, M, replace=False) + i * S
                    for i in range(B)]).astype("int64")
    mlm = ids.reshape(-1)[pos.reshape(-1)]
    nsp = r.randint(0, 2, (B, 1)).astype("int64")
    return ids, tt, task, pos, mlm, nsp


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL * max(
            1.0, float(np.abs(w).max())), err_msg=f"{what} {k}")


def _grads(model):
    return {f"grad:{n}": p.grad.numpy() for n, p in model.named_parameters()
            if p.grad is not None}


def _pretrain(P, model):
    ids, tt, task, pos, mlm, nsp = (P.to_tensor(a) for a in _inputs())
    crit = P.models.ErniePretrainingCriterion()
    mlm_logits, sop_logits = model(ids, tt, task, masked_positions=pos)
    loss = crit(mlm_logits, sop_logits, mlm, nsp,
                masked_lm_scale=float(B * M))
    loss.backward()
    seq, pooled = model.ernie(ids, tt, task)
    return {"mlm": mlm_logits.numpy(), "sop": sop_logits.numpy(),
            "loss": loss.numpy(), "seq": seq.numpy(),
            "pooled": pooled.numpy(),
            "mask": model.ernie._pad_mask(ids).numpy(), **_grads(model)}


def test_pretraining_model_matches_reference():
    jm, tm = pair(lambda P: P.models.ErnieForPretraining(_cfg(P)))
    want, got = _pretrain(jp, jm), _pretrain(tp, tm)
    assert got["mask"].shape == (B, 1, 1, S)
    assert (got["mask"][1, 0, 0, -6:] == -1e4).all()
    assert not got["mask"][0].any()
    assert "grad:bert.task_type_embeddings.weight" in got
    _close(got, want, "ErnieForPretraining")


def test_pad_mask_and_task_types_change_the_output():
    """The default mask is the pad mask (an all-zero mask gives another
    output for the padded row and the same for the unpadded one), and the
    task-type embeddings enter the sum."""
    _, tm = pair(lambda P: P.models.ErnieModel(_cfg(P)))
    ids, tt, task = (tp.to_tensor(a) for a in _inputs()[:3])
    seq, _ = tm(ids, tt, task)
    nomask, _ = tm(ids, tt, task, tp.zeros([B, 1, 1, S]))
    notask, _ = tm(ids, tt)
    diff = np.abs(seq.numpy() - nomask.numpy()).max(axis=(1, 2))
    assert diff[0] == 0 and diff[1] > 1e-3
    assert np.abs(seq.numpy() - notask.numpy()).max() > 1e-3


def _loss(P):
    crit = P.models.ErniePretrainingCriterion()

    def loss(m, ids, tt, task, pos, mlm, nsp):
        mlm_logits, sop_logits = m(ids, tt, task, masked_positions=pos)
        return crit(mlm_logits, sop_logits, mlm, nsp,
                    masked_lm_scale=float(int(pos.shape[0])
                                          * int(pos.shape[1])))

    return loss


def test_two_generic_steps_match_reference():
    hist, _ = run_both(
        (lambda P: P.models.ErnieForPretraining(_cfg(P)), _loss, _inputs()),
        steps=2, compute_dtype=None, optimizer="adamw", lr=1e-3,
        weight_decay=0.01)
    for h in hist:
        assert loss_rel(h) <= 1e-5, hist
        assert h["update"] <= 2e-3 and h["moments"] <= 2e-3, hist
    assert [h["t"] for h in hist] == [(1, 1), (2, 2)]


@pytest.mark.parametrize("head", ["ErnieForSequenceClassification",
                                  "ErnieForTokenClassification"])
def test_fine_tuning_heads_match_reference(head):
    def run(P, model):
        ids, tt, task = (P.to_tensor(a) for a in _inputs()[:3])
        logits = model(ids, tt, task)
        g = P.to_tensor(np.random.RandomState(3).randn(
            *logits.shape).astype("float32"))
        P.sum(logits * g).backward()
        return {"logits": logits.numpy(), **_grads(model)}

    jm, tm = pair(lambda P: getattr(P.models, head)(_cfg(P), num_classes=3))
    want, got = run(jp, jm), run(tp, tm)
    assert got["logits"].shape == ((B, 3) if "Sequence" in head
                                   else (B, S, 3))
    _close(got, want, head)


ARGS = ["--model", "ernie", "--steps", "3", "--hidden", "32", "--layers",
        "2", "--heads", "2", "--vocab", "256", "--seq", "16", "--batch",
        "2", "--masked", "4"]


def test_example_loop_matches_reference():
    """``pretrain_bert.py --model ernie``'s build and loop against the
    reference example's objects (ErnieConfig, ErnieForPretraining, its
    criterion, AdamW over LinearWarmup(PolynomialDecay), the clip) on
    the example's batch."""
    from paddle_tpu import nn as jnn, optimizer as jopt

    args = ex.parse(ARGS + ["--device", "cpu"])
    with jnames.guard():
        jp.seed(args.seed)
        cfg = jp.models.ErnieConfig(vocab_size=256, hidden_size=32,
                                    num_layers=2, num_heads=2,
                                    max_seq_len=16, dropout=0.0)
        jm = jp.models.ErnieForPretraining(cfg)
        crit = jp.models.ErniePretrainingCriterion()
        sched = jopt.lr.LinearWarmup(
            jopt.lr.PolynomialDecay(learning_rate=args.lr, decay_steps=10),
            warmup_steps=3, start_lr=0.0, end_lr=args.lr)
        opt = jopt.AdamW(learning_rate=sched, parameters=jm.parameters(),
                         weight_decay=0.01,
                         grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    with tnames.guard():
        tcfg, tm, tcrit, tsched, topt = ex.build(args)
    assert type(tm).__name__ == "ErnieForPretraining"
    load_paddle_state_dict(tm, state)
    batch = ex.make_batch(tcfg, 2, 16, 4, args.seed)
    ids, tt, pos, mlm, nsp = batch
    want = []
    for _ in range(3):
        mlm_logits, sop_logits = jm(jp.to_tensor(ids), jp.to_tensor(tt),
                                    masked_positions=jp.to_tensor(pos))
        loss = crit(mlm_logits, sop_logits, jp.to_tensor(mlm),
                    jp.to_tensor(nsp), masked_lm_scale=float(pos.size))
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        want.append(float(loss.numpy()))
    got = [float(ex.train_step(tm, tcrit, topt, tsched, batch).numpy())
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.examples.pretrain_bert",
         "--device", "cpu", *ARGS], capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK: loss" in out.stdout

"""fp16 AMP in the port against the reference, on the CPU.

A small BERT (vocab 256, hidden 64, 2 layers, 2 heads; batch 2, seq 16,
4 masked a sequence) trained by ``examples/pretrain_bert.py``'s loop in
both packages from the same weights, the forward under
``amp.auto_cast(dtype="float16")`` and a dynamic ``GradScaler`` (scaled
loss, ``scaler.step``, ``scaler.update``):

* O1, 3 steps at the default scale: losses within 2e-3 relative (fp16
  products summed in other orders by XLA and PyTorch), the scale
  sequences equal;
* a forced overflow, ``init_loss_scaling=2**24``: the first steps'
  fp16 gradients are not finite, so the update is skipped and the scale
  halved each time — the sequences equal, the parameters untouched;
* O2 under ``amp.decorate(level="O2", dtype="float16")``: one step, fp16
  parameters, fp32 master weights, the loss and the scale as the
  reference's.  The forward runs under ``auto_cast(level="O1")`` there:
  the reference's ``auto_cast(level="O2")`` casts the inputs of its own
  cast op again and recurses without end (the port's exempts the cast
  op, and smoke phase 19 runs BERT-base under it).

The attention of the port's CPU path is the reference's (``sdpa_plain``);
the card runs the same loop through the flash kernels in fp16 (smoke
phase 19).
"""

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
from paddle_tpu_torch.weights import load_paddle_state_dict

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=32, dropout=0.0)
B, S, M = 2, 16, 4
LR = 1e-3
LOSS_RTOL = 2e-3


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _batch():
    return ex.make_batch(tbert.BertConfig(**CFG), B, S, M, 0)


def _reference(steps, level="O1", scale=2.0 ** 16):
    """The reference's loop: returns its initial state, losses, scales
    after each step and final parameters."""
    with jnames.guard():
        jp.seed(0)
        model = jbert.BertForPretraining(jbert.BertConfig(**CFG))
        crit = jbert.BertPretrainingCriterion()
        sched = jopt.lr.LinearWarmup(
            jopt.lr.PolynomialDecay(learning_rate=LR, decay_steps=10),
            warmup_steps=1, start_lr=LR, end_lr=LR)
        opt = jopt.AdamW(learning_rate=sched, parameters=model.parameters(),
                         weight_decay=0.01,
                         grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    state = {k: np.asarray(v.numpy()) for k, v in
             model.state_dict().items()}
    if level == "O2":
        model, opt = jp.amp.decorate(models=model, optimizers=opt,
                                     level="O2", dtype="float16")
        level = "O1"            # see the module docstring
    scaler = jp.amp.GradScaler(init_loss_scaling=scale)
    ids, tt, pos, mlm, nsp = _batch()
    losses, scales = [], []
    for _ in range(steps):
        with jp.amp.auto_cast(level=level, dtype="float16"):
            mlm_logits, nsp_logits = model(jp.to_tensor(ids),
                                           jp.to_tensor(tt),
                                           masked_positions=jp.to_tensor(pos))
            loss = crit(mlm_logits, nsp_logits, jp.to_tensor(mlm),
                        jp.to_tensor(nsp), masked_lm_scale=float(pos.size))
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.numpy()))
        scales.append(scaler.get_loss_scaling())
    params = {p.name: np.asarray(p.numpy(), np.float32)
              for p in model.parameters()}
    return state, losses, scales, params


def _port(state, steps, level="O1", scale=2.0 ** 16):
    """The port's example loop (``train_step`` with ``amp="float16"`` and
    a GradScaler) from the reference's weights."""
    args = ex.parse(["--steps", "10", "--hidden", "64", "--layers", "2",
                     "--heads", "2", "--vocab", "256", "--seq", "32",
                     "--lr", str(LR), "--device", "cpu"])
    with tnames.guard():
        cfg, model, crit, sched, opt = ex.build(args)
        sched = tp.optimizer.lr.LinearWarmup(
            tp.optimizer.lr.PolynomialDecay(learning_rate=LR,
                                            decay_steps=10),
            warmup_steps=1, start_lr=LR, end_lr=LR)
        opt = tp.optimizer.AdamW(learning_rate=sched,
                                 parameters=model.parameters(),
                                 weight_decay=0.01,
                                 grad_clip=tp.nn.ClipGradByGlobalNorm(1.0))
    load_paddle_state_dict(model, state)
    init = {p.name: p.numpy().astype(np.float32)
            for p in model.parameters()}
    if level == "O2":
        model, opt = tp.amp.decorate(models=model, optimizers=opt,
                                     level="O2", dtype="float16")
        level = "O1"            # as the reference runs it
    scaler = tp.amp.GradScaler(init_loss_scaling=scale)
    losses, scales = [], []
    for _ in range(steps):
        loss = ex.train_step(model, crit, opt, sched, _batch(),
                             amp="float16", scaler=scaler, level=level)
        losses.append(float(loss.numpy()))
        scales.append(scaler.get_loss_scaling())
    params = {p.name: p.numpy().astype(np.float32)
              for p in model.parameters()}
    return losses, scales, params, model, init


def test_o1_fp16_steps_match_reference():
    state, jl, js, _ = _reference(3)
    tl, ts, _, _, _ = _port(state, 3)
    assert ts == js
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]


def test_forced_overflow_skips_and_halves_as_the_reference():
    state, jl, js, jparams = _reference(3, scale=2.0 ** 24)
    tl, ts, tparams, _, init = _port(state, 3, scale=2.0 ** 24)
    assert js == [2.0 ** 23, 2.0 ** 22, 2.0 ** 21]
    assert ts == js
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    # every step skipped: the weights are the initial ones in both
    assert len(set(tl)) == len(set(jl)) == 1
    for name, w in tparams.items():
        np.testing.assert_array_equal(w, init[name])


def test_o2_fp16_step_matches_reference():
    state, jl, js, _ = _reference(1, level="O2")
    tl, ts, _, model, _ = _port(state, 1, level="O2")
    assert ts == js
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    dtypes = {str(p.dtype) for p in model.parameters()}
    assert dtypes == {"paddle.float16"} or dtypes == {"float16"}, dtypes

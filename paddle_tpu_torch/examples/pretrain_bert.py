"""BERT or ERNIE pretraining through the port's eager paddle API (BASELINE
config 2): ``BertForPretraining`` (MLM + NSP) or, with ``--model ernie``,
``ErnieForPretraining`` (MLM + SOP, task-type embeddings, the pad-aware
default attention mask) and its criterion, AdamW over
``LinearWarmup(PolynomialDecay)`` with the global-norm gradient clip,
``loss.backward()``, ``optimizer.step()``, on synthetic masked-LM data.

Counterpart of ``examples/pretrain_bert.py``, with its flags plus
``--device`` (the card by default: ``gpu``; ``cpu`` to run on the host),
``--amp`` (the forward under ``amp.auto_cast()``, bf16) and ``--amp-dtype
float16`` (fp16 O1 with a dynamic ``GradScaler`` at its default scale,
2^16: the scaled loss's backward, ``scaler.step``, ``scaler.update``)::

    python -m paddle_tpu_torch.examples.pretrain_bert --steps 20
    python -m paddle_tpu_torch.examples.pretrain_bert --device cpu --steps 3
    python -m paddle_tpu_torch.examples.pretrain_bert --amp --hidden 768 \\
        --layers 12 --heads 12 --seq 512 --batch 32 --masked 76
    python -m paddle_tpu_torch.examples.pretrain_bert --amp \\
        --amp-dtype float16
    python -m paddle_tpu_torch.examples.pretrain_bert --model ernie

On the card ERNIE's pad mask reaches the flash kernels as their score
bias.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np


def make_batch(cfg, batch, seq, masked, seed):
    """Synthetic pretraining data, the reference example's draws: ids,
    token types, masked positions (flat indices into batch * seq), their
    labels and the next-sentence labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype("int64")
    token_type = (rng.rand(batch, seq) > 0.5).astype("int64")
    pos = np.stack([rng.choice(seq, masked, replace=False) + i * seq
                    for i in range(batch)]).astype("int64")
    mlm_labels = ids.reshape(-1)[pos.reshape(-1)].astype("int64")
    nsp_labels = rng.randint(0, 2, (batch,)).astype("int64")
    return ids, token_type, pos, mlm_labels, nsp_labels


def build(args):
    """The model, criterion, scheduler and optimizer of the example."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer as opt
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         BertPretrainingCriterion,
                                         ErnieConfig, ErnieForPretraining,
                                         ErniePretrainingCriterion)

    paddle.seed(args.seed)
    config, model_cls, crit_cls = {
        "bert": (BertConfig, BertForPretraining, BertPretrainingCriterion),
        "ernie": (ErnieConfig, ErnieForPretraining,
                  ErniePretrainingCriterion)}[args.model]
    cfg = config(vocab_size=args.vocab, hidden_size=args.hidden,
                 num_layers=args.layers, num_heads=args.heads,
                 max_seq_len=args.seq, dropout=0.0)
    model = model_cls(cfg)
    criterion = crit_cls()
    sched = opt.lr.LinearWarmup(
        opt.lr.PolynomialDecay(learning_rate=args.lr,
                               decay_steps=max(args.steps, 10)),
        warmup_steps=min(5, args.steps), start_lr=0.0, end_lr=args.lr)
    optimizer = opt.AdamW(learning_rate=sched,
                          parameters=model.parameters(), weight_decay=0.01,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0))
    return cfg, model, criterion, sched, optimizer


def train_step(model, criterion, optimizer, sched, batch, amp=False,
               scaler=None, level="O1"):
    """One step of the example's loop; returns the loss Tensor.  ``amp``:
    False, True (bf16) or the low dtype's name, the forward under
    ``amp.auto_cast(level=level, dtype=...)``; ``scaler``: a
    ``GradScaler`` that scales the loss for the backward and steps the
    optimizer (skipping the update on an overflow) and the scale."""
    import paddle_tpu_torch as paddle

    ids, token_type, pos, mlm_labels, nsp_labels = batch
    dtype = amp if isinstance(amp, str) else "bfloat16"
    ctx = (paddle.amp.auto_cast(level=level, dtype=dtype) if amp
           else contextlib.nullcontext())
    with ctx:
        mlm_logits, nsp_logits = model(
            paddle.to_tensor(ids), paddle.to_tensor(token_type),
            masked_positions=paddle.to_tensor(pos))
        loss = criterion(mlm_logits, nsp_logits,
                         paddle.to_tensor(mlm_labels),
                         paddle.to_tensor(nsp_labels),
                         masked_lm_scale=float(pos.size))
    if scaler is None:
        loss.backward()
        optimizer.step()
    else:
        scaler.scale(loss).backward()
        scaler.step(optimizer)
        scaler.update()
    optimizer.clear_grad()
    sched.step()
    return loss


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=8192)
    p.add_argument("--masked", type=int, default=20, help="masked tokens/seq")
    p.add_argument("--model", choices=["bert", "ernie"], default="bert")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="gpu",
                   help="gpu (the card, default) or cpu")
    p.add_argument("--amp", action="store_true",
                   help="run the forward under amp.auto_cast() (bf16)")
    p.add_argument("--amp-dtype", choices=["bfloat16", "float16"],
                   default="bfloat16",
                   help="auto_cast's dtype; float16 adds a dynamic "
                        "GradScaler")
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import paddle_tpu_torch as paddle

    paddle.set_device(args.device)
    cfg, model, criterion, sched, optimizer = build(args)
    batch = make_batch(cfg, args.batch, args.seq, args.masked, args.seed)
    amp = args.amp and args.amp_dtype
    scaler = paddle.amp.GradScaler() if amp == "float16" else None
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        loss = train_step(model, criterion, optimizer, sched, batch,
                          amp=amp, scaler=scaler)
        losses.append(float(loss.numpy()))
        if step % 5 == 0 or step == args.steps - 1:
            tok_s = (args.batch * args.seq * (step + 1)) / (time.time() - t0)
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"lr {optimizer.get_lr():.2e}  tokens/s {tok_s:,.0f}",
                  flush=True)
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses}")
    print(f"OK: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()

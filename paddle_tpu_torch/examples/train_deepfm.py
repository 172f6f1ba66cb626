"""DeepFM / wide&deep click-through training through the port's eager
paddle API (BASELINE config 4): one fused embedding table on the device,
``binary_cross_entropy_with_logits``, Adam with dense updates,
``loss.backward()``, ``optimizer.step()``, on synthetic Criteo-like
batches with a recoverable signal; reports the loss and a held-out AUC.

Counterpart of ``examples/train_deepfm.py``, with its flags plus
``--device`` (the card by default: ``gpu``; ``cpu`` to run on the
host)::

    python -m paddle_tpu_torch.examples.train_deepfm --steps 100
    python -m paddle_tpu_torch.examples.train_deepfm --device cpu --steps 12
    python -m paddle_tpu_torch.examples.train_deepfm --model wide_deep \\
        --fields 26 --vocab 10000
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def build(args):
    """The config, model and optimizer of the example."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.models import DeepFM, RecConfig, WideDeep

    paddle.seed(args.seed)
    cfg = RecConfig(field_vocab_sizes=(args.vocab,) * args.fields,
                    dense_dim=args.dense, embedding_dim=args.dim)
    model = (DeepFM if args.model == "deepfm" else WideDeep)(cfg)
    optimizer = opt.Adam(args.lr, parameters=model.parameters())
    return cfg, model, optimizer


def train_step(model, optimizer, batch):
    """One step of the example's loop on a numpy ``(ids, dense, label)``
    batch; returns the loss Tensor."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F

    ids, dense, label = batch
    logit = model(paddle.to_tensor(ids), paddle.to_tensor(dense))
    loss = F.binary_cross_entropy_with_logits(logit, paddle.to_tensor(label))
    loss.backward()
    optimizer.step()
    optimizer.clear_grad()
    return loss


def held_out_auc(cfg, model, batch=8192, seed=10 ** 6):
    """The reference example's held-out AUC: ``batch`` examples of seed
    ``seed``, the positive class's probability into ``metric.Auc``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.metric import Auc
    from paddle_tpu_torch.models import synthetic_click_batch

    ids, dense, label = synthetic_click_batch(cfg, batch, seed=seed)
    logit = model(paddle.to_tensor(ids), paddle.to_tensor(dense))
    prob = 1 / (1 + np.exp(-np.asarray(logit.numpy()).ravel()))
    m = Auc()
    m.update(np.stack([1 - prob, prob], axis=1), label)
    return m.accumulate()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=["deepfm", "wide_deep"],
                   default="deepfm")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--fields", type=int, default=26)
    p.add_argument("--vocab", type=int, default=1000,
                   help="vocabulary per categorical field")
    p.add_argument("--dense", type=int, default=13)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="gpu",
                   help="gpu (the card, default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import synthetic_click_batch

    paddle.set_device(args.device)
    cfg, model, optimizer = build(args)
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    print(f"{args.model}: {cfg.num_fields} fields x {args.vocab} vocab, "
          f"{n_params / 1e6:.1f}M params", flush=True)
    t0 = time.time()
    losses = []
    for step in range(args.steps):
        batch = synthetic_click_batch(cfg, args.batch, seed=step)
        losses.append(float(train_step(model, optimizer, batch).numpy()))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}", flush=True)
    dt = time.time() - t0
    auc = held_out_auc(cfg, model)
    print(f"done: loss {np.mean(losses[:5]):.4f} -> "
          f"{np.mean(losses[-5:]):.4f}, held-out AUC {auc:.4f}, "
          f"{args.steps * args.batch / dt:,.0f} examples/s")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite loss: {losses}")
    if args.steps > 10 and not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise RuntimeError(f"the loss did not fall: {losses}")
    return losses, auc


if __name__ == "__main__":
    main()

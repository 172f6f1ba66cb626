"""ViT classification training through the port's eager paddle API
(BASELINE config 1's second backbone): a ``VisionTransformer`` with
``CrossEntropyLoss`` and AdamW (weight decay 0.05, the global-norm
clip), ``loss.backward()``, ``optimizer.step()``, on synthetic images.

Counterpart of ``examples/train_vit.py``, with its flags plus
``--device`` (the card by default: ``gpu``; ``cpu`` to run on the host)
and ``--amp`` (the forward under ``amp.auto_cast()``, bf16)::

    python -m paddle_tpu_torch.examples.train_vit --steps 20
    python -m paddle_tpu_torch.examples.train_vit --device cpu --steps 3
    python -m paddle_tpu_torch.examples.train_vit --arch vit_b_16 \\
        --img 224 --batch 128 --classes 1000 --amp

On the card each block's attention runs the flash kernels at the
model's token count (197 for ``vit_b_16`` at 224 px).
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np


def build(args):
    """The model, criterion and optimizer of the example."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer as opt
    from paddle_tpu_torch.vision import models as vm

    paddle.seed(args.seed)
    model = getattr(vm, args.arch)(num_classes=args.classes,
                                   img_size=args.img)
    criterion = nn.CrossEntropyLoss()
    optimizer = opt.AdamW(learning_rate=args.lr,
                          parameters=model.parameters(), weight_decay=0.05,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0))
    return model, criterion, optimizer


def make_batch(args):
    """The reference example's synthetic images and labels."""
    rng = np.random.RandomState(args.seed)
    images = rng.randn(args.batch, 3, args.img, args.img).astype("float32")
    labels = rng.randint(0, args.classes, (args.batch, 1)).astype("int64")
    return images, labels


def train_step(model, criterion, optimizer, batch, amp=False):
    """One step of the example's loop; returns the loss Tensor."""
    import paddle_tpu_torch as paddle

    images, labels = batch
    ctx = paddle.amp.auto_cast() if amp else contextlib.nullcontext()
    with ctx:
        loss = criterion(model(paddle.to_tensor(images)),
                         paddle.to_tensor(labels))
    loss.backward()
    optimizer.step()
    optimizer.clear_grad()
    return loss


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--img", type=int, default=32)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--arch", type=str, default="vit_tiny")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="gpu",
                   help="gpu (the card, default) or cpu")
    p.add_argument("--amp", action="store_true",
                   help="run the forward under amp.auto_cast() (bf16)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import paddle_tpu_torch as paddle

    paddle.set_device(args.device)
    model, criterion, optimizer = build(args)
    batch = make_batch(args)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        loss = train_step(model, criterion, optimizer, batch, amp=args.amp)
        losses.append(float(loss.numpy()))
        if step % 5 == 0 or step == args.steps - 1:
            img_s = (args.batch * (step + 1)) / (time.time() - t0)
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"images/s {img_s:,.1f}", flush=True)
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses}")
    print(f"OK: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()

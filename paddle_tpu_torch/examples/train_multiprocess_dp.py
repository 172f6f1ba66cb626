"""Data-parallel training across processes, started by the launcher.

Counterpart of ``examples/train_multiprocess_dp.py``::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        paddle_tpu_torch/examples/train_multiprocess_dp.py --device cpu

Each process feeds its own local batch (a different seed a rank); the
gradients of the two-layer MLP are averaged over the ranks
(``paddle.distributed.all_reduce``), so every rank takes the step of the
global batch's mean loss.  The parameters start equal on every rank and
must stay equal bit for bit: at the end they are all-gathered and
compared.  The process group is NCCL on the card (``--device gpu``, the
default), gloo on the host.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--local_batch", type=int, default=8)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    return p.parse_args(argv)


def main(argv=None):
    """Train; returns ``(losses of rank 0's local batches, rank, world)``
    after checking that the ranks' parameters are equal."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import (all_gather, all_reduce,
                                              init_parallel_env)

    args = parse(argv)
    env = init_parallel_env(backend="gloo" if args.device == "cpu" else None)
    rank, world = env.rank, env.world_size
    device = env.device
    rng = np.random.RandomState(0)      # the same start on every rank
    w1 = torch.as_tensor(rng.randn(16, args.hidden).astype("float32") * 0.1,
                         device=device)
    w2 = torch.as_tensor(rng.randn(args.hidden, 1).astype("float32") * 0.1,
                         device=device)
    data = np.random.RandomState(100 + rank)    # a different batch a rank
    losses = []
    for i in range(args.steps):
        xl = data.randn(args.local_batch, 16).astype("float32")
        yl = (xl.sum(1, keepdims=True) * 0.3).astype("float32")
        x = torch.as_tensor(xl, device=device)
        y = torch.as_tensor(yl, device=device)
        a, b = w1.requires_grad_(), w2.requires_grad_()
        loss = torch.mean((torch.tanh(x @ a) @ b - y) ** 2)
        g1, g2 = torch.autograd.grad(loss, [a, b])
        grads = torch.cat([g1.reshape(-1), g2.reshape(-1)])
        all_reduce(grads)
        grads /= world
        with torch.no_grad():
            w1 = (a - args.lr * grads[:g1.numel()].view_as(g1)).detach()
            w2 = (b - args.lr * grads[g1.numel():].view_as(g2)).detach()
        losses.append(float(loss.detach()))
        if rank == 0 and (i % 5 == 0 or i == args.steps - 1):
            print(f"step {i:3d} loss {losses[-1]:.5f}", flush=True)
    mine = torch.cat([w1.reshape(-1), w2.reshape(-1)])
    every = []
    all_gather(every, mine)
    for r, theirs in enumerate(every):
        if not torch.equal(theirs, mine):
            raise AssertionError(f"rank {r}'s parameters differ from rank "
                                 f"{rank}'s")
    print(f"rank {rank}: params identical across {world} processes OK",
          flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return losses, rank, world


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()

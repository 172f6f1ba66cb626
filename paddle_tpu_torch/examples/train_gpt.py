"""BASELINE config 3: GPT pretraining over ``dp x mp x pp x sharding``,
end to end.

One train step (forward, backward, AdamW with fp32 masters) a batch:
:func:`~paddle_tpu_torch.models.gpt.build_functional_train_step`, on one
device, or as one rank's part of the hybrid step when the degrees ask
for more than one rank or the launcher started the script.  The ranks
then form a process group (NCCL on the card, gloo with ``--device
cpu``) and install the ``(dp, pp, sharding, mp)`` mesh; each feeds its
rows of the global batch.

Counterpart of ``examples/train_gpt.py``, with its flags plus
``--device`` (the card by default: ``gpu``; ``cpu`` to run on the
host)::

    python -m paddle_tpu_torch.examples.train_gpt --config tiny --device cpu
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        paddle_tpu_torch/examples/train_gpt.py --config tiny --device cpu \\
        --dp 2 --mp 2
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 1 \\
        paddle_tpu_torch/examples/train_gpt.py --config 1p3b --batch 8

:func:`build` makes the job (process group, mesh, model) and :func:`run`
trains it, so a caller can load other weights into ``job.model`` between
the two (:mod:`paddle_tpu_torch.weights`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

CONFIGS = ("tiny", "small", "medium", "1p3b", "13b")
# H100 SXM dense bf16 tensor-core peak, the MFU denominator of one card
H100_BF16_FLOPS = 989e12


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="tiny", choices=CONFIGS)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=8,
                   help="the global batch, split over dp x sharding")
    p.add_argument("--seq", type=int, default=0, help="0 = config default")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--mp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--sharding", type=int, default=1)
    p.add_argument("--sharding-stage", type=int, default=None)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--remat", default="0", choices=["0", "1", "dots"])
    p.add_argument("--seq-major", action="store_true",
                   help="[S, B, H] activations from the embedding to the "
                        "logits (GPTConfig.seq_major; attention reads "
                        "them in place)")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 projections (GPTConfig.int8): int8 "
                        "GEMMs with per-token activation scales and a "
                        "straight-through backward")
    p.add_argument("--kv-heads", type=int, default=None, metavar="N",
                   help="grouped-query attention with N KV heads "
                        "(GPTConfig.num_kv_heads; N divides the heads)")
    p.add_argument("--window", type=int, default=None, metavar="W",
                   help="sliding-window causal attention over the last W "
                        "positions (GPTConfig.attn_window)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics-dir", default=None, metavar="DIR",
                   help="loss, step time, tokens/s and MFU a step through "
                        "the serving MetricsRegistry: TensorBoard scalars "
                        "and a Prometheus metrics.prom in DIR")
    p.add_argument("--peak-flops", type=float, default=H100_BF16_FLOPS,
                   help="a card's peak FLOP/s for the MFU (default: "
                        "989e12, the H100 SXM's dense bf16 tensor cores)")
    p.add_argument("--device", default="gpu", choices=["gpu", "cpu"],
                   help="the card (default) or the host; the ranks' "
                        "process group is NCCL on the card, gloo on the "
                        "host")
    return p.parse_args(argv)


def n_params(cfg) -> int:
    """The model's global parameter count (the tied head counted once)."""
    h, f, hd = cfg.hidden_size, cfg.ffn_hidden, cfg.head_dim
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    block = 4 * h + h * qkv + qkv + h * h + h + h * f + f + f * h + h
    return (cfg.vocab_size + cfg.max_seq_len) * h + cfg.num_layers * block \
        + 2 * h


class Job:
    """What :func:`build` makes: the arguments, the config, the model
    (:class:`~paddle_tpu_torch.models.gpt.GPTParams`), its device, the
    sequence length, the installed mesh (None on one device) and whether
    this job started the process group.  :func:`run` adds the step, its
    state, the batch and the timings."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def step_once(self):
        """One more step on the job's batch; its loss."""
        self.params, self.opt_state, loss = self.step(
            self.params, self.opt_state, self.ids, self.labels)
        return loss


def build(argv=None) -> Job:
    """Parse ``argv``, start the process group and the mesh where the
    degrees or the launcher ask for them, and make the model."""
    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.distributed import env as dist_env
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.models import gpt as gpt_mod

    args = parse(argv)
    need = args.dp * args.mp * args.pp * args.sharding
    launched = "PADDLE_TRAINER_ID" in os.environ
    owns = False
    mesh = None
    if need > 1 or launched:
        owns = not dist.is_initialized()
        env = init_parallel_env(
            backend="gloo" if args.device == "cpu" else None)
        mesh = mesh_mod.build_hybrid_mesh(dp=args.dp, mp=args.mp, pp=args.pp,
                                          sharding=args.sharding)
        print(f"mesh: dp={args.dp} mp={args.mp} pp={args.pp} "
              f"sharding={args.sharding}, rank {env.rank} of "
              f"{dist.get_world_size()} ({dist.get_backend()})", flush=True)
    if args.device == "cpu":
        device = torch.device("cpu")
    elif mesh is not None:
        device = torch.device("cuda", dist_env.get_device_id())
    else:
        device = resolve_device(None)   # the card, or the policy's error
    cfg_fn = {"tiny": gpt_mod.gpt_tiny, "small": gpt_mod.gpt_small,
              "medium": gpt_mod.gpt_medium, "1p3b": gpt_mod.gpt_1p3b,
              "13b": gpt_mod.gpt_13b}[args.config]
    cfg = cfg_fn(use_parallel=args.mp > 1, seq_major=args.seq_major,
                 int8=args.int8, num_kv_heads=args.kv_heads,
                 attn_window=args.window)
    seq = args.seq or min(cfg.max_seq_len, 512)
    paddle.seed(args.seed)
    model = gpt_mod.GPTParams(cfg, device=device, seed=args.seed)
    rank0 = mesh is None or dist.get_rank() == 0
    if rank0:
        print(f"GPT-{args.config}: {n_params(cfg) / 1e6:.1f}M params, seq "
              f"{seq}, batch {args.batch}, {model.dtype} on {device}",
              flush=True)
    return Job(args=args, cfg=cfg, model=model, device=device, seq=seq,
               mesh=mesh, owns_group=owns, rank0=rank0, need=max(need, 1))


def _batch(job):
    """The global batch of the seed, this rank's rows of it."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod

    args, cfg = job.args, job.cfg
    rng = np.random.RandomState(args.seed)
    ids = rng.randint(0, cfg.vocab_size, (args.batch, job.seq)).astype("int32")
    labels = rng.randint(0, cfg.vocab_size,
                         (args.batch, job.seq)).astype("int64")
    if job.mesh is not None:
        ids, labels = mesh_mod.shard_batch(ids), mesh_mod.shard_batch(labels)
    return ids, labels


def _sync(job):
    import torch

    if job.device.type == "cuda":
        torch.cuda.synchronize(job.device)


def run(job: Job):
    """Train ``job.args.steps`` steps; returns the losses.  Leaves on the
    job ``step``, ``params``, ``opt_state``, the batch, each step's host
    milliseconds (synchronised), ``tokens_per_s`` and ``mfu`` (the steps
    after the first over ``--peak-flops`` times the mesh's size)."""
    from paddle_tpu_torch.models import gpt as gpt_mod

    args, cfg = job.args, job.cfg
    remat = {"0": False, "1": True, "dots": "dots"}[args.remat]
    job.step, job.params, job.opt_state = gpt_mod.build_functional_train_step(
        job.model, lr=args.lr, remat=remat,
        sharding_stage=args.sharding_stage,
        ce_chunk_rows=2048 if cfg.vocab_size > 10000 else 0)
    job.ids, job.labels = _batch(job)
    exporter = None
    if args.metrics_dir is not None and job.rank0:
        from paddle_tpu_torch.serving.metrics import (MetricsFileExporter,
                                                      MetricsRegistry)

        reg = MetricsRegistry()
        m_loss = reg.gauge("train_loss", "cross-entropy at the step")
        m_toks = reg.gauge("train_tokens_per_sec", "steady-state rate")
        m_mfu = reg.gauge("train_mfu", "model FLOP utilization vs "
                                       "--peak-flops")
        m_steps = reg.counter("train_steps", "optimizer steps done")
        m_step_s = reg.histogram("train_step_s", "train step wall time")
        exporter = MetricsFileExporter(reg, args.metrics_dir)
    # ~6 N flops a token for the forward and backward; the global batch
    # over every card of the mesh
    flops_per_token = 6.0 * n_params(cfg)
    peak_total = args.peak_flops * job.need
    tokens = args.batch * job.seq
    losses, job.step_ms = [], []
    for i in range(args.steps):
        _sync(job)
        t0 = time.perf_counter()
        loss = job.step_once()
        losses.append(float(loss))
        _sync(job)
        dt = time.perf_counter() - t0
        job.step_ms.append(dt * 1e3)
        if job.rank0 and (i % 5 == 0 or i == args.steps - 1):
            print(f"step {i:4d}  loss {losses[-1]:.4f}  {dt * 1e3:.1f} ms",
                  flush=True)
        if exporter is not None:
            m_steps.inc()
            m_loss.set(losses[-1])
            if i > 0:   # the first step pays the kernels' first launches
                m_toks.set(tokens / dt)
                m_mfu.set(tokens / dt * flops_per_token / peak_total)
                m_step_s.observe(dt)
            exporter.flush(i)
    timed = job.step_ms[1:] or job.step_ms
    job.tokens_per_s = tokens / (np.mean(timed) / 1e3)
    job.mfu = job.tokens_per_s * flops_per_token / peak_total
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    if job.rank0:
        print(f"OK: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"{job.tokens_per_s:,.0f} tokens/s, MFU {100 * job.mfu:.2f}%",
              flush=True)
    if exporter is not None:
        exporter.close()
        print(f"metrics: tensorboard --logdir {args.metrics_dir} "
              f"({len(reg.scalars())} series); Prometheus dump "
              f"{exporter.prom_path}")
    return losses


def close(job: Job, barrier: bool = True) -> None:
    """Take down the mesh, and the process group if the job started it
    (after a barrier, unless the run failed)."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import mesh as mesh_mod

    if job.mesh is not None:
        mesh_mod.set_mesh(None)
        if job.owns_group and dist.is_initialized():
            if barrier:
                dist.barrier()
            dist.destroy_process_group()


def main(argv=None):
    job = build(argv)
    try:
        losses = run(job)
    except BaseException:
        close(job, barrier=False)
        raise
    close(job)
    return losses


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()

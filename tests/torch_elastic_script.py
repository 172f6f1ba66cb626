"""The elastic trainer that ``tests/test_torch_launch.py`` starts through
the port's launcher with ``--elastic``: two ranks, a heartbeat thread,
eager training inside ``auto_checkpoint.train_epoch_range``.  Rank 1
kills itself once at ``ELASTIC_FAIL_EPOCH`` (a flag file marks the
injection as done): the launcher must restart the world and training
resume from the checkpointed epoch.  Rank 0 writes each epoch's first
loss to ``ELASTIC_RUN_LOG`` and its final weights to
``ELASTIC_FINAL``.  Each rank marks the end of each epoch with a file
beside the run log and waits there for the other rank's mark, so the
order is certain however slowly either rank starts: rank 0 has logged
and checkpointed the epochs before the failure when rank 1 fails, and
cannot finish the job before it, so the launcher always restarts the
world and the job resumes.  Imports no JAX."""

import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch.distributed import init_parallel_env  # noqa: E402
from paddle_tpu_torch.distributed.fleet.elastic import \
    ElasticManager  # noqa: E402
from paddle_tpu_torch.incubate import auto_checkpoint as acp  # noqa: E402

EPOCHS = 6


def train(epochs, model, opt, rng_seed=42, hook=None):
    """Five SGD steps an epoch on fixed data; ``hook(epoch, losses)``
    after each epoch.  The test runs it uninterrupted in process."""
    rng = np.random.RandomState(rng_seed)
    xs = rng.randn(16, 4).astype("float32")
    ys = (xs @ np.array([1.0, -2.0, 0.5, 3.0], "float32"))[:, None]
    for epoch in epochs:
        if hook is not None:
            hook(epoch, None)
        losses = []
        for _ in range(5):
            pred = model(paddle.to_tensor(xs))
            loss = ((pred - paddle.to_tensor(ys)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        if hook is not None:
            hook(epoch, losses)


def _epoch_done(run_log, epoch, rank, deadline=300.0):
    """Mark ``epoch`` done for ``rank``, then wait for the other rank's
    mark of the same epoch (the launcher's restart ends the wait when the
    other rank died before it)."""
    marks = run_log + ".epochs"
    os.makedirs(marks, exist_ok=True)
    open(os.path.join(marks, f"{epoch}.{rank}"), "w").close()
    other = os.path.join(marks, f"{epoch}.{1 - rank}")
    t0 = time.time()
    while not os.path.exists(other):
        if time.time() - t0 > deadline:
            raise TimeoutError(f"rank {1 - rank} never finished epoch "
                               f"{epoch}")
        time.sleep(0.01)


def build():
    paddle.seed(0)
    model = paddle.nn.Linear(4, 1)
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    return model, opt


if __name__ == "__main__":
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    env = init_parallel_env(backend="gloo")
    rank, ws = env.rank, env.world_size
    assert ws == 2, ws
    # restart-the-world wants a SIGTERMed rank gone at once; the snapshot
    # already holds the state
    signal.signal(signal.SIGTERM, lambda *_: os._exit(143))
    manager = ElasticManager()
    manager.start_beat_thread()
    fail_epoch = int(os.environ.get("ELASTIC_FAIL_EPOCH", "-1"))
    flag = os.environ.get("ELASTIC_FAIL_FLAG", "")
    run_log = os.environ.get("ELASTIC_RUN_LOG", "")
    model, opt = build()
    acp.register(model, opt)

    def hook(epoch, losses):
        if losses is None:      # before the epoch: the one failure
            if (rank == 1 and epoch == fail_epoch and flag
                    and not os.path.exists(flag)):
                with open(flag, "w") as f:
                    f.write("injected")
                os._exit(7)
            return
        if run_log and rank == 0:
            with open(run_log, "a") as f:
                f.write(json.dumps({"pid": os.getpid(), "epoch": epoch,
                                    "loss": losses[0]}) + "\n")
        if run_log:
            _epoch_done(run_log, epoch, rank)

    train(acp.train_epoch_range(EPOCHS, save_checkpoint_inter=0), model,
          opt, hook=hook)
    if rank == 0 and os.environ.get("ELASTIC_FINAL"):
        np.save(os.environ["ELASTIC_FINAL"], model.weight.numpy())
    manager.exit()
    print(f"rank {rank} done", flush=True)

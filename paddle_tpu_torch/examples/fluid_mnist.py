"""A v2.1-era fluid MNIST script (BASELINE config 0, the LeNet of
``examples/fluid_mnist.py``) on the port: every call is the classic
pre-2.x API (``fluid.layers.data``, ``fluid.nets.simple_img_conv_pool``,
``fluid.layers.fc``, ``fluid.layers.cross_entropy``,
``AdamOptimizer.minimize``, ``Executor`` feed / fetch), run by the static
Executor on the card, or on the CPU with ``--device cpu``::

    python -m paddle_tpu_torch.examples.fluid_mnist --steps 30
    python -m paddle_tpu_torch.examples.fluid_mnist --device cpu --steps 3

The data is synthetic and MNIST-shaped: class k lights up a distinct
7x7 patch.  :func:`run` builds the programs in fresh ones and a fresh
scope, so it can run twice in a process; ``init_state`` (name -> numpy,
e.g. the ``start_state`` of another run) replaces the startup program's
values before the first step.
"""

import argparse

import numpy as np

import paddle_tpu_torch as paddle
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.static.io import _host


def convolutional_neural_network(img, label):
    conv_pool_1 = fluid.nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = fluid.nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    prediction = fluid.layers.fc(input=conv_pool_2, size=10, act="softmax")
    loss = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_loss = fluid.layers.mean(loss)
    acc = fluid.layers.accuracy(input=prediction, label=label)
    return prediction, avg_loss, acc


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
    return p.parse_args(argv)


def run(args, init_state=None, log=print):
    """Train; returns (losses, accuracies, start_state): the fetched
    values of each step and the persistables before the first one."""
    paddle.set_device(args.device)
    paddle.enable_static()
    paddle.seed(0)
    try:
        with fluid.program_guard(fluid.Program(), fluid.Program()), \
                fluid.unique_name.guard(), fluid.scope_guard(fluid.Scope()):
            img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                    dtype="float32")
            label = fluid.layers.data(name="label", shape=[1], dtype="int64")
            prediction, avg_loss, acc = convolutional_neural_network(img,
                                                                     label)
            optimizer = fluid.optimizer.AdamOptimizer(learning_rate=args.lr)
            optimizer.minimize(avg_loss)

            place = (fluid.CPUPlace() if args.device == "cpu"
                     else fluid.CUDAPlace(0))
            exe = fluid.Executor(place)
            main_prog = fluid.default_main_program()
            exe.run(fluid.default_startup_program())
            if init_state is not None:
                fluid.io.set_program_state(main_prog, init_state)
            scope = fluid.global_scope()
            start_state = {v.name: _host(scope.find_var(v.name))
                           for v in main_prog.list_vars()
                           if v.persistable
                           and scope.find_var(v.name) is not None}

            rng = np.random.RandomState(0)
            losses, accs = [], []
            for step in range(args.steps):
                y = rng.randint(0, 10, (args.batch,))
                x = rng.rand(args.batch, 1, 28, 28).astype("float32") * 0.3
                for i, k in enumerate(y):
                    r, c = divmod(int(k), 4)
                    x[i, 0, r * 7:(r + 1) * 7, c * 7:(c + 1) * 7] += 1.0
                y = y.astype("int64").reshape(-1, 1)
                lv, av = exe.run(main_prog, feed={"img": x, "label": y},
                                 fetch_list=[avg_loss, acc])
                losses.append(float(lv))
                accs.append(float(av))
                if step % 10 == 0 or step == args.steps - 1:
                    log(f"step {step:3d}  loss {losses[-1]:.4f}  "
                        f"acc {accs[-1]:.3f}")
    finally:
        paddle.disable_static()
    return losses, accs, start_state


def main(argv=None):
    args = parse_args(argv)
    losses, accs, _ = run(args, log=lambda s: print(s, flush=True))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    print(f"OK: loss {losses[0]:.4f} -> {losses[-1]:.4f}  "
          f"acc {accs[0]:.3f} -> {accs[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()

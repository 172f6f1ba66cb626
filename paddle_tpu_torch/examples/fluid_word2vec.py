"""The classic fluid N-gram word2vec tutorial (``examples/fluid_word2vec.py``)
on the port: ``fluid.layers.embedding`` with ``param_attr`` sharing,
``concat``, ``fc``, ``cross_entropy``, ``SGDOptimizer.minimize``,
``fluid.DataFeeder`` and ``paddle.batch`` feeding an ``Executor`` loop,
run by the static Executor on the card, or on the CPU with
``--device cpu``::

    python -m paddle_tpu_torch.examples.fluid_word2vec --steps 60
    python -m paddle_tpu_torch.examples.fluid_word2vec --device cpu --steps 3

The corpus is synthetic: word k is usually followed by (3k + 1) % 120.
:func:`run` builds the programs in fresh ones and a fresh scope, so it can
run twice in a process; ``init_state`` (name -> numpy, e.g. the
``start_state`` of another run) replaces the startup program's values
before the first step.
"""

import argparse

import numpy as np

import paddle_tpu_torch as paddle
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.static.io import _host

EMBED_SIZE = 32
HIDDEN_SIZE = 64
N = 4  # 4-gram: 3 context words -> next word
DICT_SIZE = 120


def inference_program(words):
    embeds = []
    for w in words[:-1]:
        embeds.append(fluid.layers.embedding(
            input=w, size=[DICT_SIZE, EMBED_SIZE],
            param_attr=fluid.ParamAttr(name="shared_w")))
    concat_embed = fluid.layers.concat(embeds, axis=1)
    hidden1 = fluid.layers.fc(input=concat_embed, size=HIDDEN_SIZE,
                              act="sigmoid")
    predict_word = fluid.layers.fc(input=hidden1, size=DICT_SIZE,
                                   act="softmax")
    return predict_word


def train_program(words):
    predict_word = inference_program(words)
    cost = fluid.layers.cross_entropy(input=predict_word, label=words[-1])
    avg_cost = fluid.layers.mean(cost)
    return predict_word, avg_cost


def synthetic_corpus_reader(seed=0, n_sent=400):
    """A deterministic 'language': word k is usually followed by
    (3k + 1) % DICT_SIZE, a learnable 4-gram structure."""

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_sent):
            w = int(rng.randint(0, DICT_SIZE))
            sent = [w]
            for _ in range(N - 1):
                w = (3 * w + 1) % DICT_SIZE if rng.rand() < 0.9 \
                    else int(rng.randint(0, DICT_SIZE))
                sent.append(w)
            yield tuple([x] for x in sent)  # each word as a [1] int column

    return reader


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.5)
    p.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
    return p.parse_args(argv)


def run(args, init_state=None, log=print):
    """Train; returns (losses, start_state, the shared embedding's shape):
    the loss of each step and the persistables before the first one."""
    paddle.set_device(args.device)
    paddle.enable_static()
    paddle.seed(0)
    try:
        with fluid.program_guard(fluid.Program(), fluid.Program()), \
                fluid.unique_name.guard(), fluid.scope_guard(fluid.Scope()):
            word_names = ["firstw", "secondw", "thirdw", "nextw"]
            words = [fluid.layers.data(name=n, shape=[1], dtype="int64")
                     for n in word_names]
            _, avg_cost = train_program(words)
            sgd = fluid.optimizer.SGDOptimizer(learning_rate=args.lr)
            sgd.minimize(avg_cost)

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
            feeder = fluid.DataFeeder(feed_list=words, place=place)
            batch_reader = paddle.batch(synthetic_corpus_reader(), args.batch)

            losses = []
            step = 0
            while step < args.steps:
                for batch in batch_reader():
                    lv, = exe.run(main_prog, feed=feeder.feed(batch),
                                  fetch_list=[avg_cost])
                    losses.append(float(np.asarray(lv)))
                    step += 1
                    if step % 20 == 0 or step == args.steps:
                        log(f"step {step:4d}  loss {losses[-1]:.4f}")
                    if step >= args.steps:
                        break
            # the shared embedding serves the 3 context positions
            shape = tuple(scope.find_var("shared_w").shape)
    finally:
        paddle.disable_static()
    return losses, start_state, shape


def check(losses, shape):
    """The script's assertions: the loss falls by a fifth, and one shared
    embedding serves the context words."""
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
    assert shape == (DICT_SIZE, EMBED_SIZE)


def main(argv=None):
    args = parse_args(argv)
    losses, _, shape = run(args, log=lambda s: print(s, flush=True))
    check(losses, shape)
    print(f"OK: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(shared embedding {shape})")
    return losses


if __name__ == "__main__":
    main()

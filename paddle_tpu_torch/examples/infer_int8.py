"""Int8 inference walkthrough (``examples/infer_int8.py``) on the port:
train, calibrate by post-training quantization, export with
``jit.save``, then compare the fp32 and the int8 Predictor's accuracy.
The int8 Predictor runs its matmuls as ``quantized_matmul`` ops (the int8
GEMM kernel on the card).  On the card by default, or on the CPU with
``--device cpu``::

    python -m paddle_tpu_torch.examples.infer_int8
    python -m paddle_tpu_torch.examples.infer_int8 --device cpu

:func:`run` takes ``init_state`` (structured name -> numpy, e.g. another
package's model's ``state_dict``) to start from given weights.
"""

import argparse
import os
import tempfile

import numpy as np

import paddle_tpu_torch as paddle
from paddle_tpu_torch import inference as paddle_infer
from paddle_tpu_torch import jit, nn, optimizer as opt
from paddle_tpu_torch.incubate.quant import ImperativePTQ


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
    return p.parse_args(argv)


def run(args, init_state=None, log=print):
    """Train, quantize, export and run both Predictors; returns (fp32
    accuracy, int8 accuracy, the int8 matmuls rewritten, max |int8 -
    fp32|)."""
    paddle.set_device(args.device)
    paddle.seed(0)
    rng = np.random.RandomState(0)
    x = rng.randn(256, 16).astype("float32")
    y = (x[:, :4].sum(1) > 0).astype("int64")

    model = nn.Sequential(nn.Linear(16, 64), nn.ReLU(), nn.Linear(64, 2))
    if init_state is not None:
        for name, p in model.named_parameters():
            p.set_value(init_state[name])
    o = opt.Adam(learning_rate=0.01, parameters=model.parameters())
    loss_fn = nn.CrossEntropyLoss()
    for _ in range(60):
        logits = model(paddle.to_tensor(x))
        loss = loss_fn(logits, paddle.to_tensor(y))
        loss.backward()
        o.step()
        o.clear_grad()

    # post-training quantization: calibrate activation scales, freeze
    ptq = ImperativePTQ()
    model = ptq.quantize(model)
    model(paddle.to_tensor(x[:64]))  # calibration pass
    model = ptq.convert(model)
    model.eval()

    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "mlp_ptq")
        jit.save(model, prefix,
                 input_spec=[jit.InputSpec([None, 16], "float32", "x")])

        def config():
            cfg = paddle_infer.Config(prefix)
            if args.device == "cpu":
                cfg.disable_gpu()
            return cfg

        fp32 = paddle_infer.create_predictor(config())
        cfg = config()
        cfg.enable_int8(min_weight_elements=0)  # the demo's weights are tiny
        int8 = paddle_infer.create_predictor(cfg)

        (ref,) = fp32.run([x])
        (out,) = int8.run([x])
    acc_fp32 = float((ref.argmax(1) == y).mean())
    acc_int8 = float((out.argmax(1) == y).mean())
    delta = float(np.abs(out - ref).max())
    log(f"int8 matmuls rewritten: {int8._n_int8}")
    log(f"accuracy fp32={acc_fp32:.3f} int8={acc_int8:.3f} "
        f"(max |delta|={delta:.4f})")
    return acc_fp32, acc_int8, int8._n_int8, delta


def main(argv=None):
    acc_fp32, acc_int8, _, _ = run(parse_args(argv))
    assert acc_int8 >= acc_fp32 - 0.02, "int8 accuracy drop > 2%"
    print("int8 inference example OK")
    return acc_fp32, acc_int8


if __name__ == "__main__":
    main()

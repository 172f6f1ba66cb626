"""The port's 2-D vision ops and the functions over them against the
reference's, on the CPU.

Ops (``conv2d``, ``depthwise_conv2d``, ``conv2d_transpose``, ``pool2d``,
``max_pool2d_with_index``): the same seeded numpy inputs go through the
reference's ``registry.run_kernel`` and the port's; gradients for seeded
output gradients are the port's ``registry.op_grad`` (torch autograd)
against ``jax.vjp`` of the reference's kernel.  Functions
(``nn.functional``): conv with bias in both layouts, the transposed conv
with ``output_size``, the pools and the 1-D forms, forward and the
input's gradient through each package's tape.

Tolerances: fp32, |got - want| <= 1e-5 * (|want| + max |want|) (the two
packages' convolutions sum in different orders); masks and shapes
exactly; NaN where the reference has NaN (an average over a window of
padding alone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch as tp
from paddle_tpu_torch.ops import registry as treg

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = float(np.nanmax(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _data(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


X = _data(2, 4, 9, 8)
XH = np.ascontiguousarray(X.transpose(0, 2, 3, 1))
W = _data(6, 4, 3, 3, seed=1) * 0.3
# integers: pooling windows with ties, where the first maximum must win
TIES = np.round(_data(2, 3, 7, 7, seed=2)).astype("float32")

CASES = [
    ("conv2d", "stride_2_pad_2", {"Input": X, "Filter": W},
     dict(strides=[2, 1], paddings=[1, 2])),
    ("conv2d", "pad_4_dilation", {"Input": X, "Filter": W},
     dict(paddings=[0, 1, 2, 1], dilations=[2, 1])),
    ("conv2d", "same_stride", {"Input": X, "Filter": W},
     dict(padding_algorithm="SAME", strides=[2, 2])),
    ("conv2d", "same_dilation", {"Input": X, "Filter": W},
     dict(padding_algorithm="SAME", strides=[1, 2], dilations=[2, 2])),
    ("conv2d", "valid", {"Input": X, "Filter": W},
     dict(padding_algorithm="VALID")),
    ("conv2d", "nhwc_pad_4", {"Input": XH, "Filter": W},
     dict(paddings=[1, 0, 1, 2], strides=[2, 2], data_format="NHWC")),
    ("conv2d", "nhwc_same", {"Input": XH, "Filter": W},
     dict(padding_algorithm="SAME", strides=[2, 2], data_format="NHWC")),
    ("conv2d", "groups", {"Input": X, "Filter": _data(6, 2, 3, 3, seed=3)},
     dict(groups=2, paddings=[1, 1])),
    ("depthwise_conv2d", "nchw", {"Input": X,
                                  "Filter": _data(4, 1, 3, 3, seed=4)},
     dict(paddings=[1, 1], strides=[2, 2])),
    ("depthwise_conv2d", "nhwc", {"Input": XH,
                                  "Filter": _data(4, 1, 3, 3, seed=4)},
     dict(paddings=[1, 1], data_format="NHWC")),
    ("conv2d_transpose", "output_padding",
     {"Input": X, "Filter": _data(4, 5, 3, 3, seed=5)},
     dict(strides=[2, 2], paddings=[1, 1], output_padding=[1, 0])),
    ("conv2d_transpose", "pad_4_dilation",
     {"Input": X, "Filter": _data(4, 5, 3, 3, seed=5)},
     dict(strides=[2, 3], paddings=[0, 1, 2, 0], dilations=[1, 2])),
    ("conv2d_transpose", "output_padding_past_pad",
     {"Input": X, "Filter": _data(4, 5, 2, 3, seed=6)},
     dict(strides=[3, 3], output_padding=[2, 1])),
]
for fmt, x in (("NCHW", X), ("NHWC", XH)):
    CASES += [
        ("pool2d", f"max_pad_{fmt}", {"X": x},
         dict(pooling_type="max", ksize=[3, 3], strides=[2, 2],
              paddings=[1, 1], data_format=fmt)),
        ("pool2d", f"max_ceil_pad_4_{fmt}", {"X": x},
         dict(pooling_type="max", ksize=[3, 2], strides=[2, 2],
              paddings=[0, 1, 1, 0], ceil_mode=True, data_format=fmt)),
        ("pool2d", f"avg_exclusive_{fmt}", {"X": x},
         dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2],
              paddings=[1, 1], data_format=fmt)),
        ("pool2d", f"avg_inclusive_{fmt}", {"X": x},
         dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2],
              paddings=[1, 1], exclusive=False, data_format=fmt)),
        ("pool2d", f"avg_ceil_{fmt}", {"X": x},
         dict(pooling_type="avg", ksize=[2, 3], strides=[2, 2],
              paddings=[1, 0], ceil_mode=True, data_format=fmt)),
        ("pool2d", f"global_max_{fmt}", {"X": x},
         dict(pooling_type="max", ksize=[2, 2], global_pooling=True,
              data_format=fmt)),
        ("pool2d", f"adaptive_avg_1_{fmt}", {"X": x},
         dict(pooling_type="avg", ksize=[1, 1], adaptive=True,
              data_format=fmt)),
        ("pool2d", f"adaptive_max_{fmt}", {"X": x},
         dict(pooling_type="max", ksize=[3, 2], adaptive=True,
              data_format=fmt)),
        ("pool2d", f"adaptive_avg_{fmt}", {"X": x},
         dict(pooling_type="avg", ksize=[3, 4], adaptive=True,
              data_format=fmt)),
    ]
CASES += [
    ("pool2d", "avg_window_of_padding", {"X": X},
     dict(pooling_type="avg", ksize=[2, 3], strides=[3, 2], ceil_mode=True)),
    ("max_pool2d_with_index", "ties", {"X": TIES},
     dict(ksize=[2, 2], strides=[2, 2])),
    ("max_pool2d_with_index", "ties_ceil_pad", {"X": TIES},
     dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1], ceil_mode=True)),
    ("max_pool2d_with_index", "ties_pad_4", {"X": TIES},
     dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 0, 0, 1])),
    ("max_pool2d_with_index", "adaptive", {"X": TIES[:, :, :6, :6]},
     dict(ksize=[2, 3], adaptive=True)),
]
IDS = [f"{op}-{name}" for op, name, _, _ in CASES]


def _ref(op, ins, attrs):
    out = jreg.run_kernel(jreg.get_op_def(op), {
        s: [jnp.asarray(a)] for s, a in ins.items()}, dict(attrs))
    return {s: np.asarray(v[0]) for s, v in out.items()}


def _port(op, ins, attrs):
    out = treg.run_kernel(treg.get_op_def(op), {
        s: [torch.as_tensor(a)] for s, a in ins.items()}, dict(attrs))
    return {s: v[0].numpy() for s, v in out.items()}


@pytest.mark.parametrize("op,name,ins,attrs", CASES, ids=IDS)
def test_op_forward_and_gradient_match_reference(op, name, ins, attrs):
    want, got = _ref(op, ins, attrs), _port(op, ins, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        _close(got[slot], want[slot], f"{op} {name} {slot}")
    if "window_of_padding" in name:
        assert np.isnan(want["Out"]).any()   # 0 / 0, in both packages
        return
    # gradients of the first output slot for a seeded output gradient
    out_slot = "Output" if "conv" in op else "Out"
    g = _data(*want[out_slot].shape, seed=9)
    slots = sorted(ins)
    od = jreg.get_op_def(op)

    def f(*arrays):
        return jreg.run_kernel(od, {s: [a] for s, a in zip(slots, arrays)},
                               dict(attrs))[out_slot][0]

    _, vjp = jax.vjp(f, *[jnp.asarray(ins[s]) for s in slots])
    jg = dict(zip(slots, vjp(jnp.asarray(g))))
    tg = treg.op_grad(op, {s: [torch.as_tensor(ins[s])] for s in slots},
                      attrs, {out_slot: [torch.as_tensor(g)]})
    for s in slots:
        _close(tg[s + "@GRAD"][0].numpy(), np.asarray(jg[s]),
               f"{op} {name} d{s}")


def test_adaptive_pool_needs_sizes_that_divide():
    for P in (jp, tp):
        x = P.to_tensor(X)
        with pytest.raises(AssertionError):
            P.nn.functional.adaptive_avg_pool2d(x, [2, 3])
        with pytest.raises(AssertionError):
            P.nn.functional.adaptive_max_pool2d(x, [2, 3], return_mask=True)


def test_conv_follows_the_fp32_matmul_precision():
    """An fp32 conv on the card sets cuDNN's TF32 from the fp32 matmul
    precision (``FLAGS_tpu_matmul_precision``); on the CPU it touches
    nothing."""
    old_flag = torch.backends.cudnn.allow_tf32
    old_prec = torch.get_float32_matmul_precision()
    old_value = tp.get_flags("FLAGS_tpu_matmul_precision")
    calls = []

    class _Card:
        is_cuda = True
        dtype = torch.float32

    try:
        from paddle_tpu_torch.ops import nn_ops

        tp.set_flags({"FLAGS_tpu_matmul_precision": "float32"})
        nn_ops._conv_precision(_Card())
        calls.append(torch.backends.cudnn.allow_tf32)
        tp.set_flags({"FLAGS_tpu_matmul_precision": "tensorfloat32"})
        nn_ops._conv_precision(_Card())
        calls.append(torch.backends.cudnn.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        nn_ops._conv_precision(torch.zeros(1))
        calls.append(torch.backends.cudnn.allow_tf32)
    finally:
        tp.set_flags(old_value)
        torch.backends.cudnn.allow_tf32 = old_flag
        torch.set_float32_matmul_precision(old_prec)
    assert calls == [False, True, True]


# ---------------------------------------------------------------------------
# nn.functional: both packages' tapes
# ---------------------------------------------------------------------------

FUNCS = [
    ("conv2d_bias_nchw", lambda P, x, w, b: P.nn.functional.conv2d(
        x, w, b, stride=2, padding=1), (2, 4, 9, 8), (6, 4, 3, 3), (6,)),
    ("conv2d_bias_nhwc_same", lambda P, x, w, b: P.nn.functional.conv2d(
        x, w, b, stride=2, padding="same", data_format="NHWC"),
     (2, 9, 8, 4), (6, 4, 3, 3), (6,)),
    ("conv2d_transpose_output_size", lambda P, x, w, b:
     P.nn.functional.conv2d_transpose(x, w, b, stride=2, padding=1,
                                      output_size=[18, 16]),
     (2, 4, 9, 8), (4, 5, 3, 3), (5,)),
    ("max_pool2d", lambda P, x, w, b: P.nn.functional.max_pool2d(
        x, 3, 2, 1, ceil_mode=True), (2, 4, 9, 8), None, None),
    ("max_pool2d_mask", lambda P, x, w, b: P.nn.functional.max_pool2d(
        x, 2, 2, return_mask=True)[0], (2, 4, 9, 8), None, None),
    ("avg_pool2d_nhwc", lambda P, x, w, b: P.nn.functional.avg_pool2d(
        x, 3, 2, 1, exclusive=False, data_format="NHWC"),
     (2, 9, 8, 4), None, None),
    ("adaptive_avg_pool2d", lambda P, x, w, b:
     P.nn.functional.adaptive_avg_pool2d(x, [3, 2]), (2, 4, 9, 8), None,
     None),
    ("adaptive_max_pool2d", lambda P, x, w, b:
     P.nn.functional.adaptive_max_pool2d(x, 1), (2, 4, 9, 8), None, None),
    ("conv1d", lambda P, x, w, b: P.nn.functional.conv1d(
        x, w, b, stride=2, padding=1, dilation=2), (2, 4, 11), (6, 4, 3),
     (6,)),
    ("conv1d_transpose", lambda P, x, w, b:
     P.nn.functional.conv1d_transpose(x, w, b, stride=2, padding=1,
                                      output_padding=1), (2, 4, 11),
     (4, 5, 3), (5,)),
    ("max_pool1d", lambda P, x, w, b: P.nn.functional.max_pool1d(
        x, 3, 2, 1), (2, 4, 11), None, None),
    ("avg_pool1d", lambda P, x, w, b: P.nn.functional.avg_pool1d(
        x, 3, 2, 1), (2, 4, 11), None, None),
    ("adaptive_avg_pool1d", lambda P, x, w, b:
     P.nn.functional.adaptive_avg_pool1d(x, 1), (2, 4, 12), None, None),
    ("adaptive_max_pool1d", lambda P, x, w, b:
     P.nn.functional.adaptive_max_pool1d(x, 4), (2, 4, 12), None, None),
]


def _func_run(P, fn, xs, ws, bs):
    x = P.to_tensor(_data(*xs), stop_gradient=False)
    w = None if ws is None else P.to_tensor(_data(*ws, seed=1) * 0.3,
                                            stop_gradient=False)
    b = None if bs is None else P.to_tensor(_data(*bs, seed=2),
                                            stop_gradient=False)
    out = fn(P, x, w, b)
    g = P.to_tensor(_data(*out.shape, seed=3))
    P.sum(out * g).backward()
    res = {"out": out.numpy(), "dx": x.grad.numpy()}
    if w is not None:
        res["dw"] = w.grad.numpy()
        res["db"] = b.grad.numpy()
    return res


@pytest.mark.parametrize("name,fn,xs,ws,bs", FUNCS,
                         ids=[f[0] for f in FUNCS])
def test_functional_matches_reference(name, fn, xs, ws, bs):
    want, got = _func_run(jp, fn, xs, ws, bs), _func_run(tp, fn, xs, ws, bs)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], f"{name} {k}")


def test_return_mask_needs_nchw():
    x = tp.to_tensor(XH)
    with pytest.raises(ValueError, match="NCHW"):
        tp.nn.functional.max_pool2d(x, 2, return_mask=True,
                                    data_format="NHWC")
    with pytest.raises(NotImplementedError):
        tp.nn.functional.conv1d(tp.to_tensor(_data(2, 4, 8)),
                                tp.to_tensor(_data(6, 4, 3)),
                                data_format="NLC")

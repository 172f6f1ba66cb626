"""The port's registered ops against the reference's, on the CPU.

One parametrised case per op registered in the ported op modules
(``ops/{math,activation,tensor,optimizer,nn,sequence}_ops.py`` and the
registered ``scaled_dot_product_attention``): the same seeded numpy
inputs go through the reference's ``registry.run_kernel`` and the
port's.  One case per differentiable op: its input gradients for seeded
output gradients, the port's (torch autograd over the kernel, or the
op's hand-written grad op) against the reference's ``<type>_grad``
kernel (``jax.vjp`` of the forward, or the hand-written one).  One test
that the port's registry holds every reference op of those modules (the
vision ops are here, and ``tests/test_torch_vision_ops.py`` and
``tests/test_torch_nn_extras.py`` hold them over more attributes;
``tests/test_torch_sequence_ops.py`` holds the sequence ops over more
attributes and lengths).

Tolerances: integer and bool outputs exactly; floating outputs to 1e-6
relative, elementwise and to the tensor's scale: |got - want| <= 1e-6 *
(|want| + max |want|), so that an element much smaller than the rest
(a saturated tanh's gradient, a sum that cancels) is held to the
rounding of the tensor it belongs to.  The
random ops cannot match number for number (the port's keys seed
``torch.Generator``s, the reference's are JAX keys): ``dropout`` and
``bernoulli`` take the same injected uniforms in both packages and match
exactly; the other random ops are held to their shape, dtype, range and
first two moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the reference's ops)
import paddle_tpu.kernels.attention  # noqa: F401  (and its sdpa op)
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch as tp
from paddle_tpu_torch.ops import registry as treg

RTOL = 1e-6
MODULES = ("math_ops", "activation_ops", "tensor_ops", "optimizer_ops",
           "nn_ops", "sequence_ops")
# reference ops of those modules that the port has yet to register
DEFERRED = set()
RANDOM = {"gaussian_random", "uniform_random", "truncated_gaussian_random",
          "randint", "randperm", "multinomial"}
INJECTED = {"dropout", "bernoulli"}


def _reference_ops():
    ops = {t for t in jreg.all_ops()
           if jreg.get_op_def(t).kernel.__module__.rsplit(".", 1)[-1]
           in MODULES}
    return sorted(ops | {"scaled_dot_product_attention"})


def test_registry_holds_every_reference_op_but_the_deferred():
    ref = set(_reference_ops())
    port = set(treg.all_ops())
    assert DEFERRED <= ref
    assert sorted(ref - port) == sorted(DEFERRED)
    assert not (port & DEFERRED)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _case(op, seed=0):
    """(inputs: slot -> list of numpy arrays, attrs) of ``op``."""
    r = np.random.RandomState(seed)

    def f(*s):
        return r.randn(*s).astype("float32")

    def pos(*s):
        return (r.rand(*s) + 0.5).astype("float32")

    def unit(*s):
        return (r.rand(*s) * 1.6 - 0.8).astype("float32")

    def ints(*s, hi=5):
        return r.randint(0, hi, s).astype("int64")

    def bools(*s):
        return r.rand(*s) > 0.5

    x = f(3, 4)
    lens = np.array([5, 2, 3])
    unary_pos = {"sqrt", "rsqrt", "log", "log2", "log10", "log1p",
                 "reciprocal", "lgamma", "digamma"}
    unary_unit = {"tan", "asin", "acos"}
    unary = {"square", "exp", "abs", "sign", "floor", "ceil", "round", "sin",
             "cos", "atan", "sinh", "cosh", "erf", "expm1", "trunc", "conj",
             "real", "imag", "isnan_v2", "isinf_v2", "isfinite_v2", "relu",
             "relu6", "tanh", "sigmoid", "silu", "softplus", "softsign",
             "mish", "logsigmoid", "selu", "tanhshrink", "mean", "max",
             "squared_l2_norm", "assign", "fill_zeros_like", "stanh"}
    if op in unary_pos:
        return {"X": [pos(3, 4)]}, {}
    if op in unary_unit:
        return {"X": [unit(3, 4)]}, {}
    if op in unary:
        return {"X": [x * 4]}, {}
    binary = {"elementwise_add", "elementwise_sub", "elementwise_mul",
              "elementwise_min", "elementwise_max", "atan2"}
    if op in binary:
        return {"X": [f(2, 3, 4)], "Y": [f(3)]}, {"axis": 1}
    if op in ("elementwise_div", "elementwise_mod", "elementwise_floordiv"):
        return {"X": [f(3, 4) * 5], "Y": [pos(4)]}, {}
    if op == "elementwise_pow":
        return {"X": [pos(3, 4)], "Y": [f(4)]}, {}
    if op in ("maximum", "minimum"):
        return {"X": [f(3, 4)], "Y": [f(3, 4)]}, {}
    if op in ("equal", "not_equal", "less_than", "less_equal",
              "greater_than", "greater_equal"):
        a = np.round(f(3, 4))
        return {"X": [a], "Y": [np.round(f(3, 4))]}, {}
    if op in ("logical_and", "logical_or", "logical_xor"):
        return {"X": [bools(3, 4)], "Y": [bools(3, 4)]}, {}
    if op == "logical_not":
        return {"X": [bools(3, 4)]}, {}
    if op in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        return {"X": [ints(3, 4, hi=64)], "Y": [ints(3, 4, hi=64)]}, {}
    if op == "bitwise_not":
        return {"X": [ints(3, 4, hi=64)]}, {}
    table = {
        "scale": ({"X": [x]}, {"scale": 2.5, "bias": -0.5,
                               "bias_after_scale": False}),
        "pow": ({"X": [pos(3, 4)]}, {"factor": 2.5}),
        "sum": ({"X": [f(3, 4), f(3, 4), f(3, 4)]}, {}),
        "matmul_v2": ({"X": [f(2, 5, 3)], "Y": [f(2, 4, 5)]},
                      {"trans_x": True, "trans_y": True}),
        "matmul": ({"X": [f(2, 3, 5)], "Y": [f(5, 4)]}, {"alpha": 0.5}),
        "mul": ({"X": [f(2, 3, 4)], "Y": [f(12, 5)]},
                {"x_num_col_dims": 1}),
        "reduce_sum": ({"X": [f(2, 3, 4)]}, {"dim": [0, 2],
                                             "keep_dim": True}),
        "reduce_mean": ({"X": [f(2, 3, 4)]}, {"dim": [1]}),
        "reduce_max": ({"X": [f(2, 3, 4)]}, {"dim": [-1]}),
        "reduce_min": ({"X": [f(2, 3, 4)]}, {"reduce_all": True}),
        "reduce_prod": ({"X": [pos(2, 3, 4)]}, {"dim": [0, 1]}),
        "reduce_any": ({"X": [bools(2, 3, 4)]}, {"dim": [1]}),
        "reduce_all": ({"X": [bools(2, 3, 4)]}, {"dim": [0, 2],
                                                 "keep_dim": True}),
        "clip": ({"X": [x]}, {"min": -0.5, "max": 0.7}),
        "p_norm": ({"X": [f(3, 4)]}, {"porder": 3.0, "axis": 1,
                                      "keepdim": True}),
        "cumsum": ({"X": [f(3, 4)]}, {"axis": 1, "reverse": True,
                                      "exclusive": True}),
        "addmm": ({"Input": [f(3, 4)], "X": [f(3, 5)], "Y": [f(5, 4)]},
                  {"Alpha": 0.5, "Beta": 2.0}),
        "dot": ({"X": [f(3, 4)], "Y": [f(3, 4)]}, {}),
        "cholesky": ({"X": [_spd(r)]}, {"upper": True}),
        "inverse": ({"Input": [_spd(r)]}, {}),
        "logsumexp": ({"X": [f(2, 3, 4)]}, {"axis": [1, 2],
                                            "keepdim": True}),
        "trace": ({"Input": [f(3, 4, 4)]}, {"offset": 1, "axis1": 1,
                                            "axis2": 2}),
        "diagonal": ({"Input": [f(3, 4, 4)]}, {"offset": -1, "axis1": 1,
                                               "axis2": 2}),
        "diagflat": ({"X": [f(2, 2)]}, {"offset": 1}),
        "reduce_std": ({"X": [f(3, 4)]}, {"dim": [1]}),
        "reduce_var": ({"X": [f(3, 4)]}, {"dim": [0], "unbiased": False}),
        "median": ({"X": [f(3, 4)]}, {"axis": 1}),
        "reverse": ({"X": [x]}, {"axis": [0, 1]}),
        "index_sample": ({"X": [f(3, 6)], "Index": [ints(3, 4, hi=6)]}, {}),
        "shard_index": ({"X": [ints(4, 1, hi=20)]},
                        {"index_num": 20, "nshards": 2, "shard_id": 1}),
        "crop_tensor": ({"X": [f(4, 5)]}, {"offsets": [1, 2],
                                           "shape": [2, 3]}),
        # activations with attributes
        "gelu": ({"X": [x]}, {"approximate": True}),
        "leaky_relu": ({"X": [x]}, {"alpha": 0.1}),
        "elu": ({"X": [x]}, {"alpha": 0.7}),
        "hard_sigmoid": ({"X": [x * 4]}, {"slope": 0.3}),
        "hard_swish": ({"X": [x * 4]}, {}),
        "hard_tanh": ({"X": [x]}, {"t_min": -0.5, "t_max": 0.5}),
        "swish": ({"X": [x]}, {"beta": 1.5}),
        "softmax": ({"X": [x]}, {"axis": 0}),
        "log_softmax": ({"X": [x]}, {"axis": -1}),
        "prelu": ({"X": [f(2, 3, 4, 4)], "Alpha": [pos(3)]},
                  {"mode": "channel"}),
        "hardshrink": ({"X": [x]}, {"threshold": 0.3}),
        "softshrink": ({"X": [x]}, {"lambda": 0.3}),
        "thresholded_relu": ({"X": [x]}, {"threshold": 0.2}),
        # creation
        "fill_constant": ({}, {"shape": [2, 3], "value": 1.5,
                               "dtype": "float32"}),
        "fill_any_like": ({"X": [x]}, {"value": 3.0, "dtype": "int64"}),
        "gaussian_random": ({}, {"shape": [4000], "mean": 1.0, "std": 2.0}),
        "uniform_random": ({}, {"shape": [4000], "min": -2.0, "max": 3.0}),
        "truncated_gaussian_random": ({}, {"shape": [4000], "mean": 0.5,
                                           "std": 0.5}),
        "randint": ({}, {"shape": [4000], "low": 2, "high": 9}),
        "randperm": ({}, {"n": 50}),
        "bernoulli": ({"X": [r.rand(3, 4).astype("float32")]}, {}),
        "multinomial": ({"X": [_probs(r)]}, {"num_samples": 2000,
                                             "replacement": True}),
        "range": ({}, {"start": 1, "end": 11, "step": 3, "dtype": "int64"}),
        "eye": ({}, {"num_rows": 3, "num_columns": 5, "dtype": "float32"}),
        "linspace": ({}, {"start": -1.0, "stop": 2.0, "num": 7,
                          "dtype": "float32"}),
        "assign_value": ({}, {"shape": [2, 2], "dtype": "float32",
                              "values": [1.0, 2.0, 3.0, 4.0]}),
        "shape": ({"Input": [f(2, 3, 4)]}, {}),
        "cast": ({"X": [x * 4]}, {"out_dtype": "int32"}),
        # manipulation
        "reshape2": ({"X": [f(2, 3, 4)]}, {"shape": [0, -1]}),
        "transpose2": ({"X": [f(2, 3, 4)]}, {"axis": [2, 0, 1]}),
        "flatten_contiguous_range": ({"X": [f(2, 3, 4, 5)]},
                                     {"start_axis": 1, "stop_axis": 2}),
        "squeeze2": ({"X": [f(2, 1, 4, 1)]}, {"axes": [1, -1]}),
        "unsqueeze2": ({"X": [f(2, 4)]}, {"axes": [0, 2]}),
        "concat": ({"X": [f(2, 3), f(2, 4)]}, {"axis": 1}),
        "split": ({"X": [f(2, 6)]}, {"axis": 1, "sections": [1, 2, 3]}),
        "stack": ({"X": [f(2, 3), f(2, 3)]}, {"axis": 1}),
        "unstack": ({"X": [f(2, 3, 4)]}, {"axis": 1}),
        "expand_v2": ({"X": [f(3, 1)]}, {"shape": [2, -1, 4]}),
        "tile": ({"X": [f(2, 3)]}, {"repeat_times": [2, 1, 2]}),
        "slice": ({"Input": [f(4, 5, 6)]},
                  {"axes": [0, 2], "starts": [1, -4], "ends": [3, 100],
                   "decrease_axis": []}),
        "strided_slice": ({"Input": [f(6, 7)]},
                          {"axes": [0, 1], "starts": [5, 1], "ends": [0, 7],
                           "strides": [-2, 3]}),
        "flip": ({"X": [x]}, {"axis": [1]}),
        "roll": ({"X": [x]}, {"shifts": [1, -2], "axis": [0, 1]}),
        "pad3d": ({"X": [f(1, 2, 3, 4, 5)]},
                  {"paddings": [1, 2, 0, 1, 2, 1], "mode": "reflect"}),
        "pad": ({"X": [f(2, 3)]}, {"paddings": [1, 0, 2, 1],
                                   "pad_value": 0.5}),
        "tril_triu": ({"X": [f(4, 5)]}, {"diagonal": 1, "lower": False}),
        # indexing
        "lookup_table_v2": ({"W": [f(10, 4)], "Ids": [ints(2, 3, hi=10)]},
                            {"padding_idx": 2}),
        "gather": ({"X": [f(5, 4)], "Index": [ints(2, 3)]}, {"axis": 0}),
        "gather_nd": ({"X": [f(4, 5, 3)],
                       "Index": [np.array([[0, 1], [3, 4], [2, 2]])]}, {}),
        "scatter": ({"X": [f(5, 3)], "Ids": [np.array([3, 0, 4])],
                     "Updates": [f(3, 3)]}, {"overwrite": True}),
        "scatter_nd_add": ({"X": [f(4, 3)],
                            "Index": [np.array([[1], [3], [1]])],
                            "Updates": [f(3, 3)]}, {}),
        "index_select": ({"X": [f(3, 5)], "Index": [ints(4, hi=5)]},
                         {"dim": 1}),
        "where": ({"Condition": [bools(3, 4)], "X": [f(3, 4)],
                   "Y": [f(3, 4)]}, {}),
        "where_index": ({"Condition": [bools(3, 4)]}, {}),
        "masked_select": ({"X": [x], "Mask": [bools(3, 4)]}, {}),
        "one_hot_v2": ({"X": [ints(2, 3, hi=6)]}, {"depth": 6}),
        "arg_max": ({"X": [x]}, {"axis": 0, "keepdims": True}),
        "arg_min": ({"X": [x]}, {"flatten": True}),
        "argsort": ({"X": [np.round(f(3, 6))]}, {"axis": 1,
                                                 "descending": True}),
        "top_k_v2": ({"X": [f(3, 6)]}, {"k": 3, "axis": 1,
                                        "largest": False}),
        "unique": ({"X": [ints(12, hi=5)]}, {}),
        "take_along_axis": ({"Input": [f(3, 5)],
                             "Index": [ints(3, 2, hi=5)]}, {"Axis": 1}),
        "meshgrid": ({"X": [f(3), f(4)]}, {}),
        "broadcast_to": ({"X": [f(1, 4)]}, {"shape": [3, 4]}),
        "diag_v2": ({"X": [f(3)]}, {"offset": 1, "padding_value": 2.0}),
        "kron": ({"X": [f(2, 3)], "Y": [f(3, 2)]}, {}),
        "cross": ({"X": [f(4, 3)], "Y": [f(4, 3)]}, {"dim": 1}),
        "multiplex": ({"X": [f(3, 4), f(3, 4)],
                       "Ids": [np.array([[1], [0], [1]])]}, {}),
        "histogram": ({"X": [f(50)]}, {"bins": 7, "min": -2, "max": 2}),
        "bincount": ({"X": [ints(20, hi=6)]}, {"minlength": 8}),
        # optimizers
        "sgd": (_opt(r, "Velocity"), {}),
        "momentum": (_opt(r, "Velocity"), {"mu": 0.8, "use_nesterov": True,
                                           "regularization_method":
                                           "l2_decay",
                                           "regularization_coeff": 0.01}),
        "adam": (_opt(r, "Moment1", "Moment2", pows=2), {"beta1": 0.8}),
        "adamw": (_opt(r, "Moment1", "Moment2", pows=2), {"coeff": 0.1}),
        "lamb": (_opt(r, "Moment1", "Moment2", pows=2),
                 {"weight_decay": 0.02}),
        "rmsprop": (_opt(r, "MeanSquare", "Moment", "MeanGrad"),
                    {"centered": True, "momentum": 0.5}),
        "adagrad": (_opt(r, "Moment"), {"epsilon": 1e-5}),
        "lars_momentum": (_opt(r, "Velocity"), {"lars_weight_decay": 0.01}),
        "adadelta": (_opt(r, "AvgSquaredGrad", "AvgSquaredUpdate"),
                     {"rho": 0.9}),
        "adamax": (_opt(r, "Moment", "InfNorm", pows=1), {}),
        "clip_by_norm": ({"X": [x]}, {"max_norm": 0.5}),
        "check_finite_and_unscale": (
            {"X": [x, np.array([1.0, np.inf], "float32")],
             "Scale": [np.array([4.0], "float32")]}, {}),
        "update_loss_scaling": (
            {"X": [x], "FoundInfinite": [np.array(True)],
             "PrevLossScaling": [np.array([1024.0], "float32")],
             "InGoodSteps": [np.array([3], "int32")],
             "InBadSteps": [np.array([1], "int32")]},
            {"decr_every_n_nan_or_inf": 2}),
        # nn
        "batch_norm": ({"X": [f(4, 3, 2, 2) + 3], "Scale": [pos(3)],
                        "Bias": [f(3)], "Mean": [f(3)],
                        "Variance": [pos(3)]}, {"momentum": 0.8}),
        "batch_norm_grad": ({"X": [f(4, 3, 2, 2)], "Scale": [pos(3)],
                             "Bias": [f(3)], "Mean": [f(3)],
                             "Variance": [pos(3)], "SavedMean": [f(3)],
                             "SavedVariance": [pos(3)],
                             "Y@GRAD": [f(4, 3, 2, 2)]}, {}),
        "conv2d": ({"Input": [f(2, 3, 7, 6)], "Filter": [f(4, 3, 3, 3)]},
                   {"strides": [2, 1], "paddings": [1, 0, 2, 1]}),
        "depthwise_conv2d": ({"Input": [f(2, 5, 6, 4)],
                              "Filter": [f(4, 1, 3, 3)]},
                             {"paddings": [1, 1], "data_format": "NHWC"}),
        "conv2d_transpose": ({"Input": [f(2, 3, 5, 4)],
                              "Filter": [f(3, 2, 3, 3)]},
                             {"strides": [2, 2], "paddings": [1, 1],
                              "output_padding": [1, 0]}),
        "pool2d": ({"X": [f(2, 3, 7, 6)]},
                   {"pooling_type": "avg", "ksize": [3, 3],
                    "strides": [2, 2], "paddings": [1, 1],
                    "ceil_mode": True}),
        "max_pool2d_with_index": ({"X": [f(2, 3, 7, 6)]},
                                  {"ksize": [3, 3], "strides": [2, 2],
                                   "paddings": [1, 1]}),
        "layer_norm": ({"X": [f(2, 3, 8)], "Scale": [pos(8)],
                        "Bias": [f(8)]}, {"begin_norm_axis": 2,
                                          "epsilon": 1e-12}),
        "group_norm": ({"X": [f(2, 4, 3, 3)], "Scale": [pos(4)],
                        "Bias": [f(4)]}, {"groups": 2}),
        "instance_norm": ({"X": [f(2, 3, 4, 4)], "Scale": [pos(3)],
                           "Bias": [f(3)]}, {}),
        "dropout": ({"X": [x]}, {"dropout_prob": 0.3, "axis": [0]}),
        "dropout_grad": ({"Mask": [bools(3, 4).astype("uint8")],
                          "Out@GRAD": [x]}, {"dropout_prob": 0.3}),
        "softmax_with_cross_entropy": (
            {"Logits": [f(4, 6)],
             "Label": [np.array([[1], [-100], [5], [0]])]}, {}),
        "softmax_with_cross_entropy_grad": (
            {"Softmax": [_probs(r)], "Label": [np.array([[1], [2]])],
             "Loss@GRAD": [f(2, 1)]}, {"ignore_index": 2}),
        "cross_entropy": ({"X": [_probs(r)], "Label": [np.array([[1], [3]])]},
                          {}),
        "sigmoid_cross_entropy_with_logits": (
            {"X": [x], "Label": [r.rand(3, 4).astype("float32")]},
            {"normalize": True}),
        "bce_loss": ({"X": [r.rand(3, 4).astype("float32") * 0.9 + 0.05],
                      "Label": [bools(3, 4).astype("float32")]}, {}),
        "huber_loss": ({"X": [x], "Y": [f(3, 4)]}, {"delta": 0.5}),
        "smooth_l1_loss": ({"X": [x], "Y": [f(3, 4)]}, {"sigma": 1.5}),
        "kldiv_loss": ({"X": [f(3, 4)], "Target": [r.rand(3, 4).astype(
            "float32")]}, {"reduction": "batchmean"}),
        "square_error_cost": ({"X": [x], "Y": [f(3, 4)]}, {}),
        "accuracy": ({"Out": [f(4, 2)], "Indices": [ints(4, 2)],
                      "Label": [ints(4, 1)]}, {}),
        "label_smooth": ({"X": [_probs(r)]}, {"epsilon": 0.1}),
        "norm": ({"X": [x]}, {"axis": 1}),
        "data_norm": ({"X": [f(4, 3)], "BatchSize": [pos(3) * 10],
                       "BatchSum": [f(3)], "BatchSquareSum": [pos(3) * 10]},
                      {}),
        "data_norm_grad": ({"X": [f(4, 3)], "BatchSize": [pos(3) * 10],
                            "BatchSum": [f(3)],
                            "BatchSquareSum": [pos(3) * 10],
                            "Y@GRAD": [f(4, 3)]}, {}),
        "fused_softmax_mask": ({"X": [f(2, 3, 4)], "Mask": [f(2, 3, 4)]},
                               {}),
        "fused_softmax_mask_upper_triangle": ({"X": [f(2, 4, 4)]}, {}),
        "conv3d": ({"Input": [f(2, 3, 5, 6, 4)],
                    "Filter": [f(4, 3, 3, 2, 3)]},
                   {"strides": [1, 2, 1], "paddings": [1, 0, 1, 1, 0, 2]}),
        "conv3d_transpose": ({"Input": [f(2, 3, 3, 4, 3)],
                              "Filter": [f(3, 2, 3, 3, 2)]},
                             {"strides": [2, 1, 2], "paddings": [1, 1, 0],
                              "output_padding": [1, 0, 1]}),
        "pool3d": ({"X": [f(2, 3, 5, 6, 4)]},
                   {"pooling_type": "avg", "ksize": [3, 3, 2],
                    "strides": [2, 2, 2], "paddings": [1, 1, 0]}),
        "nearest_interp_v2": ({"X": [f(2, 3, 5, 4)]},
                              {"out_h": 8, "out_w": 3}),
        "bilinear_interp_v2": ({"X": [f(2, 3, 5, 4)]},
                               {"out_h": -1, "out_w": -1,
                                "scale": [1.6, 0.75]}),
        # sequences: a padded batch and its lengths
        "sequence_pad": ({"X": [f(3, 5, 2)], "Length": [lens]},
                         {"pad_value": -1.0, "maxlen": 7}),
        "sequence_unpad": ({"X": [f(3, 5, 2)], "Length": [lens]}, {}),
        "sequence_mask": ({"X": [np.array([3, 0, 5])]},
                          {"maxlen": 6, "out_dtype": "int32"}),
        "sequence_softmax": ({"X": [f(3, 5)], "Length": [lens]}, {}),
        "sequence_pool": ({"X": [f(3, 5, 2)], "Length": [lens]},
                          {"pooltype": "MAX"}),
        "sequence_reverse": ({"X": [f(3, 5, 2)], "Length": [lens]}, {}),
        "sequence_slice": ({"X": [f(3, 5, 2)],
                            "Offset": [np.array([1, 0, 2])],
                            "SliceLength": [np.array([3, 2, 1])]}, {}),
        "sequence_reshape": ({"X": [f(3, 4, 6)],
                              "Length": [np.array([4, 2, 3])]},
                             {"new_dim": 3}),
        "sequence_concat": ({"X": [f(2, 3, 2), f(2, 4, 2)],
                             "Length": [np.array([3, 1]),
                                        np.array([2, 4])]}, {}),
        "sequence_expand_as": ({"X": [f(3, 2)],
                                "Length": [np.array([2, 0, 3])]},
                               {"maxlen": 4}),
        "sequence_enumerate": ({"X": [ints(3, 5, hi=9)],
                                "Length": [np.array([5, 3, 1])]},
                               {"win_size": 3, "pad_value": 7}),
        "sequence_scatter": ({"X": [f(2, 6)], "Ids": [ints(2, 3, hi=6)],
                              "Updates": [f(2, 3)],
                              "Length": [np.array([3, 2])]}, {}),
        "sequence_conv": ({"X": [f(3, 5, 2)], "Filter": [f(6, 4)],
                           "Length": [lens]},
                          {"contextLength": 3, "contextStart": -1}),
        "scaled_dot_product_attention": (
            {"Q": [f(2, 2, 8, 16)], "K": [f(2, 2, 8, 16)],
             "V": [f(2, 2, 8, 16)]}, {"is_causal": True}),
    }
    return table[op]


def _spd(r):
    a = r.randn(4, 4).astype("float32")
    return (a @ a.T + 4 * np.eye(4)).astype("float32")


def _probs(r):
    p = r.rand(2, 6).astype("float32") + 0.1
    return (p / p.sum(-1, keepdims=True)).astype("float32")


def _opt(r, *state, pows=0):
    ins = {"Param": [r.randn(3, 4).astype("float32")],
           "Grad": [r.randn(3, 4).astype("float32")],
           "LearningRate": [np.array([0.05], "float32")]}
    for s in state:
        ins[s] = [(r.rand(3, 4) + 0.1).astype("float32")]
    for s in ("Beta1Pow", "Beta2Pow")[:pows]:
        ins[s] = [np.array([0.81], "float32")]
    return ins


# ---------------------------------------------------------------------------
# running both
# ---------------------------------------------------------------------------


def _ref_run(op, ins, attrs):
    od = jreg.get_op_def(op)
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    rng = jax.random.PRNGKey(0) if od.needs_rng else None
    out = jreg.run_kernel(od, jins, dict(attrs), rng=rng)
    return {s: [np.asarray(a) for a in v] for s, v in out.items()}


def _port_run(op, ins, attrs):
    od = treg.get_op_def(op)
    tins = {s: [torch.as_tensor(np.asarray(a)) for a in v]
            for s, v in ins.items()}
    with torch.no_grad():
        out = treg.run_kernel(od, tins, dict(attrs), rng=7)
    return {s: [a.numpy() for a in v] for s, v in out.items()}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        assert got.dtype.kind == want.dtype.kind, (what, got.dtype,
                                                   want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert str(got.dtype) == str(want.dtype), (what, got.dtype,
                                                   want.dtype)
        scale = float(np.max(np.abs(want))) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                                   err_msg=what)


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


@pytest.fixture
def uniforms(monkeypatch):
    """Both packages' uniform draws patched to the same numpy uniforms."""
    from paddle_tpu_torch.framework import random as trand

    def draws(shape):
        return np.random.RandomState(11).rand(*shape).astype("float32")

    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None, **kw:
                        jnp.asarray(draws(tuple(shape))))
    monkeypatch.setattr(trand, "uniform", lambda key, shape, device:
                        torch.as_tensor(draws(tuple(shape))))


FORWARD = [t for t in _reference_ops() if t not in DEFERRED]


@pytest.mark.parametrize("op", FORWARD)
def test_forward_matches_reference(op, request):
    ins, attrs = _case(op)
    if op in INJECTED:
        request.getfixturevalue("uniforms")
    got = _port_run(op, ins, attrs)
    if op in RANDOM:
        _random_properties(op, got, attrs, ins)
        return
    want = _ref_run(op, ins, attrs)
    assert sorted(got) == sorted(want), op
    for slot in want:
        assert len(got[slot]) == len(want[slot]), (op, slot)
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            _close(g, w, f"{op}.{slot}[{i}]")


def _random_properties(op, got, attrs, ins):
    out = got["Out"][0]
    if op == "randperm":
        assert out.dtype == np.int64
        assert sorted(out.tolist()) == list(range(attrs["n"]))
        return
    if op == "randint":
        assert out.dtype == np.int64 and out.shape == (4000,)
        assert out.min() >= attrs["low"] and out.max() < attrs["high"]
        assert len(set(out.tolist())) == attrs["high"] - attrs["low"]
        return
    if op == "multinomial":
        p = ins["X"][0]
        assert out.shape == (2, 2000) and out.dtype == np.int64
        freq = np.stack([np.bincount(row, minlength=6) / 2000.0
                         for row in out])
        np.testing.assert_allclose(freq, p, atol=0.05)
        return
    assert out.dtype == np.float32 and out.shape == (4000,)
    if op == "uniform_random":
        assert out.min() >= attrs["min"] and out.max() < attrs["max"]
        np.testing.assert_allclose(out.mean(), 0.5, atol=0.1)
        return
    mean, std = attrs["mean"], attrs["std"]
    np.testing.assert_allclose(out.mean(), mean, atol=0.1 * std)
    if op == "truncated_gaussian_random":
        assert np.abs(out - mean).max() <= 2 * std + 1e-6
        std *= 0.8796  # the std of a normal truncated at +-2
    np.testing.assert_allclose(out.std(), std, rtol=0.06)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _differentiable():
    out = []
    for op in FORWARD:
        od = treg.get_op_def(op)
        if od.no_grad:
            continue
        ins, _ = _case(op)
        if any(s not in od.nondiff_slots and np.asarray(a).dtype.kind == "f"
               for s, v in ins.items() for a in v):
            out.append(op)
    return out


def _ref_grad(op, ins, attrs, ogs):
    """The reference's input gradients: its ``<type>_grad`` kernel (auto
    from jax.vjp, or the hand-written one fed as its grad maker feeds
    it)."""
    od = jreg.get_op_def(op)
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    jogs = {s + jreg.GRAD_SUFFIX: [jnp.asarray(a) for a in v]
            for s, v in ogs.items()}
    rng = jax.random.PRNGKey(0) if od.needs_rng else None
    if od.grad_maker is None:
        gdef = jreg.get_grad_op_def(op)
        out = jreg.run_kernel(gdef, {**jins, **jogs}, dict(attrs), rng=rng)
    else:
        # the grad maker wires names: "<slot>:<i>" for the forward's
        # inputs and outputs, "<slot>:<i>@GRAD" for output gradients
        fwd = jreg.run_kernel(od, jins, dict(attrs), rng=rng)
        names = {f"{s}:{i}": a for s, v in list(jins.items())
                 + list(fwd.items()) for i, a in enumerate(v)}
        names.update({f"{s[:-5]}:{i}@GRAD": a for s, v in jogs.items()
                      for i, a in enumerate(v)})

        class Op:
            inputs = {s: [f"{s}:{i}" for i in range(len(v))]
                      for s, v in jins.items()}
            outputs = {s: [f"{s}:{i}" for i in range(len(v))]
                       for s, v in fwd.items()}

            def input(self, s):
                return self.inputs.get(s, [])

            def output(self, s):
                return self.outputs.get(s, [])

        op_ = Op()
        op_.attrs = dict(attrs)
        desc = od.grad_maker(op_, set())[0]
        gins = {s: [names[n] for n in ns] for s, ns in desc["inputs"].items()}
        out = jreg.run_kernel(jreg.get_op_def(desc["type"]), gins,
                              desc["attrs"])
    return {s: [np.asarray(a) for a in v] for s, v in out.items()
            if s.endswith(jreg.GRAD_SUFFIX) and s[:-5] in ins}


@pytest.mark.parametrize("op", _differentiable())
def test_gradient_matches_reference(op, request):
    ins, attrs = _case(op)
    if op in INJECTED:
        request.getfixturevalue("uniforms")
    od = treg.get_op_def(op)
    fwd = _port_run(op, ins, attrs)
    r = np.random.RandomState(5)
    ogs = {s: [np.asarray(r.randn(*np.shape(a)), np.asarray(a).dtype)
               for a in v] for s, v in fwd.items()
           if s not in od.nondiff_out_slots
           and np.asarray(v[0]).dtype.kind == "f"}
    want = _ref_grad(op, ins, attrs, ogs)
    got = treg.op_grad(op, {s: [torch.as_tensor(np.asarray(a)) for a in v]
                            for s, v in ins.items()}, attrs,
                       {s: [torch.as_tensor(a) for a in v]
                        for s, v in ogs.items()}, rng=7)
    assert want, op
    for slot, ws in want.items():
        gs = got[slot]
        for i, (g, w) in enumerate(zip(gs, ws)):
            _close(g.numpy(), w, f"{op}.{slot}[{i}]")

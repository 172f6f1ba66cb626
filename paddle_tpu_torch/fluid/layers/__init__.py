"""``paddle.fluid.layers``: the v2.1-era layer-builder surface.

Counterpart of ``paddle_tpu/fluid/layers/__init__.py``, name for name.
Pre-2.x code writes ``import paddle.fluid as fluid; fluid.layers.fc(...)``;
every name maps onto the port's 2.x functions (``static.nn`` builders,
``tensor_api``, ``nn.functional``), so such code runs unmodified, in
static mode through the Executor.  Parameter-server-era or deprecated
names raise an error naming the modern replacement, and names whose
2.x backing the port has yet to gain raise NotImplementedError naming
the ROADMAP item (the 3-D and resize ops, the RNN layers and CTC: A.7;
``vision.ops`` and ``distribution``: A.12).

The learning-rate schedule functions return the matching 2.x
``optimizer.lr`` scheduler, which every optimizer accepts: the rate a
step sees is the same.
"""

from __future__ import annotations

import numpy as np

from ... import tensor_api as T
from ...framework import program as fw
from ...nn import functional as F
from ...ops.dispatch import dispatch, single
from ...static import nn as snn
from ...static.input import data as _static_data

# the full static.nn builder family (batch_norm, embedding, conv2d,
# sequence_*, cond/while_loop/case/switch_case, create_parameter, ...)
from ...static.nn import *  # noqa: F401,F403
from ...static.nn import __all__ as _snn_all


def _waits(name, item, what):
    """A stand-in for a name whose backing the port gains with ROADMAP
    ``item``."""

    def raiser(*a, **k):
        raise NotImplementedError(
            f"fluid.layers.{name} needs {what}, which the port gains with "
            f"ROADMAP {item}")

    raiser.__name__ = name
    return raiser


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """The v2.1 keywords (input=, param_attr=, act=) over static.nn.fc
    (weight_attr=, activation= in 2.x)."""
    return snn.fc(input, size, num_flatten_dims=num_flatten_dims,
                  weight_attr=param_attr, bias_attr=bias_attr,
                  activation=act, name=name)

# tensor-array / control-flow extras
from ... import tensor_api as _T_arr
array_length = _T_arr.array_length
array_read = _T_arr.array_read
array_write = _T_arr.array_write
create_array = _T_arr.create_array


def _d(op, ins, attrs=None, slot="Out"):
    return single(dispatch(op, ins, attrs or {}), slot)


# ---------------------------------------------------------------------------
# io.py: fluid.layers.data (append_batch_size semantics)
# ---------------------------------------------------------------------------


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         **kw):
    """v2.1 ``fluid.layers.data``: prepends the -1 batch dim, unless the
    caller already gave a variable (-1 / None) dim, which makes the shape
    complete."""
    shape = [-1 if d is None else int(d) for d in shape]
    if append_batch_size and all(d >= 0 for d in shape):
        shape = [-1] + shape
    return _static_data(name, shape, dtype=dtype, lod_level=lod_level)


# ---------------------------------------------------------------------------
# tensor.py
# ---------------------------------------------------------------------------

def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    """fluid's argument order is (shape, dtype, value); 2.x ``full``'s is
    (shape, value, dtype)."""
    r = T.full(shape, value, dtype=dtype)
    if out is not None:
        T.assign(r, out)
        return out
    return r


cast = T.cast
concat = T.concat
assign = T.assign
argmax = T.argmax
argmin = T.argmin
argsort = T.argsort
zeros = T.zeros
ones = T.ones
zeros_like = T.zeros_like
ones_like = T.ones_like
linspace = T.linspace
diag = T.diag
eye = T.eye
reverse = T.flip
isfinite = T.isfinite
has_inf = lambda x: T.any(T.isinf(x))  # noqa: E731
has_nan = lambda x: T.any(T.isnan(x))  # noqa: E731


def create_tensor(dtype, name=None, persistable=False):
    blk = fw.default_main_program().current_block()
    from ...framework import unique_name

    return blk.create_var(name=name or unique_name.generate("create_tensor"),
                          dtype=dtype, shape=(), persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ...static import create_global_var as _cgv

    return _cgv(shape, value, dtype, persistable=persistable, name=name)


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    shape = list(shape)
    shape[output_dim_idx] = T.shape(input)[input_dim_idx]
    return T.full(shape, value, dtype=dtype)


def tensor_array_to_tensor(input, axis=1, use_stack=False):
    import builtins

    items = ([array_read(input, i) for i in builtins.range(len(input))]
             if isinstance(input, list) else list(input))
    out = (T.stack(items, axis=axis) if use_stack
           else T.concat(items, axis=axis))
    return out, T.shape(out)


def range(start, end, step, dtype):  # noqa: A001 (fluid's name)
    return T.arange(start, end, step, dtype=dtype)


def sums(input, out=None):
    r = T.add_n(input)
    if out is not None:
        T.assign(r, out)
        return out
    return r


# ---------------------------------------------------------------------------
# nn.py: activations / elementwise / reductions / shape ops
# ---------------------------------------------------------------------------

relu = F.relu
relu6 = F.relu6
elu = F.elu
selu = F.selu
prelu = snn.prelu
leaky_relu = F.leaky_relu
softmax = F.softmax
log = T.log
pow = T.pow  # noqa: A001
sign = T.sign
sqrt = T.sqrt
abs = T.abs  # noqa: A001
square = T.square
exp = T.exp
floor = T.floor
ceil = T.ceil
round = T.round  # noqa: A001
sin = T.sin
cos = T.cos
tanh = T.tanh
sigmoid = F.sigmoid
swish = F.swish
mish = F.mish
hard_swish = F.hardswish
hard_sigmoid = F.hardsigmoid
maxout = F.maxout
stanh = T.stanh
logsigmoid = F.log_sigmoid
softplus = F.softplus
softsign = F.softsign
softshrink = F.softshrink
hard_shrink = F.hardshrink
thresholded_relu = F.thresholded_relu
erf = T.erf


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return T.clip(x, t_min, t_max)


def soft_relu(x, threshold=40.0, name=None):
    return T.log(1 + T.exp(T.clip(x, -threshold, threshold)))


def _reduce(fn):
    def wrapper(input, dim=None, keep_dim=False, name=None):
        return fn(input, axis=dim, keepdim=keep_dim)

    return wrapper


reduce_sum = _reduce(T.sum)
reduce_mean = _reduce(T.mean)
reduce_max = _reduce(T.max)
reduce_min = _reduce(T.min)
reduce_prod = _reduce(T.prod)
reduce_all = _reduce(T.all)
reduce_any = _reduce(T.any)


def _elementwise(op):
    def wrapper(x, y, axis=-1, act=None, name=None):
        out = _d(op, {"X": [x], "Y": [y]}, {"axis": axis})
        if act:
            out = getattr(F, act)(out)
        return out

    return wrapper


elementwise_add = _elementwise("elementwise_add")
elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")
elementwise_max = _elementwise("elementwise_max")
elementwise_min = _elementwise("elementwise_min")
elementwise_pow = _elementwise("elementwise_pow")
elementwise_mod = _elementwise("elementwise_mod")
elementwise_floordiv = _elementwise("elementwise_floordiv")


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _d("mul", {"X": [x], "Y": [y]},
              {"x_num_col_dims": x_num_col_dims,
               "y_num_col_dims": y_num_col_dims})


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    out = T.matmul(x, y, transpose_x=transpose_x, transpose_y=transpose_y)
    if alpha != 1.0:
        out = T.scale(out, scale=alpha)
    return out


mean = T.mean
scale = T.scale
clip = T.clip
def clip_by_norm(x, max_norm, name=None):
    norm = T.sqrt(T.sum(T.square(x)))
    factor = T.minimum(T.full_like(norm, 1.0),
                       T.full_like(norm, float(max_norm)) /
                       T.maximum(norm, T.full_like(norm, 1e-12)))
    return x * factor
sum = T.add_n  # noqa: A001 — fluid.layers.sum adds a LIST of tensors
slice = T.slice  # noqa: A001
strided_slice = T.strided_slice
shape = T.shape
rank = T.rank
size = lambda x: T.numel(x)  # noqa: E731
logical_and = T.logical_and
logical_or = T.logical_or
logical_xor = T.logical_xor
logical_not = T.logical_not
equal = T.equal
not_equal = T.not_equal
less_than = T.less_than
less_equal = T.less_equal
greater_than = T.greater_than
greater_equal = T.greater_equal
reshape = T.reshape
squeeze = T.squeeze
unsqueeze = T.unsqueeze
transpose = T.transpose
split = T.split
stack = T.stack
unstack = T.unstack
unbind = T.unbind
expand = lambda x, expand_times, name=None: T.tile(x, expand_times)  # noqa: E731
expand_as = T.expand_as
gather = T.gather
gather_nd = T.gather_nd
scatter = T.scatter
scatter_nd = T.scatter_nd
scatter_nd_add = T.scatter_nd_add
where = T.nonzero  # fluid.layers.where(cond) = indices of True (nonzero)
topk = T.topk
unique = T.unique
flatten = F.flatten
one_hot = F.one_hot
label_smooth = F.label_smooth
l2_normalize = lambda x, axis, epsilon=1e-12, name=None: F.normalize(  # noqa: E731
    x, p=2, axis=axis, epsilon=epsilon)
pad = F.pad
unfold = _waits("unfold", "A.7", "nn.functional.unfold")
pixel_shuffle = _waits("pixel_shuffle", "A.7", "nn.functional.pixel_shuffle")
dropout_impl = F.dropout


def dropout(x, dropout_prob, is_test=False, seed=None,
            name=None, dropout_implementation="downgrade_in_infer"):
    return F.dropout(x, p=dropout_prob, training=not is_test,
                     mode=dropout_implementation)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCHW"):
    if global_pooling:
        return _d("pool2d", {"X": [input]},
                  {"pooling_type": pool_type, "ksize": [1, 1],
                   "global_pooling": True, "data_format": data_format})
    fn = F.max_pool2d if pool_type == "max" else F.avg_pool2d
    kw = dict(kernel_size=pool_size, stride=pool_stride,
              padding=pool_padding, ceil_mode=ceil_mode,
              data_format=data_format)
    if pool_type != "max":
        kw["exclusive"] = exclusive
    return fn(input, **kw)


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    if require_index:
        if pool_type != "max":
            raise ValueError("require_index needs pool_type='max'")
        return F.adaptive_max_pool2d(input, pool_size, return_mask=True)
    fn = (F.adaptive_max_pool2d if pool_type == "max"
          else F.adaptive_avg_pool2d)
    return fn(input, pool_size)


image_resize = _waits("image_resize", "A.7", "the interp ops")
resize_bilinear = _waits("resize_bilinear", "A.7", "the interp ops")
resize_nearest = _waits("resize_nearest", "A.7", "the interp ops")


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    return F.pad(input, list(paddings), mode=mode.replace("edge", "replicate"),
                 value=pad_value, data_format=data_format)


def crop_tensor(x, shape=None, offsets=None, name=None):
    return T.crop(x, shape=shape, offsets=offsets)


crop = crop_tensor
lrn = F.local_response_norm


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,  # noqa: A002
                   name=None):
    return T.uniform(shape, dtype=dtype, min=min, max=max, seed=seed)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    return T.standard_normal(shape, dtype=dtype) * std + mean


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):  # noqa: A002
    shape = list(shape)
    shape[output_dim_idx] = T.shape(input)[input_dim_idx]
    return T.uniform(shape, dtype=dtype, min=min, max=max, seed=seed)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    shape = list(shape)
    shape[output_dim_idx] = T.shape(input)[input_dim_idx]
    return T.standard_normal(shape, dtype=dtype) * std + mean


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    from ...static import create_global_var as _cgv

    counter = _cgv([1], begin - step, "int64", persistable=True,
                   name=counter_name or "@STEP_COUNTER@")
    return increment(counter, value=step, in_place=True)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """v2.1 ``smooth_l1_loss``: the diff scaled by sigma^2 inside the
    Huber branch point, the weights multiplying the diff (inside) and the
    loss (outside), the loss summed over every non-batch dim ([N, 1])."""
    sigma2 = float(sigma if sigma is not None else 1.0) ** 2
    diff = T.subtract(x, y)
    if inside_weight is not None:
        diff = T.multiply(diff, inside_weight)
    ad = T.abs(diff)
    inv = 1.0 / sigma2
    quad = T.scale(T.multiply(diff, diff), 0.5 * sigma2)
    lin = T.subtract(ad, T.full_like(ad, 0.5 * inv))
    loss = T.where(T.less_than(ad, T.full_like(ad, inv)), quad, lin)
    if outside_weight is not None:
        loss = T.multiply(loss, outside_weight)
    n = loss.shape[0]
    return T.sum(T.reshape(loss, [n, -1]), axis=1, keepdim=True)


# ---------------------------------------------------------------------------
# loss.py
# ---------------------------------------------------------------------------


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """fluid semantics: ``input`` is post-softmax PROBABILITIES."""
    return _d("cross_entropy", {"X": [input], "Label": [label]},
              {"soft_label": soft_label, "ignore_index": ignore_index},
              slot="Y")


softmax_with_cross_entropy = F.softmax_with_cross_entropy
square_error_cost = F.square_error_cost


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    """Elementwise BCE with logits; positions where ``label ==
    ignore_index`` give 0, and ``normalize=True`` divides by the count of
    the others."""
    loss = F.binary_cross_entropy_with_logits(x, label, reduction="none")
    keep = T.cast(T.not_equal(label, T.full_like(label, ignore_index)),
                  loss.dtype)
    loss = T.multiply(loss, keep)
    if normalize:
        total = T.sum(keep)
        loss = T.divide(loss, T.maximum(total, T.full_like(total, 1.0)))
    return loss
log_loss = F.log_loss
mse_loss = F.mse_loss
kldiv_loss = F.kl_div
nce = snn.nce
npair_loss = None
margin_rank_loss = (
    lambda label, left, right, margin=0.1, name=None:
    F.margin_ranking_loss(left, right, label, margin=margin,
                          reduction="none"))
huber_loss = (lambda input, label, delta:
              F.smooth_l1_loss(input, label, reduction="none", delta=delta))


def dice_loss(input, label, epsilon=1e-5):
    label = T.cast(label, input.dtype)
    label = T.squeeze(label, [-1]) if label.shape[-1] == 1 else label
    label = F.one_hot(T.cast(label, "int64"), input.shape[-1])
    reduce_dim = list(np.arange(1, len(input.shape)))
    inse = T.sum(input * label, axis=reduce_dim)
    dice_denominator = T.sum(input, axis=reduce_dim) + T.sum(
        label, axis=reduce_dim)
    dice_score = 1 - inse * 2 / (dice_denominator + epsilon)
    return T.mean(dice_score)


# ---------------------------------------------------------------------------
# metric_op.py
# ---------------------------------------------------------------------------

from ...static import accuracy, auc  # noqa: F401,E402


# ---------------------------------------------------------------------------
# control_flow.py extras (cond/while_loop/case/switch_case come from
# static.nn; the imperative builders live in static.control_flow)
# ---------------------------------------------------------------------------


def increment(x, value=1.0, in_place=True):
    out = T.add(x, T.full_like(x, value))
    if in_place:
        T.assign(out, x)
        return x
    return out


def is_empty(x, name=None):
    return T.equal(T.numel(x), T.full([], 0, "int64"))


class Print:  # noqa: N801 (fluid exports Print here too)
    def __new__(cls, input, **kw):
        from ...static import Print as _p

        return _p(input, **kw)


# ---------------------------------------------------------------------------
# learning_rate_scheduler.py — return 2.x scheduler objects
# ---------------------------------------------------------------------------


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    from ...optimizer import lr

    return lr.NoamDecay(d_model, warmup_steps, learning_rate=learning_rate)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    from ...optimizer import lr

    # the rate of step e: base * decay_rate ** (e / decay_steps)
    class _Exp(lr.LRScheduler):
        def get_lr(self):
            e = self.last_epoch / decay_steps
            if staircase:
                e = int(e)
            return self.base_lr * decay_rate ** e

    return _Exp(learning_rate=learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    import math

    from ...optimizer import lr

    class _NatExp(lr.LRScheduler):
        def get_lr(self):
            e = self.last_epoch / decay_steps
            if staircase:
                e = int(e)
            return self.base_lr * math.exp(-decay_rate * e)

    return _NatExp(learning_rate=learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    from ...optimizer import lr

    class _Inv(lr.LRScheduler):
        def get_lr(self):
            e = self.last_epoch / decay_steps
            if staircase:
                e = int(e)
            return self.base_lr / (1 + decay_rate * e)

    return _Inv(learning_rate=learning_rate)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    from ...optimizer import lr

    return lr.PolynomialDecay(learning_rate, decay_steps,
                              end_lr=end_learning_rate, power=power,
                              cycle=cycle)


def piecewise_decay(boundaries, values):
    from ...optimizer import lr

    return lr.PiecewiseDecay(boundaries, values)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    from ...optimizer import lr

    return lr.CosineAnnealingDecay(learning_rate, step_each_epoch * epochs)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    from ...optimizer import lr

    if not isinstance(learning_rate, lr.LRScheduler):
        learning_rate = float(learning_rate)
    return lr.LinearWarmup(learning_rate, warmup_steps, start_lr, end_lr)


# ---------------------------------------------------------------------------
# detection.py: vision.ops, which the port gains with ROADMAP A.12
# ---------------------------------------------------------------------------

for _n in ("box_coder", "distribute_fpn_proposals", "prior_box",
           "roi_align", "yolo_box", "yolov3_loss", "multiclass_nms",
           "roi_pool", "generate_proposals"):
    globals()[_n] = _waits(_n, "A.12", "vision.ops")


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=None,
                    deformable_groups=None, im2col_step=None,
                    param_attr=None, bias_attr=None,
                    modulated=True, name=None):
    return snn.deform_conv2d(
        input, offset, mask if modulated else None, num_filters, filter_size,
        stride=stride, padding=padding, dilation=dilation,
        groups=groups or 1, deformable_groups=deformable_groups or 1,
        param_attr=param_attr, bias_attr=bias_attr)


def box_clip(input, im_info, name=None):
    h = im_info[:, 0]
    w = im_info[:, 1]
    zero = T.zeros([], dtype=input.dtype)
    xmin = T.maximum(T.minimum(input[..., 0], w - 1), zero)
    ymin = T.maximum(T.minimum(input[..., 1], h - 1), zero)
    xmax = T.maximum(T.minimum(input[..., 2], w - 1), zero)
    ymax = T.maximum(T.minimum(input[..., 3], h - 1), zero)
    return T.stack([xmin, ymin, xmax, ymax], axis=-1)


bipartite_match = _waits("bipartite_match", "A.12", "vision.ops")


# ---------------------------------------------------------------------------
# rnn.py — the modern RNN API covers these; LoD-dynamic ones are PS-era
# ---------------------------------------------------------------------------


lstm = _waits("lstm", "A.7", "nn.LSTM (nn/layer/rnn.py)")


# ---------------------------------------------------------------------------
# distributions (moved to paddle.distribution in 2.x)
# ---------------------------------------------------------------------------


def _unsupported(name, why, instead):
    def raiser(*a, **k):
        raise NotImplementedError(
            f"fluid.layers.{name} is {why} in this build; "
            f"use {instead} instead.")

    raiser.__name__ = name
    return raiser


# ---------------------------------------------------------------------------
# v2.1 names wired to their existing 2.x implementations (arg order is the
# fluid one; the bodies are the 2.x ops)
# ---------------------------------------------------------------------------


grid_sampler = _waits("grid_sampler", "A.7", "nn.functional.grid_sample")
temporal_shift = _waits("temporal_shift", "A.7",
                        "nn.functional.temporal_shift")
affine_grid = _waits("affine_grid", "A.7", "nn.functional.affine_grid")
gather_tree = _waits("gather_tree", "A.7", "nn.functional.gather_tree")
multiplex = T.multiplex


def mean_iou(input, label, num_classes):
    """``(mean_iou, out_wrong, out_correct)``: per-class wrong and correct
    counts (a mismatch counts against both classes) and the IoU mean over
    the classes that appear."""
    from ...dygraph import tracer

    def fn(pred, lab):
        import torch

        pred = pred.reshape(-1).long()
        lab = lab.reshape(-1).long()
        hit = pred == lab
        n = num_classes

        def count(v):
            return torch.bincount(v, minlength=n + 1)[:n]

        correct = count(torch.where(hit, pred, torch.full_like(pred, n)))
        wrong = (count(torch.where(hit, torch.full_like(pred, n), pred))
                 + count(torch.where(hit, torch.full_like(lab, n), lab)))
        denom = correct + wrong
        valid = denom > 0
        iou = torch.where(valid, correct / torch.clamp_min(denom, 1),
                          torch.zeros((), dtype=torch.float64,
                                      device=denom.device))
        miou = torch.sum(iou) / torch.clamp_min(torch.sum(valid), 1)
        return miou.float(), wrong.int(), correct.int()

    return tracer.trace_fn(fn, [input, label], name="mean_iou")


def unique_with_counts(x, dtype="int32"):
    """``(out, index, count)``: ``out`` in first-appearance order (not
    sorted: [2, 3, 3, 1, 5, 3] gives [2, 3, 1, 5]), ``index`` each
    element's slot in ``out``, index and count of ``dtype``."""
    from ...dygraph import tracer
    from ...framework.dtype import to_torch_dtype

    dt = to_torch_dtype(dtype)

    def fn(a):
        import torch

        flat = a.reshape(-1)
        u, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                      return_counts=True)
        pos = torch.arange(flat.numel(), device=flat.device)
        first = torch.full((u.numel(),), flat.numel(), dtype=torch.long,
                           device=flat.device).scatter_reduce(
                               0, inv, pos, reduce="amin")
        order = torch.argsort(first)     # sorted slot -> appearance order
        rank = torch.argsort(order)      # appearance rank of each slot
        return u[order], rank[inv].to(dt), counts[order].to(dt)

    return tracer.trace_fn(fn, [x], name="unique_with_counts")


def space_to_depth(x, blocksize, name=None):
    """NCHW blocks of ``blocksize`` moved into channels, in (offset_h,
    offset_w, c) order: out[:, (oh * bs + ow) * C + c, h, w]."""
    from ...dygraph import tracer

    bs = int(blocksize)

    def fn(a):
        n, c, h, w = a.shape
        assert h % bs == 0 and w % bs == 0, (
            f"space_to_depth: spatial dims {(h, w)} must divide "
            f"blocksize {bs}")
        a = a.reshape(n, c, h // bs, bs, w // bs, bs)
        a = a.permute(0, 3, 5, 1, 2, 4)
        return a.reshape(n, c * bs * bs, h // bs, w // bs)

    return tracer.trace_fn(fn, [x], name="space_to_depth")


# parameter-server-era, LoD-runtime or deprecated names: an informative
# raise naming the modern route
_PS_ERA = {
    "linear_chain_crf": ("CRF training on the PS runtime",
                         "paddle.text CRF layers or an external CRF lib"),
    "chunk_eval": ("a PS-era metric op", "paddle.metric with seqeval-style "
                   "python evaluation"),
    "im2sequence": ("a LoD-producing op", "paddle.nn.functional.unfold"),
    "ctc_greedy_decoder": ("a LoD-consuming decode op",
                           "paddle.nn.functional.ctc_decode-style numpy "
                           "post-processing"),
    "dynamic_lstm": ("a LoD-dynamic recurrent op", "paddle.nn.LSTM"),
    "dynamic_lstmp": ("a LoD-dynamic recurrent op", "paddle.nn.LSTM"),
    "dynamic_gru": ("a LoD-dynamic recurrent op", "paddle.nn.GRU"),
    "gru_unit": ("a single-step PS-era cell op", "paddle.nn.GRUCell"),
    "lstm_unit": ("a single-step PS-era cell op", "paddle.nn.LSTMCell"),
    "beam_search": ("a low-level LoD beam op",
                    "models.generation beam search"),
    "beam_search_decode": ("a low-level LoD beam op",
                           "models.generation beam search"),
    "py_reader": ("the legacy queue-feed reader", "paddle.io.DataLoader"),
    "double_buffer": ("the legacy queue-feed pipeline",
                      "paddle.io.DataLoader(prefetch_factor=...)"),
    "read_file": ("the legacy file reader", "paddle.io.DataLoader"),
    "load": ("the legacy persistable loader", "paddle.static.load"),
    "random_crop": ("a stateful data-aug op",
                    "paddle.vision.transforms.RandomCrop"),
    "sampling_id": ("a sampler over softmax rows",
                    "paddle.multinomial"),
    "similarity_focus": ("a deprecated attention op", "explicit tensor ops"),
    "hash": ("a PS sparse-feature op", "python-side feature hashing"),
    "add_position_encoding": ("deprecated", "explicit position embeddings"),
    "merge_selected_rows": ("a SelectedRows runtime op",
                            "dense gradients (SelectedRows are dense here)"),
    "get_tensor_from_selected_rows": ("a SelectedRows runtime op",
                                      "the tensor itself"),
    "shuffle_channel": ("deprecated", "reshape+transpose"),
    "psroi_pool": ("a niche detection op", "roi_align"),
    "prroi_pool": ("a niche detection op", "roi_align"),
    "fsp_matrix": ("a distillation helper", "explicit matmul over features"),
    "continuous_value_model": ("a PS CTR op", "explicit feature slicing"),
    "filter_by_instag": ("a PS instance-tag op", "python-side filtering"),
    "shard_index": ("a PS sharding op",
                    "mesh sharding (paddle.distributed)"),
    "affine_channel": ("deprecated", "scale+bias tensor ops"),
    "inplace_abn": ("a fused-CUDA ABN", "paddle.static.nn.batch_norm"),
    "pad_constant_like": ("deprecated", "paddle.nn.functional.pad"),
    "lod_reset": ("a LoD mutation op", "the padded+mask sequence design"),
    "lod_append": ("a LoD mutation op", "the padded+mask sequence design"),
    "image_resize_short": ("deprecated", "paddle.vision.transforms.Resize"),
    "resize_linear": ("1-D resize", "paddle.nn.functional.interpolate"),
    "resize_trilinear": ("3-D resize", "paddle.nn.functional.interpolate"),
    "deformable_roi_pooling": ("a niche detection op", "roi_align"),
    "bilinear_tensor_product": ("available via static.nn",
                                "paddle.static.nn.bilinear_tensor_product"),
    "StaticRNN": ("the legacy symbolic RNN builder",
                  "paddle.nn.RNN / paddle.static.nn.while_loop"),
    "DynamicRNN": ("the LoD-dynamic RNN builder", "paddle.nn.RNN"),
    "IfElse": ("the legacy block builder", "paddle.static.nn.cond"),
    "Switch": ("the legacy block builder", "paddle.static.nn.case"),
    "While": ("the legacy block builder", "paddle.static.nn.while_loop"),
}

for _n, (_why, _instead) in _PS_ERA.items():
    if globals().get(_n) is None:
        globals()[_n] = _unsupported(_n, _why, _instead)

# placeholders that resolved to None (the feature exists under another name)
for _n in [k for k, v in list(globals().items()) if v is None]:
    globals()[_n] = _unsupported(_n, "not bound", "the paddle.nn 2.x API")


# ---------------------------------------------------------------------------
# the remaining fluid.layers names (rnn.py decoder classes, distributions,
# pool3d, losses, detection extras): the 2.x implementations where they
# exist, informative raises for the parameter-server-era ones
# ---------------------------------------------------------------------------

from ... import nn as _nn2  # noqa: E402

for _n, _what in (("RNNCell", "nn.RNNCellBase"), ("GRUCell", "nn.GRUCell"),
                  ("LSTMCell", "nn.LSTMCell"),
                  ("BeamSearchDecoder", "nn.BeamSearchDecoder"),
                  ("dynamic_decode", "nn.dynamic_decode"),
                  ("rnn", "nn.RNN"), ("birnn", "nn.BiRNN")):
    globals()[_n] = _waits(_n, "A.7", _what + " (nn/layer/rnn.py)")
for _n in ("Categorical", "Normal", "Uniform"):
    globals()[_n] = _waits(_n, "A.12", "paddle.distribution")

sequence_mask = F.sequence_mask
triu = T.triu
sigmoid_focal_loss = F.sigmoid_focal_loss
kldiv_loss = F.kl_div


warpctc = _waits("warpctc", "A.7", "nn.functional.ctc_loss")
hsigmoid = _waits("hsigmoid", "A.7", "nn.HSigmoidLoss")


def cos_sim(X, Y):
    # [N, 1], as fluid returns it
    return T.unsqueeze(F.cosine_similarity(X, Y, axis=-1), [-1])


pool3d = _waits("pool3d", "A.7", "the 3-D pool ops")
adaptive_pool3d = _waits("adaptive_pool3d", "A.7", "the 3-D pool ops")


def bpr_loss(input, label, name=None):
    """Bayesian personalized ranking: for each row, the sum over j !=
    label of -log(sigmoid(score_label - score_j)), over (num_classes -
    1)."""
    n, c = input.shape[0], input.shape[-1]
    idx = T.cast(T.reshape(label, [-1, 1]), "int64")
    pos = T.gather_nd(input, T.concat([
        T.unsqueeze(T.arange(0, n, 1, dtype="int64"), [-1]), idx], axis=-1))
    diff = T.unsqueeze(pos, [-1]) - input
    loss = -T.log(F.sigmoid(diff) + 1e-8)
    # the j == label term is left out
    mask = T.cast(T.not_equal(
        T.unsqueeze(T.arange(0, c, 1, dtype="int64"), [0]),
        idx), loss.dtype)
    return T.sum(loss * mask, axis=-1, keepdim=True) / float(int(c) - 1)


def rank_loss(label, left, right, name=None):
    """C(o) = -o~ * o + log(1 + exp(o)), o = left - right."""
    o = left - right
    return -label * o + T.log(1.0 + T.exp(o))


def iou_similarity(x, y, box_normalized=True, name=None):
    """Pairwise IoU between [N, 4] and [M, 4] boxes."""
    x1 = T.unsqueeze(x, [1])  # [N,1,4]
    y1 = T.unsqueeze(y, [0])  # [1,M,4]
    ixmin = T.maximum(x1[..., 0], y1[..., 0])
    iymin = T.maximum(x1[..., 1], y1[..., 1])
    ixmax = T.minimum(x1[..., 2], y1[..., 2])
    iymax = T.minimum(x1[..., 3], y1[..., 3])
    off = 0.0 if box_normalized else 1.0
    iw = T.clip(ixmax - ixmin + off, 0.0, 1e10)
    ih = T.clip(iymax - iymin + off, 0.0, 1e10)
    inter = iw * ih
    ax = ((x1[..., 2] - x1[..., 0] + off) * (x1[..., 3] - x1[..., 1] + off))
    ay = ((y1[..., 2] - y1[..., 0] + off) * (y1[..., 3] - y1[..., 1] + off))
    return inter / (ax + ay - inter + 1e-10)


class Assert:
    """``fluid.layers.Assert(cond)``: a check of a concrete value (every
    element true); a static Variable raises through its truthiness
    guard."""

    def __new__(cls, cond, data=None, summarize=20, name=None):
        import numpy as np

        arr = (np.asarray(cond.numpy()) if hasattr(cond, "numpy")
               else np.asarray(cond))
        if not bool(np.all(arr)):
            raise AssertionError(
                f"fluid.layers.Assert failed (cond={arr.reshape(-1)[:summarize]})"
                + (f"; data={data}" if data is not None else ""))
        return cond


_PS_ERA_2 = {
    "MultivariateNormalDiag": ("moved in 2.x", "paddle.distribution"),
    "BasicDecoder": ("the legacy seq2seq decoder kit",
                     "paddle.nn.BeamSearchDecoder + dynamic_decode"),
    "Decoder": ("the legacy seq2seq decoder kit",
                "paddle.nn.BeamSearchDecoder + dynamic_decode"),
    "DecodeHelper": ("the legacy seq2seq helper kit",
                     "models.generation greedy/beam utilities"),
    "TrainingHelper": ("the legacy seq2seq helper kit",
                       "teacher forcing via plain layer calls"),
    "GreedyEmbeddingHelper": ("the legacy seq2seq helper kit",
                              "models.generation greedy decode"),
    "SampleEmbeddingHelper": ("the legacy seq2seq helper kit",
                              "models.generation sampling decode"),
    "anchor_generator": ("a detection-era op", "vision.ops.prior_box"),
    "density_prior_box": ("a detection-era op", "vision.ops.prior_box"),
    "detection_output": ("a detection-era op",
                         "vision.ops.multiclass_nms over decoded boxes"),
    "matrix_nms": ("pending", "vision.ops.multiclass_nms"),
    "locality_aware_nms": ("a niche OCR op", "vision.ops.multiclass_nms"),
    "collect_fpn_proposals": ("a detection-era op",
                              "vision.ops.distribute_fpn_proposals"),
    "box_decoder_and_assign": ("a detection-era op", "vision.ops.box_coder"),
    "polygon_box_transform": ("a niche OCR op", "explicit tensor ops"),
    "roi_perspective_transform": ("a niche OCR op", "vision.ops.roi_align"),
    "retinanet_detection_output": ("a detection-era op",
                                   "vision.ops.multiclass_nms"),
    "retinanet_target_assign": ("a detection-era op",
                                "python-side target assignment"),
    "rpn_target_assign": ("a detection-era op",
                          "python-side target assignment"),
    "generate_mask_labels": ("a detection-era op",
                             "python-side target assignment"),
    "generate_proposal_labels": ("a detection-era op",
                                 "python-side target assignment"),
    "ssd_loss": ("a detection-era composite", "explicit loss composition "
                 "over vision.ops.iou/box utilities"),
    "target_assign": ("a detection-era op",
                      "python-side target assignment"),
    "center_loss": ("a stateful-centers op",
                    "an explicit centers buffer + mse update"),
    "sampled_softmax_with_cross_entropy": (
        "a sampling-softmax op", "full softmax_with_cross_entropy"),
    "teacher_student_sigmoid_loss": ("a PS CTR loss",
                                     "explicit sigmoid-loss composition"),
    "edit_distance": ("a host-side metric", "python/numpy edit distance "
                      "over decoded sequences"),
    "create_py_reader_by_data": ("the legacy queue-feed reader",
                                 "paddle.io.DataLoader"),
    "reorder_lod_tensor_by_rank": ("a LoD-runtime op",
                                   "the padded+mask sequence design"),
    "autodoc": ("an internal doc decorator", "nothing — decorate directly"),
    "templatedoc": ("an internal doc decorator",
                    "nothing — decorate directly"),
    "generate_activation_fn": ("an internal codegen helper",
                               "paddle.nn.functional activations"),
    "generate_inplace_fn": ("an internal codegen helper",
                            "paddle tensor in-place methods"),
    "generate_layer_fn": ("an internal codegen helper",
                          "the public layer builders"),
}

for _n, (_why, _instead) in _PS_ERA_2.items():
    if globals().get(_n) is None:
        globals()[_n] = _unsupported(_n, _why, _instead)

"""``paddle.static.nn``: static-graph layer builders and control flow.

Counterpart of ``paddle_tpu/static/nn/__init__.py``, builder for builder.
Each call appends ops to the current main program and makes its
parameters in the startup program, as ``LayerHelper`` does; calling a
builder again with the same ``name`` shares its parameters (the layer is
kept on the main program).  ``py_func`` runs a host Python function as an
op (the executor runs ops one by one, so a callback costs one device to
host copy of its inputs).

The ``sequence_*`` builders append the sequence ops
(:mod:`paddle_tpu_torch.ops.sequence_ops`) over a padded batch and its
lengths.  ``multi_box_head`` and ``deform_conv2d`` build on
:mod:`paddle_tpu_torch.vision.ops` (``prior_box``, ``deform_conv2d``).
"""

from __future__ import annotations

import numpy as np
import torch

from ...framework import program as fw
from ..control_flow import cond, while_loop  # noqa: F401

__all__ = [
    "fc", "batch_norm", "embedding", "sparse_embedding",
    "bilinear_tensor_product", "case", "cond", "conv2d", "conv2d_transpose",
    "conv3d", "conv3d_transpose", "crf_decoding", "data_norm",
    "deform_conv2d", "group_norm", "instance_norm", "layer_norm",
    "multi_box_head", "nce", "prelu", "py_func", "row_conv",
    "spectral_norm", "switch_case", "while_loop", "create_parameter",
    "sequence_conv", "sequence_softmax", "sequence_pool",
    "sequence_concat", "sequence_first_step", "sequence_last_step",
    "sequence_slice", "sequence_expand", "sequence_expand_as",
    "sequence_pad", "sequence_unpad", "sequence_reshape",
    "sequence_scatter", "sequence_enumerate", "sequence_reverse",
]


def _waits(name, item, what):
    raise NotImplementedError(
        f"paddle.static.nn.{name} needs {what}, which the port gains with "
        f"ROADMAP {item}")


# ---------------------------------------------------------------------------
# name-based layer reuse (LayerHelper's param_attr semantics)
# ---------------------------------------------------------------------------


def _reuse(kind: str, name, make):
    """Build (or fetch) a layer keyed by ``(kind, name)`` on the current
    main program, so ``name=...`` shares parameters across calls."""
    prog = fw.default_main_program()
    cache = getattr(prog, "_builder_layers", None)
    if cache is None:
        cache = prog._builder_layers = {}
    if name is None:
        return make()
    key = (kind, name)
    layer = cache.get(key)
    if layer is None:
        layer = cache[key] = make()
    return layer


def _act(out, activation):
    if activation:
        from ...nn import functional as F

        out = getattr(F, activation)(out)
    return out


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    from .. import create_parameter as _cp

    return _cp(shape, dtype=dtype, name=name, attr=attr, is_bias=is_bias,
               default_initializer=default_initializer)


# ---------------------------------------------------------------------------
# dense / conv / norm builders
# ---------------------------------------------------------------------------


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """``paddle.static.nn.fc``: y = act(x W + b), params reused by name."""
    from ... import nn as _nn

    in_dim = int(np.prod(x.shape[num_flatten_dims:]))

    layer = _reuse("fc", name, lambda: _nn.Linear(
        in_dim, size, weight_attr=weight_attr, bias_attr=bias_attr))
    if num_flatten_dims != 1 or len(x.shape) > 2:
        from ... import tensor_api as T

        lead = list(x.shape[:num_flatten_dims])
        x = T.reshape(x, lead + [in_dim])
    return _act(layer(x), activation)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None,
           data_format="NCHW"):
    from ... import nn as _nn

    in_ch = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    layer = _reuse("conv2d", name, lambda: _nn.Conv2D(
        int(in_ch), num_filters, filter_size, stride=stride, padding=padding,
        dilation=dilation, groups=groups, weight_attr=param_attr,
        bias_attr=bias_attr))
    return _act(layer(input), act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None,
                     data_format="NCHW"):
    from ... import nn as _nn

    if filter_size is None:
        raise ValueError("conv2d_transpose requires filter_size (deriving "
                         "it from output_size is not supported)")
    in_ch = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    layer = _reuse("conv2d_transpose", name, lambda: _nn.Conv2DTranspose(
        int(in_ch), num_filters, filter_size, stride=stride, padding=padding,
        dilation=dilation, groups=groups, weight_attr=param_attr,
        bias_attr=bias_attr))
    out = (layer(input, output_size=output_size) if output_size is not None
           else layer(input))
    return _act(out, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None,
           data_format="NCDHW"):
    from ... import nn as _nn

    in_ch = input.shape[1] if data_format == "NCDHW" else input.shape[-1]
    layer = _reuse("conv3d", name, lambda: _nn.Conv3D(
        int(in_ch), num_filters, filter_size, stride=stride, padding=padding,
        dilation=dilation, groups=groups, weight_attr=param_attr,
        bias_attr=bias_attr))
    return _act(layer(input), act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None,
                     data_format="NCDHW"):
    from ... import nn as _nn

    if filter_size is None:
        raise ValueError("conv3d_transpose requires filter_size")
    in_ch = input.shape[1] if data_format == "NCDHW" else input.shape[-1]
    layer = _reuse("conv3d_transpose", name, lambda: _nn.Conv3DTranspose(
        int(in_ch), num_filters, filter_size, stride=stride, padding=padding,
        dilation=dilation, groups=groups, weight_attr=param_attr,
        bias_attr=bias_attr))
    return _act(layer(input), act)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-05,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=True, use_global_stats=False):
    from ... import nn as _nn

    ch = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    layer = _reuse("batch_norm", name, lambda: _nn.BatchNorm(
        int(ch), momentum=momentum, epsilon=epsilon, param_attr=param_attr,
        bias_attr=bias_attr, use_global_stats=use_global_stats))
    if is_test or use_global_stats:
        layer.eval()
    return _act(layer(input), act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-05, param_attr=None, bias_attr=None, act=None,
               name=None):
    from ... import nn as _nn

    shape = [int(s) for s in input.shape[begin_norm_axis:]]
    layer = _reuse("layer_norm", name, lambda: _nn.LayerNorm(
        shape, epsilon=epsilon,
        weight_attr=(param_attr if scale else False),
        bias_attr=(bias_attr if shift else False)))
    return _act(layer(input), act)


def group_norm(input, groups, epsilon=1e-05, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    from ... import nn as _nn

    ch = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    layer = _reuse("group_norm", name, lambda: _nn.GroupNorm(
        groups, int(ch), epsilon=epsilon, weight_attr=param_attr,
        bias_attr=bias_attr))
    return _act(layer(input), act)


def instance_norm(input, epsilon=1e-05, param_attr=None, bias_attr=None,
                  name=None):
    from ... import nn as _nn

    ch = int(input.shape[1])
    dim = len(input.shape)
    cls = {3: _nn.InstanceNorm1D, 4: _nn.InstanceNorm2D,
           5: _nn.InstanceNorm3D}.get(dim)
    if cls is None:
        raise ValueError(f"instance_norm expects 3/4/5-D input, got {dim}-D")
    layer = _reuse("instance_norm", name, lambda: cls(
        ch, epsilon=epsilon, weight_attr=param_attr, bias_attr=bias_attr))
    return layer(input)


def data_norm(input, act=None, epsilon=1e-05, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              is_test=False, enable_scale_and_shift=False):
    """Normalize by accumulated batch statistics, ``(x - sum / size) *
    sqrt(size / square_sum)``, over the accumulator triple (batch_size,
    batch_sum, batch_square_sum): persistable, not trainable, and
    updated by the op's grad op in training (so a program without a
    backward never moves them)."""
    from ...framework import unique_name
    from ...ops.dispatch import dispatch, dispatch_static

    ch = int(input.shape[-1] if data_layout == "NHWC" else input.shape[1])
    base = name or unique_name.generate("data_norm")
    attrs = {"epsilon": float(epsilon),
             "summary_decay_rate": float(summary_decay_rate),
             "is_test": bool(is_test)}
    if fw.in_dygraph_mode():
        from ...dygraph.tensor import Tensor

        stats = [Tensor(np.full((ch,), v, "float32"), stop_gradient=True)
                 for v in (1e4, 0.0, 1e4)]
        outs = dispatch("data_norm", {
            "X": [input], "BatchSize": [stats[0]], "BatchSum": [stats[1]],
            "BatchSquareSum": [stats[2]]}, attrs)
        return _act(outs["Y"][0], act)

    blk = fw.default_main_program().global_block()
    sb = fw.default_startup_program().global_block()
    stat_vars = []
    for suffix, init in (("batch_size", 1e4), ("batch_sum", 0.0),
                         ("batch_square_sum", 1e4)):
        v = blk.create_var(name=f"{base}.{suffix}", shape=(ch,),
                           dtype="float32", persistable=True,
                           stop_gradient=True)
        sb.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                      persistable=True)
        sb.append_op(type="fill_constant", inputs={},
                     outputs={"Out": [v.name]},
                     attrs={"shape": [ch], "value": init,
                            "dtype": "float32"})
        stat_vars.append(v)
    y = blk.create_var(name=unique_name.generate(f"{base}.out"))
    outs = dispatch_static(
        "data_norm",
        {"X": [input], "BatchSize": [stat_vars[0]],
         "BatchSum": [stat_vars[1]], "BatchSquareSum": [stat_vars[2]]},
        attrs,
        outputs={"Y": [y], "BatchSizeOut": [stat_vars[0]],
                 "BatchSumOut": [stat_vars[1]],
                 "BatchSquareSumOut": [stat_vars[2]]},
    )
    return _act(outs["Y"][0], act)


def _const_init(v):
    from ...nn.initializer import Constant

    return Constant(v)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    from ... import nn as _nn

    layer = _reuse("spectral_norm", name, lambda: _nn.SpectralNorm(
        [int(v) for v in weight.shape], dim=dim, power_iters=power_iters,
        eps=eps))
    return layer(weight)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    from ... import nn as _nn

    name = getattr(param_attr, "name", None) if param_attr is not None \
        else None
    layer = _reuse("embedding", name, lambda: _nn.Embedding(
        int(size[0]), int(size[1]), padding_idx=padding_idx,
        weight_attr=param_attr))
    return layer(input)


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, table_class="CommonSparseTable",
                     param_attr=None, dtype="float32", slot=None):
    """A dense embedding (the parameter-server sparse table is out of
    scope)."""
    return embedding(input, size, padding_idx=padding_idx,
                     param_attr=param_attr, dtype=dtype)


def prelu(x, mode, param_attr=None, data_format="NCHW", name=None):
    from ...nn import functional as F
    from .. import create_parameter as _cp
    from ...framework import unique_name

    if mode == "all":
        shape = [1]
    elif mode == "channel":
        ch = x.shape[1] if data_format == "NCHW" else x.shape[-1]
        shape = [int(ch)]
    elif mode == "element":
        shape = [int(s) for s in x.shape[1:]]
    else:
        raise ValueError(f"prelu mode must be all/channel/element, got {mode}")
    pname = (getattr(param_attr, "name", None)
             or (name and f"{name}.w") or unique_name.generate("prelu_alpha"))
    alpha = _cp(shape, dtype=str(x.dtype), name=pname,
                default_initializer=_const_init(0.25))
    if mode == "channel":
        from ... import tensor_api as T

        nd = len(x.shape)
        bshape = ([1, shape[0]] + [1] * (nd - 2) if data_format == "NCHW"
                  else [1] * (nd - 1) + [shape[0]])
        alpha = T.reshape(alpha, bshape)
    return F.prelu(x, alpha, data_format=data_format)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    from ... import nn as _nn

    layer = _reuse("bilinear", name, lambda: _nn.Bilinear(
        int(x.shape[-1]), int(y.shape[-1]), size, weight_attr=param_attr,
        bias_attr=bias_attr))
    return _act(layer(x, y), act)


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead convolution: out[b, t] = sum_{k=0..K} w[k] * x[b, t+k]
    (zero beyond T)."""
    from ... import tensor_api as T
    from .. import create_parameter as _cp
    from ...framework import unique_name

    d = int(input.shape[-1])
    k = int(future_context_size) + 1
    pname = (getattr(param_attr, "name", None)
             or unique_name.generate("row_conv_w"))
    w = _cp([k, d], dtype=str(input.dtype), name=pname)
    outs = []
    t_dim = int(input.shape[1])
    for j in range(k):
        if j:
            tail = T.slice(input, axes=[1], starts=[j], ends=[t_dim])
            shifted = T.concat(
                [tail, T.zeros([int(input.shape[0]), j, d],
                               dtype=str(input.dtype))], axis=1)
        else:
            shifted = input
        wj = T.reshape(T.slice(w, axes=[0], starts=[j], ends=[j + 1]), [d])
        outs.append(shifted * wj)
    out = outs[0]
    for o in outs[1:]:
        out = out + o
    return _act(out, act)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=5, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss: negatives drawn uniformly by a
    ``randint`` op, loss = -log sig(s_pos) - sum log sig(-s_neg)."""
    from ... import tensor_api as T
    from ...nn import functional as F
    from .. import create_parameter as _cp
    from ...framework import unique_name

    d = int(input.shape[-1])
    base = name or unique_name.generate("nce")
    w = _cp([num_total_classes, d], dtype=str(input.dtype),
            name=(getattr(param_attr, "name", None) or f"{base}.w"))
    b = _cp([num_total_classes], dtype=str(input.dtype),
            name=(getattr(bias_attr, "name", None) or f"{base}.b"),
            is_bias=True)
    bsz = int(input.shape[0])
    neg = T.randint(0, num_total_classes, [bsz, num_neg_samples],
                    dtype="int64")
    lab = T.reshape(label, [bsz, 1]).astype("int64")
    pos_w = T.gather(w, T.reshape(lab, [-1]))          # [B, D]
    pos_b = T.gather(b, T.reshape(lab, [-1]))          # [B]
    s_pos = T.sum(input * pos_w, axis=-1) + pos_b      # [B]
    neg_w = T.gather(w, T.reshape(neg, [-1]))          # [B*N, D]
    neg_w = T.reshape(neg_w, [bsz, num_neg_samples, d])
    neg_b = T.reshape(T.gather(b, T.reshape(neg, [-1])),
                      [bsz, num_neg_samples])
    s_neg = T.sum(T.unsqueeze(input, 1) * neg_w, axis=-1) + neg_b
    loss = -F.log_sigmoid(s_pos) - T.sum(F.log_sigmoid(-s_neg), axis=-1)
    return T.reshape(loss, [bsz, 1])


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode over linear-chain CRF emissions: ``input`` [B, T, N],
    the transition parameter [N+2, N] (row 0 start, row 1 stop, rows 2..
    transitions).  With ``label``, the 0/1 mask of tags equal to it."""
    from ...dygraph import tracer
    from .. import create_parameter as _cp

    name = getattr(param_attr, "name", None)
    n = int(input.shape[-1])
    trans = _cp([n + 2, n], dtype=str(input.dtype), name=name or "crfw")
    has_label = label is not None
    has_length = length is not None

    def decode(emis, tr, ln):
        start, stop, trn = tr[0], tr[1], tr[2:]
        b, t, _ = emis.shape
        alpha = start[None, :] + emis[:, 0]                    # [B, N]
        alphas, backs = [alpha], []
        for k in range(1, t):
            sc = alpha[:, :, None] + trn[None] + emis[:, k, None, :]
            alpha, arg = torch.max(sc, dim=1)
            alphas.append(alpha)
            backs.append(arg)
        lens = (ln.reshape(-1).long() if ln is not None
                else torch.full((b,), t, dtype=torch.long,
                                device=emis.device))
        all_alpha = torch.stack(alphas, dim=1)                 # [B, T, N]
        idx = lens - 1
        final = all_alpha[torch.arange(b, device=emis.device), idx] + stop
        tag = torch.argmax(final, dim=-1)
        tags = [tag]
        for k in range(t - 2, -1, -1):
            prev = torch.gather(backs[k], 1, tag[:, None])[:, 0]
            tag = torch.where(k + 1 <= idx, prev, tag)
            tags.append(tag)
        path = torch.stack(tags[::-1], dim=1)
        pos = torch.arange(t, device=emis.device)[None, :]
        return torch.where(pos < lens[:, None], path, torch.zeros_like(path))

    def run(emis, tr, *rest):
        rest = list(rest)
        lbl = rest.pop(0) if has_label else None
        ln = rest.pop(0) if has_length else None
        path = decode(emis, tr, ln)
        if lbl is None:
            return path
        ok = path == lbl.reshape(path.shape).to(path.dtype)
        if ln is not None:
            pos = torch.arange(path.shape[1], device=path.device)[None, :]
            ok = ok & (pos < ln.reshape(-1).long()[:, None])
        return ok.long()

    args = ([input, trans] + ([label] if has_label else [])
            + ([length] if has_length else []))
    return tracer.trace_fn(run, args, name="crf_decoding")


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD's detection head: each feature map's prior boxes
    (``vision.ops.prior_box``) and its location / confidence convs;
    returns (locs [B, priors, 4], confs [B, priors, classes], boxes
    [priors, 4], variances [priors, 4])."""
    from ... import tensor_api as T
    from ...vision import ops as vops

    if min_sizes is None:
        # SSD's sizes: ratios evenly spaced over the feature maps
        num_layer = len(inputs)
        min_sizes, max_sizes = [], []
        step = int(np.floor((max_ratio - min_ratio) / (num_layer - 2)))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes

    locs, confs, boxes, vars_ = [], [], [], []
    for i, x in enumerate(inputs):
        ms = min_sizes[i]
        mx = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i]
        box, var = vops.prior_box(
            x, image, min_sizes=[ms] if np.isscalar(ms) else ms,
            max_sizes=([mx] if mx is not None and np.isscalar(mx) else mx),
            aspect_ratios=[ar] if np.isscalar(ar) else ar, flip=flip,
            clip=clip, steps=[steps[i], steps[i]] if steps else [0.0, 0.0],
            offset=offset, variance=list(variance))
        nbox = int(np.prod(box.shape[:-1]))
        num_px = nbox // (int(x.shape[2]) * int(x.shape[3]))
        loc = conv2d(x, num_px * 4, kernel_size, padding=pad, stride=stride,
                     name=(name and f"{name}.loc{i}"))
        conf = conv2d(x, num_px * num_classes, kernel_size, padding=pad,
                      stride=stride, name=(name and f"{name}.conf{i}"))
        # NCHW -> [B, prior, 4/classes]
        loc = T.reshape(T.transpose(loc, [0, 2, 3, 1]), [0, nbox, 4])
        conf = T.reshape(T.transpose(conf, [0, 2, 3, 1]),
                         [0, nbox, num_classes])
        locs.append(loc)
        confs.append(conf)
        boxes.append(T.reshape(box, [-1, 4]))
        vars_.append(T.reshape(var, [-1, 4]))
    mbox_locs = T.concat(locs, axis=1)
    mbox_confs = T.concat(confs, axis=1)
    all_boxes = T.concat(boxes, axis=0)
    all_vars = T.concat(vars_, axis=0)
    return mbox_locs, mbox_confs, all_boxes, all_vars


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None, name=None):
    """Deformable convolution (v2 with ``mask``, v1 without): the filter
    and bias parameters, then ``vision.ops.deform_conv2d``."""
    from ...vision import ops as vops
    from .. import create_parameter as _cp
    from ...framework import unique_name

    kh, kw = ((int(filter_size),) * 2 if np.isscalar(filter_size)
              else (int(filter_size[0]), int(filter_size[1])))
    cin = int(x.shape[1])
    base = name or unique_name.generate("deform_conv")
    w = _cp([num_filters, cin // groups, kh, kw], dtype=str(x.dtype),
            name=(getattr(param_attr, "name", None) or f"{base}.w"))
    b = _cp([num_filters], dtype=str(x.dtype),
            name=(getattr(bias_attr, "name", None) or f"{base}.b"),
            is_bias=True) if bias_attr is not False else None
    return vops.deform_conv2d(
        x, offset, w, bias=b, stride=stride, padding=padding,
        dilation=dilation, deformable_groups=deformable_groups,
        groups=groups, mask=mask)


class _PyFunc(torch.autograd.Function):
    """A host function as an op: the inputs go to the host as numpy, the
    results come back to the inputs' device; ``backward_func(*inputs,
    *outputs, *output grads)`` gives the input gradients."""

    @staticmethod
    def forward(ctx, spec, *xs):
        func, out_specs = spec["func"], spec["out_specs"]
        dev = xs[0].device if xs else torch.device("cpu")
        res = func(*[x.detach().cpu().numpy() for x in xs])
        res = res if isinstance(res, (list, tuple)) else [res]
        outs = tuple(torch.as_tensor(np.asarray(r).astype(d), device=dev)
                     for r, (_, d) in zip(res, out_specs))
        ctx.spec = spec
        ctx.save_for_backward(*xs, *outs)
        return outs

    @staticmethod
    def backward(ctx, *gys):
        spec = ctx.spec
        saved = ctx.saved_tensors
        n = len(saved) - len(gys)
        xs, ys = saved[:n], saved[n:]
        host = [t.detach().cpu().numpy() for t in (*xs, *ys, *gys)]
        gx = spec["backward_func"](*host)
        gx = gx if isinstance(gx, (list, tuple)) else [gx]
        return (None, *[torch.as_tensor(np.asarray(g), device=x.device)
                        .to(x.dtype) for g, x in zip(gx, xs)])


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """A host Python callable as an op.  Its results are bound to the
    caller's ``out`` variables (and returned); ``backward_func(*x, *out,
    *out_grads)`` gives the gradients when passed."""
    from ...dygraph import tracer

    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    out_specs = [(tuple(o.shape), str(o.dtype)) for o in outs]
    spec = {"func": func, "out_specs": out_specs,
            "backward_func": backward_func}

    def run(*ts):
        if backward_func is None:
            with torch.no_grad():
                res = _PyFunc.apply(spec, *ts)
        else:
            res = _PyFunc.apply(spec, *ts)
        return tuple(res) if len(out_specs) > 1 else res[0]

    got = tracer.trace_fn(run, xs, name="py_func")
    got_list = list(got) if isinstance(got, (list, tuple)) else [got]
    if fw.in_dygraph_mode():
        for o, g in zip(outs, got_list):
            o._t = g._t
    else:
        blk = fw.default_main_program().current_block()
        for o, g in zip(outs, got_list):
            blk.append_op(type="assign", inputs={"X": [g.name]},
                          outputs={"Out": [o.name]}, attrs={})
    return out if isinstance(out, (list, tuple)) else outs[0]


# ---------------------------------------------------------------------------
# control-flow builders
# ---------------------------------------------------------------------------


def case(pred_fn_pairs, default=None, name=None):
    """The first true predicate's function (a chain of ``cond``)."""
    if not pred_fn_pairs:
        raise ValueError("case needs at least one (pred, fn) pair")
    (pred, fn), rest = pred_fn_pairs[0], pred_fn_pairs[1:]
    if not rest:
        return cond(pred, fn, default if default is not None else fn)
    return cond(pred, fn, lambda: case(rest, default))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch of the integer ``branch_index``."""
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    else:
        items = list(enumerate(branch_fns))
    pairs = [(branch_index == idx, fn) for idx, fn in items]
    return case(pairs, default=default if default is not None
                else items[-1][1])


# ---------------------------------------------------------------------------
# the sequence family (ops/sequence_ops.py: a padded batch and its lengths)
# ---------------------------------------------------------------------------


def _seq(op_type, ins, attrs=None, n_out=1):
    """The op's Out, or (Out, Length) for ``n_out=2``."""
    from ...ops.dispatch import dispatch

    out = dispatch(op_type, ins, attrs or {})

    def first(v):
        return v[0] if isinstance(v, list) else v

    if n_out == 1:
        return first(out["Out"])
    return first(out["Out"]), first(out["Length"])


def _with_length(ins, length):
    if length is not None:
        ins["Length"] = [length]
    return ins


def sequence_pad(x, pad_value=0.0, maxlen=None, length=None, name=None):
    """``(out, length)``: ``pad_value`` past each row's length."""
    return _seq("sequence_pad", _with_length({"X": [x]}, length),
                {"pad_value": float(pad_value), "maxlen": maxlen or 0},
                n_out=2)


def sequence_unpad(x, length, name=None):
    return _seq("sequence_unpad", {"X": [x], "Length": [length]})


def sequence_softmax(input, length=None, use_cudnn=False, name=None):
    return _seq("sequence_softmax", _with_length({"X": [input]}, length))


def sequence_pool(input, pool_type, length=None, is_test=False,
                  pad_value=0.0):
    return _seq("sequence_pool", _with_length({"X": [input]}, length),
                {"pooltype": str(pool_type).upper()})


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length=length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length=length)


def sequence_reverse(x, length=None, name=None):
    return _seq("sequence_reverse", _with_length({"X": [x]}, length))


def sequence_slice(input, offset, length, name=None):
    return _seq("sequence_slice",
                {"X": [input], "Offset": [offset], "SliceLength": [length]},
                n_out=2)[0]


def sequence_reshape(input, new_dim, length=None):
    return _seq("sequence_reshape", _with_length({"X": [input]}, length),
                {"new_dim": int(new_dim)})


def sequence_concat(input, lengths=None, name=None):
    ins = {"X": list(input)}
    if lengths is not None:
        ins["Length"] = list(lengths)
    return _seq("sequence_concat", ins, n_out=2)[0]


def sequence_expand(x, y_length, maxlen=None, ref_level=-1, name=None):
    """Each row of ``x`` over the first ``y_length[i]`` steps of a new
    time axis (the dense form of repeating it)."""
    return sequence_expand_as(x, y_length, maxlen=maxlen, name=name)


def sequence_expand_as(x, y_length, maxlen=None, name=None):
    if maxlen is None:
        raise ValueError(
            "sequence_expand_as needs an explicit maxlen (the time axis's "
            "static size)")
    return _seq("sequence_expand_as", {"X": [x], "Length": [y_length]},
                {"maxlen": int(maxlen)}, n_out=2)[0]


def sequence_enumerate(input, win_size, pad_value=0, length=None, name=None):
    return _seq("sequence_enumerate", _with_length({"X": [input]}, length),
                {"win_size": int(win_size), "pad_value": pad_value})


def sequence_scatter(input, index, updates, length=None, name=None):
    return _seq("sequence_scatter", _with_length(
        {"X": [input], "Ids": [index], "Updates": [updates]}, length))


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None, length=None):
    """The context-window convolution: a Filter [filter_size * D,
    num_filters] (and a bias), the window starting ``padding_start`` steps
    back (default -(filter_size - 1) // 2)."""
    from .. import create_parameter as _cp
    from ...framework import unique_name

    d = int(input.shape[-1])
    pname = (getattr(param_attr, "name", None)
             or (name and f"{name}.w") or unique_name.generate("seq_conv_w"))
    w = _cp([int(filter_size) * d, num_filters], dtype=str(input.dtype),
            name=pname)
    start = (padding_start if padding_start is not None
             else -((int(filter_size) - 1) // 2))
    out = _seq("sequence_conv",
               _with_length({"X": [input], "Filter": [w]}, length),
               {"contextLength": int(filter_size), "contextStart": int(start),
                "contextStride": int(filter_stride)})
    if bias_attr is not False:
        bname = (getattr(bias_attr, "name", None)
                 or (name and f"{name}.b")
                 or unique_name.generate("seq_conv_b"))
        b = _cp([num_filters], dtype=str(input.dtype), name=bname,
                is_bias=True)
        out = out + b
        if length is not None:
            # the pad must stay 0 after the bias add
            out = sequence_unpad(out, length)
    return _act(out, act)

"""Static-graph automatic mixed precision: bf16 casts written into the
program.

Counterpart of ``paddle_tpu/static/amp.py``: ``rewrite_program`` walks
the global block and casts the float inputs of white-list ops (matmul,
conv) to bf16 and the bf16 inputs of black-list ops (softmax, norms,
losses, reductions) back to fp32; gray ops run in the dtype that reaches
them.  The attention op is on the white list, so it runs the bf16 flash
kernels.
Parameters stay fp32 in the scope: the casts run per use, the
gradients of the casts are casts back, and the optimizer updates the
fp32 weights.  bf16 has fp32's exponent range, so no loss scaling is
needed; ``decorate`` keeps the arguments for scripts that pass them.
"""

from __future__ import annotations

from typing import Optional, Set

from ..framework import program as fw

__all__ = [
    "AutoMixedPrecisionLists",
    "rewrite_program",
    "cast_model_to_bf16",
    "decorate",
    "bf16_guard",
]


class AutoMixedPrecisionLists:
    """The three-way op split: white ops run in bf16 (safe, and fast on
    tensor cores), black ops in fp32 (numerically sensitive), gray ops
    follow their inputs."""

    # the reference's white list and the attention op (which the eager
    # amp lists carry too): its bf16 q, k and v run the bf16 flash kernels
    _DEFAULT_WHITE = {
        "matmul", "matmul_v2", "mul", "conv2d", "depthwise_conv2d",
        "conv2d_transpose", "addmm", "scaled_dot_product_attention",
    }
    _DEFAULT_BLACK = {
        "softmax_with_cross_entropy", "cross_entropy",
        "sigmoid_cross_entropy_with_logits", "bce_loss", "c_softmax_with_cross_entropy",
        "mean", "reduce_mean", "reduce_sum", "sum",
        "exp", "log", "log2", "log10", "log1p", "rsqrt", "pow",
        "square", "squared_l2_norm", "p_norm", "norm", "cumsum",
        "softmax", "log_softmax", "layer_norm", "batch_norm",
        "group_norm", "instance_norm",
    }

    def __init__(self, custom_white_list: Optional[Set[str]] = None,
                 custom_black_list: Optional[Set[str]] = None,
                 custom_black_varnames: Optional[Set[str]] = None):
        self.white_list = set(self._DEFAULT_WHITE)
        self.black_list = set(self._DEFAULT_BLACK)
        self.black_varnames = set(custom_black_varnames or ())
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)


_FLOAT_DTYPES = {"float32", "float64"}


def _is_float_var(block, name):
    try:
        var = block._var_recursive(name)
    except Exception:
        return False
    return str(getattr(var, "dtype", "")) in _FLOAT_DTYPES | {"bfloat16",
                                                              "float16"}


def _insert_cast(block, new_ops, cache, name, dest, src_dtype):
    """Append a cast op producing ``name.cast_<dest>`` (memoized)."""
    key = (name, dest)
    if key in cache:
        return cache[key]
    out = f"{name}.cast_{dest}"
    if out not in block.vars:
        src = block._var_recursive(name)
        block.create_var(name=out, shape=getattr(src, "shape", None),
                         dtype=dest)
    op = fw.Operator(block, "cast", inputs={"X": [name]},
                     outputs={"Out": [out]},
                     attrs={"in_dtype": src_dtype, "out_dtype": dest})
    new_ops.append(op)
    cache[key] = out
    return out


def rewrite_program(main_program, amp_lists: Optional[AutoMixedPrecisionLists]
                    = None, dest_dtype: str = "bfloat16"):
    """Walk the global block: cast the float inputs of white-list ops to
    ``dest_dtype`` and the maybe-low inputs of black-list ops back to
    fp32; gray ops run in whatever dtype reaches them.

    Two sets track the dtypes: ``known_low``, the outputs of white ops
    and of gray ops whose float inputs are all known low (bf16 in, bf16
    out), which a white op reads without a cast; and ``maybe_low``, those
    plus the outputs of gray ops with any maybe-low input, which a black
    op casts back.  A gray op over bf16 and fp32 inputs (a bias added to
    a matmul's output) promotes to fp32, so its output is only maybe
    low, and the next white op casts it: the program then computes what
    ``amp.auto_cast`` (O1) computes eagerly.  (The reference counts such
    an output as low: its next matmul then reads fp32 beside a bf16
    weight, which JAX promotes to an fp32 product.)"""
    amp_lists = amp_lists or AutoMixedPrecisionLists()
    block = main_program.global_block()
    new_ops = []
    cache = {}
    known_low, maybe_low = set(), set()
    for op in list(block.ops):
        if op.type in ("cast", "feed", "fetch"):
            new_ops.append(op)
            continue
        if op.type in amp_lists.white_list and not (
                amp_lists.black_varnames
                and any(n in amp_lists.black_varnames
                        for ns in op.outputs.values() for n in ns)):
            for slot, names in op.inputs.items():
                for i, n in enumerate(names):
                    if not _is_float_var(block, n) or n in known_low:
                        continue
                    names[i] = _insert_cast(block, new_ops, cache, n,
                                            dest_dtype, "float32")
            new_ops.append(op)
            for ns in op.outputs.values():
                known_low.update(ns)
                maybe_low.update(ns)
        elif op.type in amp_lists.black_list:
            for slot, names in op.inputs.items():
                for i, n in enumerate(names):
                    if n in maybe_low:
                        names[i] = _insert_cast(block, new_ops, cache, n,
                                                "float32", dest_dtype)
            new_ops.append(op)
        else:
            new_ops.append(op)
            ins = [n for ns in op.inputs.values() for n in ns]
            floats = [n for n in ins if _is_float_var(block, n)]
            outs = [n for ns in op.outputs.values() for n in ns]
            if floats and all(n in known_low for n in floats):
                known_low.update(outs)
            if any(n in maybe_low for n in ins):
                maybe_low.update(outs)
    block.ops = new_ops
    return main_program


def cast_model_to_bf16(program, amp_lists=None):
    """``cast_model_to_fp16``'s role, in bf16."""
    return rewrite_program(program, amp_lists, dest_dtype="bfloat16")


class _BF16GuardCtx:
    enabled = False


class bf16_guard:
    """A scope marker (``fp16_guard``'s role): every op is eligible for
    the rewrite, so the guard is accepted for API compatibility."""

    def __enter__(self):
        _BF16GuardCtx.enabled = True
        return self

    def __exit__(self, *exc):
        _BF16GuardCtx.enabled = False
        return False


class OptimizerWithMixedPrecision:
    """Wraps ``minimize``: rewrite the forward program to bf16, then
    append backward and update ops to the rewritten program (the
    gradients of casts are casts back, so parameter gradients and updates
    stay fp32: master weights)."""

    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False, dest_dtype="bfloat16"):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._dest_dtype = dest_dtype
        # bf16 needs no loss scaling (fp32 exponent range)
        self._loss_scaling = init_loss_scaling

    def get_loss_scaling(self):
        return self._loss_scaling

    def amp_init(self, place=None, scope=None, test_program=None,
                 use_bf16_test=False):
        if test_program is not None:
            rewrite_program(test_program, self._amp_lists, self._dest_dtype)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        program = loss.block.program
        rewrite_program(program, self._amp_lists, self._dest_dtype)
        return self._optimizer.minimize(
            loss, startup_program=startup_program, parameters=parameters,
            no_grad_set=no_grad_set)

    def backward(self, loss, **kw):
        rewrite_program(loss.block.program, self._amp_lists, self._dest_dtype)
        return self._optimizer.backward(loss, **kw)

    def __getattr__(self, name):
        return getattr(self._optimizer, name)


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=None, decr_every_n_nan_or_inf=None,
             incr_ratio=None, decr_ratio=None,
             use_dynamic_loss_scaling=False, use_pure_bf16=False,
             use_bf16_guard=None):
    """The optimizer wrapped for bf16 (see
    :class:`OptimizerWithMixedPrecision`)."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists=amp_lists,
        init_loss_scaling=init_loss_scaling,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling)

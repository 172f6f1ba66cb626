"""``paddle.jit``: ``to_static``, ``save`` / ``load`` and ``TracedLayer``.

Counterpart of ``paddle_tpu/jit/__init__.py``.  The conversion re-runs
the SAME layer and function code in static mode: every dispatch appends
an op instead of running it, so tracing is program capture.  Tensor
control flow (``if`` / ``while`` / ``for i in range(<Tensor>)``) goes
through :mod:`.dy2static`'s AST pass, which builds ``cond`` /
``while_loop`` ops; ``Layer.__call__`` converts a sub-layer's forward
under the same trace.

A :class:`StaticFunction` caches one Program per input signature and runs
it on the static Executor of the current place (the card, ``gpu:0``,
unless ``set_device("cpu")`` says otherwise), where the program's ops run
their kernels (the attention op launches the flash forward).  A Tensor
argument is fed as it lies on the device: it does not go through the
host.  The layer's parameters and buffers are bound into the function's
own scope by name when it traces, sharing their storage.

``save`` writes what ``static.save_inference_model`` writes (the program
as JSON and the persistables as ``.npz``, the reference's format), and
``load`` gives a :class:`TranslatedLayer` over the loaded program.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..dygraph.tensor import Tensor
from ..framework import program as fw
from ..framework import unique_name
from ..framework.scope import Scope
from ..static import io as static_io
from ..static.executor import Executor
from ..static.input import InputSpec
from . import dy2static

__all__ = ["to_static", "save", "load", "not_to_static", "TranslatedLayer",
           "InputSpec", "declarative", "ProgramTranslator", "TracedLayer",
           "set_verbosity", "set_code_level"]


class ProgramTranslator:
    """The switch of ``to_static`` conversion (a singleton): with
    ``enable(False)`` a :class:`StaticFunction` runs its function
    eagerly."""

    _instance = None

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self):
        self.enable_to_static = True

    def enable(self, enable_to_static: bool):
        type(self).get_instance().enable_to_static = bool(enable_to_static)


def _feed_value(a):
    """A feed as the executor takes it: a Tensor as its torch tensor (on
    its device, not through the host), a torch tensor as it is, anything
    else as numpy."""
    if isinstance(a, Tensor):
        return a._t
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


class StaticFunction:
    """A function (or a layer's forward) run as a traced static program,
    one per input signature (see the module docstring)."""

    def __init__(self, fn, input_spec: Optional[Sequence[InputSpec]] = None):
        self._fn = fn
        self._input_spec = list(input_spec) if input_spec else None
        self._cache = {}
        self._scope = Scope()
        self._exe = Executor()
        self.__wrapped__ = fn

    def _sig(self, args):
        from ..ops.registry import _freeze

        out = []
        for a in args:
            if isinstance(a, Tensor):
                out.append(("T", tuple(a.shape), a.dtype))
            elif isinstance(a, np.ndarray):
                out.append(("A", a.shape, str(a.dtype)))
            else:
                out.append(("P", _freeze(a)))
        return tuple(out)

    def _trace(self, args):
        """Build the Program by re-running the function in static mode."""
        from ..nn.layer_base import Layer

        main, startup = fw.Program(), fw.Program()
        feed_vars = []
        with fw.program_guard(main, startup), fw._dygraph_guard(False):
            sym_args = []
            for i, a in enumerate(args):
                if isinstance(a, (Tensor, np.ndarray)):
                    spec = (self._input_spec[i] if self._input_spec
                            and i < len(self._input_spec) else None)
                    shape = (tuple(spec.shape) if spec is not None
                             else tuple(a.shape))
                    name = (spec.name if spec is not None and spec.name
                            else unique_name.generate("jit_input"))
                    v = main.global_block().create_var(
                        name=name, shape=shape, dtype=str(a.dtype),
                        is_data=True)
                    feed_vars.append(v)
                    sym_args.append(v)
                else:
                    sym_args.append(a)
            owner = getattr(self._fn, "__self__", None)
            if isinstance(owner, Layer):
                self._bind_params(owner, main)
            # a method converts as its function (the conversion is cached
            # per code object, shared by every instance)
            func = getattr(self._fn, "__func__", self._fn)
            conv = dy2static.convert_func(func)
            if conv is func:
                out = self._fn(*sym_args)
            elif owner is not None:
                out = conv(owner, *sym_args)
            else:
                out = conv(*sym_args)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return (main, startup, [v.name for v in feed_vars],
                [o.name for o in outs], isinstance(out, (list, tuple)))

    def _bind_params(self, layer, main):
        """The layer's parameters and buffers as persistable variables of
        the program, their tensors in the scope (shared, not copied)."""
        blk = main.global_block()
        for _, p in layer.named_parameters():
            blk.create_parameter(shape=p.shape, dtype=p.dtype, name=p.name)
            self._scope.set(p.name, p._t.detach())
        for _, b in layer.named_buffers():
            if isinstance(b, Tensor):
                blk.create_var(name=b.name, shape=tuple(b.shape),
                               dtype=b.dtype, persistable=True)
                self._scope.set(b.name, b._t.detach())

    def __call__(self, *args):
        # a training layer whose parameters need gradients runs eagerly:
        # the program's fetches carry none (as the reference's)
        from ..dygraph import tracer
        from ..nn.layer_base import Layer

        if not ProgramTranslator.get_instance().enable_to_static:
            return self._fn(*args)
        owner = getattr(self._fn, "__self__", None)
        needs_grad = tracer.has_grad() and (
            any(isinstance(a, Tensor) and not a.stop_gradient for a in args)
            or (isinstance(owner, Layer)
                and any(not p.stop_gradient for p in owner.parameters()))
        ) and fw.in_dygraph_mode()
        if needs_grad and getattr(owner, "training", False):
            return self._fn(*args)
        main, _, feed_names, fetch_names, is_seq = self.get_traced(args)
        feeds = [a for a in args if isinstance(a, (Tensor, np.ndarray))]
        feed = {n: _feed_value(a) for n, a in zip(feed_names, feeds)}
        outs = self._exe.run(main, feed=feed, fetch_list=fetch_names,
                             scope=self._scope, return_numpy=False)
        return outs if is_seq else outs[0]

    @property
    def concrete_program(self):
        if not self._cache:
            raise RuntimeError("call the function once (or save with "
                               "input_spec)")
        return next(iter(self._cache.values()))

    def get_traced(self, args):
        """(main, startup, feed names, fetch names, is_seq) of the program
        for ``args``' signature, traced on first use."""
        key = self._sig(args)
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = self._trace(args)
        return entry


def to_static(function=None, input_spec=None, build_strategy=None,
              **kwargs):
    """``paddle.jit.to_static``: a decorator, or a call on a function or a
    Layer (whose ``forward`` becomes the :class:`StaticFunction`)."""

    def deco(fn):
        from ..nn.layer_base import Layer

        if isinstance(fn, Layer):
            fn.forward = StaticFunction(fn.forward, input_spec)
            return fn
        return functools.wraps(fn)(StaticFunction(fn, input_spec))

    if function is not None:
        return deco(function)
    return deco


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def save(layer, path: str, input_spec: Optional[Sequence[InputSpec]] = None,
         **configs):
    """``paddle.jit.save``: trace (at ``input_spec``, a None or -1 dim
    traced at 1 and kept dynamic in the program) and
    ``save_inference_model``."""
    from ..nn.layer_base import Layer

    if isinstance(layer, Layer):
        fn = layer.forward
        sf = (fn if isinstance(fn, StaticFunction)
              else StaticFunction(fn, input_spec))
    elif isinstance(layer, StaticFunction):
        sf = layer
    else:
        sf = StaticFunction(layer, input_spec)
    if input_spec is None and not sf._cache:
        raise ValueError("jit.save needs input_spec or a prior call to trace")
    if input_spec is not None:
        args = [Tensor(np.zeros([1 if (s is None or s < 0) else s
                                 for s in spec.shape], dtype=spec.dtype))
                for spec in input_spec]
        main, _, feed_names, fetch_names, _ = sf.get_traced(args)
    else:
        main, _, feed_names, fetch_names, _ = sf.concrete_program
    block = main.global_block()
    static_io.save_inference_model(
        path, [block.var(n) for n in feed_names],
        [block.var(n) for n in fetch_names], program=main, scope=sf._scope)


class TranslatedLayer:
    """A loaded inference program, callable like a Layer."""

    def __init__(self, program, feed_names, fetch_names, scope):
        self._program = program
        self._feed_names = feed_names
        self._fetch_names = fetch_names
        self._scope = scope
        self._exe = Executor()
        self.training = False

    def __call__(self, *args):
        feed = {name: _feed_value(a)
                for name, a in zip(self._feed_names, args)}
        outs = self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_names, scope=self._scope,
                             return_numpy=False)
        return outs[0] if len(outs) == 1 else outs

    def eval(self):
        return self

    def train(self):
        return self


def load(path: str, **configs) -> TranslatedLayer:
    """``paddle.jit.load``: the saved program and its persistables, on the
    current place's device."""
    scope = Scope()
    program, feed_names, fetch_names = static_io.load_inference_model(
        path, scope=scope)
    return TranslatedLayer(program, feed_names, fetch_names, scope)


declarative = to_static  # the fluid name


class TracedLayer:
    """``fluid.dygraph.TracedLayer``: a layer's forward traced into a
    program and run through the Executor."""

    def __init__(self, static_fn, inputs):
        self._fn = static_fn
        self._inputs = inputs

    @staticmethod
    def trace(layer, inputs):
        """(the layer's outputs, a TracedLayer): the program is traced
        here, also for a layer in training, which runs eagerly."""
        sf = to_static(layer.forward if hasattr(layer, "forward") else layer)
        sf.get_traced(inputs)
        return sf(*inputs), TracedLayer(sf, inputs)

    def __call__(self, *args):
        return self._fn(*args)

    def save_inference_model(self, path, feed=None, fetch=None):
        save(self._fn, path, input_spec=None)


_VERBOSITY = 0
_CODE_LEVEL = 0


def set_verbosity(level=0, also_to_stdout=False):
    """``jit.set_verbosity``: the level is recorded (the conversion logs
    nothing)."""
    global _VERBOSITY
    _VERBOSITY = int(level)


def set_code_level(level=100, also_to_stdout=False):
    """``jit.set_code_level``: the level is recorded (no converted code is
    printed)."""
    global _CODE_LEVEL
    _CODE_LEVEL = int(level)


dy2static.ProgramTranslator = ProgramTranslator
print_function = None  # the legacy ``from __future__`` re-export

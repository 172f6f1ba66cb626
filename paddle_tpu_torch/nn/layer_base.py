"""``paddle.nn.Layer``, the module base class, and its containers.

Counterpart of ``paddle_tpu/nn/layer_base.py`` (``Layer``: parameters,
buffers and sublayers, forward hooks, ``state_dict`` /
``set_state_dict``, ``train`` / ``eval``, ``apply``; ``ParamAttr``,
``EagerParameter``, ``LayerList``, ``Sequential``, ``ParameterList``),
in dygraph mode: a parameter is a leaf Tensor that needs a gradient,
named by the unique-name counters as the reference names it
(``linear_0.w_0``), so state-dict keys and optimizer state keys agree
between the packages.  In static mode a parameter is a ``Parameter`` of
the main program and its initializer op goes into the startup program,
under the same names.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import torch

from ..framework import program as fw
from ..framework import unique_name
from ..framework.dtype import convert_dtype, to_torch_dtype
from ..dygraph.tensor import Tensor
from .initializer import Constant, Initializer, XavierUniform


class ParamAttr:
    """Parity: ``python/paddle/fluid/param_attr.py`` ParamAttr."""

    def __init__(
        self,
        name=None,
        initializer: Optional[Initializer] = None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        need_clip: bool = True,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        return ParamAttr()


class EagerParameter(Tensor):
    """Dygraph parameter (parity: ParamBase in varbase_patch / framework.py)."""

    def __init__(self, data, trainable=True, name=None, **meta):
        # ``place``: where the parameter lives (the current place when
        # None), for layers built on a device named by the caller
        super().__init__(data, stop_gradient=not trainable, name=name,
                         persistable=True, place=meta.pop("place", None))
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": meta.pop("learning_rate", 1.0)}
        self.regularizer = meta.pop("regularizer", None)
        self.need_clip = meta.pop("need_clip", True)
        self.is_distributed = meta.pop("is_distributed", False)

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


class Layer:
    """See module docstring."""

    def __init__(self, name_scope: Optional[str] = None, dtype: str = "float32"):
        self.training = True
        self._dtype = dtype
        self._parameters: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self._buffers: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self._non_persistable_buffer_names: set = set()
        self._sub_layers: "collections.OrderedDict[str, Layer]" = collections.OrderedDict()
        self._forward_pre_hooks: "collections.OrderedDict[int, Callable]" = collections.OrderedDict()
        self._forward_post_hooks: "collections.OrderedDict[int, Callable]" = collections.OrderedDict()
        self._full_name = unique_name.generate(
            name_scope or self.__class__.__name__.lower()
        )

    # ------------------------------------------------------------------
    # parameter / buffer / sublayer registration
    # ------------------------------------------------------------------
    def create_parameter(
        self,
        shape,
        attr=None,
        dtype=None,
        is_bias: bool = False,
        default_initializer: Optional[Initializer] = None,
    ):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = convert_dtype(dtype or self._dtype)
        # priority (set_global_initializer parity): ParamAttr's pinned
        # initializer > the global default > the layer's default > built-in
        init = attr.initializer
        if init is None:
            from .initializer import _global_initializer

            init = _global_initializer(is_bias)
        if init is None:
            init = default_initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierUniform()
        name = attr.name or unique_name.generate(self._full_name + ".w")
        shape = [int(s) for s in shape]
        if fw.in_dygraph_mode():
            value = init.apply_dygraph(shape, dtype)
            return EagerParameter(
                value, trainable=attr.trainable, name=name,
                learning_rate=attr.learning_rate,
                regularizer=attr.regularizer, need_clip=attr.need_clip)
        # static mode: a Parameter of the main program, initialized by an
        # op of the startup program
        p = fw.default_main_program().global_block().create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            initializer=init, regularizer=attr.regularizer,
            need_clip=attr.need_clip)
        init.apply_static(p, fw.default_startup_program().global_block())
        return p

    def create_variable(self, name=None, persistable=False, dtype=None):
        """Non-parameter state: a Variable of the main program in static
        mode; in dygraph mode the caller registers a buffer instead
        (None)."""
        dtype = convert_dtype(dtype or self._dtype)
        name = name or unique_name.generate(self._full_name + ".b")
        if fw.in_dygraph_mode():
            return None
        return fw.default_main_program().global_block().create_var(
            name=name, dtype=dtype, persistable=persistable)

    def add_parameter(self, name: str, parameter):
        self._parameters[name] = parameter
        return parameter

    def register_buffer(self, name: str, tensor, persistable: bool = True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self._sub_layers[name] = sublayer
        return sublayer

    # attribute magic ----------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        subs = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if params is not None and isinstance(value, (EagerParameter,)):
            params[name] = value
            for d in (subs, buffers):
                if d is not None and name in d:
                    del d[name]
            return
        if subs is not None and isinstance(value, Layer):
            subs[name] = value
            for d in (params, buffers):
                if d is not None and name in d:
                    del d[name]
            return
        if buffers is not None and name in buffers:
            buffers[name] = value
            return
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{self.__class__.__name__}' object has no attribute {name!r}"
        )

    def __delattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        return list(super().__dir__()) + list(self._parameters) + list(self._sub_layers) + list(self._buffers)

    # ------------------------------------------------------------------
    # iteration
    # ------------------------------------------------------------------
    def named_sublayers(
        self, prefix: str = "", include_self: bool = False, layers_set=None
    ) -> Iterator[Tuple[str, "Layer"]]:
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, sub in self._sub_layers.items():
            if sub is None or id(sub) in layers_set:
                continue
            layers_set.add(id(sub))
            p = prefix + ("." if prefix else "") + name
            yield p, sub
            yield from sub.named_sublayers(prefix=p, include_self=False, layers_set=layers_set)

    def sublayers(self, include_self: bool = False) -> List["Layer"]:
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def children(self) -> Iterator["Layer"]:
        yield from self._sub_layers.values()

    def named_children(self):
        yield from self._sub_layers.items()

    def named_parameters(self, prefix: str = "", include_sublayers: bool = True):
        seen = set()
        for lp, layer in [(prefix, self)] + (
            [(p if not prefix else prefix + "." + p, l) for p, l in self.named_sublayers()]
            if include_sublayers
            else []
        ):
            for name, param in layer._parameters.items():
                if param is None or id(param) in seen:
                    continue
                seen.add(id(param))
                yield (lp + ("." if lp else "") + name, param)

    def parameters(self, include_sublayers: bool = True) -> List:
        return [p for _, p in self.named_parameters(include_sublayers=include_sublayers)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True):
        seen = set()
        for lp, layer in [(prefix, self)] + (
            [(p if not prefix else prefix + "." + p, l) for p, l in self.named_sublayers()]
            if include_sublayers
            else []
        ):
            for name, buf in layer._buffers.items():
                if buf is None or id(buf) in seen:
                    continue
                seen.add(id(buf))
                yield (lp + ("." if lp else "") + name, buf)

    def buffers(self, include_sublayers: bool = True) -> List:
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers)]

    # ------------------------------------------------------------------
    # modes / apply
    # ------------------------------------------------------------------
    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False
        return self

    def apply(self, fn: Callable[["Layer"], None]):
        for l in self.sublayers(include_self=True):
            fn(l)
        return self

    def full_name(self) -> str:
        return self._full_name

    def to(self, device=None, dtype=None, blocking=None):
        """Move the parameters and buffers to ``device`` (a place or a
        device string) and / or cast the float ones to ``dtype``."""
        from ..framework.place import Place, _parse

        dev = None
        if device is not None:
            dev = (device if isinstance(device, Place)
                   else _parse(device)).torch_device()
        tdt = None if dtype is None else to_torch_dtype(dtype)
        for t in self.parameters() + self.buffers():
            if not isinstance(t, Tensor):
                continue
            new = t._t.detach()
            if dev is not None:
                new = new.to(dev)
            if tdt is not None and new.is_floating_point():
                new = new.to(tdt)
            t._t = new.requires_grad_(t._t.requires_grad)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # ------------------------------------------------------------------
    # hooks
    # ------------------------------------------------------------------
    _hook_id = [0]

    class _HookRemover:
        def __init__(self, d, k):
            self._d, self._k = d, k

        def remove(self):
            self._d.pop(self._k, None)

    def register_forward_pre_hook(self, hook):
        Layer._hook_id[0] += 1
        k = Layer._hook_id[0]
        self._forward_pre_hooks[k] = hook
        return Layer._HookRemover(self._forward_pre_hooks, k)

    def register_forward_post_hook(self, hook):
        Layer._hook_id[0] += 1
        k = Layer._hook_id[0]
        self._forward_post_hooks[k] = hook
        return Layer._HookRemover(self._forward_post_hooks, k)

    # ------------------------------------------------------------------
    # call
    # ------------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        fwd = self.forward
        if not fw.in_dygraph_mode() and not getattr(
                fwd, "__dy2static_converted__", False):
            # under a static trace a sub-layer's tensor control flow builds
            # cond / while ops too: its forward is converted (cached per
            # code object; a forward with nothing to convert runs as is)
            from ..jit import dy2static

            func = getattr(fwd, "__func__", fwd)
            conv = dy2static.convert_func(func)
            outputs = (conv(self, *inputs, **kwargs) if conv is not func
                       else fwd(*inputs, **kwargs))
        else:
            outputs = fwd(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    # ------------------------------------------------------------------
    # state dict
    # ------------------------------------------------------------------
    def state_dict(
        self,
        destination=None,
        include_sublayers: bool = True,
        structured_name_prefix: str = "",
        use_hook: bool = True,
    ) -> Dict[str, Any]:
        dest = destination if destination is not None else collections.OrderedDict()
        for name, p in self.named_parameters(include_sublayers=include_sublayers):
            dest[structured_name_prefix + name] = p
        # persistable buffers only — checked against the OWNING layer's
        # non-persistable set (a sublayer's transient state must not leak)
        layers = [("", self)] + (
            list(self.named_sublayers()) if include_sublayers else []
        )
        seen = set()
        for lp, layer in layers:
            for name, buf in layer._buffers.items():
                if buf is None or id(buf) in seen:
                    continue
                seen.add(id(buf))
                if name in layer._non_persistable_buffer_names:
                    continue
                full = (lp + "." if lp else "") + name
                dest[structured_name_prefix + full] = buf
        return dest

    def set_state_dict(self, state_dict: Dict[str, Any], use_structured_name: bool = True):
        own = self.state_dict()
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            own[k].set_value(v)
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    def clear_gradients(self):
        for p in self.parameters():
            if isinstance(p, Tensor):
                p.clear_grad()

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, sub in self._sub_layers.items():
            sub_repr = repr(sub).split("\n")
            sub_repr = [sub_repr[0]] + ["  " + l for l in sub_repr[1:]]
            lines.append(f"  ({name}): " + "\n".join(sub_repr))
        main = f"{self.__class__.__name__}({extra}"
        if lines:
            return main + "\n" + "\n".join(lines) + "\n)"
        return main + ")"

    def extra_repr(self) -> str:
        return ""


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        return self._sub_layers[str(idx if idx >= 0 else len(self) + idx)]

    def __setitem__(self, idx, layer):
        if idx < 0:
            idx += len(self)
        self._sub_layers[str(idx)] = layer

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._sub_layers.values())
        layers.insert(index, layer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and not isinstance(layers[0], Layer):
            layers = layers[0]
        for i, l in enumerate(layers):
            if isinstance(l, (list, tuple)):
                name, l = l
                self.add_sublayer(str(name), l)
            else:
                self.add_sublayer(str(i), l)

    def forward(self, x):
        for l in self._sub_layers.values():
            x = l(x)
        return x

    def __getitem__(self, idx):
        return list(self._sub_layers.values())[idx]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self)), parameter)
        return self

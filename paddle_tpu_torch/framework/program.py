"""Static-graph programs: ``Program``, ``Block``, ``Variable``,
``Operator``, ``Parameter`` and the mode switch.

Counterpart of ``paddle_tpu/framework/program.py``, desc for desc: a
Program is a list of Blocks, a Block holds named Variables and a list of
Operators, an Operator maps slots (``"X"``, ``"Out"`` ...) to variable
names.  The descs are plain Python data that serialise to dicts
(:meth:`Program.to_dict` / :meth:`Program.from_dict`), which
``static/io.py`` writes as JSON.

Shape inference runs the registered kernel itself on ``meta``-device
tensors (:func:`paddle_tpu_torch.ops.registry.infer_shape`), so a
Variable's shape and dtype are what the kernel makes; dims of ``-1``
(a batch left open) are probed at two sizes, as the reference probes
them.  The static executor (``static/executor.py``) runs a block op by
op on torch tensors on its device.

The mode switch: dygraph (eager) is the default; :func:`enable_static`
makes every ``paddle.*`` function append ops to the current main
program instead (:func:`paddle_tpu_torch.ops.dispatch.dispatch`).
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Any, Dict, List, Optional, Sequence

from . import unique_name
from .dtype import convert_dtype

__all__ = [
    "Variable",
    "Parameter",
    "Operator",
    "Block",
    "Program",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "in_dygraph_mode",
    "enable_static",
    "disable_static",
    "name_scope",
    "grad_var_name",
]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class Variable:
    """A named tensor slot inside a Block: a symbolic handle whose value
    lives in a Scope at run time (a torch tensor)."""

    def __bool__(self):
        # a Variable has no value while the program is built: `if var:`
        # would otherwise take the true branch silently
        raise TypeError(
            f"bool(Variable '{self.name}') is undefined in a static graph: "
            "a Variable has no value at trace time.  Use "
            "paddle.static.nn.cond / while_loop, or run the function "
            "through paddle.jit.to_static so `if`/`while` convert.")

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        persistable: bool = False,
        stop_gradient: bool = False,
        is_data: bool = False,
        type: str = "lod_tensor",
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else ()
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type
        self.op: Optional["Operator"] = None  # producing op

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def astype(self, dtype):
        from ..ops.dispatch import dispatch_static

        return dispatch_static(
            "cast", {"X": [self]}, {"out_dtype": convert_dtype(dtype)},
            block=self.block)["Out"][0]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape),
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "type": self.type,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
        }

    def __repr__(self):
        return (
            f"var {self.name} : shape={self.shape} dtype={self.dtype} "
            f"persistable={self.persistable} stop_gradient={self.stop_gradient}"
        )

    __str__ = __repr__


class Parameter(Variable):
    """A persistable trainable Variable of a program's global block."""

    def __deepcopy__(self, memo):
        """A new parameter (fresh name) in the same block, its initializer
        replayed into the startup program: layers deep-copied under a
        program (an encoder's stacked layers) get weights of their own."""
        new = self.block.create_parameter(
            shape=self.shape,
            dtype=self.dtype,
            name=unique_name.generate(self.name.rsplit("_", 1)[0]),
            trainable=self.trainable,
            initializer=self.initializer,
            regularizer=self.regularizer,
            need_clip=self.need_clip,
        )
        memo[id(self)] = new
        if self.initializer is not None:
            from ..nn.initializer import Initializer

            if isinstance(self.initializer, Initializer):
                self.initializer.apply_static(
                    new, default_startup_program().global_block())
        return new

    def __init__(self, block, shape, dtype, name=None, trainable=True, **kwargs):
        initializer = kwargs.pop("initializer", None)
        regularizer = kwargs.pop("regularizer", None)
        need_clip = kwargs.pop("need_clip", True)
        is_distributed = kwargs.pop("is_distributed", False)
        kwargs.pop("persistable", None)
        super().__init__(block, name=name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable,
                         **kwargs)
        self.trainable = trainable
        self.initializer = initializer
        self.regularizer = regularizer
        self.need_clip = need_clip
        self.is_distributed = is_distributed


def raise_with_op_site(op, what: str, e: Exception):
    """Re-raise an op's failure naming the op and, with
    ``FLAGS_call_stack_level >= 2``, the Python stack that built it."""
    site = getattr(op, "callstack", None)
    raise RuntimeError(
        f"op {op.type!r} {what}: {e}"
        + (f"\n[operator creation stack]\n{site}" if site else
           "\n(set FLAGS_call_stack_level=2 for the operator creation "
           "stack)")
    ) from e


class Operator:
    """An op desc: ``inputs`` / ``outputs`` map slot names to lists of
    variable names."""

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, List[str]]] = None,
        outputs: Optional[Dict[str, List[str]]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        from . import flags as _flags

        if _flags.flag("FLAGS_call_stack_level") >= 2:
            import traceback

            self.callstack = "".join(traceback.format_stack(limit=12)[:-2])
        else:
            self.callstack = None

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self) -> List[str]:
        return [n for v in self.inputs.values() for n in v]

    @property
    def output_arg_names(self) -> List[str]:
        return [n for v in self.outputs.values() for n in v]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def _set_attr(self, name: str, val):
        self.attrs[name] = val

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": copy.deepcopy(self.attrs),
        }

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{{Op({self.type}) inputs:[{ins}] outputs:[{outs}] attrs:{self.attrs}}}"


class Block:
    """Variables by name and an op list; ``parent_idx`` links sub-blocks."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs) -> Parameter:
        # parameters live in the program's global block
        gblock = self.program.global_block()
        param = Parameter(gblock, **kwargs)
        gblock.vars[param.name] = param
        return param

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"Variable {name!r} not found in block {self.idx}")
        return v

    def _var_recursive(self, name: str) -> Variable:
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        raise ValueError(f"Variable {name!r} not found (recursive)")

    def _has_var_recursive(self, name: str) -> bool:
        try:
            self._var_recursive(name)
            return True
        except ValueError:
            return False

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        """Append an op: Variables become names, and the outputs' shapes
        and dtypes come from the registry's shape inference."""
        inputs = _normalize_io(inputs)
        outputs = _normalize_io(outputs)
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._version += 1
        self._infer_shape(op)
        for slot_vars in outputs.values():
            for name in slot_vars:
                if name in self.vars:
                    self.vars[name].op = op
        return op

    def _prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        inputs = _normalize_io(inputs)
        outputs = _normalize_io(outputs)
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._version += 1
        self._infer_shape(op)
        return op

    def _infer_shape(self, op: Operator):
        from ..ops import registry

        try:
            registry.infer_shape(self, op)
        except registry.OpNotRegistered:
            pass
        except Exception as e:
            raise_with_op_site(op, "failed shape inference", e)

    def to_dict(self) -> dict:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """Blocks (block 0 the global one), a random seed and a version that
    every appended op bumps (the executor's cache key)."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._seed_counter = 0
        self._version = 0
        self._is_start_up_program = False

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        if parent_idx is None:
            parent_idx = self.current_block_idx
        blk = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        return blk

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def all_parameters(self) -> List[Parameter]:
        return [p for b in self.blocks for p in b.all_parameters()]

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    @property
    def version(self) -> int:
        return self._version

    def clone(self, for_test: bool = False) -> "Program":
        """A copy of the descs; ``for_test`` sets ``is_test`` on the ops
        that behave differently in evaluation (dropout, batch_norm)."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for v in b.vars.values():
                if isinstance(v, Parameter):
                    nv = Parameter(nb, shape=v.shape, dtype=v.dtype,
                                   name=v.name, trainable=v.trainable)
                else:
                    nv = Variable(nb, name=v.name, shape=v.shape,
                                  dtype=v.dtype, persistable=v.persistable,
                                  stop_gradient=v.stop_gradient,
                                  is_data=v.is_data, type=v.type)
                nb.vars[v.name] = nv
            for op in b.ops:
                attrs = copy.deepcopy(op.attrs)
                if for_test and op.type in _IS_TEST_OPS:
                    attrs["is_test"] = True
                nop = Operator(nb, op.type, op.inputs, op.outputs, attrs)
                # a one-off op's def lives as long as an op that runs it
                eph = getattr(op, "_ephemeral_def", None)
                if eph is not None:
                    nop._ephemeral_def = eph
                nb.ops.append(nop)
            p.blocks.append(nb)
        p.current_block_idx = 0
        return p

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    @staticmethod
    def from_dict(d: dict) -> "Program":
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                if vd.get("is_parameter"):
                    v = Parameter(blk, shape=vd["shape"], dtype=vd["dtype"],
                                  name=vd["name"],
                                  trainable=vd.get("trainable", True))
                else:
                    v = Variable(blk, name=vd["name"], shape=vd["shape"],
                                 dtype=vd["dtype"],
                                 persistable=vd["persistable"],
                                 stop_gradient=vd["stop_gradient"],
                                 is_data=vd.get("is_data", False),
                                 type=vd.get("type", "lod_tensor"))
                blk.vars[v.name] = v
            for od in bd["ops"]:
                blk.ops.append(
                    Operator(blk, od["type"], od["inputs"], od["outputs"],
                             od["attrs"]))
            p.blocks.append(blk)
        return p

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"-- block {b.idx} (parent {b.parent_idx}) --")
            for v in b.vars.values():
                lines.append("  " + repr(v))
            for op in b.ops:
                lines.append("  " + repr(op))
        return "\n".join(lines)

    __str__ = __repr__


# ops whose attributes include is_test (for clone(for_test=True))
_IS_TEST_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
}


def _normalize_io(io) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    if not io:
        return out
    for slot, vs in io.items():
        if vs is None:
            continue
        if isinstance(vs, (Variable, str)):
            vs = [vs]
        out[slot] = [v.name if isinstance(v, Variable) else str(v) for v in vs]
    return out


# ---------------------------------------------------------------------------
# the default programs
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()
_startup_program_._is_start_up_program = True


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(program: Program) -> Program:
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


@contextlib.contextmanager
def name_scope(prefix: str):
    with unique_name.guard(prefix + "/"):
        yield


# ---------------------------------------------------------------------------
# the mode switch: dygraph by default, static after enable_static()
# ---------------------------------------------------------------------------

_dygraph_state = threading.local()


def in_dygraph_mode() -> bool:
    return getattr(_dygraph_state, "enabled", True)


def enable_static():
    _dygraph_state.enabled = False


def disable_static():
    _dygraph_state.enabled = True


@contextlib.contextmanager
def _dygraph_guard(enabled: bool):
    old = in_dygraph_mode()
    _dygraph_state.enabled = enabled
    try:
        yield
    finally:
        _dygraph_state.enabled = old

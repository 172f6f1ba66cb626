"""Custom C++ ops, and C++ sources built at run time with a content-hash
cache: ``paddle.utils.cpp_extension``.

Counterpart of ``paddle_tpu/utils/cpp_extension.py``, after the
reference's ``utils/cpp_extension/`` (``load``: the user's C++ compiled by
g++ at run time; ``load_op_library``) over the C ABI of
``paddle_tpu_torch/extension/paddle_tpu_ext.h`` (the reference's
``custom_operator.cc`` role).

A custom op runs on the host, as the JAX package runs it (there as a
host callback): its kernel is the user's C++ over host buffers.  A tensor
on the card is copied to the host for the call (``.cpu()``, which waits
for the work queued on its stream) and the outputs are copied back to its
device: that copy is the op's own semantics, not a fallback.  When the
library exports ``pt_<name>_backward``, the op's grad op
``<name>_grad`` runs it, so the op differentiates in dygraph and in a
static program.

:func:`compile_cached` also builds the DataLoader's shared-memory ring
(``csrc/shm_ring.cc``, :mod:`paddle_tpu_torch.io.shm_ring`).  The
reference builds into ``tempfile.gettempdir()``; the port builds into
``build/paddle_tpu_torch/`` at the root of the checkout (ignored by git),
beside the CUDA libraries of :mod:`paddle_tpu_torch.kernels._build`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from types import SimpleNamespace
from typing import List, Optional, Sequence

import torch

from ..kernels._build import BUILD_DIR

__all__ = ["load", "load_op_library", "get_include", "compile_cached"]

_MAX_DIMS = 8

# the ABI's dtype codes (extension/paddle_tpu_ext.h, enum PT_DType)
_DTYPES = [torch.float32, torch.float64, torch.int32, torch.int64,
           torch.uint8, torch.bool, torch.bfloat16]


def get_include() -> str:
    """The directory of ``paddle_tpu_ext.h``."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "extension")


class _PTTensor(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("dims", ctypes.c_int64 * _MAX_DIMS),
        ("ndim", ctypes.c_int32),
        ("dtype", ctypes.c_int32),
    ]


def _pt(t: torch.Tensor) -> _PTTensor:
    """The ABI's view of a contiguous host tensor."""
    s = _PTTensor()
    s.data = t.data_ptr()
    for i, d in enumerate(t.shape):
        s.dims[i] = d
    s.ndim = t.ndim
    s.dtype = _DTYPES.index(t.dtype)
    return s


class _CustomOp:
    """One op's C entry points."""

    def __init__(self, lib, name: str):
        self.name = name
        self._n_out = int(getattr(lib, f"pt_{name}_num_outputs")())
        self._infer = getattr(lib, f"pt_{name}_infer_shape")
        self._fwd = getattr(lib, f"pt_{name}_forward")
        self._bwd = getattr(lib, f"pt_{name}_backward", None)

    def infer(self, shapes: Sequence[tuple], dtypes: Sequence[torch.dtype]):
        """[(shape, dtype)] of the outputs, from the library."""
        n_in = len(shapes)
        in_dims = (ctypes.c_int64 * (_MAX_DIMS * n_in))()
        in_ndims = (ctypes.c_int32 * n_in)()
        in_dtypes = (ctypes.c_int32 * n_in)()
        for i, (sh, dt) in enumerate(zip(shapes, dtypes)):
            in_ndims[i] = len(sh)
            in_dtypes[i] = _DTYPES.index(dt)
            for j, d in enumerate(sh):
                in_dims[i * _MAX_DIMS + j] = d
        out_dims = (ctypes.c_int64 * (_MAX_DIMS * self._n_out))()
        out_ndims = (ctypes.c_int32 * self._n_out)()
        out_dtypes = (ctypes.c_int32 * self._n_out)()
        rc = self._infer(in_dims, in_ndims, in_dtypes, n_in,
                         out_dims, out_ndims, out_dtypes)
        if rc != 0:
            raise RuntimeError(f"custom op {self.name}: infer_shape rc={rc}")
        return [(tuple(out_dims[k * _MAX_DIMS + j]
                       for j in range(out_ndims[k])), _DTYPES[out_dtypes[k]])
                for k in range(self._n_out)]

    def _call_c(self, fn, ins: List[torch.Tensor], out_specs):
        outs = [torch.empty(sh, dtype=dt) for sh, dt in out_specs]
        c_ins = (_PTTensor * len(ins))(*[_pt(t) for t in ins])
        c_outs = (_PTTensor * len(outs))(*[_pt(t) for t in outs])
        rc = fn(c_ins, len(ins), c_outs, len(outs))
        if rc != 0:
            raise RuntimeError(f"custom op {self.name}: kernel rc={rc}")
        return outs

    def run(self, xs: List[torch.Tensor], n_grad_in: Optional[int] = None):
        """The forward (``n_grad_in`` None) or the backward over ``xs``,
        on host copies; the outputs on the device of ``xs[0]``.  On the
        ``meta`` device (shape inference) nothing runs."""
        dev = xs[0].device
        if n_grad_in is None:
            fn = self._fwd
            specs = self.infer([tuple(x.shape) for x in xs],
                               [x.dtype for x in xs])
        else:
            # the gradients have the shapes and dtypes of the inputs
            fn = self._bwd
            specs = [(tuple(x.shape), x.dtype) for x in xs[:n_grad_in]]
        if dev.type == "meta":
            return [torch.empty(sh, dtype=dt, device=dev) for sh, dt in specs]
        # the op runs on the host: a tensor on the card is copied over
        # once its stream's work is done, and the outputs go back to it
        host = [x.detach().cpu().contiguous() for x in xs]
        outs = self._call_c(fn, host, specs)
        return [o.to(dev) for o in outs]


def _register(op: _CustomOp):
    """Register the op, and its grad op when the library has one."""
    from ..ops.registry import GRAD_SUFFIX, get_op_def, register_op

    def fwd_kernel(ins, attrs):
        return {"Out": op.run(list(ins["X"]))}

    grad_maker = None
    if op._bwd is not None:
        grad_type = op.name + "_grad"

        def grad_kernel(ins, attrs):
            xs = list(ins["X"])
            return {"X" + GRAD_SUFFIX: op.run(
                xs + list(ins["Out" + GRAD_SUFFIX]), n_grad_in=len(xs))}

        register_op(grad_type, list_slots=("X", "Out" + GRAD_SUFFIX,
                                           "X" + GRAD_SUFFIX),
                    no_grad=True)(grad_kernel)
        get_op_def(grad_type).is_custom = True

        def grad_maker(ins, outs, out_grads):
            return grad_type, {"X": list(ins["X"]),
                               "Out" + GRAD_SUFFIX: list(out_grads["Out"])}

    register_op(op.name, list_slots=("X", "Out"), grad_maker=grad_maker,
                no_grad=op._bwd is None)(fwd_kernel)
    get_op_def(op.name).is_custom = True

    def surface(*tensors):
        from ..ops.dispatch import dispatch

        outs = dispatch(op.name, {"X": list(tensors)}, {})["Out"]
        return outs[0] if len(outs) == 1 else outs

    surface.__name__ = op.name
    return surface


def load_op_library(path: str):
    """Load a compiled library and register every op it lists; returns a
    namespace of the ops' functions.  A name that a built-in op holds
    raises; loading a custom op of the same name again replaces it."""
    from ..ops import registry

    lib = ctypes.CDLL(os.path.abspath(path))
    lib.pt_op_list.restype = ctypes.c_char_p
    ns = SimpleNamespace()
    for raw in lib.pt_op_list().decode().split(","):
        name = raw.strip()
        if not name:
            continue
        if registry.is_registered(name) and not getattr(
                registry.get_op_def(name), "is_custom", False):
            raise ValueError(
                f"custom op {name!r} collides with a built-in framework op")
        setattr(ns, name, _register(_CustomOp(lib, name)))
    ns._library_path = os.path.abspath(path)
    return ns


def compile_cached(name: str, sources: Sequence[str],
                   extra_cflags: Optional[list] = None,
                   extra_include_paths: Optional[list] = None,
                   extra_ldflags: Optional[list] = None,
                   hash_extra_files: Optional[list] = None,
                   build_directory: Optional[str] = None,
                   verbose: bool = False) -> str:
    """Compile C++ sources to a shared library with g++ and return its
    path.  The library is named by a hash of the sources (and of
    ``hash_extra_files``) and of the flags, so an unchanged build loads the
    library it made before; g++ writes to a temporary name that is renamed
    into place, so a reader never sees a partial file.

    Raises RuntimeError when the compile fails and OSError when there is no
    compiler."""
    build_dir = build_directory or str(BUILD_DIR)
    os.makedirs(build_dir, exist_ok=True)
    h = hashlib.sha1()
    for src in list(sources) + list(hash_extra_files or []):
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(repr((sorted(extra_cflags or []),
                   sorted(extra_include_paths or []),
                   sorted(extra_ldflags or []))).encode())
    so_path = os.path.join(build_dir, f"lib{name}_{h.hexdigest()[:12]}.so")
    if not os.path.exists(so_path):
        cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++14"]
        cmd += [f"-I{inc}" for inc in extra_include_paths or []]
        cmd += list(extra_cflags or [])
        cmd += [os.path.abspath(s) for s in sources]
        tmp_path = f"{so_path}.tmp.{os.getpid()}"
        cmd += ["-o", tmp_path]
        cmd += list(extra_ldflags or [])
        if verbose:
            print("cpp_extension:", " ".join(cmd), file=sys.stderr)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"cpp_extension build failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp_path, so_path)
    return so_path


def load(name: str, sources: Sequence[str], extra_cflags: Optional[list]
         = None, extra_include_paths: Optional[list] = None,
         build_directory: Optional[str] = None, verbose: bool = False):
    """Compile the user's C++ ``sources`` with g++ (into the content-hash
    cache under ``build/paddle_tpu_torch/`` unless ``build_directory``
    says otherwise) and register the ops the library lists.  A failed
    compile raises with g++'s output."""
    header = os.path.join(get_include(), "paddle_tpu_ext.h")
    so_path = compile_cached(
        name, sources, extra_cflags=extra_cflags,
        extra_include_paths=[get_include()] + list(extra_include_paths or []),
        hash_extra_files=[header], build_directory=build_directory,
        verbose=verbose)
    return load_op_library(so_path)

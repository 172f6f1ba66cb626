"""Build the port's CUDA sources at first use and bind them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles on its own into a shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/paddle_tpu_torch/<name>-<hash>.so <name>.cu

There is no fast-math flag: divisions stay IEEE and ``rintf`` rounds half
to even, which the bit-exact quantization of ``w8a8_gemm.cu`` relies on.
The output lands in ``build/paddle_tpu_torch/`` at the root of the
checkout (ignored by git), named by a hash of the sources, the headers
and the flags, so a changed source builds anew and an unchanged one loads
the library it built before.  :func:`build_all` starts one ``nvcc`` per
source at once.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points: name -> (source, function, argtypes), the source
# being csrc/<source>.cu.  kv_bits is 0 for float pages (the scale
# pointers may then be null), 8 or 4.  The flash entries take a pointer to
# int64 strides (b, s, h of each tensor operand, in argument order), and
# a score bias with a pointer to its four int64 strides.
SIGNATURES = {
    # q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths, out,
    # workspace, B, H, Hkv, page_size, D, max_pages, num_pages,
    # pages_per_split, scale, window, dtype (0 fp32, 1 bf16), kv_bits,
    # stream
    "paged_attention": ("paged_attention", "paged_attention_fwd",
                        [_P] * 9 + [_I] * 8 + [_F, _I, _I, _I, _P]),
    # q, k_pages, v_pages, k_scales, v_scales, block_table, out,
    # workspace, start, C, H, Hkv, page_size, D, max_pages, num_pages,
    # pages_per_split, scale, window, dtype, kv_bits, stream
    "paged_prefill": ("paged_prefill", "paged_prefill_fwd",
                      [_P] * 8 + [_I] * 9 + [_F, _I, _I, _I, _P]),
    # q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths, out,
    # workspace, B, T, H, Hkv, page_size, D, max_pages, num_pages,
    # pages_per_split, scale, window, dtype, kv_bits, stream
    "paged_attention_mq": ("paged_attention_mq", "paged_attention_mq_fwd",
                           [_P] * 9 + [_I] * 9 + [_F, _I, _I, _I, _P]),
    # x, xq, sx, wq, ws, out, M, N, K, dtype, path (0 split, 1 wgmma), bm,
    # bn, chunks per split, stream
    "w8a8_gemm": ("w8a8_gemm", "w8a8_gemm_fwd", [_P] * 6 + [_I] * 8 + [_P]),
    # q, k, v, out, lse, strides, bias (fp32 or null), bias strides (b,
    # h, q, k), B, H, Hkv, S, D, scale, causal, window, dtype (0 fp32, 1
    # bf16), stream
    "flash_fwd": ("flash_fwd", "flash_fwd", [_P] * 8 + [_I] * 5 + [_F]
                  + [_I] * 3 + [_P]),
    # q, k, v, out, dout, lse, delta, dq, strides, then as flash_fwd
    "flash_bwd_dq": ("flash_bwd", "flash_bwd_dq", [_P] * 11 + [_I] * 5
                     + [_F] + [_I] * 3 + [_P]),
    # q, k, v, dout, lse, delta, dk, dv, strides, then as flash_fwd
    "flash_bwd_dkv": ("flash_bwd", "flash_bwd_dkv", [_P] * 11 + [_I] * 5
                      + [_F] + [_I] * 3 + [_P]),
    # D, dtype, dkv (0 dQ, 1 dK/dV): the kernel's dynamic shared memory in
    # bytes (no launch)
    "flash_bwd_smem": ("flash_bwd", "flash_bwd_smem", [_I] * 3),
}
#: the CUDA sources, csrc/<name>.cu, in registration order
SOURCES = tuple(dict.fromkeys(src for src, _, _ in SIGNATURES.values()))

#: launches of every kernel variant (a kernel and its page kind), by name,
#: in registration order: its wrapper adds one right after each launch of
#: that variant, and nowhere else
LAUNCHES: Dict[str, int] = {}

_loaded: Dict[str, object] = {}
#: seconds each source took to compile in this process (0 when cached)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built; returns
    (target, tmp, process, start time) or None."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc, time.perf_counter()


def _finish(name: str, started) -> None:
    target, tmp, proc, t0 = started
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
    os.replace(tmp, target)   # atomic: a reader never sees a partial file


def build_all(names: Iterable[str] = SOURCES) -> List[Path]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes at once, and return the libraries' paths."""
    names = list(names)
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is None:
            build_seconds.setdefault(n, 0.0)
        else:
            _finish(n, s)
    return [_target(n) for n in names]


def kernel(name: str):
    """The C entry point ``name`` with its argtypes set, building its
    source's library first if needed.  The function returns the CUDA error
    code of its launch (0 on success)."""
    fn = _loaded.get(name)
    if fn is None:
        source, symbol, argtypes = SIGNATURES[name]
        path = build_all([source])[0]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check(name: str, code: int) -> None:
    """Raise when a launch returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")

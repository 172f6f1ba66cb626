"""C++ sources built at run time with a content-hash cache.

Counterpart of ``paddle_tpu/utils/cpp_extension.py``'s :func:`compile_cached`
(the rest of that module, ``load`` / ``load_op_library`` and the custom-op
ABI, waits for ROADMAP A.12).  The DataLoader's shared-memory ring
(``csrc/shm_ring.cc``, :mod:`paddle_tpu_torch.io.shm_ring`) builds through
it.

The reference builds into ``tempfile.gettempdir()``; the port builds into
``build/paddle_tpu_torch/`` at the root of the checkout (ignored by git),
beside the CUDA libraries of :mod:`paddle_tpu_torch.kernels._build`.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from typing import Optional, Sequence

from ..kernels._build import BUILD_DIR

__all__ = ["compile_cached"]


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

"""Where the package's headers and libraries are: ``paddle.sysconfig``.

Counterpart of ``paddle_tpu/sysconfig.py``, after the reference's
``sysconfig.py`` (``get_include``, ``get_lib``).  The include directory
holds the custom-op C ABI (``extension/paddle_tpu_ext.h``); the library
directory is the port's build cache (``build/paddle_tpu_torch/`` at the
root of the checkout), where ``utils.cpp_extension`` and the CUDA kernels
put the libraries they build.
"""

import os

__all__ = ["get_include", "get_lib"]


def get_include():
    """The directory of the C/C++ headers (the custom-op ABI)."""
    return os.path.join(os.path.abspath(os.path.dirname(__file__)),
                        "extension")


def get_lib():
    """The directory of the libraries built at run time."""
    from .kernels._build import BUILD_DIR

    return str(BUILD_DIR)

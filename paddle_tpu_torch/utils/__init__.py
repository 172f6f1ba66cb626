"""``paddle.utils``: custom C++ ops (:mod:`.cpp_extension`), the weights
cache (:mod:`.download`), ``deprecated``, ``try_import``,
``require_version``, ``run_check``, ``unique_name`` and the profiler's
names.

Counterpart of ``paddle_tpu/utils/__init__.py``, after the reference's
``utils/`` (``deprecated.py``, ``lazy_import.py``, ``install_check.py``)
and ``fluid/framework.py``'s ``require_version``.
"""

from . import cpp_extension  # noqa: F401
from . import download  # noqa: F401
from .cpp_extension import load_op_library  # noqa: F401
from ..framework import unique_name  # noqa: F401
from ..profiler import Profiler, ProfilerOptions, get_profiler  # noqa: F401

__all__ = ["deprecated", "run_check", "require_version", "try_import"]


def deprecated(update_to="", since="", reason=""):
    """Mark an API deprecated: the docstring says so and every call warns
    (``DeprecationWarning``)."""
    import functools
    import warnings

    def decorator(func):
        msg = f"API \"{func.__module__}.{func.__name__}\" is deprecated"
        if update_to:
            msg += f", please use \"{update_to}\" instead"
        if since:
            msg += f" since {since}"
        if reason:
            msg += f", reason: {reason}"
        func.__doc__ = (f"\n    Warning:\n        {msg}\n\n"
                        + (func.__doc__ or ""))

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return func(*args, **kwargs)

        return wrapper

    return decorator


def try_import(module_name, err_msg=None):
    """Import an optional dependency, or raise ImportError saying what to
    install."""
    import importlib

    try:
        return importlib.import_module(module_name)
    except ImportError:
        if err_msg is None:
            err_msg = (f"Failed importing {module_name}. This likely means "
                       f"that some paddle modules require additional "
                       f"dependencies that have to be manually installed "
                       f"(usually with `pip install {module_name}`).")
        raise ImportError(err_msg)


def require_version(min_version, max_version=None):
    """Raise unless the package's version lies in [min_version,
    max_version]."""
    import paddle_tpu_torch

    def parse(v):
        return tuple(int(p) for p in str(v).split(".")[:3] if p.isdigit())

    cur = parse(paddle_tpu_torch.__version__)
    if parse(min_version) > cur:
        raise Exception(
            f"VersionError: paddle_tpu_torch version "
            f"{paddle_tpu_torch.__version__} is below the required minimum "
            f"{min_version}")
    if max_version is not None and parse(max_version) < cur:
        raise Exception(
            f"VersionError: paddle_tpu_torch version "
            f"{paddle_tpu_torch.__version__} is above the allowed maximum "
            f"{max_version}")


def run_check():
    """Check the install: a small matmul and its gradient through the
    eager API, on the card when one is present (else on the CPU), and
    print the device."""
    import numpy as np
    import torch

    import paddle_tpu_torch as paddle
    from ..framework.place import CPUPlace, CUDAPlace, place_guard

    place = CUDAPlace(0) if torch.cuda.is_available() else CPUPlace()
    with place_guard(place):
        dev = paddle.get_device()
        x = paddle.to_tensor(np.ones((4, 4), "float32"), stop_gradient=False)
        w = paddle.to_tensor(np.full((4, 4), 0.5, "float32"),
                             stop_gradient=False)
        y = paddle.matmul(x, w).sum()
        y.backward()
        got = float(y.numpy())
        assert abs(got - 32.0) < 1e-4, f"matmul check failed: {got}"
        assert np.allclose(x.grad.numpy(), 2.0), "backward check failed"
        where = (torch.cuda.get_device_name(0) if isinstance(place, CUDAPlace)
                 else "CPU")
    print(f"PaddlePaddle (paddle_tpu_torch) is installed successfully! "
          f"Device: {dev} ({where}).")

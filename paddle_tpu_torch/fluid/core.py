"""``paddle.fluid.core``: the names of the C++ core that user code
touches (places, device counts, feature probes); any other name raises
with guidance instead of an AttributeError."""

from __future__ import annotations

import torch

from ..framework.place import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace, Place, TPUPlace,
    XPUPlace, is_compiled_with_cuda, is_compiled_with_npu,
    is_compiled_with_xpu,
)


def get_cuda_device_count() -> int:
    return torch.cuda.device_count()


def get_tpu_device_count() -> int:
    return 0


def is_compiled_with_mkldnn() -> bool:
    return False


def is_compiled_with_brpc() -> bool:
    return False


def is_compiled_with_dist() -> bool:
    return True  # torch.distributed collectives


class VarDesc:
    class VarType:
        FP16 = "float16"
        BF16 = "bfloat16"
        FP32 = "float32"
        FP64 = "float64"
        INT8 = "int8"
        INT16 = "int16"
        INT32 = "int32"
        INT64 = "int64"
        BOOL = "bool"
        UINT8 = "uint8"
        LOD_TENSOR = "lod_tensor"
        SELECTED_ROWS = "selected_rows"
        LOD_TENSOR_ARRAY = "lod_tensor_array"


def __getattr__(name):  # noqa: N807
    raise NotImplementedError(
        f"fluid.core.{name}: the C++ core's internals are PyTorch's in "
        "this build; use the public paddle API for this capability.")

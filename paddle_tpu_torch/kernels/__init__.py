"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

The CUDA sources live in ``paddle_tpu_torch/csrc`` and build at first use
(:mod:`._build`).  Every kernel variant (a kernel and its page kind) keeps
a count of its launches: ``KERNELS[name]``.
"""

from . import _build
from .attention import sdpa, sdpa_plain
from .flash import (flash_attention, flash_bwd_plain, flash_fwd_plain,
                    supported)
from .int8_gemm import w8a8_gemm, w8a8_gemm_plain
from .paged_attention import (gather_pages, paged_attention,
                              paged_attention_mq, paged_attention_mq_plain,
                              paged_attention_plain)
from .paged_prefill import paged_prefill, paged_prefill_plain

#: every kernel variant of the port, by name: ``paged_attention``,
#: ``paged_attention_int8``, ``paged_attention_int4``, the same three of
#: ``paged_attention_mq`` and ``paged_prefill``, ``w8a8_gemm``, and the
#: flash kernels ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``
KERNELS = _build.LAUNCHES


def reset_launch_counts() -> None:
    for name in KERNELS:
        KERNELS[name] = 0


__all__ = ["flash_attention", "flash_fwd_plain", "flash_bwd_plain",
           "supported", "sdpa", "sdpa_plain", "gather_pages", "paged_attention", "paged_attention_plain",
           "paged_attention_mq", "paged_attention_mq_plain",
           "paged_prefill", "paged_prefill_plain", "w8a8_gemm",
           "w8a8_gemm_plain", "KERNELS", "reset_launch_counts"]

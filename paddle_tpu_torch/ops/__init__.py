"""Numerics shared by the port's layers (counterpart of ``paddle_tpu/ops``)."""

from .quant_ops import (dequantize_int4, pack_int4, quantize_int4_per_token,
                        quantize_per_channel, quantize_per_token, unpack_int4,
                        w8a8_apply, w8a8_matmul)

__all__ = ["quantize_per_token", "pack_int4", "unpack_int4",
           "quantize_int4_per_token", "dequantize_int4",
           "quantize_per_channel", "w8a8_apply", "w8a8_matmul"]

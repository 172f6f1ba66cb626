"""Lift a JAX GPT parameter tree (as numpy) into the port.

The reference's decoder reads its parameters as one flat tree
(``paddle_tpu/models/generation.py``: ``_decoder_setup`` and
``_block_params``)::

    {"wte": [V, h], "wpe": [S, h], "lnf_g": [h], "lnf_b": [h],
     "blocks": [{"ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
                 "ln2_g", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b"}, ...]}

Linear weights there are ``[in, out]`` and applied as ``x @ W``.  The port
KEEPS that layout (it does not transpose to ``nn.Linear``'s ``[out, in]``),
so every array copies over unchanged and the two packages run the same
products on the same memory layout.

Only the float tree crosses over.  For W8A8 decoding both packages
quantize the int8 weights from these float weights at setup
(``models/generation._block_params``), so a quantized tree (``*_wq``) is
never loaded; the port keeps its int8 weights transposed, (N, K), for the
tensor-core kernel.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_BLOCK_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
               "ln2_g", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")
_TOP_KEYS = ("wte", "wpe", "lnf_g", "lnf_b")


def params_from_jax(tree) -> Dict[str, object]:
    """The reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` accepts) as a port state dict: ``{"wte": tensor, …,
    "blocks.0.qkv_w": tensor, …}`` in fp32 on the CPU, ready for
    ``GPTForPretraining.load_state_dict``.  Quantized trees (``*_wq``) are
    refused: the port quantizes its int8 weights from the float ones."""
    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {k: tensor(tree[k]) for k in _TOP_KEYS}
    for i, blk in enumerate(tree["blocks"]):
        missing = [k for k in _BLOCK_KEYS if k not in blk]
        if missing:
            raise ValueError(f"block {i} lacks {missing}: only float "
                             "parameter trees can be loaded")
        for k in _BLOCK_KEYS:
            out[f"blocks.{i}.{k}"] = tensor(blk[k])
    return out


def load_jax_params(model, tree) -> None:
    """Copy the reference's parameter tree into ``model`` (a
    :class:`~paddle_tpu_torch.models.gpt.GPTForPretraining`), casting to
    the model's dtype and device.  Shapes must match exactly."""
    model.load_state_dict(params_from_jax(tree), strict=True)

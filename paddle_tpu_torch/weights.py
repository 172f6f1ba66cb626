"""Lift JAX GPT parameters (as numpy) into the port, and back.

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

Training compares by the JAX model's named parameters instead
(``gpt.embeddings.word_embeddings.weight``, ``gpt.blocks.{i}.attn.qkv.
weight``, ...): their order, ``model.parameters()``, is the order of the
reference train step's flat leaves and of the port's
``GPTForPretraining.leaves()``.  :func:`load_jax_named_params` maps
them to the port's names; :func:`params_to_numpy` gives the port's
parameters back as numpy in that order.
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


# the JAX model's parameter names -> the port's
_JAX_TOP = {"gpt.embeddings.word_embeddings.weight": "wte",
            "gpt.embeddings.position_embeddings.weight": "wpe",
            "gpt.ln_f.weight": "lnf_g", "gpt.ln_f.bias": "lnf_b"}
_JAX_BLOCK = {"ln1.weight": "ln1_g", "ln1.bias": "ln1_b",
              "attn.qkv.weight": "qkv_w", "attn.qkv.bias": "qkv_b",
              "attn.proj.weight": "proj_w", "attn.proj.bias": "proj_b",
              "ln2.weight": "ln2_g", "ln2.bias": "ln2_b",
              "mlp.fc1.weight": "fc1_w", "mlp.fc1.bias": "fc1_b",
              "mlp.fc2.weight": "fc2_w", "mlp.fc2.bias": "fc2_b"}


def port_name(jax_name: str) -> str:
    """The port's parameter name for a JAX GPT parameter name:
    ``gpt.blocks.3.attn.qkv.weight`` -> ``blocks.3.qkv_w``."""
    if jax_name in _JAX_TOP:
        return _JAX_TOP[jax_name]
    head, _, rest = jax_name.partition("gpt.blocks.")
    idx, _, key = rest.partition(".")
    if head or not idx.isdigit() or key not in _JAX_BLOCK:
        raise ValueError(f"not a GPT parameter name: {jax_name!r}")
    return f"blocks.{idx}.{_JAX_BLOCK[key]}"


def load_jax_named_params(model, named) -> None:
    """Copy ``(name, array)`` pairs of the JAX model's
    ``named_parameters()`` (arrays as numpy) into ``model``, casting to its
    dtype and device.  Every parameter must be given, shapes exactly."""
    state = {port_name(n): torch.from_numpy(np.array(a, dtype=np.float32))
             for n, a in named}
    model.load_state_dict(state, strict=True)


def params_to_numpy(params):
    """The port's parameters (tensors in ``GPTForPretraining.leaves()``
    order, as the train step returns them) as fp32 numpy arrays, in that
    order."""
    return [p.detach().float().cpu().numpy() for p in params]


def load_jax_params(model, tree) -> None:
    """Copy the reference's parameter tree into ``model`` (a
    :class:`~paddle_tpu_torch.models.gpt.GPTForPretraining`), casting to
    the model's dtype and device.  Shapes must match exactly."""
    model.load_state_dict(params_from_jax(tree), strict=True)

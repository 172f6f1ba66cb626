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

Tensor parallelism (``GPTConfig.use_parallel`` under a mesh with mp >
1) keeps rank r's slice of each split parameter (:func:`tp_index`): the
vocabulary rows of ``wte``; the columns of ``qkv`` BY HEAD (its q heads,
then the k heads and the v heads those q heads read: GSPMD splits the
fused columns contiguously, which would hand a rank other heads' columns)
and of ``fc1``; the rows of ``proj`` and ``fc2``.  The rest is whole on
every rank.  Where mp does not divide the heads (:func:`attn_split`),
attention is not split: ``qkv`` and ``proj`` are whole on every rank;
where fewer K/V heads than ranks exist, the ranks that read one K/V head
each hold a copy of it.  :func:`load_jax_named_params` and :func:`load_jax_params` slice
global weights for a tensor-parallel model; :func:`rank_shards` gives a
rank of any ``(dp, pp, sharding, mp)`` topology its shards (its pipeline
stage's blocks) and :func:`gather_shards` puts ranks' shards back
together; given the paddle layers' state dicts (``models/gpt_layers``,
a pipeline's ``run_functions`` keys), it returns the reference's
``GPTForPretraining`` keys.

Training compares by the JAX model's named parameters instead
(``gpt.embeddings.word_embeddings.weight``, ``gpt.blocks.{i}.attn.qkv.
weight``, ...): their order, ``model.parameters()``, is the order of the
reference train step's flat leaves and of the port's
``GPTParams.leaves()``.  :func:`load_jax_named_params` maps
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
    ``GPTParams.load_state_dict``.  Quantized trees (``*_wq``) are
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


def reference_name(name: str) -> str:
    """The inverse of :func:`port_name`: ``blocks.3.qkv_w`` ->
    ``gpt.blocks.3.attn.qkv.weight``."""
    for jax_name, port in _JAX_TOP.items():
        if port == name:
            return jax_name
    head, idx, key = name.split(".")
    for jax_key, port in _JAX_BLOCK.items():
        if port == key and head == "blocks":
            return f"gpt.blocks.{idx}.{jax_key}"
    raise ValueError(f"not a port GPT parameter name: {name!r}")


def pipe_to_reference(key: str, num_layers: int) -> str:
    """A ``GPTForPretrainingPipe`` state-dict key as the reference's
    ``GPTForPretraining`` key: ``run_functions.0.*`` is the embedding,
    ``run_functions.{i}.*`` block ``i - 1``, ``run_functions.{L + 1}`` the
    final LayerNorm."""
    head, idx, rest = key.split(".", 2)
    if head != "run_functions":
        raise ValueError(f"not a pipeline key: {key!r}")
    i = int(idx)
    if i == 0:
        return f"gpt.embeddings.{rest}"
    if i <= num_layers:
        return f"gpt.blocks.{i - 1}.{rest}"
    if i == num_layers + 1:
        return f"gpt.ln_f.{rest}"
    raise ValueError(f"{key!r}: no layer {i} in a {num_layers}-layer pipe")


def reference_to_pipe(key: str, num_layers: int) -> str:
    """The inverse of :func:`pipe_to_reference`."""
    if key.startswith("gpt.embeddings."):
        return "run_functions.0." + key[len("gpt.embeddings."):]
    if key.startswith("gpt.blocks."):
        idx, rest = key[len("gpt.blocks."):].split(".", 1)
        return f"run_functions.{int(idx) + 1}.{rest}"
    if key.startswith("gpt.ln_f."):
        return f"run_functions.{num_layers + 1}.{key[len('gpt.ln_f.'):]}"
    raise ValueError(f"not a GPT key: {key!r}")


def _pipe_layers(keys):
    """The block count of a GPT pipe from its state-dict keys (the final
    LayerNorm is ``run_functions.{L + 1}``, held by every rank)."""
    return max(int(k.split(".")[1]) for k in keys
               if k.startswith("run_functions.")) - 1


def attn_split(cfg, mp: int, rank: int):
    """How tensor parallelism over ``mp`` ranks splits attention for rank
    ``rank``: ``(q0, nq, kv0, nkv)``, its first query head and their
    count and the first K/V head they read and their count; None when
    attention stays whole on every rank.  Attention splits by head when
    mp divides the query heads and the K/V heads split evenly or each
    rank's query heads read one K/V head (mp a multiple of the K/V
    heads; the ranks that share it hold copies)."""
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    if nh % mp or (nkv % mp and mp % nkv):
        return None
    nq = nh // mp
    group = nh // nkv
    q0 = rank * nq
    kv0 = q0 // group
    return q0, nq, kv0, (q0 + nq - 1) // group + 1 - kv0


def tp_index(cfg, name: str, mp: int, rank: int):
    """``(dim, indices)``: where port parameter ``name`` is split over
    ``mp`` tensor-parallel ranks and which of its indices rank ``rank``
    holds (numpy int64); None for a parameter every rank holds whole."""
    key = name.rsplit(".", 1)[-1]
    hd = cfg.head_dim
    heads = attn_split(cfg, mp, rank)
    if key in ("qkv_w", "qkv_b", "proj_w") and heads is None:
        return None
    if key == "qkv_w" or key == "qkv_b":
        q0, nq, kv0, nkv = heads
        k0 = (cfg.num_heads + kv0) * hd
        v0 = (cfg.num_heads + cfg.num_kv_heads + kv0) * hd
        idx = np.concatenate([np.arange(q0 * hd, (q0 + nq) * hd),
                              np.arange(k0, k0 + nkv * hd),
                              np.arange(v0, v0 + nkv * hd)])
        return (1 if key == "qkv_w" else 0), idx
    split = {"wte": (0, cfg.vocab_size), "proj_w": (0, cfg.hidden_size),
             "fc1_w": (1, cfg.ffn_hidden), "fc1_b": (0, cfg.ffn_hidden),
             "fc2_w": (0, cfg.ffn_hidden)}.get(key)
    if split is None:
        return None
    dim, n = split
    per = n // mp
    return dim, np.arange(rank * per, (rank + 1) * per)


def _tp_length(cfg, key):
    """The global length of split parameter ``key`` along its split dim."""
    if key in ("qkv_w", "qkv_b"):
        return (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    return {"wte": cfg.vocab_size, "proj_w": cfg.hidden_size}.get(
        key, cfg.ffn_hidden)


def tp_shard(cfg, name, a, mp, rank):
    """Rank ``rank``'s slice of the global parameter ``a`` (numpy or
    torch) named ``name``; a global shape other than ``cfg``'s raises
    ValueError."""
    where = tp_index(cfg, name, mp, rank) if mp > 1 else None
    if where is None:
        return a
    dim, idx = where
    length = _tp_length(cfg, name.rsplit(".", 1)[-1])
    if a.shape[dim] != length:
        raise ValueError(f"{name}: global size {a.shape[dim]} along dim "
                         f"{dim}, the config's is {length}")
    if isinstance(a, torch.Tensor):
        return a.index_select(dim, torch.as_tensor(idx, device=a.device))
    return np.take(a, idx, axis=dim)


def _load(model, state):
    """``state`` (global port-named tensors) into ``model``, sliced to the
    model's tensor-parallel rank when it has one."""
    tp = getattr(model, "tp", None)
    if tp is not None:
        state = {k: tp_shard(model.cfg, k, v, tp.n, tp.rank)
                 for k, v in state.items()}
    model.load_state_dict(state, strict=True)


def load_jax_named_params(model, named) -> None:
    """Copy ``(name, array)`` pairs of the JAX model's
    ``named_parameters()`` (arrays as numpy, global) into ``model``,
    casting to its dtype and device; a tensor-parallel model takes its
    rank's slices.  Every parameter must be given, shapes exactly."""
    _load(model, {port_name(n): torch.from_numpy(np.array(a, np.float32))
                  for n, a in named})


def _stage_of(name, cfg, pp):
    """The pipeline stage holding ``name`` (None: every stage)."""
    if not name.startswith("blocks."):
        return None
    return int(name.split(".")[1]) // (cfg.num_layers // pp)


def rank_shards(named, cfg, coord, dims) -> Dict[str, np.ndarray]:
    """The shards one rank holds, as port-named numpy arrays: ``named`` is
    the reference's global ``(name, array)`` pairs, ``coord`` the rank's
    ``{"dp", "pp", "sharding", "mp"}`` indices and ``dims`` the degrees.
    The rank holds the blocks of its pipeline stage and the other leaves,
    each its tensor-parallel slice (dp and sharding ranks hold the
    same)."""
    mp, pp = dims.get("mp", 1), dims.get("pp", 1)
    out = {}
    for n, a in named:
        name = port_name(n)
        stage = _stage_of(name, cfg, pp)
        if stage is None or stage == coord.get("pp", 0):
            out[name] = tp_shard(cfg, name, np.asarray(a, np.float32), mp,
                                 coord.get("mp", 0))
    return out


def gather_shards(ranks, cfg, dims) -> Dict[str, np.ndarray]:
    """The inverse of :func:`rank_shards`: ``ranks`` is ``(coord, shards)``
    pairs covering every pipeline stage and tensor-parallel rank (more
    dp / sharding replicas may come; the first of each is taken);
    returns the global arrays.  Shards by port name give port names;
    shards by the paddle layers' state-dict names (the reference's
    ``GPTForPretraining`` keys, or a ``GPTForPretrainingPipe``'s
    ``run_functions.{i}`` keys, each rank's held part and its
    tensor-parallel slices as :mod:`~paddle_tpu_torch.models.gpt_layers`
    splits them) give the reference's ``GPTForPretraining`` keys."""
    paddle = any(k.startswith(("gpt.", "run_functions."))
                 for _, shards in ranks for k in shards)
    if paddle:
        ranks = [(coord, {port_name(
            pipe_to_reference(k, cfg.num_layers)
            if k.startswith("run_functions.") else k): a
            for k, a in shards.items()}) for coord, shards in ranks]
    mp = dims.get("mp", 1)
    pieces = {}
    for coord, shards in ranks:
        for name, a in shards.items():
            pieces.setdefault(name, {}).setdefault(coord.get("mp", 0),
                                                   np.asarray(a))
    out = {}
    for name, by_rank in pieces.items():
        where = tp_index(cfg, name, mp, 0) if mp > 1 else None
        if where is None:
            out[name] = by_rank[0]
            continue
        dim = where[0]
        shape = list(by_rank[0].shape)
        shape[dim] = _tp_length(cfg, name.rsplit(".", 1)[-1])
        full = np.zeros(shape, by_rank[0].dtype)
        for r, a in by_rank.items():
            idx = tp_index(cfg, name, mp, r)[1]
            index = [slice(None)] * full.ndim
            index[dim] = idx
            full[tuple(index)] = a
        out[name] = full
    if paddle:
        out = {reference_name(k): v for k, v in out.items()}
    return out


def gpt_params(model):
    """``model`` as the torch parameter holder
    (:class:`~paddle_tpu_torch.models.gpt.GPTParams`) that generation,
    serving and the functional train step read: a holder as it is; a
    paddle ``GPTForPretraining`` (:mod:`~paddle_tpu_torch.models.
    gpt_layers`, the reference's class) as a new holder of its config
    with copies of its weights (mapped by the reference's names,
    :func:`port_name`), on its device, in its dtype and in its training
    mode, as the reference's functional step and decoder read a paddle
    model's parameters without changing them.  A tensor-parallel paddle
    model (rank slices) raises NotImplementedError: build the holder
    with ``use_parallel`` instead."""
    from .models.gpt import GPTParams
    from .models.gpt_layers import GPTForPretraining

    if isinstance(model, GPTParams):
        return model
    if not isinstance(model, GPTForPretraining):
        raise TypeError(f"a GPTParams or a paddle GPTForPretraining, not "
                        f"{type(model).__name__}")
    named = list(model.named_parameters())
    if any(getattr(p, "tp_split", None) is not None for _, p in named):
        raise NotImplementedError(
            "a tensor-parallel paddle GPTForPretraining holds rank slices; "
            "build GPTParams with use_parallel for the functional paths")
    w = model.gpt.embeddings.word_embeddings.weight._t
    holder = GPTParams(model.cfg, device=w.device, dtype=w.dtype)
    with torch.no_grad():
        holder.load_state_dict({port_name(n): p._t for n, p in named})
    return holder.train(model.training)


def params_to_numpy(params):
    """The port's parameters (tensors in ``GPTParams.leaves()``
    order, as the train step returns them) as fp32 numpy arrays, in that
    order."""
    return [p.detach().float().cpu().numpy() for p in params]


def load_jax_params(model, tree) -> None:
    """Copy the reference's parameter tree into ``model`` (a
    :class:`~paddle_tpu_torch.models.gpt.GPTParams`), casting to
    the model's dtype and device; a tensor-parallel model takes its
    rank's slices.  Shapes must match exactly."""
    _load(model, params_from_jax(tree))


# ---------------------------------------------------------------------------
# the paddle-shaped eager API: nn.Layer state dicts, optimizer state
# ---------------------------------------------------------------------------


def load_paddle_state_dict(layer, state) -> None:
    """Load a reference ``Layer.state_dict()`` (structured names such as
    ``bert.layers.0.attn.qkv.weight``, values as numpy arrays or anything
    ``np.asarray`` takes, paddle layouts: Linear weights ``[in, out]``)
    into the port's :class:`~paddle_tpu_torch.nn.Layer` of the same
    structure, cast to each parameter's dtype and device.  Every key must
    match, both ways, with two translations:

    * a ``GPTForPretrainingPipe`` (``run_functions.{i}`` keys) takes a
      ``GPTForPretraining`` state dict (:func:`reference_to_pipe`); on a
      pipeline rank the blocks of other stages, which the engine dropped,
      are skipped;
    * a tensor-parallel parameter (``tp_split``) given its global value
      keeps its slice."""
    own = layer.state_dict()
    state = {k: np.asarray(v) for k, v in state.items()}
    if (any(k.startswith("run_functions.") for k in own)
            and any(k.startswith("gpt.") for k in state)):
        n = _pipe_layers(own)
        state = {reference_to_pipe(k, n): v for k, v in state.items()}
        state = {k: v for k, v in state.items()
                 if k in own or not k.startswith("run_functions.")
                 or not 1 <= int(k.split(".")[1]) <= n}
    for k, v in state.items():
        split = getattr(own.get(k), "tp_split", None)
        if split is not None and tuple(v.shape) != tuple(own[k].shape):
            dim, idx, _ = split
            state[k] = np.take(v, idx, axis=dim)
    missing, unexpected = layer.set_state_dict(state)
    if missing or unexpected:
        raise ValueError(f"state dict mismatch: missing {missing[:8]}, "
                         f"unexpected {unexpected[:8]}")


def state_dict_to_numpy(layer) -> Dict[str, np.ndarray]:
    """The port's ``Layer.state_dict()`` as fp32 (or integer) numpy
    arrays, by structured name."""
    return {k: v.numpy() for k, v in layer.state_dict().items()}


def optimizer_state_to_numpy(opt) -> Dict[str, object]:
    """The port optimizer's ``state_dict()`` as numpy arrays under the
    reference's keys (``{param}_{acc}_0``; ``LR_Scheduler`` as it is)."""
    return {k: (v if k == "LR_Scheduler" else np.asarray(
        v.numpy() if hasattr(v, "numpy") else v))
        for k, v in opt.state_dict().items()}


def load_optimizer_state(opt, state) -> None:
    """Load a reference optimizer's ``state_dict()`` (numpy values under
    its keys) into the port's optimizer: existing accumulators are
    overwritten, the rest are held until the first step creates them."""
    opt.set_state_dict({k: (v if k == "LR_Scheduler" else np.asarray(v))
                        for k, v in state.items()})

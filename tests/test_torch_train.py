"""The port's GPT training path against the reference, on the CPU.

The reference's ``build_functional_train_step`` and the port's take the
same weights (the JAX model's named parameters through
``paddle_tpu_torch.weights``) and the same batch for 3 steps; losses agree
to 1e-5 relative and trained parameters to a stated absolute tolerance.
fp32 tolerances: both sides run the same operations in another summation
order; AdamW's normalised update turns a last-bit difference of a
near-zero gradient into up to ~lr of a parameter, hence 2e-5 at lr 1e-4.
W8A8: a last-bit difference now and then rounds an activation to the
other int8 value, 1e-4.  bf16 parameters (fp32 masters) and the bf16
compute dtype: one bf16 rounding of a parameter near 1 is 7.8e-3, so the
parameters agree to 1e-2 and the losses to 1e-3.

Three steps at lr 1e-4 move a weight by about 3e-4, which the absolute
tolerances alone cannot see, so each leaf's update (of the fp32 masters
where there are any) is held to the reference's too: ||port update -
reference update|| / ||reference update|| below 1e-3 in fp32 (at most
1.2e-4 measured on the CPU), 2e-2 under W8A8 (5.7e-3) and 0.3 with bf16
(0.165 with bf16 parameters, on ``blocks.1.ln1_g``, and 0.114 with the
bf16 compute dtype: both sides round their gradients to bf16 in another
order, and the sign-like first AdamW steps flip where a gradient is that
small).  A step that updates from the bf16 copy instead of the masters
reads 0.70 there.

Model: vocab 512, hidden 64, 2 layers, 2 heads, seq 64, batch 2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import quant_ops as jq
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         build_functional_train_step)
from paddle_tpu_torch.ops import w8a8_matmul
from paddle_tpu_torch.weights import (load_jax_named_params,
                                      params_to_numpy, port_name)

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64)
FP32 = (1e-5, 2e-5, 1e-3)      # loss rtol, parameter atol, update ratio
W8A8 = (1e-5, 1e-4, 2e-2)
BF16 = (1e-3, 1e-2, 0.3)

# id, config overrides, train-step options, dtype of the parameters, tols
CASES = [
    ("default", {}, {}, None, FP32),
    ("remat_false", {}, {"remat": False}, None, FP32),
    ("remat_dots", {}, {"remat": "dots"}, None, FP32),
    ("ce_dense", {}, {"ce_chunk_rows": 0}, None, FP32),
    ("ce_chunk32", {}, {"ce_chunk_rows": 32}, None, FP32),
    ("seq_major", {"seq_major": True}, {"remat": False}, None, FP32),
    ("gqa", {"num_kv_heads": 1}, {}, None, FP32),
    ("gqa_seq_major", {"num_kv_heads": 1, "seq_major": True}, {}, None,
     FP32),
    ("window", {"attn_window": 9}, {"ce_chunk_rows": 32}, None, FP32),
    ("int8", {"int8": True}, {}, None, W8A8),
    ("bf16_masters", {}, {"remat": False}, "bfloat16", BF16),
    ("compute_bf16", {}, {"compute_dtype": "bfloat16"}, None, BF16),
]


def _pair(over, seed=0):
    """(reference model, port model on the CPU with its weights)."""
    paddle.seed(seed)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**CFG, **over))
    named = [(n, np.asarray(p._array)) for n, p in jm.named_parameters()]
    tm = GPTForPretraining(GPTConfig(**CFG, **over), device="cpu")
    load_jax_named_params(tm, named)
    return jm, tm


def _update_ratio(name, got, want, init, cfg):
    """||(got - init) - (want - init)|| / ||want - init|| of one leaf.  The
    key part of the QKV bias is left out: it adds q.b_k to a whole row of
    scores, which the softmax cancels, so its gradient is zero but for
    rounding and both sides step on their own noise there."""
    if name.endswith("qkv_b"):
        keys = np.arange(cfg.hidden_size,
                         cfg.hidden_size + cfg.num_kv_heads * cfg.head_dim)
        got, want, init = (np.delete(a, keys) for a in (got, want, init))
    return np.linalg.norm(got - want) / np.linalg.norm(want - init)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab_size"], (2, 64)).astype("int32")
    labels = rng.randint(0, CFG["vocab_size"], (2, 64)).astype("int64")
    return ids, labels


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_train_step_matches_reference(case):
    _, over, opts, dtype, (loss_rtol, param_atol, update_rtol) = case
    jm, tm = _pair(over)
    if dtype is not None:
        for p in jm.parameters():
            p._array = p._array.astype(jnp.dtype(dtype))
        tm.to(getattr(torch, dtype))
    jstep, jp, jo = jgpt.build_functional_train_step(jm, **opts)
    tstep, tp, to = build_functional_train_step(tm, **opts)
    assert ("master" in to) == (dtype is not None)
    ids, labels = _batch()
    init = [a.copy() for a in params_to_numpy(tp)]
    losses = []
    for _ in range(3):
        jp, jo, jl = jstep(jp, jo, ids, labels)
        tp, to, tl = tstep(tp, to, ids, labels)
        np.testing.assert_allclose(float(tl), float(jl), rtol=loss_rtol)
        losses.append(float(tl))
    assert losses[-1] < losses[0]
    want = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(jp)]
    got = params_to_numpy(tp)
    assert [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=param_atol)
    # the fp32 weights (the masters where there are any) moved as the
    # reference's did, leaf by leaf
    assert ("master" in jo) == ("master" in to)
    if "master" in to:
        for p, w32 in zip(tp, to["master"]):
            assert torch.equal(p, w32.to(p.dtype))      # written back
        got32 = params_to_numpy(to["master"])
        want32 = [np.asarray(a, np.float32) for a in jo["master"]]
    else:
        got32, want32 = got, want
    names = [port_name(n) for n, _ in jm.named_parameters()]
    ratios = {n: _update_ratio(n, a, b, a0, tm.cfg)
              for n, a, b, a0 in zip(names, got32, want32, init)}
    assert max(ratios.values()) < update_rtol, ratios
    # the step trained the model's own parameters in place
    assert tp[0].data_ptr() == tm.wte.data_ptr()
    assert to["t"] == 3


@pytest.mark.parametrize("seq_major", [False, True], ids=["bsh", "sbh"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "w8a8"])
def test_forward_and_criterion_match_reference(seq_major, int8):
    over = dict(seq_major=seq_major, int8=int8, num_kv_heads=1)
    jm, tm = _pair(over, seed=1)
    ids, labels = _batch(1)
    labels[0, :5] = -100                       # ignored positions
    mask = (np.random.RandomState(2).rand(2, 64) > 0.2).astype(np.float32)
    jlogits = jm(paddle.to_tensor(ids))
    tlogits = tm(ids)
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits.numpy(),
                               rtol=1e-5, atol=1e-5)
    jcrit = jgpt.GPTPretrainingCriterion(seq_major=seq_major)
    tcrit = GPTPretrainingCriterion(seq_major=seq_major)
    for lm in (None, mask):
        jl = jcrit(jlogits, paddle.to_tensor(labels),
                   None if lm is None else paddle.to_tensor(lm))
        tl = tcrit(tlogits, torch.from_numpy(labels),
                   None if lm is None else torch.from_numpy(lm))
        np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()),
                                   rtol=1e-5)


@pytest.mark.parametrize("transpose_y", [False, True], ids=["xw", "xwT"])
def test_w8a8_matmul_is_the_reference_ste(transpose_y):
    """Forward bit for bit (the same per-call quantization of the live
    weight and the same int8 product); gradients equal jax.vjp of the
    reference's _w8a8_ste (fp32 products, 1e-5)."""
    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = (rng.randn(48, 64) if transpose_y else rng.randn(64, 48))
    w = (0.05 * w).astype(np.float32)
    g = rng.randn(3, 5, 48).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b: jq._w8a8_ste(transpose_y, a, b),
                       jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    out = w8a8_matmul(tx, tw, transpose_y=transpose_y)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    out.backward(torch.from_numpy(g))
    dx, dw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw), rtol=1e-5,
                               atol=1e-5)


def test_weight_names_map_to_the_port_in_train_order():
    jm, tm = _pair({"num_kv_heads": 1})
    names = [n for n, _ in jm.named_parameters()]
    mapped = [port_name(n) for n in names]
    ports = dict(tm.named_parameters())
    assert sorted(mapped) == sorted(ports)
    # the train step's order is the reference's
    assert [ports[n].data_ptr() for n in mapped] == \
        [p.data_ptr() for p in tm.leaves()]
    for (_, a), b in zip(jm.named_parameters(), params_to_numpy(tm.leaves())):
        np.testing.assert_array_equal(b, np.asarray(a._array))
    with pytest.raises(ValueError):
        port_name("gpt.blocks.0.attn.rotary.weight")


def test_options_that_are_not_ported_raise():
    _, tm = _pair({})
    with pytest.raises(ValueError, match="remat"):
        build_functional_train_step(tm, remat="full")
    for kw in ({"mesh": object()}, {"dp_axis": "dp"}, {"sharding_stage": 2}):
        with pytest.raises(NotImplementedError):
            build_functional_train_step(tm, **kw)
    m = GPTForPretraining(GPTConfig(**CFG, use_parallel=True), device="cpu")
    with pytest.raises(NotImplementedError):
        build_functional_train_step(m)
    # dropout is ported: it drops in training mode and is the identity
    # in eval
    m = GPTForPretraining(GPTConfig(**CFG, dropout=0.1), device="cpu")
    build_functional_train_step(m)
    ids = np.zeros((1, 4), np.int64)
    assert not torch.equal(m(ids), m(ids))
    m.eval()
    assert m(ids).shape == (1, 4, 512)
    assert torch.equal(m(ids), m(ids))


def test_decoding_setup_builds_no_autograd_graph():
    """The model's parameters now require gradients; the decoder's (and
    so the engine's) parameter dict hands out detached tensors, so its
    int8 quantization and the float tree record no autograd graph."""
    from paddle_tpu_torch.models.generation import _decoder_setup

    _, tm = _pair({"int8": True})
    assert all(p.requires_grad for p in tm.parameters())
    for int8 in (False, True):
        params, _ = _decoder_setup(tm, int8=int8)
        leaves = [params[k] for k in ("wte", "wpe", "lnf_g", "lnf_b")]
        leaves += [t for blk in params["blocks"] for t in blk.values()]
        assert not any(t.requires_grad or t.grad_fn is not None
                       for t in leaves)

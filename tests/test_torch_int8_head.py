"""``GPTConfig.int8_lm_head`` in the port against the reference.

With ``int8`` and ``int8_lm_head`` the eager forward's tied head is the
W8A8 product ``w8a8_matmul(x, wte, transpose_y=True)``: per-vocab-row
weight scales, per-token activation scales, the int8 product through
``w8a8_gemm`` (its plain version on the CPU).  Held against the
reference's ``dispatch("w8a8_matmul", ..., {"transpose_y": True})``:

* the head alone on the same hidden states: bit for bit against the
  reference evaluated op by op (``jax.disable_jit()``), as the two
  packages' quantize and GEMM decisions are (``test_torch_quant.py``);
  the reference's jitted op rounds the rescale's two products another
  way in some elements, by one ulp (1e-6 relative);
* the whole eager forward's logits: both sides compute the W8A8 blocks'
  hidden states in another summation order, and a last-bit difference
  now and then rounds an activation to the other int8 value, which moves
  its row's logits by up to a few 1e-4 (1.6e-4 measured at this size);
  so every logit within 1e-3 and 99% of them within 1e-5.

The functional train step's chunked cross-entropy head stays float under
``int8_lm_head``, as the reference's does: its losses equal the step's
without the flag bit for bit.  Without ``int8`` the flag does nothing.

Model: vocab 512, hidden 64, 2 layers, 2 heads, seq 64, batch 2.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.dygraph.tensor import Tensor as JTensor
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.dispatch import dispatch
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTParams,
                                         build_functional_train_step)
from paddle_tpu_torch.ops import w8a8_matmul
from paddle_tpu_torch.weights import load_jax_named_params

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64)


def _pair(**over):
    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**CFG, **over))
    jm.eval()
    named = [(n, np.asarray(p._array)) for n, p in jm.named_parameters()]
    tm = GPTParams(GPTConfig(**CFG, **over), device="cpu")
    tm.eval()
    load_jax_named_params(tm, named)
    return jm, tm


def _ids():
    return np.random.RandomState(0).randint(0, 512, (2, 64)).astype("int32")


def test_int8_head_is_bit_exact_on_the_same_hidden_states():
    jm, tm = _pair(int8=True, int8_lm_head=True)
    x = jm.gpt(JTensor(jnp.asarray(_ids())))
    w = jm.gpt.embeddings.word_embeddings.weight
    with jax.disable_jit():
        want = np.asarray(dispatch("w8a8_matmul", {"X": [x], "W": [w]},
                                   {"transpose_y": True})["Out"][0]._array)
    jitted = np.asarray(dispatch("w8a8_matmul", {"X": [x], "W": [w]},
                                 {"transpose_y": True})["Out"][0]._array)
    got = w8a8_matmul(torch.from_numpy(np.array(x._array)), tm.wte,
                      transpose_y=True)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # the reference's jitted op rounds the rescale's two products its own
    # way in some elements (1 ulp); op by op it is the port's bit for bit
    np.testing.assert_allclose(jitted, want, rtol=1e-6, atol=0)


def test_int8_head_forward_matches_reference():
    jm, tm = _pair(int8=True, int8_lm_head=True)
    want = np.asarray(jm(JTensor(jnp.asarray(_ids())))._array)
    got = tm(_ids()).detach().numpy()
    assert got.shape == (2, 64, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert np.mean(np.abs(got - want) <= 1e-5) >= 0.99
    # the head is not the float one
    _, float_head = _pair(int8=True)
    float_head.load_state_dict(tm.state_dict())
    assert not np.allclose(float_head(_ids()).detach().numpy(), got,
                           atol=1e-6)


def test_int8_head_flag_needs_int8_and_leaves_the_train_step_float():
    _, tm = _pair(int8_lm_head=True)
    _, plain = _pair()
    np.testing.assert_array_equal(tm(_ids()).detach().numpy(),
                                  plain(_ids()).detach().numpy())
    ids = _ids()
    labels = np.random.RandomState(1).randint(0, 512, (2, 64))
    losses = []
    for over in ({"int8": True, "int8_lm_head": True}, {"int8": True}):
        _, m = _pair(**over)
        step, params, opt = build_functional_train_step(m, remat=False)
        run = []
        for _ in range(2):
            params, opt, loss = step(params, opt, ids, labels)
            run.append(float(loss))
        losses.append(run)
    assert losses[0] == losses[1]

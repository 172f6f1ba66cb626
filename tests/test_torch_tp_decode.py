"""Tensor-parallel decoding in the port at mp=2, on two gloo ranks spawned
on the CPU: greedy and beam search, fp32 and W8A8, token for token.

The model is ``tests/test_w8a8_gpt.py``'s (vocab 512, hidden 64, 2
layers, 2 heads; seed 0 in the reference), and the same with GQA (4
query heads over 2 K/V heads) and a window of 6; the prompts (2, 7) of
its ``test_int8_decode_tp2``, 10 new tokens; and 4 query heads over one
K/V head, which both ranks hold.  fp32: both ranks equal the
port's one-device decode and the reference's ``build_generate_fn`` /
``build_beam_search_fn`` tokens exactly.  W8A8: both ranks equal the
port's one-device int8 decode exactly (the row-parallel products take the
global activation absmax and sum their int32 partials, so every int8
value is the one-device one); the reference's own int8 tp2 test fails its
int8-vs-fp budget on the CPU (ROADMAP C), so it is no oracle for int8.
"""

import numpy as np
import pytest

import torch_dist_workers as W

import paddle_tpu as paddle
from paddle_tpu.models import generation as jgen
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import build_beam_search_fn, build_generate_fn
from paddle_tpu_torch.models.gpt import GPTConfig, GPTParams
from paddle_tpu_torch.weights import load_jax_named_params

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64)
NEW = 10


# the reference test's model, and one with GQA (4 query heads over 2 K/V
# heads: one K/V head a rank) and a sliding window
MODELS = {"mha": {}, "gqa_window": {"num_heads": 4, "num_kv_heads": 2,
                                    "attn_window": 6},
          # one K/V head for two ranks: both hold it
          "kv_heads_1": {"num_heads": 4, "num_kv_heads": 1}}


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    ids = np.random.RandomState(0).randint(0, 512, (2, 7)).astype("int64")
    ref, single, models = {}, {}, []
    for name, over in MODELS.items():
        cfg = {**CFG, **over}
        paddle.seed(0)
        jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**cfg, dropout=0.0))
        jm.eval()
        named = [(n, np.asarray(p._array)) for n, p in jm.named_parameters()]
        ref[name] = {"greedy": np.asarray(jgen.build_generate_fn(jm, NEW)(
            ids)), "beam": np.asarray(jgen.build_beam_search_fn(
                jm, NEW, beam_size=3)(ids))}
        tm = GPTParams(GPTConfig(**cfg), device="cpu")
        load_jax_named_params(tm, named)
        tm.eval()
        single[name] = {
            "logits": tm(ids).detach().numpy(),
            "greedy": build_generate_fn(tm, NEW)(ids).numpy(),
            "beam": build_beam_search_fn(tm, NEW, beam_size=3)(ids).numpy(),
            "int8": build_generate_fn(tm, NEW, int8=True)(ids).numpy(),
            "int8_beam": build_beam_search_fn(tm, NEW, beam_size=3,
                                              int8=True)(ids).numpy()}
        models.append((cfg, named))
    got = W.run(tmp_path_factory.mktemp("decode"), 2, "decode",
                {"mp": 2, "models": models, "ids": ids, "new": NEW})
    return ref, single, {name: [g[i] for g in got]
                         for i, name in enumerate(MODELS)}


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_tp2_float_decode_equals_one_device_and_reference(decoded, model,
                                                          kind):
    ref, single, got = decoded
    np.testing.assert_array_equal(single[model][kind], ref[model][kind])
    for res in got[model]:
        np.testing.assert_array_equal(res[kind], single[model][kind])


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("kind", ["int8", "int8_beam"])
def test_tp2_int8_decode_equals_one_device_int8(decoded, model, kind):
    _, single, got = decoded
    for res in got[model]:
        np.testing.assert_array_equal(res[kind], single[model][kind])


def test_each_rank_decodes_its_heads(decoded):
    _, _, got = decoded
    assert [res["heads"] for res in got["mha"]] == [(1, 1), (1, 1)]
    assert [res["heads"] for res in got["gqa_window"]] == [(2, 1), (2, 1)]
    assert [res["heads"] for res in got["kv_heads_1"]] == [(2, 1), (2, 1)]


@pytest.mark.parametrize("model", list(MODELS))
def test_tp2_eager_forward_gathers_the_whole_logits(decoded, model):
    """The eager forward of a tensor-parallel model returns the whole
    vocabulary's logits on every rank (1e-5: fp32 sums in another
    order)."""
    _, single, got = decoded
    for res in got[model]:
        np.testing.assert_allclose(res["logits"], single[model]["logits"],
                                   rtol=1e-5, atol=1e-5)

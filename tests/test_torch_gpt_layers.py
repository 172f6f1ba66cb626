"""The paddle-shaped GPT of the port (``paddle_tpu_torch.models.
gpt_layers``: ``GPTForPretraining`` and ``GPTPretrainingCriterion`` as
``nn.Layer``s) against the reference's, on the CPU.

Config: the reference's ``tests/test_pipeline_gpt.py`` CFG (vocab 128,
hidden 32, 4 layers, 2 heads), batch 2, seq 16.  The port's model takes
the reference model's ``state_dict()`` (``weights.
load_paddle_state_dict``); both are built under fresh unique-name
counters.  Compared: the logits, the criterion's loss and every
parameter's gradient (by state-dict name) at rtol 1e-5 / atol 1e-6 (fp32:
the same operations in another summation order), in four cases:
batch-major, ``seq_major``, GQA (one K/V head) with a sliding window of
5, and W8A8 (``int8`` with the int8 tied head; ``tests/
test_torch_quant.py``'s tolerances, rtol = atol = 1e-5).  Also the model's
structure: its state-dict keys equal the reference's, in order.
"""

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.models import gpt_layers as tgpt
from paddle_tpu_torch.weights import load_paddle_state_dict

from torch_parity import interpretable  # noqa: F401  (fixture)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=2,
           max_seq_len=32, dropout=0.0)
FP32 = dict(rtol=1e-5, atol=1e-6)
W8A8 = dict(rtol=1e-5, atol=1e-5)
CASES = [
    ("batch_major", {}, FP32),
    ("seq_major", {"seq_major": True}, FP32),
    ("gqa_window", {"num_kv_heads": 1, "attn_window": 5}, FP32),
    ("int8", {"int8": True, "int8_lm_head": True}, W8A8),
]


@pytest.fixture(autouse=True)
def _cpu(interpretable):
    tp.set_device("cpu")


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, CFG["vocab_size"], (2, 16)).astype("int64")
    labels = rng.randint(0, CFG["vocab_size"], (2, 16)).astype("int64")
    return ids, labels


def _run(P, gpt, names, over, state=None):
    """Build ``gpt``'s model and criterion under fresh names (loading
    ``state`` when given), run forward, loss and backward on the batch;
    returns (state, logits, loss, grads by state-dict name, keys)."""
    with names.guard():
        P.seed(0)
        cfg = gpt.GPTConfig(**{**CFG, **over})
        model = gpt.GPTForPretraining(cfg)
        crit = gpt.GPTPretrainingCriterion(seq_major=cfg.seq_major)
    if state is not None:
        load_paddle_state_dict(model, state)
    sd = model.state_dict()
    state = {k: np.asarray(v.numpy()) for k, v in sd.items()}
    ids, labels = _batch()
    logits = model(P.to_tensor(ids))
    loss = crit(logits, P.to_tensor(labels))
    loss.backward()
    grads = {k: v.grad.numpy() for k, v in sd.items()}
    return state, logits.numpy(), float(loss.numpy()), grads, list(sd)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gpt_layers_match_reference(case):
    _, over, tol = case
    state, jl, jloss, jg, jkeys = _run(jp, jgpt, jnames, over)
    _, tl, tloss, tg, tkeys = _run(tp, tgpt, tnames, over, state)
    assert tkeys == jkeys
    np.testing.assert_allclose(tl, jl, **tol)
    np.testing.assert_allclose(tloss, jloss, rtol=tol["rtol"])
    for k in jkeys:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# ROADMAP C.6: models has the reference's names and kinds
# ---------------------------------------------------------------------------


def test_models_names_resolve_to_the_reference_kinds():
    """``models`` and ``models.gpt`` give the reference's GPT names the
    reference's kinds: the model and the criterion are paddle Layers (the
    gpt_layers classes), ``build_functional_train_step`` a function; the
    torch holder is GPTParams."""
    import inspect

    from paddle_tpu import models as jmodels
    from paddle_tpu_torch import models as tmodels
    from paddle_tpu_torch.models import gpt as tgpt_mod

    for mod in (tmodels, tgpt_mod):
        for name in ("GPTForPretraining", "GPTModel",
                     "GPTPretrainingCriterion"):
            got, want = getattr(mod, name), getattr(jmodels, name)
            assert got is getattr(tgpt, name), name
            assert issubclass(got, tp.nn.Layer) and issubclass(
                want, jp.nn.Layer), name
        assert inspect.isfunction(mod.build_functional_train_step)
    assert inspect.isfunction(jmodels.build_functional_train_step)
    assert not issubclass(tmodels.GPTParams, tp.nn.Layer)
    for name in ("ErnieModel", "ErnieForPretraining", "BertModel",
                 "build_generate_fn", "generate", "build_beam_search_fn",
                 "GPTForPretrainingPipe", "ernie_3_0_base"):
        assert hasattr(tmodels, name) and hasattr(jmodels, name), name


def test_paddle_optimizer_steps_the_paddle_gpt():
    """A paddle AdamW step on ``models.GPTForPretraining(gpt_tiny())``
    (the holder had no paddle parameters: AttributeError there before)."""
    from paddle_tpu_torch import models as tmodels
    from paddle_tpu_torch import optimizer as topt

    ids, labels = _batch()
    with tnames.guard():
        tp.seed(0)
        model = tmodels.GPTForPretraining(tmodels.gpt_tiny())
        crit = tmodels.GPTPretrainingCriterion()
        opt = topt.AdamW(learning_rate=1e-3, parameters=model.parameters())
    before = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    loss = crit(model(tp.to_tensor(ids)), tp.to_tensor(labels))
    loss.backward()
    opt.step()
    moved = [k for k, v in model.state_dict().items()
             if not np.array_equal(v.numpy(), before[k])]
    assert np.isfinite(float(loss.numpy()))
    assert len(moved) == len(before)


def test_functional_paths_take_the_paddle_gpt():
    """``build_functional_train_step``, ``generate`` and ``ServingEngine``
    take a paddle ``GPTForPretraining``: one functional step from it
    equals, bit for bit, the step from the holder with the same weights;
    greedy generation and the engine's tokens equal the holder's; the
    paddle model keeps its weights."""
    import torch

    from paddle_tpu_torch import models as tmodels
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.weights import reference_name

    cfg = tmodels.GPTConfig(**CFG)
    holder = tmodels.GPTParams(cfg, device="cpu", dtype=torch.float32,
                               seed=3)
    with tnames.guard():
        model = tmodels.GPTForPretraining(cfg)
    load_paddle_state_dict(model, {reference_name(k): v.numpy()
                                   for k, v in holder.state_dict().items()})
    before = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    ids, labels = _batch()
    runs = []
    for m in (holder, model):
        step, params, opt = tmodels.build_functional_train_step(
            m, lr=1e-3, remat=False)
        params, opt, loss = step(params, opt, ids, labels)
        runs.append((float(loss), [p.clone() for p in params]))
    (hl, hp), (ml, mp) = runs
    assert hl == ml
    assert all(torch.equal(a, b) for a, b in zip(hp, mp))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), before[k])

    holder = tmodels.GPTParams(cfg, device="cpu", dtype=torch.float32,
                               seed=3)
    prompt = ids[:, :6]
    want = tmodels.generate(holder, prompt, max_new_tokens=5, greedy=True)
    got = tmodels.generate(model, prompt, max_new_tokens=5, greedy=True)
    assert torch.equal(got, want)

    def serve(m):
        eng = ServingEngine(m, device="cpu", max_slots=2)
        done = eng.run([(row, 4) for row in prompt])
        return [tuple(done[r].tokens.tolist()) for r in sorted(done)]

    assert serve(model) == serve(holder)

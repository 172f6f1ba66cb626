"""The port's Vision Transformer against the reference's, on the CPU.

``vit_tiny`` (32 px, 8 px patches: 17 tokens, width 64, 2 blocks of 2
heads, 10 classes) is built in both packages under fresh unique-name
counters and the reference's ``state_dict()`` is carried into the
port's (``load_paddle_state_dict``).  Compared on the same seeded images:
the logits and the cross-entropy loss (1e-5 relative to the largest
value), the input's and every parameter's gradient of the loss (1e-5,
summation order only), and 2 steps of ``build_model_train_step`` (AdamW,
fp32) from the reference's state, held as ``tests/test_torch_step_
builder.py`` holds its models: losses to 1e-5, updates to 2e-3, moments
to 2e-3.  Also the layer names and the ``vit_*`` constructors' shapes.
"""

import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import unique_name as tnames
from torch_step_parity import loss_rel, pair, run_both

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _factory(P):
    return P.vision.models.vit_tiny()


def _batch():
    r = np.random.RandomState(0)
    return (r.randn(4, 3, 32, 32).astype("float32"),
            r.randint(0, 10, (4, 1)).astype("int64"))


def _ce(P):
    def loss(m, images, labels):
        return P.mean(P.nn.functional.softmax_with_cross_entropy(
            m(images), labels))

    return loss


def _eager(P, model):
    images, labels = _batch()
    x = P.to_tensor(images, stop_gradient=False)
    logits = model(x)
    loss = _ce(P)(lambda a: logits, x, P.to_tensor(labels))
    loss.backward()
    res = {"logits": logits.numpy(), "loss": loss.numpy(),
           "grad:x": x.grad.numpy()}
    for n, p in model.named_parameters():
        res[f"grad:{n}"] = p.grad.numpy()
    return res


def test_logits_loss_and_gradients_match_reference():
    jm, tm = pair(_factory)
    want, got = _eager(jp, jm), _eager(tp, tm)
    assert got["logits"].shape == (4, 10)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL * max(
            1.0, float(np.abs(w).max())), err_msg=k)


def test_two_generic_steps_match_reference():
    hist, _ = run_both((_factory, _ce, _batch()), steps=2,
                       compute_dtype=None, optimizer="adamw", lr=1e-3,
                       weight_decay=0.05)
    for h in hist:
        assert loss_rel(h) <= 1e-5, hist
        assert h["update"] <= 2e-3 and h["moments"] <= 2e-3, hist
    assert [h["t"] for h in hist] == [(1, 1), (2, 2)]


def test_names_and_constructors_match_reference():
    def build(P, names, fn, **kw):
        with names.guard():
            return getattr(P.vision.models, fn)(**kw)

    jm, tm = (build(P, n, "vit_tiny") for P, n in ((jp, jnames),
                                                    (tp, tnames)))
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [p.name for p in tm.parameters()] == [p.name for p in
                                                 jm.parameters()]
    # vit_b_16 at 224 px: 196 patches and the class token
    vb = build(tp, tnames, "vit_b_16", num_classes=0)
    assert vb.patch_embed.num_patches == 196 and vb.head is None
    assert vb.pos_embed.shape == [1, 197, 768] and len(vb.blocks) == 12


def test_example_loop_matches_reference_and_cli_runs():
    """``examples/train_vit.py``'s loop (CrossEntropyLoss, AdamW with the
    clip) 3 steps in both packages from the same weights, losses to
    1e-5; then the port's CLI on the CPU."""
    import subprocess
    import sys

    from paddle_tpu import nn as jnn, optimizer as jopt
    from paddle_tpu_torch.examples import train_vit as ex
    from paddle_tpu_torch.weights import load_paddle_state_dict

    args = ex.parse(["--steps", "3", "--batch", "4", "--device", "cpu"])
    with jnames.guard():
        jp.seed(args.seed)
        jm = jp.vision.models.vit_tiny(num_classes=10, img_size=32)
        crit = jnn.CrossEntropyLoss()
        opt = jopt.AdamW(learning_rate=args.lr, parameters=jm.parameters(),
                         weight_decay=0.05,
                         grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    with tnames.guard():
        tm, tcrit, topt = ex.build(args)
    load_paddle_state_dict(tm, {k: np.asarray(v.numpy())
                                for k, v in jm.state_dict().items()})
    images, labels = batch = ex.make_batch(args)
    want = []
    for _ in range(3):
        loss = crit(jm(jp.to_tensor(images)), jp.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        want.append(float(loss.numpy()))
    got = [float(ex.train_step(tm, tcrit, topt, batch).numpy())
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TOL)

    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.examples.train_vit",
         "--device", "cpu", "--steps", "3", "--batch", "4"],
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "images/s" in out.stdout and "OK: loss" in out.stdout

"""The port's ``build_model_train_step`` against the reference's, on the
CPU.

Both packages build the same model under fresh unique-name counters, the
reference's state dict (parameters and BatchNorm statistics) is carried
into the port's, and both steps run 3 steps on the same seeded batches:
momentum on ResNet-18 (32 px, batch 4, NCHW and NHWC) and AdamW on a
2-layer BERT (hidden 64), as ``bench.py``'s ``_resnet50_bench`` and
``_bert_bench`` drive the reference's step.  Each step starts both
packages from the reference's state (parameters, buffers, moments): a
ResNet-18 at 32 px normalises its last stage over the 4 samples of a 1 x
1 map, which multiplies the packages' rounding differences (their
convolutions sum in different orders) by about ten a step when they run
free, so a free run after 3 steps says little about the third step.
Compared at every step: the loss, each parameter's update as a norm ratio
``||got - want|| / ||want - start||``, the BatchNorm buffers and the
optimizer's moments as relative norms, and the step count.  The key part
of BERT's QKV bias is left out of the updates' ratio, as the smoke's
``update_ratios`` leaves it out: it adds ``q . b_k`` to a whole row of
scores, which the softmax cancels, so its gradient is zero but for
rounding, and AdamW steps each element by ~lr on its own noise.

Tolerances, fp32: losses to 1e-5, updates to 2e-3, buffers to 1e-4,
moments to 2e-3.  bf16 compute (BERT, momentum, whose update is linear in
the gradient): losses to 2e-2, all parameters' updates together to 5e-2
and each parameter's to 0.25, bf16's rounding of the activations and of
the cast weights being 4e-3 relative, and more where a parameter's
gradient is a sum that cancels (measured: 1.1e-2 to 1.7e-2 together,
0.146 at worst for one parameter).
"""

import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models.step_builder import build_model_train_step as jbuild

import paddle_tpu_torch as tp
from paddle_tpu_torch.distributed import mesh as mesh_mod
from paddle_tpu_torch.models.step_builder import \
    build_model_train_step as tbuild
from torch_step_parity import loss_rel as _loss_rel
from torch_step_parity import pair as _pair
from torch_step_parity import run_both as _run_both
import torch_dist_workers as W


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _ce(P):
    def loss(m, images, labels):
        return P.mean(P.nn.functional.softmax_with_cross_entropy(
            m(images), labels))

    return loss


def _bert_loss(P):
    crit = P.models.BertPretrainingCriterion()

    def loss(m, ids, token_type, pos, mlm_labels, nsp_labels):
        mlm, nsp = m(ids, token_type, masked_positions=pos)
        return crit(mlm, nsp, mlm_labels, nsp_labels,
                    masked_lm_scale=float(int(pos.shape[0])
                                          * int(pos.shape[1])))

    return loss


def _resnet(fmt):
    def factory(P):
        return P.vision.models.resnet18(num_classes=10, data_format=fmt)

    r = np.random.RandomState(0)
    shape = (4, 3, 32, 32) if fmt == "NCHW" else (4, 32, 32, 3)
    batch = (r.randn(*shape).astype("float32"),
             r.randint(0, 10, (4, 1)).astype("int64"))
    return factory, _ce, batch


def _bert():
    def factory(P):
        cfg = P.models.BertConfig(vocab_size=256, hidden_size=64,
                                  num_layers=2, num_heads=2, max_seq_len=16)
        return P.models.BertForPretraining(cfg)

    r = np.random.RandomState(0)
    b, s, m = 2, 16, 4
    ids = r.randint(0, 256, (b, s)).astype("int64")
    tt = (r.rand(b, s) > 0.5).astype("int64")
    pos = np.stack([r.choice(s, m, replace=False) + i * s
                    for i in range(b)]).astype("int64")
    mlm = ids.reshape(-1)[pos.reshape(-1)]
    nsp = r.randint(0, 2, (b, 1)).astype("int64")
    return factory, _bert_loss, (ids, tt, pos, mlm, nsp)


CASES = [("resnet18_momentum_nchw", lambda: _resnet("NCHW"),
          dict(optimizer="momentum", lr=1e-3, weight_decay=1e-4)),
         ("resnet18_momentum_nhwc", lambda: _resnet("NHWC"),
          dict(optimizer="momentum", lr=1e-3, weight_decay=1e-4)),
         ("bert_adamw", _bert,
          dict(optimizer="adamw", lr=1e-3, weight_decay=0.01))]


def _fp32_histories():
    """Each fp32 case's per-step record (JSON-ready), run here."""
    tp.set_device("cpu")
    out = {}
    for name, case, kw in CASES:
        hist, _ = _run_both(case(), compute_dtype=None, **kw)
        out[name] = [dict(h, t=list(h["t"])) for h in hist]
    return out


@pytest.fixture(scope="module")
def fp32_histories():
    """The fp32 cases, both packages, in one fresh process (ROADMAP C.15).

    In the whole suite the reference's ResNet-18 step now and then rounds
    another way in one xdist worker than in any fresh process (its step-1
    loss 2.5212166 against 2.5212128, the port's 2.5212259 in both), and
    the chaotic BatchNorm at 1 x 1 (the module docstring) carries that to
    a step-3 loss pair 1.3e-5 apart.  What the worker's earlier tests left
    behind was not found (not XLA's thread count, a CPU pinning, x64, the
    compilation cache, nor any one earlier file), so the comparison runs
    where the reference's arithmetic is pinned: a fresh interpreter with
    the suite's JAX settings (``conftest.py``'s: CPU, 8 virtual devices,
    the persistent compilation cache).  The bounds are unchanged."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [here, os.path.dirname(here)] + [env["PYTHONPATH"]]
        if env.get("PYTHONPATH") else [here, os.path.dirname(here)])
    code = ("import json\n"
            "import conftest\n"
            "import test_torch_step_builder as T\n"
            "print('HISTORIES ' + json.dumps(T._fp32_histories()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=here, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [s for s in proc.stdout.splitlines()
            if s.startswith("HISTORIES ")][-1]
    return {name: [dict(h, t=tuple(h["t"]), loss=tuple(h["loss"]))
                   for h in hist]
            for name, hist in json.loads(line[len("HISTORIES "):]).items()}


@pytest.mark.parametrize("name,case,kw", CASES, ids=[c[0] for c in CASES])
def test_three_steps_match_reference_fp32(name, case, kw, fp32_histories):
    hist = fp32_histories[name]
    for h in hist:
        assert _loss_rel(h) <= 1e-5, hist
        assert h["update"] <= 2e-3 and h["moments"] <= 2e-3, hist
        assert h["buffers"] <= 1e-4, hist
    assert [h["t"] for h in hist] == [(1, 1), (2, 2), (3, 3)]
    assert all(np.isfinite(h["loss"][0]) for h in hist)


def test_bf16_compute_matches_reference():
    """compute_dtype="bfloat16": weights and floating inputs cast at use,
    the fp32 masters updated; held at bf16's tolerance."""
    hist, (_, _, tpar, _) = _run_both(
        _bert(), compute_dtype="bfloat16", optimizer="momentum", lr=1e-3,
        weight_decay=0.01)
    assert max(_loss_rel(h) for h in hist) <= 2e-2, hist
    assert max(h["update_all"] for h in hist) <= 5e-2, hist
    assert max(h["update"] for h in hist) <= 0.25, hist
    assert all(p.dtype == torch.float32 for p in tpar)


def test_model_stays_at_its_initial_weights_and_buffers_move():
    factory, loss, batch = _resnet("NHWC")
    _, tm = _pair(factory)
    before = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    step, params, bufs, opt = tbuild(tm, loss(tp), lr=1e-3,
                                     compute_dtype=None)
    bufs0 = [b.clone() for b in bufs]
    params, bufs, opt, loss_t = step(params, bufs, opt, *batch)
    assert loss_t.dtype == torch.float32 and loss_t.ndim == 0
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), before[k])
    assert any((b - b0).abs().max() > 0 for b, b0 in zip(bufs, bufs0))
    # a Tensor batch (as the DataLoader yields) gives the same step
    _, tm2 = _pair(factory)
    step2, p2, b2, o2 = tbuild(tm2, loss(tp), lr=1e-3, compute_dtype=None)
    _, _, _, l2 = step2(p2, b2, o2, *[tp.to_tensor(a) for a in batch])
    assert float(l2) == float(loss_t)


def test_signature_matches_reference():
    assert inspect.signature(tbuild) == inspect.signature(jbuild)


def test_refuses_a_data_parallel_mesh_and_unknown_optimizers():
    """A mesh whose data-parallel group has 2 ranks needs a process group
    (the step averages its gradients over it; without one it raises);
    an unknown optimizer raises."""
    class _Mesh:
        shape = {"dp": 2, "pp": 1, "sharding": 1, "mp": 1}

    factory, loss, _ = _resnet("NCHW")
    _, tm = _pair(factory)
    old = mesh_mod.get_mesh()
    mesh_mod.set_mesh(_Mesh())
    try:
        with pytest.raises(RuntimeError, match="initialised process group"):
            tbuild(tm, loss(tp))
    finally:
        mesh_mod.set_mesh(old)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tbuild(tm, loss(tp), optimizer="sgd")


@pytest.mark.parametrize("dims", [{"dp": 2}, {"sharding": 2}],
                         ids=["dp2", "sharding2"])
def test_data_parallel_step_matches_reference_global_batch(dims, tmp_path):
    """``build_model_train_step`` on 2 gloo ranks, each feeding its rows of
    the global batch (BatchNorm's statistics and the gradients reduced
    over dp x sharding), against the reference's step over the whole
    batch: 2 momentum steps, losses to 1e-5 relative, parameters and
    BatchNorm buffers to 1e-5 (a sum over ranks in another order)."""
    with jnames.guard():
        jp.seed(0)
        jm = W.bn_net(jp)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    r = np.random.RandomState(3)
    batches = [(r.randn(8, 3, 6, 6).astype("float32"),
                r.randint(0, 5, (8, 1)).astype("int64")) for _ in range(2)]
    opts = dict(optimizer="momentum", lr=0.1, weight_decay=1e-4)
    js, jpar, jbuf, jopt = jbuild(jm, W.bn_net_loss(jp), compute_dtype=None,
                                  **opts)
    losses = []
    for x, y in batches:
        jpar, jbuf, jopt, loss = js(jpar, jbuf, jopt, x, y)
        losses.append(float(np.asarray(loss)))
    res = W.run(tmp_path, 2, "step_builder_dp",
                {"dims": dims, "state": state, "batches": batches,
                 "opts": opts})
    for rank in res:
        np.testing.assert_allclose(rank["losses"], losses, rtol=1e-5)
        for got, want in zip(rank["params"], jpar):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=1e-5)
        for got, want in zip(rank["buffers"], jbuf):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=1e-5)

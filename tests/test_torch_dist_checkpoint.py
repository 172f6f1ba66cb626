"""The port's sharded checkpoint (``paddle_tpu_torch/distributed/
checkpoint.py``) against the reference's, on the CPU.

* Format: a checkpoint written by either package loads in the other, in
  fp32 exactly.  bf16: the reference's bf16 checkpoint loads in the port
  bit for bit, and the port writes the reference's files for the same
  values (``meta.json``, ``shards_0.idx.json`` and the npz's ``V2`` bytes
  equal).  The reference's own loader refuses a bf16 checkpoint of either
  package alike (numpy has no cast from ``V2`` to ``ml_dtypes``'
  bfloat16; ROADMAP C, standing caveats), which the test records.
* Layouts: a flat range of a row-major array becomes rectangles that
  cover it exactly (every range of four small shapes), and a
  tensor-parallel slice plus a ZeRO chunk saves and reloads.
* Distributed: the GPT train step on 2 gloo ranks (ZeRO stage 2 and 3
  over sharding 2, tensor parallel over mp 2, and dp 2, whose replicated
  entries rank 0 alone writes; 2 AdamW steps from the
  reference's weights) saves its state; each checkpoint loads into a
  one-rank step's state: the parameters equal the ranks' own gathered
  parameters exactly, the fp32 masters and moments the one-device step's
  after the same 2 steps within 1e-5 relative and absolute (a gradient
  summed over ranks in another order), and step 3 from the loaded state
  equals step 3 of the one-device run within the same tolerance.  One
  of the ZeRO stage-2 saves goes over a directory that a world-4 save
  left (stale files of ranks 2 and 3), and must remove them.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.models import gpt as jgpt

from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.distributed.checkpoint import Shard, _flat_rects
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTParams,
                                         build_functional_train_step,
                                         load_train_state, save_train_state,
                                         train_state_dict)
from paddle_tpu_torch.weights import gather_shards, load_jax_named_params
import torch_dist_workers as W

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def test_fp32_checkpoints_cross_both_ways(tmp_path):
    r = np.random.RandomState(0)
    w, b = r.randn(3, 4).astype("float32"), r.randint(0, 9, (5,))
    jck.save_state_dict({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                        str(tmp_path / "ref"))
    got = {"w": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.int64)}
    tck.load_state_dict(got, str(tmp_path / "ref"))
    np.testing.assert_array_equal(got["w"].numpy(), w)
    np.testing.assert_array_equal(got["b"].numpy(), b)
    tck.save_state_dict({"w": torch.as_tensor(w * 2),
                         "b": torch.as_tensor(b + 1)}, str(tmp_path / "port"))
    back = {"w": jnp.zeros((3, 4), jnp.float32),
            "b": jnp.zeros((5,), jnp.int64)}
    jck.load_state_dict(back, str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back["w"]), w * 2)
    np.testing.assert_array_equal(np.asarray(back["b"]), b + 1)


def test_bf16_checkpoints_cross_both_ways(tmp_path):
    r = np.random.RandomState(1)
    t = torch.as_tensor(r.randn(6, 5).astype("float32")).to(torch.bfloat16)
    ref = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    jck.save_state_dict({"w": ref, "f": jnp.ones((2,), jnp.float32)},
                        str(tmp_path / "ref"))
    got = {"w": torch.zeros(6, 5, dtype=torch.bfloat16), "f": torch.zeros(2)}
    tck.load_state_dict(got, str(tmp_path / "ref"))
    np.testing.assert_array_equal(_bits(got["w"]), _bits(t))
    # the port writes the reference's files for the same values
    tck.save_state_dict({"w": t, "f": torch.ones(2)}, str(tmp_path / "port"))
    for name in ("meta.json", "shards_0.idx.json"):
        assert (json.load(open(tmp_path / "port" / name))
                == json.load(open(tmp_path / "ref" / name))), name
    a = np.load(tmp_path / "port" / "shards_0.npz")
    b = np.load(tmp_path / "ref" / "shards_0.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k
    # and the port reads its own back; the reference's loader refuses
    # bf16 from either package the same way (ROADMAP C, standing caveats)
    again = {"w": torch.zeros(6, 5)}
    tck.load_state_dict(again, str(tmp_path / "port"))
    np.testing.assert_array_equal(again["w"].numpy(), t.float().numpy())
    for d in ("ref", "port"):
        with pytest.raises(ValueError, match="cast"):
            jck.load_state_dict({"w": jnp.zeros((6, 5), jnp.bfloat16)},
                                str(tmp_path / d))


@pytest.mark.parametrize("shape", [(7,), (3, 4), (2, 3, 4), (4, 1, 3)])
def test_flat_ranges_become_exact_rectangles(shape):
    n = int(np.prod(shape))
    for a in range(n + 1):
        for b in range(a, n + 1):
            cover = np.zeros(shape, int)
            for s, e, sl in _flat_rects(a, b, shape):
                assert int(np.prod([y - x for x, y in sl])) == e - s
                cover[tuple(slice(x, y) for x, y in sl)] += 1
            want = np.zeros(n, int)
            want[a:b] = 1
            assert (cover.reshape(-1) == want).all(), (shape, a, b)


def test_tensor_parallel_and_flat_pieces_reload(tmp_path):
    """Rank pieces written by hand as two ranks would (a column slice of
    non-consecutive indices, its flat ZeRO halves) reload whole and into
    another layout."""
    g = torch.arange(90.0).reshape(9, 10)
    idx = np.array([0, 1, 2, 6, 7, 8])
    local = g.index_select(0, torch.as_tensor(idx)).reshape(-1)
    pad = torch.cat([local, torch.zeros(4)])
    pieces = [Shard(pad[:32], (9, 10), 0, idx, flat=0),
              Shard(pad[32:], (9, 10), 0, idx, flat=32),
              Shard(g[3:6], (9, 10), 0, np.arange(3, 6))]
    tck.save_state_dict({"w": pieces[0]}, str(tmp_path))
    for rank, sh in enumerate(pieces[1:], 1):
        arrays, index = {}, {}
        for k, (sl, arr) in enumerate(sh.pieces()):
            arrays[f"w::{k}"] = arr
            index[f"w::{k}"] = {"name": "w", "slices": sl}
        np.savez(tmp_path / f"shards_{rank}.npz", **arrays)
        json.dump(index, open(tmp_path / f"shards_{rank}.idx.json", "w"))
    whole = {"w": torch.zeros(9, 10)}
    tck.load_state_dict(whole, str(tmp_path))
    np.testing.assert_array_equal(whole["w"].numpy(), g.numpy())
    other = Shard(torch.zeros(12), (9, 10), 1, np.array([2, 9]), flat=6)
    tck.load_state_dict({"w": other}, str(tmp_path))
    want = g[:, [2, 9]].reshape(-1)[6:18].numpy()
    np.testing.assert_array_equal(other.data.numpy(), want)


def _plain(named, steps, ids, labels):
    model = GPTParams(GPTConfig(**CFG), device="cpu")
    load_jax_named_params(model, named)
    step, params, opt = build_functional_train_step(model, lr=1e-3)
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, ids, labels)
        losses.append(float(loss))
    return step, params, opt, losses


def _stale_world4(named, ids, labels, path):
    """``path`` as a save at world 4 leaves it: the step-0 state in the
    files of ranks 0 to 3, which the world-2 save that follows must not
    let through."""
    step, params, opt, _ = _plain(named, 0, ids, labels)
    save_train_state(step, params, opt, path)
    for rank in (1, 2, 3):
        for ext in (".npz", ".idx.json"):
            shutil.copy(os.path.join(path, f"shards_0{ext}"),
                        os.path.join(path, f"shards_{rank}{ext}"))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.GPTConfig(**CFG))
    named = [(n, np.asarray(p._array)) for n, p in jm.named_parameters()]
    r = np.random.RandomState(0)
    ids = r.randint(0, CFG["vocab_size"], (4, 16)).astype("int64")
    labels = r.randint(0, CFG["vocab_size"], (4, 16)).astype("int64")
    tmp = tmp_path_factory.mktemp("ckpt")
    runs = [{"dims": {"sharding": 2}, "stage": 2, "path": str(tmp / "z2")},
            {"dims": {"sharding": 2}, "stage": 3, "path": str(tmp / "z3")},
            {"dims": {"mp": 2}, "path": str(tmp / "mp2")},
            {"dims": {"dp": 2}, "path": str(tmp / "dp2")},
            {"dims": {"sharding": 2}, "stage": 2,
             "path": str(tmp / "z2_over_world4")}]
    _stale_world4(named, ids, labels, runs[-1]["path"])
    res = W.run(tmp, 2, "ckpt_train",
                {"cfg": CFG, "named": named, "ids": ids, "labels": labels,
                 "steps": 2, "runs": runs})
    return named, ids, labels, runs, res


@pytest.mark.parametrize("i", [0, 1, 2, 3, 4],
                         ids=["zero2", "zero3", "mp2", "dp2",
                              "zero2_over_world4"])
def test_sharded_save_loads_on_one_rank(sharded, i):
    named, ids, labels, runs, res = sharded
    run = runs[i]
    assert res[0][i]["stage"] == run.get("stage", 0)
    step, params, opt, losses = _plain(named, 2, ids, labels)
    np.testing.assert_allclose(res[0][i]["losses"], losses, **TOL)
    want = {k: v.clone() for k, v in
            train_state_dict(step, params, opt).items()}
    # a fresh one-rank state, the checkpoint loaded into it
    s2, p2, o2, _ = _plain(named, 0, ids, labels)
    load_train_state(s2, p2, o2, run["path"])
    got = train_state_dict(s2, p2, o2)
    assert int(got["t"]) == 2 == o2["t"]
    if run["dims"] == {"dp": 2}:
        # every entry is replicated: rank 0 writes it once
        assert os.path.getsize(os.path.join(run["path"], "shards_1.npz")) \
            < 1024
    # a world-2 save over a world-4 one leaves no file of ranks 2 and 3
    assert sorted(f for f in os.listdir(run["path"])
                  if f.startswith("shards_")) == [
        "shards_0.idx.json", "shards_0.npz", "shards_1.idx.json",
        "shards_1.npz"]
    ranks = [(r[i]["coord"], r[i]["params"]) for r in res]
    gathered = gather_shards(ranks, GPTConfig(**CFG), run["dims"])
    for k, v in got.items():
        if k.startswith("param/"):
            np.testing.assert_array_equal(v.numpy(), gathered[k[6:]],
                                          err_msg=k)
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)
    _, _, loss3 = s2(p2, o2, ids, labels)
    _, _, want3 = step(params, opt, ids, labels)
    np.testing.assert_allclose(float(loss3), float(want3), **TOL)

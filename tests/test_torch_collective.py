"""The port's collective API, its Megatron helpers and the hybrid
topology, on gloo ranks spawned on the CPU.

The ranks run :mod:`torch_dist_workers` (no JAX there); the test process
holds the expected values: numpy for the collectives, single-process
PyTorch autograd on the global tensors for the five ``_c_*`` Functions
(1e-6: one reduction order against another), and the reference's
``CommunicateTopology`` / ``HybridCommunicateGroup`` for the topology
(exact).  One spawn per world size covers all collective cases.
"""

import os

import numpy as np
import pytest
import torch

import torch_dist_workers as W

from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed.fleet import topology as jtop
from paddle_tpu_torch.distributed.fleet.topology import CommunicateTopology

TOL = dict(rtol=1e-6, atol=1e-6)


def _payload(n, seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    return {"w": rng.randn(4, 3 * n).astype(f),
            "wr": rng.randn(n, 4, 3).astype(f),
            "x": rng.randn(n, 4, 3).astype(f),
            "xg": rng.randn(4, 3 * n).astype(f),
            "logits": rng.randn(n, 5, 4).astype(f),
            "label": rng.randint(0, 4 * n, (5,)).astype(np.int64)}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    p = _payload(n)
    return n, p, W.run(tmp_path_factory.mktemp(f"coll{n}"), n,
                       "collectives", p)


def test_all_reduce_every_op(world):
    n, _, res = world
    base = np.stack([[r + 1.0, 2.0 - r, 0.5 * (r + 2)] for r in range(n)])
    want = {"sum": base.sum(0), "max": base.max(0), "min": base.min(0),
            "prod": base.prod(0)}
    for r in range(n):
        for op, w in want.items():
            np.testing.assert_allclose(res[r]["all_reduce_" + op], w, **TOL)


def test_gather_broadcast_reduce_scatter_alltoall_p2p(world):
    n, _, res = world
    base = np.stack([[r + 1.0, 2.0 - r, 0.5 * (r + 2)] for r in range(n)])
    for r in range(n):
        np.testing.assert_allclose(res[r]["all_gather"], base * 10, **TOL)
        np.testing.assert_allclose(res[r]["broadcast"], base[n - 1])
        np.testing.assert_allclose(res[r]["scatter"], [100.0 * r] * 2)
        np.testing.assert_allclose(res[r]["alltoall"],
                                   [[10.0 * s + r] * 2 for s in range(n)])
    np.testing.assert_allclose(res[0]["reduce_on_0"], base.sum(0), **TOL)
    np.testing.assert_allclose(res[1]["recv_on_1"], base[0] * 7, **TOL)
    np.testing.assert_allclose(res[0]["recv_on_1"], 0.0)


def test_groups(world):
    n, _, res = world
    base = np.stack([[r + 1.0, 2.0 - r, 0.5 * (r + 2)] for r in range(n)])
    for r in range(n):
        rank, nranks, ranks = res[r]["new_group"]
        assert (rank, nranks, ranks) == (r if r < 2 else -1, 2, [0, 1])
        assert res[r]["get_group"] == (n, [0, 1])
        if r < 2:
            np.testing.assert_allclose(res[r]["new_group_sum"],
                                       base[:2].sum(0), **TOL)
        assert res[r]["util_sum"] == [n * (n + 1) / 2]
        assert res[r]["worker"] == (r, n, r == 0)
        assert res[r]["mesh"] == {"dp": n, "pp": 1, "sharding": 1, "mp": 1}
        assert res[r]["env"] == (r, n, n, "cpu", "gloo")
        np.testing.assert_array_equal(res[r]["shard_batch"], [2 * r,
                                                               2 * r + 1])
        assert "does not split" in res[r]["shard_batch_ragged"]
    files = [f for r in range(n) for f in res[r]["files"]]
    assert files == [f"f{i}" for i in range(5)]


def test_megatron_functions_match_single_process_autograd(world):
    """Outputs and input gradients of ``_c_identity``, ``_mp_allreduce``,
    ``_c_concat``, ``_c_split`` and ``_c_softmax_with_cross_entropy``
    against the same function written on the global tensors in one
    process (every rank's loss term counted once)."""
    n, p, res = world
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    # identity: y = x on every rank, loss sum_r <y[:, :3], wr_r>
    x = t["xg"].clone().requires_grad_()
    sum(((x[:, :3] * t["wr"][r]).sum() for r in range(n))).backward()
    for r in range(n):
        np.testing.assert_allclose(res[r]["c_identity"][0], p["xg"])
        np.testing.assert_allclose(res[r]["c_identity"][1], x.grad, **TOL)
    # mp_allreduce: y = sum_r x_r, one loss <y, w[:, :3]>
    xs = t["x"].clone().requires_grad_()
    y = xs.sum(0)
    (y * t["w"][:, :3]).sum().backward()
    for r in range(n):
        np.testing.assert_allclose(res[r]["mp_allreduce"][0], y.detach(),
                                   **TOL)
        np.testing.assert_allclose(res[r]["mp_allreduce"][1], xs.grad[r],
                                   **TOL)
    # concat: y = [x_0 | x_1 | ...], one loss <y, w>
    xs = t["x"].clone().requires_grad_()
    y = torch.cat(list(xs), dim=-1)
    (y * t["w"]).sum().backward()
    for r in range(n):
        np.testing.assert_allclose(res[r]["c_concat"][0], y.detach())
        np.testing.assert_allclose(res[r]["c_concat"][1], xs.grad[r], **TOL)
    # split: y_r = x[:, 3r:3r+3], loss sum_r <y_r, wr_r>
    x = t["xg"].clone().requires_grad_()
    sum(((x[:, 3 * r:3 * r + 3] * t["wr"][r]).sum()
         for r in range(n))).backward()
    for r in range(n):
        np.testing.assert_allclose(res[r]["c_split"][0],
                                   p["xg"][:, 3 * r:3 * r + 3])
        np.testing.assert_allclose(res[r]["c_split"][1], x.grad, **TOL)
    # vocab-parallel cross-entropy against F.cross_entropy of the whole
    logits = torch.cat(list(t["logits"]), dim=-1).requires_grad_()
    loss = torch.nn.functional.cross_entropy(logits, t["label"],
                                             reduction="none")
    loss.sum().backward()
    soft = torch.softmax(logits.detach(), -1)
    for r in range(n):
        got_loss, got_soft, got_grad = res[r]["xent"]
        np.testing.assert_allclose(got_loss[:, 0], loss.detach(), **TOL)
        np.testing.assert_allclose(got_soft, soft[:, 4 * r:4 * r + 4], **TOL)
        np.testing.assert_allclose(got_grad, logits.grad[:, 4 * r:4 * r + 4],
                                   **TOL)


DIMS = [(2, 2, 1, 2), (2, 1, 2, 2), (1, 2, 2, 2), (8, 1, 1, 1),
        (1, 1, 1, 8), (1, 4, 1, 2), (2, 1, 1, 4), (1, 2, 4, 1)]


@pytest.mark.parametrize("dims", DIMS, ids=["x".join(map(str, d))
                                            for d in DIMS])
def test_communicate_topology_matches_reference(dims):
    ref = jtop.CommunicateTopology(dims=dims)
    got = CommunicateTopology(dims=dims)
    assert got.world_size() == ref.world_size()
    for name in ("data", "pipe", "sharding", "model"):
        assert got.get_dim(name) == ref.get_dim(name)
        assert got.get_comm_list(name) == ref.get_comm_list(name)
        for i in range(got.get_dim(name)):
            assert got.get_axis_list(name, i) == ref.get_axis_list(name, i)
    for r in range(got.world_size()):
        assert tuple(got.get_coord(r)) == tuple(ref.get_coord(r))
        assert got.get_rank(**got.get_coord(r)._asdict()) == r


HCG_DIMS = [(4, 1, 1, 1), (1, 1, 1, 4), (2, 1, 1, 2), (1, 2, 1, 2),
            (1, 2, 2, 1), (2, 1, 2, 1), (1, 1, 2, 2)]


def test_hybrid_communicate_group_matches_reference(tmp_path, monkeypatch):
    """Each rank's accessors against the reference's group built for that
    rank (``PADDLE_TRAINER_ID``), for seven degree combinations of four
    ranks; the axis groups are the reference topology's comm lists."""
    res = W.run(tmp_path, 4, "hcg", {"dims": HCG_DIMS})
    for i, (dp, pp, sd, mp) in enumerate(HCG_DIMS):
        topo = jtop.CommunicateTopology(dims=(dp, pp, sd, mp))
        for r in range(4):
            monkeypatch.setenv("PADDLE_TRAINER_ID", str(r))
            assert jenv.get_rank() == r
            ref = jtop.HybridCommunicateGroup(topo)
            got = res[r][i]
            for name in W.HCG_ACCESSORS:
                assert got[name] == getattr(ref, name)(), (i, r, name)
            assert got["rank_from_stage"] == [ref.get_rank_from_stage(s)
                                              for s in range(pp)]
            for axis, pname in (("data_parallel", "data"),
                                ("model_parallel", "model"),
                                ("pipe_parallel", "pipe"),
                                ("sharding_parallel", "sharding")):
                mine = [g for g in topo.get_comm_list(pname) if r in g]
                assert got["groups"][axis] == mine[0]


def test_split_builds_the_parallel_layers(world):
    n, _, res = world
    for r in range(n):
        assert res[r]["split"] == ((4, 2 * n), (4, 2), (4, 3), (1, 2, 5))


def test_spawn_join_deadline_ends_a_hung_rank(tmp_path):
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        W.run(tmp_path, 2, "hang", timeout=10)
    assert time.monotonic() - t0 < 45


def test_spawn_ends_the_pool_when_a_rank_fails(tmp_path):
    """Rank 0, blocked in a barrier with the failed rank, is terminated
    at once, well inside the group's 60 s timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        W.run(tmp_path, 2, "fail")
    assert time.monotonic() - t0 < 45


def test_fleet_wrappers_of_nn_layers_wait_for_a7(tmp_path):
    """``fleet.distributed_model`` / ``distributed_optimizer`` wrap a small
    ``nn.Layer`` and optimizer in the reference's types (one gloo rank,
    every degree 1: data parallel).  (The name is the one of the check
    that they raised until the wrappers were ported.)"""
    from paddle_tpu import nn as jnn, optimizer as jopt
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed import mesh as jmesh

    jfleet.init(is_collective=True)
    net = jnn.Linear(4, 4)
    want = (type(jfleet.distributed_model(net)).__name__,
            type(jfleet.distributed_optimizer(
                jopt.SGD(0.1, parameters=net.parameters()))).__name__)
    jmesh._MESH = None
    got, = W.run(tmp_path, 1, "fleet_wrappers",
                 {"modes": {"data_parallel": {}}})
    assert got["data_parallel"] == want == ("DataParallelSPMD",
                                            "HybridParallelOptimizer")


def test_spawn_and_all_reduce_signatures_match_reference(tmp_path):
    """ROADMAP C.5: ``spawn`` and ``all_reduce`` take the reference's
    arguments (``inspect.signature`` equal), and ``spawn(f)`` with the
    default ``nprocs=-1`` runs one rank per local device: one gloo rank
    on this host, which has no card."""
    import inspect
    import pickle

    import importlib

    from paddle_tpu.distributed import collective as jcoll
    from paddle_tpu_torch.distributed import all_reduce, spawn

    jspawn = importlib.import_module("paddle_tpu.distributed.spawn")
    assert inspect.signature(spawn) == inspect.signature(jspawn.spawn)
    assert inspect.signature(all_reduce) == inspect.signature(
        jcoll.all_reduce)
    assert not torch.cuda.is_available()
    spawn(W.solo_rank, args=(str(tmp_path),), timeout=W.JOIN_TIMEOUT)
    with open(tmp_path / "solo.pkl", "rb") as f:
        got = pickle.load(f)
    assert (got["rank"], got["world"]) == (0, 1)
    np.testing.assert_array_equal(got["t"], [0.0, 1.0, 2.0])

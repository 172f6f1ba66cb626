"""Four faults of the port's public API against the reference's, repaired
(ROADMAP C.9-C.12), on the CPU.

* C.9: ``paddle.device`` is the reference's namespace: its 13 names
  resolve, ``__all__`` is the reference's, and the listings name the
  torch devices present.
* C.10: ``profiler.start`` / ``profiler.stop`` are the 2.x-style aliases
  of ``start_profiler("All", logdir)`` / ``stop_profiler(sorted_key,
  profile_path)``, with the reference's parameters.
* C.11: ``KVPool`` takes the reference's arguments in its order,
  ``dtype`` positional and ``int8=True`` meaning ``kv_bits=8``; ``device``
  stays keyword-only.
* C.12: ``distributed.new_group(ranks, backend, axis_name, *, timeout)``
  and ``Group.axis_name``; a group bound to a mesh axis names that axis's
  process group for the ``c_*`` ops of its ring (a one-rank gloo world
  here).
"""

import inspect
import json

import numpy as np
import pytest
import torch

import paddle_tpu.device as jdevice
from paddle_tpu import profiler as jprofiler
from paddle_tpu.distributed import collective as jcoll
from paddle_tpu.serving.kv_pool import KVPool as JKVPool

import paddle_tpu_torch as tp
import paddle_tpu_torch.device as tdevice
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.distributed import collective as tcoll
from paddle_tpu_torch.serving import KVPool


def test_device_namespace_has_the_reference_names():
    assert tdevice.__all__ == jdevice.__all__
    for name in jdevice.__all__:
        assert getattr(tdevice, name) is not None, name
    assert tp.device is tdevice
    kinds = tdevice.get_all_device_type()
    assert "cpu" in kinds and ("gpu" in kinds) == torch.cuda.is_available()
    assert tdevice.get_available_device() == [
        f"gpu:{i}" for i in range(torch.cuda.device_count())]
    assert tdevice.get_all_custom_device_type() == []
    assert tdevice.get_available_custom_device() == []
    assert tdevice.is_compiled_with_xpu() is False
    assert tdevice.is_compiled_with_npu() is False
    tdevice.set_device("cpu")
    assert tdevice.get_device() == "cpu"
    assert issubclass(tdevice.XPUPlace, tp.CUDAPlace)


def test_profiler_start_and_stop_aliases(tmp_path):
    for name in ("start", "stop"):
        assert (list(inspect.signature(getattr(tprofiler, name)).parameters)
                == list(inspect.signature(getattr(jprofiler, name))
                        .parameters)), name
    tprofiler.start(logdir=str(tmp_path / "trace"))
    with tprofiler.RecordEvent("repaired_alias"):
        torch.ones(4).sum()
    path = tmp_path / "profile.json"
    tprofiler.stop("total", str(path))
    assert "repaired_alias" in json.loads(path.read_text())


def test_kv_pool_takes_the_reference_arguments():
    mine = list(inspect.signature(KVPool).parameters.values())
    ref = list(inspect.signature(JKVPool).parameters)
    assert [p.name for p in mine[:len(ref)]] == ref
    assert [(p.name, p.kind) for p in mine[len(ref):]] == [
        ("device", inspect.Parameter.KEYWORD_ONLY)]
    pool = KVPool(2, 4, 16, 8, 4, torch.float32, True, device="cpu")
    assert pool.kv_bits == 8 and pool.buffers["k"].dtype == torch.int8
    pool = KVPool(2, 4, 16, 8, 4, torch.float32, device="cpu")
    assert pool.kv_bits is None and pool.buffers["k"].dtype == torch.float32
    assert KVPool(2, 4, 16, 8, 4, torch.float32, True, kv_bits=4,
                  device="cpu").kv_bits == 4


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.distributed import mesh as mesh_mod

    init_parallel_env(backend="gloo", store_path=str(tmp_path / "store"),
                      timeout=60)
    mesh_mod.build_hybrid_mesh(mp=1)
    try:
        yield
    finally:
        mesh_mod.set_mesh(None)
        dist.destroy_process_group()


def test_new_group_takes_axis_name(one_rank, monkeypatch):
    sig = inspect.signature(tcoll.new_group)
    ref = inspect.signature(jcoll.new_group)
    params = list(sig.parameters.values())
    assert [p.name for p in params[:3]] == list(ref.parameters)
    assert params[3].name == "timeout"
    assert params[3].kind == inspect.Parameter.KEYWORD_ONLY
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.ops import collective_ops, registry

    g = tcoll.new_group(axis_name="mp")
    assert (g.axis_name, g.ranks, g.rank, g.nranks) == ("mp", [0], 0, 1)
    assert g.process_group is mesh_mod.get_mesh().group("mp")
    assert collective_ops.get_ring_axis(g.id) is g.process_group
    plain = tcoll.new_group([0])
    assert plain.axis_name is None and plain.id != g.id
    x = torch.arange(6.0)
    out = registry.run_kernel(registry.get_op_def("c_allreduce_sum"),
                              {"X": [x]}, {"ring_id": g.id})["Out"][0]
    assert torch.equal(out, x)
    # a ring bound to no group refuses
    with pytest.raises(ValueError, match="bound to no group"):
        registry.run_kernel(registry.get_op_def("c_allreduce_sum"),
                            {"X": [x]}, {"ring_id": 999})
    np.testing.assert_array_equal(
        tcoll.all_reduce(x.clone(), group=g).numpy(), x.numpy())


def test_a_new_world_forgets_the_rings_of_the_last(tmp_path):
    """A ring bound in a destroyed world names no group in the next one;
    ring 0 is the new world."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.ops import registry

    init_parallel_env(backend="gloo", store_path=str(tmp_path / "a"),
                      timeout=60)
    mesh_mod.build_hybrid_mesh(mp=1)
    old = tcoll.new_group(axis_name="mp")
    tcoll.get_group(0)
    mesh_mod.set_mesh(None)
    dist.destroy_process_group()
    init_parallel_env(backend="gloo", store_path=str(tmp_path / "b"),
                      timeout=60)
    try:
        x = torch.arange(4.0)
        out = registry.run_kernel(registry.get_op_def("c_allreduce_sum"),
                                  {"X": [x]}, {"ring_id": 0})["Out"][0]
        assert torch.equal(out, x)
        with pytest.raises(ValueError, match="bound to no group"):
            registry.run_kernel(registry.get_op_def("c_allreduce_sum"),
                                {"X": [x]}, {"ring_id": old.id})
        assert tcoll.get_group(0).process_group is dist.group.WORLD
    finally:
        dist.destroy_process_group()

"""The port's ``io`` (datasets, samplers, the DataLoader and its
shared-memory ring) and ``save`` / ``load`` against the reference's, on
the CPU.

The ring: a round trip of nested batches, slot recycling, a payload larger
than a slot, a producer and a consumer on separate attachments, and an
arena larger than ``/dev/shm`` failing when it is made.  The DataLoader:
single-process and multi-process (2 spawned workers) over the ring, over
the queue (``use_shared_memory=False``, and batches larger than a slot),
and with persistent workers after an abandoned epoch; every run's batches
equal to the reference's single-process loader over the same data,
exactly, with the ring / queue counts asserted.  The samplers' index
sequences equal the reference's under one ``np.random.seed``.  Files
written by either package's ``save`` load in the other's ``load``.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu import io as jio

import paddle_tpu_torch as tp
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io import shm_ring


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


@pytest.fixture(scope="module")
def lib():
    lib = shm_ring.get_lib()
    assert lib is not None, shm_ring._BUILD_ERR      # g++ builds the ring
    return lib


def _name(tag):
    return f"/pt_test_{tag}_{os.getpid()}"


def test_ring_roundtrip_and_recycling(lib):
    ring = shm_ring.ShmRing.create(_name("rt"), 4, 1 << 20)
    try:
        batch = [np.arange(1000, dtype="float32").reshape(10, 100),
                 {"labels": np.ones((10, 1), "int64"), "n": 7}]
        out = ring.get(ring.put(batch))
        np.testing.assert_array_equal(out[0], batch[0])
        np.testing.assert_array_equal(out[1]["labels"], batch[1]["labels"])
        assert out[1]["n"] == 7 and out[0].flags.writeable
        for i in range(10):                   # more puts than slots
            got = ring.get(ring.put({"i": i, "a": np.full((256,), i,
                                                          "int32")}))
            assert got["i"] == i and got["a"][0] == i
    finally:
        ring.close()
    assert not os.path.exists("/dev/shm" + _name("rt"))


def test_ring_oversize_payload_is_refused(lib):
    ring = shm_ring.ShmRing.create(_name("big"), 2, 1 << 12)
    try:
        assert ring.put(np.zeros((1 << 16,), "float32")) is None
    finally:
        ring.close()


def test_ring_attach_cross_handle(lib):
    """Producer and consumer on separate attachments (worker and main)."""
    name = _name("x")
    ring = shm_ring.ShmRing.create(name, 2, 1 << 16)
    other = shm_ring.ShmRing.attach(name, shm_ring.lib_path())
    try:
        arr = np.random.RandomState(0).randn(64, 8).astype("float32")
        np.testing.assert_array_equal(ring.get(other.put(arr)), arr)
    finally:
        other.close()
        ring.close()


def test_ring_larger_than_dev_shm_fails_when_made(lib):
    """The arena's pages are reserved at create: one that cannot fit fails
    there with ENOSPC (tmpfs refuses a request past its size without
    allocating), not at a later write with SIGBUS."""
    st = os.statvfs("/dev/shm")
    too_big = 2 * st.f_blocks * st.f_frsize
    with pytest.raises(OSError, match="shared-memory ring") as info:
        shm_ring.ShmRing.create(_name("huge"), 2, too_big // 2)
    assert info.value.errno != 0
    assert not os.path.exists("/dev/shm" + _name("huge"))


# ---------------------------------------------------------------------------
# the DataLoader
# ---------------------------------------------------------------------------


def _arrays(n=48, width=16):
    r = np.random.RandomState(3)
    return [r.randn(n, 32, width).astype("float32"),
            (np.arange(n) % 10).astype("int64")]


def _want(arrays, batch_size):
    """The reference's single-process loader over the same data."""
    jp.set_device("cpu")
    ds = jio.TensorDataset(arrays)
    return [[t.numpy() for t in b]
            for b in jio.DataLoader(ds, batch_size=batch_size)]


def _same(got, want):
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _run(loader):
    return [[t.numpy() for t in b] for b in loader]


def test_single_process_loader_matches_reference():
    arrays = _arrays()
    dl = tio.DataLoader(tio.TensorDataset(arrays), batch_size=8)
    got = _run(dl)
    _same(got, _want(arrays, 8))
    assert (dl.ring_batches, dl.queue_batches) == (0, 0)
    assert isinstance(next(iter(dl))[0], tp.Tensor)


@pytest.mark.parametrize("mode", ["ring", "queue", "oversize"])
def test_multiprocess_loader_matches_reference(mode, lib, monkeypatch):
    """2 spawned workers; the ring (1 MB slots), no shared memory, or
    batches of 1.3 MB against 1 MB slots (queue pickling)."""
    monkeypatch.setenv("PADDLE_SHM_SLOT_MB", "1")
    arrays = _arrays(width=1280 if mode == "oversize" else 16)
    dl = tio.DataLoader(tio.TensorDataset(arrays), batch_size=8,
                        num_workers=2, use_shared_memory=mode != "queue")
    got = _run(dl)
    _same(got, _want(arrays, 8))
    n = len(got)
    assert (dl.ring_batches, dl.queue_batches) == (
        (n, 0) if mode == "ring" else (0, n))
    assert not [f for f in os.listdir("/dev/shm")
                if f.startswith(f"pt_dl_{os.getpid()}_{id(dl)}_")]


def test_persistent_workers_drain_an_abandoned_epoch(lib, monkeypatch):
    """Breaking out of an epoch with batches in flight frees their slots
    and drops the stale messages: the next epoch is exact and in order."""
    monkeypatch.setenv("PADDLE_SHM_SLOT_MB", "1")
    arrays = _arrays()
    dl = tio.DataLoader(tio.TensorDataset(arrays), batch_size=8,
                        num_workers=2, persistent_workers=True)
    try:
        for i, _ in enumerate(dl):
            if i == 1:
                break
        _same(_run(dl), _want(arrays, 8))
        assert dl.queue_batches == 0
    finally:
        dl._shutdown_pool(dl._pool)
        dl._pool = None


def test_iterable_dataset_and_collate_match_reference():
    class Stream:
        def __init__(self, base):
            self.base = base

        def __iter__(self):
            for i in range(11):
                yield {"x": np.full((3,), i, "float32"), "y": i}

    class JStream(Stream, jio.IterableDataset):
        pass

    class TStream(Stream, tio.IterableDataset):
        pass

    jp.set_device("cpu")
    want = [{k: v.numpy() for k, v in b.items()}
            for b in jio.DataLoader(JStream(0), batch_size=4)]
    got = [{k: v.numpy() for k, v in b.items()}
           for b in tio.DataLoader(TStream(0), batch_size=4)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype
    with pytest.raises(TypeError):
        len(tio.DataLoader(TStream(0), batch_size=4))


# ---------------------------------------------------------------------------
# samplers and datasets
# ---------------------------------------------------------------------------


class _Range(list):
    pass


SAMPLERS = [
    ("RandomSampler", lambda m: list(m.RandomSampler(_Range(range(20))))),
    ("RandomSampler_replacement", lambda m: list(m.RandomSampler(
        _Range(range(20)), replacement=True, num_samples=30))),
    ("WeightedRandomSampler", lambda m: list(m.WeightedRandomSampler(
        [0.1, 0.5, 0.2, 0.2], 12))),
    ("BatchSampler_shuffle", lambda m: list(m.BatchSampler(
        _Range(range(23)), shuffle=True, batch_size=5))),
    ("BatchSampler_drop_last", lambda m: list(m.BatchSampler(
        _Range(range(23)), batch_size=5, drop_last=True))),
    ("DistributedBatchSampler", lambda m: [
        list(m.DistributedBatchSampler(_Range(range(22)), 3, num_replicas=4,
                                       rank=r, shuffle=True))
        for r in range(4)]),
    ("random_split", lambda m: [list(s.indices) for s in m.random_split(
        _Range(range(17)), [5, 12])]),
]


@pytest.mark.parametrize("name,draw", SAMPLERS, ids=[s[0] for s in SAMPLERS])
def test_sampler_indices_match_reference(name, draw):
    np.random.seed(5)
    want = draw(jio)
    np.random.seed(5)
    got = draw(tio)
    assert got == want


def test_distributed_batch_sampler_shards_are_disjoint(monkeypatch):
    shards = []
    for r in range(4):
        s = tio.DistributedBatchSampler(_Range(range(16)), 2, num_replicas=4,
                                        rank=r, shuffle=True)
        s.set_epoch(3)
        shards.append([i for b in s for i in b])
    assert all(len(x) == 4 for x in shards)
    assert sorted(i for x in shards for i in x) == list(range(16))
    # the rank and world size come from the launcher's environment
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    s = tio.DistributedBatchSampler(_Range(range(16)), 2, shuffle=True)
    s.set_epoch(3)
    assert (s.local_rank, s.nranks) == (2, 4)
    assert [i for b in s for i in b] == shards[2]


def test_datasets_match_reference():
    arrays = _arrays(10)
    pairs = [(jio.TensorDataset(arrays), tio.TensorDataset(arrays)),
             (jio.ComposeDataset([jio.TensorDataset(arrays)] * 2),
              tio.ComposeDataset([tio.TensorDataset(arrays)] * 2)),
             (jio.Subset(jio.TensorDataset(arrays), [3, 1, 7]),
              tio.Subset(tio.TensorDataset(arrays), [3, 1, 7]))]
    for a, b in pairs:
        assert len(a) == len(b)
        for i in range(len(a)):
            for x, y in zip(a[i], b[i]):
                np.testing.assert_array_equal(y, x)
    assert tio.get_worker_info() is None


# ---------------------------------------------------------------------------
# save / load across the packages
# ---------------------------------------------------------------------------


def _state(P):
    with (jp if P is jp else tp).framework.unique_name.guard():
        P.seed(0)
        layer = P.nn.Linear(4, 3)
    return {"model": layer.state_dict(), "step": 7,
            "nested": [P.to_tensor(np.arange(6, dtype="int64")),
                       (P.to_tensor(np.ones((2, 2), "float32")), "tag")]}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_saved_files_load_in_the_other_package(writer, tmp_path):
    jp.set_device("cpu")
    path = str(tmp_path / "sub" / "ckpt.pdparams")
    src, dst = (jp, tp) if writer == "reference" else (tp, jp)
    state = _state(src)
    src.save(state, path)
    loaded = dst.load(path)
    as_np = dst.load(path, return_numpy=True)
    assert loaded["step"] == 7 and loaded["nested"][1][1] == "tag"
    assert isinstance(loaded["nested"][1], tuple)
    for k, v in state["model"].items():
        got = loaded["model"][k]
        assert isinstance(got, dst.Tensor)
        assert got.name == v.name and got.stop_gradient == v.stop_gradient
        np.testing.assert_array_equal(got.numpy(), v.numpy())
        np.testing.assert_array_equal(as_np["model"][k], v.numpy())
    np.testing.assert_array_equal(loaded["nested"][0].numpy(),
                                  np.arange(6, dtype="int64"))
    assert loaded["nested"][0].numpy().dtype == np.int64


def test_load_gives_tensors_on_the_current_place(tmp_path):
    path = str(tmp_path / "t.pd")
    tp.save({"w": tp.to_tensor(np.ones(3, "float32"))}, path)
    got = tp.load(path)["w"]
    assert got._t.device == torch.device("cpu")
    assert tp.io is tio and tp.reader is not None

"""``paddle.io``: datasets, samplers and the DataLoader.

Counterpart of ``paddle_tpu/io/__init__.py``, class for class.  The
multi-process path ships each batch's control message over a queue and its
array payloads through a shared-memory slot ring (``csrc/shm_ring.cc``,
built at first use by :mod:`paddle_tpu_torch.utils.cpp_extension`): pickle
protocol 5 with out-of-band buffers, one memcpy each way.  A batch larger
than a slot (``PADDLE_SHM_SLOT_MB``, 64 by default) goes by queue pickling,
as does every batch when no compiler can build the ring; the loader counts
how each batch travelled (:attr:`DataLoader.ring_batches`,
:attr:`DataLoader.queue_batches`).  A ring that does not fit ``/dev/shm``
raises when the workers start (:mod:`.shm_ring`).

Workers start with ``spawn``: the parent holds a CUDA context, which a
fork must not copy.  A worker runs the dataset and the collate function
over numpy and never touches the card.  The main process stages each batch
on the current place as port Tensors: on the card from pinned memory,
with ``non_blocking=True``.
"""

from __future__ import annotations

import itertools
import math
import os
import queue
import threading
from typing import Any, Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "BatchSampler", "DistributedBatchSampler", "DataLoader", "get_worker_info",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not indexable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        arrays = [np.asarray(t.numpy() if hasattr(t, "numpy") else t) for t in tensors]
        assert all(a.shape[0] == arrays[0].shape[0] for a in arrays)
        self.tensors = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    assert sum(lengths) == len(dataset)
    perm = np.random.permutation(len(dataset))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off : off + n].tolist()))
        off += n
    return out


# -- samplers ---------------------------------------------------------------


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype="float64")
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(p), self.num_samples, replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        assert (dataset is None) != (sampler is None)
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Each rank sees a disjoint shard; the rank and world size come from
    :mod:`paddle_tpu_torch.distributed.env` unless given."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        from ..distributed import env as dist_env

        self.nranks = num_replicas if num_replicas is not None else dist_env.get_world_size()
        self.local_rank = rank if rank is not None else dist_env.get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        # pad so every rank gets the same count
        pad = self.total_size - n
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        shard = indices[self.local_rank : self.total_size : self.nranks]
        batch = []
        for idx in shard.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


# -- collate ----------------------------------------------------------------


def default_collate_fn(batch: List[Any]):
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype="int64")
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype="float32")
    if hasattr(sample, "numpy"):
        return np.stack([np.asarray(s.numpy()) for s in batch])
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(items)) for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return np.asarray(batch)


_worker_info = threading.local()


def get_worker_info():
    return getattr(_worker_info, "info", None)


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


# -- DataLoader -------------------------------------------------------------


def _stage(x: np.ndarray, dev: torch.device):
    """``x`` as a port Tensor on ``dev``; to the card from pinned memory,
    without waiting for the copy."""
    from ..dygraph.tensor import Tensor, _as_torch

    t = _as_torch(x, device=torch.device("cpu"))
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return Tensor._wrap(t)


def _to_device(batch, return_list=True):
    """Stage a collated batch's numpy arrays as Tensors on the current
    place."""
    from ..framework.place import current_device

    dev = current_device()

    def conv(x):
        if isinstance(x, np.ndarray):
            return _stage(x, dev)
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return x

    if isinstance(batch, (list, tuple)):
        return [conv(b) for b in batch]
    return conv(batch)


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_id,
                 num_workers, worker_init_fn, shm_name=None, shm_so=None):
    """One worker: index lists in, batches out.  With the ring, each
    batch's array buffers go out of band through a shared-memory slot and
    only a small control message rides the queue; otherwise (no ring, or a
    batch larger than a slot) the whole batch is pickled through the
    queue."""
    _worker_info.info = WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    ring = None
    if shm_name is not None:
        from . import shm_ring as _sr

        ring = _sr.ShmRing.attach(shm_name, shm_so)
    while True:
        item = index_queue.get()
        if item is None:
            break
        gen, seq, indices = item
        try:
            batch = collate_fn([dataset[i] for i in indices])
            slot = ring.put(batch) if ring is not None else None
            if slot is not None:
                data_queue.put((gen, seq, worker_id, "shm", slot))
            else:
                data_queue.put((gen, seq, worker_id, "pkl", batch))
        except Exception as e:  # ship the error to the main process
            import traceback

            data_queue.put((gen, seq, worker_id, "err", RuntimeError(
                f"DataLoader worker {worker_id} failed: {e}\n{traceback.format_exc()}"
            )))
    if ring is not None:
        ring.close()


class DataLoader:
    """The reference's DataLoader (the 2.x iterable form).

    :attr:`ring_batches` and :attr:`queue_batches` count the batches the
    workers sent through the shared-memory ring and by queue pickling,
    over the loader's life."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 use_shared_memory=True, prefetch_factor=2, timeout=60,
                 worker_init_fn=None, persistent_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.timeout = timeout
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._pool = None  # (index_queues, data_queue, workers, rings) when persistent
        self.ring_batches = 0
        self.queue_batches = 0
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_size = batch_size
            self.drop_last = drop_last
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last,
            )

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset-backed DataLoader has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable_mode:
            yield from self._iter_iterable()
        elif self.num_workers == 0:
            yield from self._iter_single()
        else:
            yield from self._iter_multiprocess()

    # -- single process ---------------------------------------------------
    def _iter_single(self):
        for indices in self.batch_sampler:
            batch = self.collate_fn([self.dataset[i] for i in indices])
            yield _to_device(batch, self.return_list)

    def _iter_iterable(self):
        buf = []
        for sample in self.dataset:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield _to_device(self.collate_fn(buf), self.return_list)
                buf = []
        if buf and not self.drop_last:
            yield _to_device(self.collate_fn(buf), self.return_list)

    # -- multi process ----------------------------------------------------
    def _spawn_pool(self):
        import multiprocessing as mp

        # spawn, not fork: the parent holds a CUDA context (and threads),
        # which a forked child must not inherit; workers only need numpy
        ctx = mp.get_context("spawn")
        index_queues = [ctx.Queue() for _ in range(self.num_workers)]
        data_queue = ctx.Queue()
        rings = {}
        shm_so = None
        if self.use_shared_memory:
            from . import shm_ring as _sr

            shm_so = _sr.lib_path()
        workers = []
        for wid in range(self.num_workers):
            shm_name = None
            if shm_so is not None:
                from . import shm_ring as _sr

                slot_mb = int(os.environ.get("PADDLE_SHM_SLOT_MB", "64"))
                shm_name = f"/pt_dl_{os.getpid()}_{id(self)}_{wid}"
                try:
                    rings[wid] = _sr.ShmRing.create(
                        shm_name, nslots=self.prefetch_factor + 2,
                        slot_bytes=slot_mb << 20)
                except OSError:
                    self._shutdown_pool((index_queues, data_queue, workers,
                                         rings))
                    raise
            w = ctx.Process(
                target=_worker_loop,
                args=(self.dataset, index_queues[wid], data_queue,
                      self.collate_fn, wid, self.num_workers,
                      self.worker_init_fn, shm_name, shm_so),
                daemon=True,
            )
            w.start()
            workers.append(w)
        return index_queues, data_queue, workers, rings

    def _shutdown_pool(self, pool):
        index_queues, _, workers, rings = pool
        for q in index_queues:
            q.put(None)
        for w in workers:
            w.join(timeout=1)
            if w.is_alive():
                w.terminate()
        for r in rings.values():
            r.close()

    def __del__(self):
        if self._pool is not None:
            try:
                self._shutdown_pool(self._pool)
            except Exception:
                pass
            self._pool = None

    def _iter_multiprocess(self):
        if self.persistent_workers:
            if self._pool is None:
                self._pool = self._spawn_pool()
            index_queues, data_queue, workers, rings = self._pool
        else:
            index_queues, data_queue, workers, rings = self._spawn_pool()
        # Generation id: every epoch's messages are tagged, so a batch a
        # worker was still computing when the previous epoch was abandoned
        # is recognized and dropped instead of colliding with the new
        # epoch's restarted seq numbering.
        self._generation = getattr(self, "_generation", 0) + 1
        gen = self._generation
        inflight = 0
        try:
            batches = list(self.batch_sampler)
            n = len(batches)
            next_send = 0
            # prefetch_factor batches per worker in flight
            max_inflight = self.prefetch_factor * self.num_workers
            reorder = {}
            next_yield = 0
            while next_yield < n:
                while next_send < n and inflight < max_inflight:
                    index_queues[next_send % self.num_workers].put(
                        (gen, next_send, batches[next_send])
                    )
                    next_send += 1
                    inflight += 1
                mgen, seq, wid, kind, payload = data_queue.get(
                    timeout=self.timeout)
                if mgen != gen:
                    # stale message from an abandoned epoch: release its shm
                    # slot and ignore it (it was never counted in inflight)
                    if kind == "shm":
                        rings[wid].release(payload)
                    continue
                inflight -= 1
                if kind == "err":
                    raise payload
                if kind == "shm":
                    payload = rings[wid].get(payload)
                    self.ring_batches += 1
                else:
                    self.queue_batches += 1
                reorder[seq] = payload
                while next_yield in reorder:
                    yield _to_device(reorder.pop(next_yield), self.return_list)
                    next_yield += 1
        finally:
            if not self.persistent_workers:
                self._shutdown_pool((index_queues, data_queue, workers, rings))
            elif inflight > 0:
                # epoch abandoned mid-flight (break / worker error): best-
                # effort drain to free shm slots promptly; anything a worker
                # is still computing is caught by the generation check above
                while inflight > 0:
                    try:
                        mgen, _seq, wid, kind, payload = data_queue.get(
                            timeout=1.0)
                    except queue.Empty:
                        break
                    if mgen == gen:
                        inflight -= 1
                    if kind == "shm":
                        rings[wid].release(payload)

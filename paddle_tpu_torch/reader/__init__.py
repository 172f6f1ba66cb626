"""Reader-creator combinators: ``paddle.reader``.

Counterpart of ``paddle_tpu/reader/__init__.py``, function for function.
A *reader creator* is a zero-argument callable returning an iterable of
samples; ``paddle_tpu_torch.batch`` consumes them.  The combinators are
host-side data plumbing (pure Python, threads for ``xmap_readers`` and
``multiprocess_reader``), independent of the device.
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading

__all__ = []


def cache(reader):
    """Cache the first full pass in memory; later passes replay it."""
    all_data = tuple(reader())

    def __impl__():
        for item in all_data:
            yield item

    return __impl__


def map_readers(func, *readers):
    """Yield ``func(*samples)`` over the zipped component readers."""

    def reader():
        rs = [r() for r in readers]
        for e in map(func, *rs):
            yield e

    return reader


def shuffle(reader, buf_size):
    """Shuffle within a sliding buffer of ``buf_size`` samples."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if len(buf) > 0:
            _random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate the outputs of the component readers in order."""

    def reader():
        rs = [r() for r in readers]
        for e in itertools.chain(*rs):
            yield e

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip component readers into tuple samples; with
    ``check_alignment=True`` (default) a length mismatch raises
    :class:`ComposeNotAligned`."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    """Prefetch up to ``size`` samples through a background thread."""

    class EndSignal:
        pass

    end = EndSignal()

    def read_worker(r, q):
        for d in r:
            q.put(d)
        q.put(end)

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)
        t = threading.Thread(target=read_worker, args=(r, q))
        t.daemon = True
        t.start()
        e = q.get()
        while e is not end:
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    """Limit the reader to its first ``n`` samples."""

    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


class XmapEndSignal:
    pass


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Apply ``mapper`` over the reader with ``process_num`` worker
    THREADS and a ``buffer_size`` queue; ``order=True`` preserves input
    order.  (Threads, not processes, as in the reference package: the
    mappers are IO- or numpy-bound in practice.)"""
    end = XmapEndSignal()

    def read_worker(r, in_q):
        for i in r():
            in_q.put(i)
        in_q.put(end)

    def order_read_worker(r, in_q):
        for i, x in enumerate(r()):
            in_q.put((i, x))
        in_q.put(end)

    def handle_worker(in_q, out_q, m):
        sample = in_q.get()
        while not isinstance(sample, XmapEndSignal):
            out_q.put(m(sample))
            sample = in_q.get()
        in_q.put(end)
        out_q.put(end)

    def order_handle_worker(in_q, out_q, m, out_order, cond):
        ins = in_q.get()
        while not isinstance(ins, XmapEndSignal):
            order_id, sample = ins
            result = m(sample)
            with cond:
                while order_id != out_order[0]:
                    cond.wait()
                out_q.put(result)
                out_order[0] += 1
                cond.notify_all()
            ins = in_q.get()
        in_q.put(end)
        out_q.put(end)

    def xreader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        out_order = [0]
        cond = threading.Condition()
        target = order_read_worker if order else read_worker
        t = threading.Thread(target=target, args=(reader, in_q))
        t.daemon = True
        t.start()
        workers = []
        for _ in range(process_num):
            if order:
                w = threading.Thread(target=order_handle_worker,
                                     args=(in_q, out_q, mapper, out_order,
                                           cond))
            else:
                w = threading.Thread(target=handle_worker,
                                     args=(in_q, out_q, mapper))
            w.daemon = True
            w.start()
            workers.append(w)
        finish = 0
        while finish < process_num:
            sample = out_q.get()
            if isinstance(sample, XmapEndSignal):
                finish += 1
            else:
                yield sample

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave multiple readers concurrently, one thread each (a fork
    would copy the parent's CUDA context; the DataLoader's spawned workers
    are the heavy-data path)."""
    assert len(readers) > 0, "readers must not be empty"
    end = XmapEndSignal()

    def read_into(r, q):
        try:
            for s in r():
                q.put(s)
        finally:
            q.put(end)

    def reader():
        q = queue.Queue(queue_size)
        for r in readers:
            t = threading.Thread(target=read_into, args=(r, q))
            t.daemon = True
            t.start()
        finish = 0
        while finish < len(readers):
            s = q.get()
            if isinstance(s, XmapEndSignal):
                finish += 1
            else:
                yield s

    return reader

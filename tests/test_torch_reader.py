"""The port's reader combinators and ``batch`` against the reference's, on
the CPU: the cases of ``tests/test_reader_compat.py``, each run with both
packages and compared sample for sample (``shuffle`` under one
``random.seed``; the unordered ``xmap_readers`` and
``multiprocess_reader`` as multisets, their order being the threads')."""

import random

import pytest

import paddle_tpu as jp
from paddle_tpu import reader as jreader

import paddle_tpu_torch as tp
from paddle_tpu_torch import reader as treader


def _r(n=10):
    return lambda: iter(range(n))


def _both(build, ordered=True):
    """``build(reader_module)`` -> reader creator, run under one seed in
    each package; the samples are equal (as multisets if not ordered)."""
    out = []
    for mod in (jreader, treader):
        random.seed(7)
        out.append(list(build(mod)()))
    want, got = out
    if ordered:
        assert got == want
    else:
        assert sorted(got) == sorted(want)
    return got


def test_cache_reads_its_source_once():
    calls = []

    def creator():
        calls.append(1)
        return iter(range(5))

    c = treader.cache(creator)
    assert list(c()) == list(c()) == list(range(5))
    assert len(calls) == 1


@pytest.mark.parametrize("name,build,ordered,want", [
    ("map_readers", lambda R: R.map_readers(lambda a, b: a + b, _r(4),
                                            _r(4)), True, [0, 2, 4, 6]),
    ("shuffle", lambda R: R.shuffle(_r(20), 7), True, None),
    ("chain", lambda R: R.chain(_r(3), _r(2)), True, [0, 1, 2, 0, 1]),
    ("compose", lambda R: R.compose(_r(3), lambda: iter("abc")), True,
     [(0, "a"), (1, "b"), (2, "c")]),
    ("compose_unaligned", lambda R: R.compose(_r(3), _r(5),
                                              check_alignment=False), True,
     [(0, 0), (1, 1), (2, 2)]),
    ("buffered", lambda R: R.buffered(_r(6), 2), True, list(range(6))),
    ("firstn", lambda R: R.firstn(_r(100), 4), True, [0, 1, 2, 3]),
    ("xmap_ordered", lambda R: R.xmap_readers(lambda x: x * x, _r(25), 4, 8,
                                              order=True), True,
     [i * i for i in range(25)]),
    ("xmap_unordered", lambda R: R.xmap_readers(lambda x: x * x, _r(25), 4,
                                                8), False,
     [i * i for i in range(25)]),
    ("multiprocess_reader", lambda R: R.multiprocess_reader([_r(5), _r(5)]),
     False, list(range(5)) * 2),
])
def test_reader_matches_reference(name, build, ordered, want):
    got = _both(build, ordered)
    if want is not None:
        assert (got if ordered else sorted(got)) == (
            want if ordered else sorted(want))
    if name == "shuffle":
        assert sorted(got) == list(range(20)) and got != list(range(20))


def test_compose_alignment_raises_in_both():
    for mod in (jreader, treader):
        with pytest.raises(mod.ComposeNotAligned):
            list(mod.compose(_r(3), _r(5))())


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_matches_reference(drop_last):
    want = list(jp.batch(_r(10), 3, drop_last=drop_last)())
    got = list(tp.batch(_r(10), 3, drop_last=drop_last)())
    assert got == want
    with pytest.raises(ValueError):
        tp.batch(_r(10), 0)

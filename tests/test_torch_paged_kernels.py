"""The port's paged attention kernels against the JAX reference.

On the CPU the port's wrappers take their plain PyTorch versions; those are
held here, at fp32 and rtol = atol = 1e-5, against both the reference's
jnp oracles (``paged_attention_ref`` / ``paged_prefill_ref``) and its
Pallas kernels run by the interpreter, on the same numpy inputs: MHA, GQA
and sliding window, ragged lengths, chunk starts past 0 and chunk widths
that are not powers of two.  The CUDA kernels themselves are compared with
the plain versions on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.kernels import paged_prefill as jpp
from paddle_tpu_torch.kernels import (KERNELS, paged_attention,
                                      paged_attention_plain, paged_prefill,
                                      paged_prefill_plain)
from torch_parity import interpretable  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)

def _pages(rng, P, HKV, PS, D):
    return (rng.randn(P, HKV, PS, D).astype("float32"),
            rng.randn(P, HKV, PS, D).astype("float32"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("window", [None, 12], ids=["full", "win"])
@pytest.mark.parametrize("group", [1, 2, 4], ids=["mha", "gqa2", "gqa4"])
def test_decode_plain_matches_reference(group, window, interpretable):
    rng = np.random.RandomState(17 * group)
    B, HKV, D, PS, MAXP, P = 3, 2, 16, 8, 4, 10
    q = rng.randn(B, HKV * group, D).astype("float32")
    kp, vp = _pages(rng, P, HKV, PS, D)
    bt = rng.randint(1, P, (B, MAXP)).astype("int32")
    lens = np.array([5, 17, 32], "int32")        # ragged, one slot full
    out = paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lens),
                          window=window).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, lens)]
    ref = np.asarray(jpa.paged_attention_ref(*jargs, window=window))
    kern = np.asarray(jpa.paged_attention(*jargs, window=window,
                                          interpret=True))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, kern, **TOL)


@pytest.mark.parametrize("start,chunk", [(0, 8), (13, 8), (5, 6)],
                         ids=["start0", "start13", "ragged6"])
@pytest.mark.parametrize("window", [None, 5], ids=["full", "win"])
@pytest.mark.parametrize("group", [1, 2, 4], ids=["mha", "gqa2", "gqa4"])
def test_prefill_plain_matches_reference(group, window, start, chunk,
                                         interpretable):
    rng = np.random.RandomState(53 * group + start)
    HKV, D, PS, MAXP, P = 2, 16, 8, 4, 9
    q = rng.randn(chunk, HKV * group, D).astype("float32")
    kp, vp = _pages(rng, P, HKV, PS, D)
    bt = rng.randint(1, P, (MAXP,)).astype("int32")
    out = paged_prefill(_t(q), _t(kp), _t(vp), _t(bt), start,
                        window=window).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt)]
    ref = np.asarray(jpp.paged_prefill_ref(*jargs, start, window=window))
    kern = np.asarray(jpp.paged_prefill(*jargs, start, window=window,
                                        interpret=True))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, kern, **TOL)


def test_decode_masked_positions_cannot_influence_output():
    """Positions at or past ``lengths``, below the window, and the null
    page's contents do not reach the output: rewriting them changes
    nothing, bit for bit."""
    rng = np.random.RandomState(2)
    P, HKV, PS, D, W = 6, 2, 8, 16, 10
    q = _t(rng.randn(2, 4, D).astype("float32"))             # group 2
    kp, vp = _pages(rng, P, HKV, PS, D)
    bt = _t(np.array([[1, 2, 3], [4, 5, 0]], "int32"))        # 0: null page
    lens = _t(np.array([20, 11], "int32"))
    a = paged_attention_plain(q, _t(kp), _t(vp), bt, lens, window=W)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[1], vp2[1] = 99.0, -99.0      # slot 0: positions 0..7 < 20 - 10
    kp2[2, :, :2] = 55.0              # slot 0: positions 8, 9 below window
    kp2[3, :, 4:] = 7.0               # slot 0: positions 20.. >= length
    kp2[5, :, 3:], vp2[5, :, 3:] = 9.0, -9.0   # slot 1: 11.. >= length
    kp2[0], vp2[0] = 5.0, 5.0         # the null page
    b = paged_attention_plain(q, _t(kp2), _t(vp2), bt, lens, window=W)
    assert torch.equal(a, b)


def test_prefill_masked_positions_cannot_influence_output():
    """Chunk row i sees exactly positions <= start + i: later positions
    (stale tail garbage, unwritten pool zeros) leave its output alone."""
    rng = np.random.RandomState(42)
    P, H, PS, D, C, start = 5, 2, 8, 16, 4, 9
    q = _t(rng.randn(C, H, D).astype("float32"))
    kp, vp = _pages(rng, P, H, PS, D)
    bt = _t(np.array([1, 2, 3], "int32"))
    a = paged_prefill_plain(q, _t(kp), _t(vp), bt, start)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[2, :, 3:], vp2[2, :, 3:] = 99.0, -99.0    # positions 11..15
    kp2[3], vp2[3] = 7.0, 7.0                     # positions 16..23
    b = paged_prefill_plain(q, _t(kp2), _t(vp2), bt, start)
    assert torch.equal(a[:2], b[:2])              # rows see <= 9, <= 10
    assert not torch.equal(a[2:], b[2:])


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.RandomState(5)
    kp, vp = _pages(rng, 4, 2, 8, 16)
    q = _t(rng.randn(2, 2, 16).astype("float32"))
    bt = _t(np.array([[1, 2], [3, 0]], "int32"))
    lens = _t(np.array([9, 3], "int32"))
    before = dict(KERNELS)
    a = paged_attention(q, _t(kp), _t(vp), bt, lens)
    assert torch.equal(a, paged_attention_plain(q, _t(kp), _t(vp), bt, lens))
    c = paged_prefill(q, _t(kp), _t(vp), bt[0], 7)
    assert torch.equal(c, paged_prefill_plain(q, _t(kp), _t(vp), bt[0], 7))
    assert KERNELS == before


# (batch, kv_heads, max_pages, page_size): the smoke's timed and GQA
# shapes, one page, pages smaller and larger than the kernel's 32-key
# tiles, and wide tables that need many splits
PLAN_SHAPES = [(8, 16, 64, 32), (8, 4, 64, 32), (1, 1, 1, 32), (3, 2, 7, 8),
               (64, 16, 512, 16), (2, 8, 33, 128), (16, 2, 1000, 32),
               (10, 2, 24, 32)]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["-".join(map(str, s)) for s in PLAN_SHAPES])
def test_split_plan_covers_every_page_once(shape):
    """Every block-table entry lies in exactly one split, no split is
    empty, and a split spans at least SPLIT_MIN_POSITIONS positions unless
    the whole table is shorter."""
    from paddle_tpu_torch.kernels.paged_attention import (
        SPLIT_MIN_POSITIONS, split_plan)

    batch, kv_heads, max_pages, page_size = shape
    pps, n_split = split_plan(*shape)
    cover = np.zeros(max_pages, int)
    for s in range(n_split):
        lo, hi = s * pps, min((s + 1) * pps, max_pages)
        assert lo < hi
        cover[lo:hi] += 1
    assert (cover == 1).all()
    assert pps * page_size >= min(SPLIT_MIN_POSITIONS, max_pages * page_size)


class _Untouchable(torch.Tensor):
    """A lengths tensor that fails every use but handing over its
    address, as the CUDA path may."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.data_ptr:
            return super().__torch_function__(func, types, args, kwargs or {})
        raise AssertionError(f"the wrapper read lengths ({func})")


@pytest.mark.parametrize("t,dtype", [(None, torch.bfloat16),
                                     (5, torch.bfloat16),
                                     (None, torch.float16),
                                     (5, torch.float16)],
                         ids=["decode", "verify", "decode-fp16",
                              "verify-fp16"])
@pytest.mark.parametrize("shape", PLAN_SHAPES[:4],
                         ids=["-".join(map(str, s)) for s in PLAN_SHAPES[:4]])
def test_cuda_launch_plans_from_shapes_alone(monkeypatch, shape, t, dtype):
    """The launch the wrappers make for bf16 and fp16 queries: the kernel
    gets split_plan's pages per split and a workspace exactly when there
    is more than one split, its dtype code (1 bf16, 2 fp16), and lengths
    only by address: the plan reads nothing from the device."""
    import importlib
    import types

    from paddle_tpu_torch.kernels import _build
    mod = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")

    batch, hkv, maxp, ps = shape
    calls = []
    monkeypatch.setattr(_build, "kernel",
                        lambda name: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    h, d = 2 * hkv, 16
    q = torch.zeros((batch, h, d) if t is None else (batch, t, h, d),
                    dtype=dtype)
    pages = torch.zeros(1 + batch * maxp, hkv, ps, d, dtype=dtype)
    bt = torch.zeros(batch, maxp, dtype=torch.int32)
    lens = torch.zeros(batch, dtype=torch.int32).as_subclass(_Untouchable)
    name = "paged_attention" if t is None else "paged_attention_mq"
    mod._launch(name, q, pages, pages, bt, lens, None, None, 0, None, None)
    pps, n_split = mod.split_plan(batch, hkv, maxp, ps)
    args = calls[0]
    ws, pps_arg = args[8], args[16 if t is None else 17]
    assert pps_arg == pps
    assert (ws is not None) == (n_split > 1)
    assert args[-3] == (2 if dtype == torch.float16 else 1)


# (chunk, heads, kv_heads, max_pages, page_size): the smoke's timed chunk
# and the engine's smallest bucket at GPT-1.3B's shapes, GQA, one-row and
# ragged chunks, pages smaller and larger than a 32-key tile, and a wide
# table
PREFILL_PLAN_SHAPES = [(128, 16, 16, 64, 32), (8, 16, 16, 64, 32),
                       (128, 16, 4, 64, 32), (1, 2, 2, 48, 32),
                       (40, 16, 2, 48, 32), (128, 8, 8, 33, 8),
                       (64, 32, 32, 512, 16), (16, 4, 1, 7, 128)]


@pytest.mark.parametrize("shape", PREFILL_PLAN_SHAPES,
                         ids=["-".join(map(str, s))
                              for s in PREFILL_PLAN_SHAPES])
def test_prefill_plan_covers_every_page_once(shape):
    """Every block-table entry lies in exactly one split, no split is
    empty, and a split spans at least PREFILL_MIN_POSITIONS positions
    unless the whole table is shorter; the plan reaches SPLIT_BLOCKS
    blocks unless the splits are at their smallest."""
    from paddle_tpu_torch.kernels.paged_attention import SPLIT_BLOCKS
    from paddle_tpu_torch.kernels.paged_prefill import (
        PREFILL_MIN_POSITIONS, PREFILL_ROWS, prefill_plan)

    chunk, heads, kv_heads, max_pages, page_size = shape
    pps, n_split = prefill_plan(*shape)
    cover = np.zeros(max_pages, int)
    for s in range(n_split):
        lo, hi = s * pps, min((s + 1) * pps, max_pages)
        assert lo < hi
        cover[lo:hi] += 1
    assert (cover == 1).all()
    least = -(-PREFILL_MIN_POSITIONS // page_size)
    assert pps >= min(least, max_pages)
    blocks = kv_heads * -(-chunk * (heads // kv_heads) // PREFILL_ROWS)
    assert blocks * n_split >= SPLIT_BLOCKS or pps <= least \
        or n_split == max_pages


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16],
                         ids=["bf16", "fp32", "fp16"])
@pytest.mark.parametrize("shape", PREFILL_PLAN_SHAPES[:5],
                         ids=["-".join(map(str, s))
                              for s in PREFILL_PLAN_SHAPES[:5]])
def test_cuda_prefill_launch_plans_from_shapes_alone(monkeypatch, shape,
                                                     dtype):
    """The launch the prefill wrapper makes: bf16 and fp16 queries get
    prefill_plan's pages per split and a workspace exactly when there is
    more than one split, the same at every start (one grid per chunk
    bucket); fp32 queries take the whole table and no workspace.  The
    kernel gets q's dtype code."""
    import importlib
    import types

    from paddle_tpu_torch.kernels import _build
    mod = importlib.import_module("paddle_tpu_torch.kernels.paged_prefill")

    chunk, heads, hkv, maxp, ps = shape
    calls = []
    monkeypatch.setattr(_build, "kernel",
                        lambda name: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    d = 16
    q = torch.zeros(chunk, heads, d, dtype=dtype)
    pages = torch.zeros(1 + maxp, hkv, ps, d, dtype=dtype)
    bt = torch.zeros(maxp, dtype=torch.int32)
    starts = (0, 37, maxp * ps - chunk)
    for start in starts:
        mod._launch(q, pages, pages, bt, start, None, None, 0, None, None)
    pps, n_split = mod.prefill_plan(chunk, heads, hkv, maxp, ps)
    for args, start in zip(calls, starts):
        ws, start_arg, pps_arg = args[7], args[8], args[16]
        assert start_arg == start
        assert args[-3] == {torch.float32: 0, torch.bfloat16: 1,
                            torch.float16: 2}[dtype]
        if dtype != torch.float32:
            assert pps_arg == pps
            assert (ws is not None) == (n_split > 1)
        else:
            assert pps_arg == maxp and ws is None

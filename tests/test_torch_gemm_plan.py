"""The W8A8 GEMM's launch plan and wrapper on the CPU, and its plain
version at the edge shapes.

``gemm_plan`` (``paddle_tpu_torch/kernels/int8_gemm.py``) decides from the
shapes alone which body of ``csrc/w8a8_gemm.cu`` runs and how it cuts K:
every 64-byte chunk of K lies in exactly one split, the path only ever
turns from the split body to the wgmma body as M grows, and the scratch
the wrapper allocates holds xq and sx alone.  The launch is checked
with the C entry point replaced by a recorder.  ``w8a8_gemm_plain`` is
held against the reference's ``w8a8_gemm_ref`` and its Pallas kernel run
by the interpreter at the ragged row counts the kernel now takes (1, 65,
129): xq and sx bit for bit, the output to 1e-6 relative (the reference's
own two paths differ by rescale rounding).  The kernel itself is held
against the plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import int8_gemm as jgemm
from paddle_tpu.ops import quant_ops as jq
from paddle_tpu_torch.kernels import _build, int8_gemm
from paddle_tpu_torch.kernels.int8_gemm import (GEMM_CROSSOVER, GEMM_KC,
                                                SPLIT_BLOCKS, SPLIT_BN,
                                                SPLIT_MAX, GemmPlan,
                                                gemm_plan, w8a8_gemm_plain)
from torch_parity import interpretable  # noqa: F401

# (K, N) of GPT-1.3B's four projections (the serving runs) and of the
# training flagship's (run (d))
SERVING = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048)]
TRAINING = [(1536, 4608), (1536, 1536), (1536, 6144), (6144, 1536)]
# (M, N, K): decode, verify and prefill rows at the serving shapes, the
# training rows, the edges (one row, ragged rows around the tiles, one
# K chunk, the narrowest N) and a long K
PLAN_SHAPES = ([(m, n, k) for k, n in SERVING for m in (8, 40, 128)]
               + [(12288, n, k) for k, n in TRAINING]
               + [(1, 48, 64), (65, 48, 64), (129, 48, 64), (17, 16, 128),
                  (300, 4608, 1536), (8, 2048, 16384)])
IDS = ["x".join(map(str, s)) for s in PLAN_SHAPES]


def _chunks_of(plan, k):
    """How often each 64-byte chunk of K is taken across the splits."""
    chunks = k // GEMM_KC
    cover = np.zeros(chunks, int)
    for s in range(plan.n_split):
        lo = s * plan.chunks_per_split
        hi = min(lo + plan.chunks_per_split, chunks)
        assert lo < hi, "an empty split"
        cover[lo:hi] += 1
    return cover


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=IDS)
@pytest.mark.parametrize("path", [None, "split", "wgmma"])
def test_gemm_plan_covers_every_chunk_once(shape, path):
    """Every 64-byte K chunk lies in exactly one split, on the plan's own
    path and on each forced one; the wgmma path takes K whole; the split
    path's own count is a power of two, as many splits as keep the grid
    within SPLIT_BLOCKS blocks, at most SPLIT_MAX (one cluster)."""
    m, n, k = shape
    plan = gemm_plan(m, n, k, path=path)
    assert (_chunks_of(plan, k) == 1).all()
    if plan.path == "wgmma":
        assert plan.n_split == 1
        wide = -(-m // 128) * -(-n // 256) >= int8_gemm.WGMMA_SMS
        assert (plan.bm, plan.bn) == (128, 256 if wide else 128)
        return
    assert (plan.bm, plan.bn) == (16, SPLIT_BN)
    tiles = -(-m // plan.bm) * -(-n // plan.bn)
    if path is None:
        # a power of two of splits, as many as keep the grid within
        # SPLIT_BLOCKS blocks (or the chunks run out), at most SPLIT_MAX
        want = plan.n_split if plan.chunks_per_split > 1 else None
        if want is not None:
            assert want & (want - 1) == 0 and want <= SPLIT_MAX
            assert want == 1 or tiles * want <= SPLIT_BLOCKS
            assert want == SPLIT_MAX or tiles * 2 * want > SPLIT_BLOCKS
    assert plan.n_split <= SPLIT_MAX


@pytest.mark.parametrize("kn", SERVING, ids=["x".join(map(str, s))
                                             for s in SERVING])
def test_gemm_plan_puts_two_decode_blocks_on_every_sm(kn):
    """At the decode rows (M = 8) of every serving projection the split
    grid has at least two blocks for each of the card's 132 SMs."""
    k, n = kn
    plan = gemm_plan(8, n, k)
    assert plan.path == "split"
    assert -(-n // plan.bn) * plan.n_split >= 2 * 132


@pytest.mark.parametrize("kn", SERVING + TRAINING + [(64, 48)])
def test_gemm_plan_path_is_monotone_in_m(kn):
    """As M grows the path turns once, from split to wgmma, at the
    crossover."""
    k, n = kn
    paths = [gemm_plan(m, n, k).path for m in range(1, 400)]
    turn = paths.index("wgmma")
    assert turn == GEMM_CROSSOVER
    assert set(paths[:turn]) == {"split"} and set(paths[turn:]) == {"wgmma"}


def _record(monkeypatch):
    """Replace the C entry point by a recorder of its arguments."""
    calls = []
    monkeypatch.setattr(_build, "kernel",
                        lambda name: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("shape", PLAN_SHAPES[:12] + PLAN_SHAPES[16:22],
                         ids=IDS[:12] + IDS[16:22])
def test_gemm_launch_allocates_xq_and_sx_alone(monkeypatch, shape):
    """The wrapper's one scratch buffer holds xq (M K bytes), then sx (M
    fp32), and nothing else: neither path needs a workspace.  The launch
    carries the plan."""
    m, n, k = shape
    calls = _record(monkeypatch)
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    wq = torch.zeros(n, k, dtype=torch.int8)
    ws = torch.ones(n)
    plan = gemm_plan(m, n, k)
    out, scratch = int8_gemm._launch(x, wq, ws, plan)
    assert out.shape == (m, n) and out.dtype == x.dtype
    (args,) = calls
    assert scratch.numel() == m * k + 4 * m
    assert args[1] == scratch.data_ptr()
    assert args[2] == scratch.data_ptr() + m * k
    assert args[6:9] == (m, n, k)
    assert args[9] == 1                         # bf16
    assert args[10:14] == ({"split": 0, "wgmma": 1}[plan.path], plan.bm,
                           plan.bn, plan.chunks_per_split)


def test_gemm_launch_depends_on_shapes_alone(monkeypatch):
    """Two calls of one shape launch the same plan whatever the values and
    the activation dtype (its code 0 fp32, 1 bf16, 2 fp16 passed on); the
    plan itself is a function of its integers."""
    calls = _record(monkeypatch)
    m, n, k = 8, 2048, 2048
    wq = torch.zeros(n, k, dtype=torch.int8)
    ws = torch.ones(n)
    for x in (torch.zeros(m, k), torch.randn(m, k) * 1e3,
              torch.randn(m, k).bfloat16(), torch.randn(m, k).half()):
        out, _ = int8_gemm._launch(x, wq, ws, gemm_plan(m, n, k))
        assert out.dtype == x.dtype
    assert len({a[6:9] + a[10:14] for a in calls}) == 1
    assert [a[9] for a in calls] == [0, 0, 1, 2]
    assert gemm_plan(m, n, k) == gemm_plan(int(m), int(n), int(k))
    assert gemm_plan(m, n, k) == gemm_plan(m, n, k, path="split")


@pytest.mark.parametrize("bad", [
    dict(m=0), dict(k=96), dict(k=0), dict(n=24), dict(n=8),
    dict(path="dense"), dict(bn=64, path="wgmma"), dict(bn=512, path="wgmma"),
    dict(bn=128, path="split"), dict(bn=64),
], ids=["m0", "k96", "k0", "n24", "n8", "path", "wgmma_bn64", "wgmma_bn512",
        "split_bn128", "split_bn64"])
def test_gemm_plan_rejects_what_the_kernel_cannot_take(bad):
    shape = {**dict(m=8, n=48, k=64),
             **{key: v for key, v in bad.items() if key in "mnk"}}
    over = {key: v for key, v in bad.items() if key not in "mnk"}
    with pytest.raises(ValueError):
        gemm_plan(shape["m"], shape["n"], shape["k"], **over)


def _operands(k=64, n=48):
    x = torch.zeros(2, k)
    wq = torch.zeros(n, k, dtype=torch.int8)
    ws = torch.ones(n)
    return x, wq, ws


def _misaligned():
    x = torch.zeros(2 * 64 + 1)[1:].view(2, 64)      # 4 bytes off
    return (x,) + _operands()[1:]


@pytest.mark.parametrize("case", [
    lambda: (torch.zeros(2, 64, dtype=torch.int32),) + _operands()[1:],
    lambda: (torch.zeros(1, 2, 64),) + _operands()[1:],
    lambda: (torch.zeros(64, 2).t(),) + _operands()[1:],
    lambda: (_operands()[0], torch.zeros(48, 128, dtype=torch.int8),
             _operands()[2]),
    lambda: (_operands()[0], torch.zeros(48, 64), _operands()[2]),
    lambda: (_operands()[0], torch.zeros(64, 48, dtype=torch.int8).t(),
             _operands()[2]),
    lambda: _operands()[:2] + (torch.ones(47),),
    lambda: _operands()[:2] + (torch.ones(48, dtype=torch.float64),),
    lambda: (torch.zeros(2, 96),) + _operands(k=96)[1:],
    lambda: _operands(n=40),
    lambda: (torch.zeros(0, 64),) + _operands()[1:],
    _misaligned,
], ids=["x_dtype", "x_dim", "x_strided", "wq_k", "wq_dtype", "wq_strided",
        "ws_shape", "ws_dtype", "k96", "n40", "m0", "misaligned"])
def test_w8a8_gemm_raises_on_what_the_kernel_cannot_take(case):
    """The CUDA path's checks (the same as before the redesign): the
    kernel takes contiguous fp32/bf16 x, (N, K) int8 wq, (N,) fp32 ws, M >=
    1, K % 64 == 0, N % 16 == 0 and 16-byte aligned x and wq."""
    with pytest.raises(ValueError):
        int8_gemm._validate(*case())


@pytest.mark.parametrize("m", [1, 65, 129])
def test_w8a8_gemm_plain_matches_reference_at_ragged_rows(m, interpretable):
    """N = 48, K = 64: xq and sx bit for bit against the reference's
    quantize, the output against ``w8a8_gemm_ref`` and the Pallas kernel
    run by the interpreter (one block of all M rows and N columns)."""
    rng = np.random.RandomState(m)
    k, n = 64, 48
    x = rng.randn(m, k).astype(np.float32) * 3.0
    x[-1] = 0.0                                    # the 1e-8 clamp
    if m > 1:
        x[0, :4] = [127.0, 2.5, -0.5, 3.5]         # scale 1: .5 ties
    wq, ws = jq.quantize_per_channel(
        jnp.asarray(rng.randn(k, n).astype(np.float32) * 0.05), axis=1)
    wq, ws = np.asarray(wq), np.asarray(ws)
    out, txq, tsx = w8a8_gemm_plain(torch.from_numpy(x),
                                    torch.from_numpy(wq.T.copy()),
                                    torch.from_numpy(ws),
                                    return_quantized=True)
    jxq, jsx = jq.quantize_per_token(jnp.asarray(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    args = (jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws))
    ref = np.asarray(jgemm.w8a8_gemm_ref(*args))
    kern = np.asarray(jgemm.w8a8_gemm(*args, block_m=m, block_n=n,
                                      interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(out.numpy(), kern, rtol=1e-6, atol=0)


def test_gemm_plan_is_a_named_plan():
    plan = gemm_plan(8, 48, 64)
    assert isinstance(plan, GemmPlan)
    assert plan._fields == ("path", "bm", "bn", "chunks_per_split",
                            "n_split")


# (M, K, N): ragged K and N as a GPT-2 vocabulary (50257) or width (1600)
# gives them, K below one chunk, and one row and column
RAGGED = [(3, 96, 50257), (5, 1600, 40), (2, 1, 1), (17, 130, 24),
          (1, 2048, 50257)]


@pytest.mark.parametrize("shape", RAGGED, ids=["x".join(map(str, s))
                                               for s in RAGGED])
def test_padding_to_the_kernel_granularity_is_exact(shape):
    """``pad_operands`` zero-pads K to a multiple of 64 and N to one of 16
    (weight rows of scale 1): the plain version over the padded operands,
    sliced back, equals it over the ragged ones bit for bit, xq and sx
    included (zero columns change neither a row's absmax nor a sum)."""
    m, k, n = shape
    g = torch.Generator().manual_seed(k + n)
    x = torch.randn(m, k, generator=g) * 3.0
    x[0, 0] = 0.0
    wq = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g)
    ws = torch.rand(n, generator=g) * 1e-2
    xp, wqp, wsp = int8_gemm.pad_operands(x, wq, ws)
    assert xp.shape[1] % GEMM_KC == 0 and wqp.shape[0] % 16 == 0
    assert wqp.shape[1] == xp.shape[1] and wsp.shape == (wqp.shape[0],)
    want, wxq, wsx = w8a8_gemm_plain(x, wq, ws, return_quantized=True)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        got = w8a8_gemm_plain(xp.to(dtype), wqp, wsp)[:, :n]
        assert torch.equal(got, w8a8_gemm_plain(x.to(dtype), wq, ws))
    _, pxq, psx = w8a8_gemm_plain(xp, wqp, wsp, return_quantized=True)
    assert torch.equal(pxq[:, :k], wxq) and torch.equal(psx, wsx)
    assert not pxq[:, k:].any()


def test_aligned_operands_are_not_copied():
    x, wq, ws = torch.zeros(4, 128), torch.zeros(48, 128, dtype=torch.int8), \
        torch.ones(48)
    assert all(a is b for a, b in zip(int8_gemm.pad_operands(x, wq, ws),
                                      (x, wq, ws)))


@pytest.mark.parametrize("shape", RAGGED[:2] + [(40, 1600, 50257)],
                         ids=["3x96x50257", "5x1600x40", "40x1600x50257"])
def test_kernel_path_launches_padded_shapes_and_slices_back(monkeypatch,
                                                            shape):
    """The CUDA path (its C entry point recorded) launches the padded
    shape with the plan of the padded shape and returns (M, N), xq (M,
    K) and sx (M, 1): no ragged shape reaches the kernel, and none goes
    to the plain version."""
    m, k, n = shape
    calls = _record(monkeypatch)
    monkeypatch.setattr(int8_gemm, "w8a8_gemm_plain",
                        lambda *a, **kw: pytest.fail("plain version"))
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    wq = torch.zeros(n, k, dtype=torch.int8)
    out, xq, sx = int8_gemm._kernel_gemm(x, wq, torch.ones(n), True, None)
    (args,) = calls
    kp, np_ = -(-k // 64) * 64, -(-n // 16) * 16
    assert args[6:9] == (m, np_, kp)
    plan = gemm_plan(m, np_, kp)
    assert args[10:14] == ({"split": 0, "wgmma": 1}[plan.path], plan.bm,
                           plan.bn, plan.chunks_per_split)
    assert out.shape == (m, n) and out.is_contiguous()
    assert xq.shape == (m, k) and sx.shape == (m, 1)
    with pytest.raises(ValueError):
        int8_gemm._kernel_gemm(x, wq[:, :-1], torch.ones(n), False, None)
    with pytest.raises(ValueError):
        int8_gemm._kernel_gemm(x, wq, torch.ones(n + 1), False, None)

"""The port's CUDA kernels against their plain versions, and the train
step on the card against the CPU, on the card.

Skips where PyTorch sees no CUDA device.  This file imports neither JAX nor
the reference package, so it also runs on a machine that has only the
port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from paddle_tpu_torch.kernels import (flash_bwd_plain, flash_fwd_plain,
                                      paged_attention, paged_attention_mq,
                                      paged_attention_mq_plain,
                                      paged_attention_plain, paged_prefill,
                                      paged_prefill_plain, sdpa, w8a8_gemm,
                                      w8a8_gemm_plain)
from paddle_tpu_torch.kernels.flash import flash_bwd, flash_fwd
from paddle_tpu_torch.ops import quantize_int4_per_token, quantize_per_token


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # fp32 products in full fp32 in the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool(dev, g, bits, P=40, HKV=2, PS=32, D=128):
    """Random pages of kind ``bits`` (None float, 8, 4) and their scales."""
    kp = torch.randn(P, HKV, PS, D, device=dev, generator=g)
    vp = torch.randn(P, HKV, PS, D, device=dev, generator=g)
    if bits is None:
        return kp, vp, {}
    quant = quantize_int4_per_token if bits == 4 else quantize_per_token
    (kq, ks), (vq, vs) = quant(kp), quant(vp)
    return kq, vq, dict(k_scales=ks, v_scales=vs)


@pytest.mark.cuda
def test_kernels_match_plain_on_card(dev):
    """The CUDA kernels against their plain versions on the card, fp32
    pages (1e-5: only the summation order differs) with GQA, a window,
    ragged lengths and a ragged prefill tile."""
    g = torch.Generator(device=dev).manual_seed(0)
    P, HKV, PS, D, H = 40, 2, 32, 128, 8
    kp = torch.randn(P, HKV, PS, D, device=dev, generator=g)
    vp = torch.randn(P, HKV, PS, D, device=dev, generator=g)
    bt = torch.randperm(P - 1, device=dev, generator=g)[:24].add(1)
    bt = bt.to(torch.int32).reshape(3, 8).contiguous()
    lens = torch.tensor([1, 100, 256], dtype=torch.int32, device=dev)
    q = torch.randn(3, H, D, device=dev, generator=g)
    for window in (None, 40):
        out = paged_attention(q, kp, vp, bt, lens, window=window)
        ref = paged_attention_plain(q, kp, vp, bt, lens, window=window)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        for c, start in ((40, 0), (40, 100), (128, 120)):
            qc = torch.randn(c, H, D, device=dev, generator=g)
            out = paged_prefill(qc, kp, vp, bt[2], start, window=window)
            ref = paged_prefill_plain(qc, kp, vp, bt[2], start,
                                      window=window)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quantized_page_kernels_match_plain_on_card(dev, bits):
    """int8 and int4 pages through the decode and prefill kernels, fp32
    queries: the dequantized values are exact, so 1e-5 (summation order)
    holds, with GQA, a window and ragged lengths and tiles."""
    g = torch.Generator(device=dev).manual_seed(bits)
    kp, vp, sc = _pool(dev, g, bits)
    bt = torch.randperm(39, device=dev, generator=g)[:24].add(1)
    bt = bt.to(torch.int32).reshape(3, 8).contiguous()
    lens = torch.tensor([1, 100, 256], dtype=torch.int32, device=dev)
    q = torch.randn(3, 8, 128, device=dev, generator=g)
    for window in (None, 40):
        kw = dict(sc, window=window)
        torch.testing.assert_close(
            paged_attention(q, kp, vp, bt, lens, **kw),
            paged_attention_plain(q, kp, vp, bt, lens, **kw),
            rtol=1e-5, atol=1e-5)
        for c, start in ((40, 0), (128, 120)):
            qc = torch.randn(c, 8, 128, device=dev, generator=g)
            torch.testing.assert_close(
                paged_prefill(qc, kp, vp, bt[2], start, **kw),
                paged_prefill_plain(qc, kp, vp, bt[2], start, **kw),
                rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_mq_kernel_matches_plain_on_card(dev, bits):
    """The verify kernel over float, int8 and int4 pages, fp32 queries
    (1e-5), T in {3, 5} with GQA and a window; T == 1 is the decode kernel
    at lengths + 1."""
    g = torch.Generator(device=dev).manual_seed(7 + (bits or 0))
    kp, vp, sc = _pool(dev, g, bits)
    bt = torch.randperm(39, device=dev, generator=g)[:24].add(1)
    bt = bt.to(torch.int32).reshape(3, 8).contiguous()
    lens = torch.tensor([0, 99, 250], dtype=torch.int32, device=dev)
    for t in (1, 3, 5):
        q = torch.randn(3, t, 8, 128, device=dev, generator=g)
        for window in (None, 40):
            kw = dict(sc, window=window)
            torch.testing.assert_close(
                paged_attention_mq(q, kp, vp, bt, lens, **kw),
                paged_attention_mq_plain(q, kp, vp, bt, lens, **kw),
                rtol=1e-5, atol=1e-5)


# The split-KV body (bf16 queries) and the fp32 body at a block-table width
# the plan cuts into several splits: lengths at the page edges (1, 31, 32,
# 33), a split's length +-1 and the full table; windows inside one split
# (40) and windows that leave whole splits empty (300 and 100 of the
# longest slots).  bf16 is held to 2e-2 against the plain version computed
# in fp32 from the same inputs (the kernel rounds P to bf16 for the tensor
# cores and rounds its output), fp16 to 5e-3 (the same roundings with three
# more bits of mantissa), fp32 to 1e-5 (summation order only).
SPLIT_B, SPLIT_HKV, SPLIT_MAXP, SPLIT_PS = 10, 2, 48, 32
SPLIT_WINDOWS = (None, 40, 100, 300)


def _split_lengths():
    from paddle_tpu_torch.kernels.paged_attention import split_plan

    pps, n_split = split_plan(SPLIT_B, SPLIT_HKV, SPLIT_MAXP, SPLIT_PS)
    assert n_split > 2
    span = pps * SPLIT_PS
    return [1, 31, 32, 33, span - 1, span, span + 1, 2 * span + 1,
            SPLIT_MAXP * SPLIT_PS - 1, SPLIT_MAXP * SPLIT_PS]


def _split_case(dev, g, bits, dtype):
    """Pages of kind ``bits`` (float ones in ``dtype``), a shuffled block
    table, and the pages the plain version reads in fp32."""
    kp, vp, sc = _pool(dev, g, bits, P=1 + SPLIT_B * SPLIT_MAXP,
                       HKV=SPLIT_HKV, PS=SPLIT_PS)
    if bits is None:
        kp, vp = kp.to(dtype), vp.to(dtype)
    bt = torch.randperm(SPLIT_B * SPLIT_MAXP, device=dev, generator=g).add(1)
    bt = bt.to(torch.int32).reshape(SPLIT_B, SPLIT_MAXP).contiguous()
    kf, vf = (kp, vp) if sc else (kp.float(), vp.float())
    return kp, vp, sc, bt, kf, vf


HALF_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3}


def _held(out, ref, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert out.dtype == dtype
        err = (out.float() - ref).abs().max().item()
        assert err <= HALF_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_split_decode_matches_plain_on_card(dev, bits, dtype):
    """Decode over several splits, G in {1, 2, 4, 8}, every window; two
    identical calls are bit-identical (the merge adds in a fixed order)."""
    g = torch.Generator(device=dev).manual_seed(11 + (bits or 0))
    lens = torch.tensor(_split_lengths(), dtype=torch.int32, device=dev)
    for group in (1, 2, 4, 8):
        kp, vp, sc, bt, kf, vf = _split_case(dev, g, bits, dtype)
        q = torch.randn(SPLIT_B, group * SPLIT_HKV, 128, device=dev,
                        generator=g).to(dtype)
        for window in SPLIT_WINDOWS:
            out = paged_attention(q, kp, vp, bt, lens, window=window, **sc)
            ref = paged_attention_plain(q.float(), kf, vf, bt, lens,
                                        window=window, **sc)
            _held(out, ref, dtype)
            again = paged_attention(q, kp, vp, bt, lens, window=window, **sc)
            assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_split_verify_matches_plain_on_card(dev, bits, dtype):
    """Verify over several splits, G in {1, 2, 4, 8} x T in {2, 5, 8}
    (up to 64 rows: four row groups), every window; bit-identical
    repeats."""
    g = torch.Generator(device=dev).manual_seed(23 + (bits or 0))
    for group in (1, 2, 4, 8):
        kp, vp, sc, bt, kf, vf = _split_case(dev, g, bits, dtype)
        for t in (2, 5, 8):
            # the block's last row at most at the table's last position
            lens = torch.tensor([max(0, n - t) for n in _split_lengths()],
                                dtype=torch.int32, device=dev)
            q = torch.randn(SPLIT_B, t, group * SPLIT_HKV, 128, device=dev,
                            generator=g).to(dtype)
            for window in SPLIT_WINDOWS:
                out = paged_attention_mq(q, kp, vp, bt, lens, window=window,
                                         **sc)
                ref = paged_attention_mq_plain(q.float(), kf, vf, bt, lens,
                                               window=window, **sc)
                _held(out, ref, dtype)
                again = paged_attention_mq(q, kp, vp, bt, lens,
                                           window=window, **sc)
                assert torch.equal(out, again)


# page sizes and head dims of the split-KV body besides the engine's
# (32, 128): pages smaller than a 32-key tile (zero-padded tiles), a page
# of two tiles, D padded to 64 and to 128, and D=256 (two-warp groups)
SPLIT_SHAPES = [(8, 128), (16, 64), (64, 128), (32, 96), (32, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("ps,d", SPLIT_SHAPES,
                         ids=[f"page{p}-d{d}" for p, d in SPLIT_SHAPES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_split_shapes_match_plain_on_card(dev, bits, ps, d, dtype):
    """Decode (G=2) and verify (T=5, G=2) with bf16 and fp16 queries over
    several splits at other page sizes and head dims, with and without a
    window; bit-identical repeats."""
    g = torch.Generator(device=dev).manual_seed(ps + d + (bits or 0))
    b, hkv, maxp = 4, 2, 1024 // ps
    kp, vp, sc = _pool(dev, g, bits, P=1 + b * maxp, HKV=hkv, PS=ps, D=d)
    if bits is None:
        kp, vp = kp.to(dtype), vp.to(dtype)
    kf, vf = (kp, vp) if sc else (kp.float(), vp.float())
    bt = torch.randperm(b * maxp, device=dev, generator=g).add(1)
    bt = bt.to(torch.int32).reshape(b, maxp).contiguous()
    for t in (None, 5):
        lens = [1, ps + 1, 600, 1024 - (t or 0)]
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        shape = (b, 2 * hkv, d) if t is None else (b, t, 2 * hkv, d)
        q = torch.randn(shape, device=dev, generator=g).to(dtype)
        fn, plain = ((paged_attention, paged_attention_plain) if t is None
                     else (paged_attention_mq, paged_attention_mq_plain))
        for window in (None, 100):
            out = fn(q, kp, vp, bt, lens, window=window, **sc)
            ref = plain(q.float(), kf, vf, bt, lens, window=window, **sc)
            _held(out, ref, dtype)
            assert torch.equal(out, fn(q, kp, vp, bt, lens, window=window,
                                       **sc))


# Prefill with bf16 and fp16 queries (the split-KV body's row split, over
# the prefill plan's splits) at a block-table width the plan cuts into
# several splits: chunks of 1, 16, 40 and 128 rows at start 0, at a page edge and
# in mid-page, with no window, a window smaller than a tile (which leaves
# whole tiles and splits of the table unseen) and one wider than a split;
# G in {1, 2, 4, 8}; held to HALF_TOL against the plain version computed
# in fp32 from the same inputs, and two identical calls bit-identical.
PREFILL_MAXP = 48
PREFILL_CHUNKS = (1, 16, 40, 128)
PREFILL_STARTS = (0, 256, 700)
PREFILL_WINDOWS = (None, 24, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_split_prefill_matches_plain_on_card(dev, bits, dtype):
    """The prefill kernel on the split-KV body for each page kind: every
    chunk width, start and window above, G 1-8; bit-identical repeats.
    The plan splits the 48-entry table into several splits in every
    case."""
    from paddle_tpu_torch.kernels.paged_prefill import prefill_plan

    g = torch.Generator(device=dev).manual_seed(31 + (bits or 0))
    hkv = 2
    for group in (1, 2, 4, 8):
        kp, vp, sc = _pool(dev, g, bits, P=1 + PREFILL_MAXP, HKV=hkv)
        if bits is None:
            kp, vp = kp.to(dtype), vp.to(dtype)
        kf, vf = (kp, vp) if sc else (kp.float(), vp.float())
        bt = torch.randperm(PREFILL_MAXP, device=dev, generator=g).add(1)
        bt = bt.to(torch.int32).contiguous()
        for c in PREFILL_CHUNKS:
            assert prefill_plan(c, group * hkv, hkv, PREFILL_MAXP, 32)[1] > 1
            for start in PREFILL_STARTS:
                q = torch.randn(c, group * hkv, 128, device=dev,
                                generator=g).to(dtype)
                for window in PREFILL_WINDOWS:
                    out = paged_prefill(q, kp, vp, bt, start, window=window,
                                        **sc)
                    ref = paged_prefill_plain(q.float(), kf, vf, bt, start,
                                              window=window, **sc)
                    _held(out, ref, dtype)
                    again = paged_prefill(q, kp, vp, bt, start,
                                          window=window, **sc)
                    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("ps,d", SPLIT_SHAPES + [(32, 64)],
                         ids=[f"page{p}-d{d}"
                              for p, d in SPLIT_SHAPES + [(32, 64)]])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp", "int8", "int4"])
def test_split_prefill_shapes_match_plain_on_card(dev, bits, ps, d, dtype):
    """Prefill with bf16 and fp16 queries (G=2) at other page sizes (8,
    16, 64) and head dims (64, 96, 256: the row split's two-warp groups),
    chunks of 40 and 128 rows from a mid-page start, with and without a
    window; bit-identical repeats."""
    g = torch.Generator(device=dev).manual_seed(ps + d + 5 + (bits or 0))
    hkv, maxp = 2, 1024 // ps
    kp, vp, sc = _pool(dev, g, bits, P=1 + maxp, HKV=hkv, PS=ps, D=d)
    if bits is None:
        kp, vp = kp.to(dtype), vp.to(dtype)
    kf, vf = (kp, vp) if sc else (kp.float(), vp.float())
    bt = torch.randperm(maxp, device=dev, generator=g).add(1)
    bt = bt.to(torch.int32).contiguous()
    for c, start in ((40, 300), (128, 600)):
        q = torch.randn(c, 2 * hkv, d, device=dev, generator=g).to(dtype)
        for window in (None, 100):
            out = paged_prefill(q, kp, vp, bt, start, window=window, **sc)
            ref = paged_prefill_plain(q.float(), kf, vf, bt, start,
                                      window=window, **sc)
            _held(out, ref, dtype)
            assert torch.equal(out, paged_prefill(q, kp, vp, bt, start,
                                                  window=window, **sc))


def _gemm_weight(dev, g, n, k):
    """A per-channel int8 weight (N, K) and its scales, as the model
    quantizes one."""
    w = torch.randn(n, k, device=dev, generator=g) * 0.02
    ws = w.abs().amax(1).clamp_min(1e-8) / 127.0
    wq = torch.round(w / ws[:, None]).clamp(-127, 127).to(torch.int8)
    return wq, ws


def _gemm_exact(x, wq, ws, plan=None):
    """w8a8_gemm equals its plain version bit for bit (xq, sx, out), and a
    second call gives the same bits."""
    from paddle_tpu_torch.kernels.int8_gemm import w8a8_gemm as gemm

    out, xq, sx = gemm(x, wq, ws, return_quantized=True, plan=plan)
    ref, rxq, rsx = w8a8_gemm_plain(x, wq, ws, return_quantized=True)
    assert torch.equal(xq, rxq) and torch.equal(sx, rsx)
    assert torch.equal(out, ref)
    assert torch.equal(gemm(x, wq, ws, plan=plan), out)


GEMM_MS = (1, 8, 16, 17, 40, 63, 64, 65, 128, 129, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(64, 48), (2048, 6144), (8192, 2048),
                                 (1536, 4608), (128, 48)])
def test_w8a8_gemm_is_exact_on_card(dev, k, n):
    """The W8A8 kernel equals its plain version bit for bit on both paths
    and on both sides of the crossover: the quantized activations and their
    scales, and the output in fp32, bf16 and fp16 (the same int32 sums,
    converted and rescaled in the same order).  Each M also runs on the path its plan
    does not pick."""
    from paddle_tpu_torch.kernels.int8_gemm import gemm_plan

    g = torch.Generator(device=dev).manual_seed(k + n)
    wq, ws = _gemm_weight(dev, g, n, k)
    for m in GEMM_MS:
        x = torch.randn(m, k, device=dev, generator=g)
        x[-1] = 0.0                      # all-zero row: the 1e-8 clamp
        other = "wgmma" if gemm_plan(m, n, k).path == "split" else "split"
        for xt in (x, x.to(torch.bfloat16), x.half()):
            _gemm_exact(xt, wq, ws)
            _gemm_exact(xt, wq, ws, gemm_plan(m, n, k, path=other))
    with pytest.raises(ValueError):
        w8a8_gemm(x[:, :-1].contiguous(), wq, ws)      # K != wq's K


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["split", "wgmma"])
def test_w8a8_gemm_rows_columns_and_ties_on_card(dev, path):
    """A map of the accumulator fragment that swapped rows or columns
    cannot hide: rows of distinct scales and a per-column ws = 1 + col / N;
    and values that fall on exact .5 boundaries after the division, which
    round half to even (2.5 -> 2, 3.5 -> 4, -0.5 -> -0)."""
    from paddle_tpu_torch.kernels.int8_gemm import gemm_plan

    g = torch.Generator(device=dev).manual_seed(11)
    m, k, n = 72, 256, 208
    wq, _ = _gemm_weight(dev, g, n, k)
    ws = 1.0 + torch.arange(n, device=dev, dtype=torch.float32) / n
    x = torch.randn(m, k, device=dev, generator=g)
    x *= (1.0 + torch.arange(m, device=dev, dtype=torch.float32))[:, None]
    # row 0: absmax 127 gives sx = 1, so x / sx is x itself
    x[0] = torch.tensor([2.5, 3.5, -0.5, 0.5, -2.5, 126.5, -126.5, 127.0],
                        device=dev).repeat(k // 8)
    plan = gemm_plan(m, n, k, path=path)
    for xt in (x, x.to(torch.bfloat16), x.half()):
        _gemm_exact(xt, wq, ws, plan)
    _, xq, _ = w8a8_gemm(x, wq, ws, return_quantized=True, plan=plan)
    assert xq[0, :8].tolist() == [2, 4, 0, 0, -2, 126, -126, 127]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("want,n_split", [(1, 1), (2, 2), (6, 6), (8, 8)])
def test_w8a8_gemm_split_counts_on_card(dev, want, n_split, dtype):
    """The split path at M = 8 under any split count, clusters of 1 to 8
    blocks (6 wanted gives 6 splits of 6, 6, 6, 6, 6 and 2 chunks), and a
    CUDA graph's replays give the same bits."""
    from paddle_tpu_torch.kernels.int8_gemm import gemm_plan

    g = torch.Generator(device=dev).manual_seed(want)
    m, k, n = 8, 2048, 2048
    wq, ws = _gemm_weight(dev, g, n, k)
    x = torch.randn(m, k, device=dev, generator=g).to(dtype)
    plan = gemm_plan(m, n, k, n_split=want)
    assert plan.n_split == n_split
    _gemm_exact(x, wq, ws, plan)
    ref = w8a8_gemm_plain(x, wq, ws)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = w8a8_gemm(x, wq, ws, plan=plan)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_w8a8_gemm_training_rows_on_card(dev, dtype):
    """The training flagship's qkv projection at its M = 12 x 1024 rows,
    bf16 and fp16 activations: bit-exact on the wgmma path."""
    from paddle_tpu_torch.kernels.int8_gemm import gemm_plan

    g = torch.Generator(device=dev).manual_seed(3)
    m, k, n = 12288, 1536, 4608
    wq, ws = _gemm_weight(dev, g, n, k)
    x = torch.randn(m, k, device=dev, generator=g).to(dtype)
    assert gemm_plan(m, n, k).path == "wgmma"
    _gemm_exact(x, wq, ws)


@pytest.mark.cuda
def test_fp16_cuda_tensors_never_take_the_plain_version(dev, monkeypatch):
    """fp16 CUDA operands reach the kernels, never a plain version: with
    every ``*_plain`` made to raise on a CUDA tensor, decode, verify and
    prefill over fp16, int8 and int4 pages and ``w8a8_gemm`` return fp16
    outputs, and each counts its own ``_fp16`` launch name."""
    import importlib

    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    def refuse(name):
        def plain(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kw.values())):
                raise AssertionError(f"{name} took a CUDA tensor")
        return plain

    for mod, name in (("paged_attention", "paged_attention_plain"),
                      ("paged_attention", "paged_attention_mq_plain"),
                      ("paged_prefill", "paged_prefill_plain"),
                      ("int8_gemm", "w8a8_gemm_plain")):
        module = importlib.import_module(f"paddle_tpu_torch.kernels.{mod}")
        monkeypatch.setattr(module, name, refuse(name))
    g = torch.Generator(device=dev).manual_seed(19)
    reset_launch_counts()
    bt = torch.randperm(8, device=dev, generator=g).add(1)
    bt = bt.to(torch.int32).reshape(2, 4).contiguous()
    lens = torch.tensor([40, 97], dtype=torch.int32, device=dev)
    for bits in (None, 8, 4):
        kp, vp, sc = _pool(dev, g, bits, P=9)
        if bits is None:
            kp, vp = kp.half(), vp.half()
        q = torch.randn(2, 4, 128, device=dev, generator=g).half()
        q5 = torch.randn(2, 5, 4, 128, device=dev, generator=g).half()
        qc = torch.randn(16, 4, 128, device=dev, generator=g).half()
        for out in (paged_attention(q, kp, vp, bt, lens, **sc),
                    paged_attention_mq(q5, kp, vp, bt, lens, **sc),
                    paged_prefill(qc, kp, vp, bt[1], 60, **sc)):
            assert out.dtype == torch.float16 and out.is_cuda
    wq, ws = _gemm_weight(dev, g, 48, 128)
    x = torch.randn(8, 128, device=dev, generator=g).half()
    assert w8a8_gemm(x, wq, ws).dtype == torch.float16
    torch.cuda.synchronize()
    launched = {name for name, n in KERNELS.items() if n}
    assert launched == {f"{k}{s}_fp16" for k in ("paged_attention",
                                                 "paged_attention_mq",
                                                 "paged_prefill")
                        for s in ("", "_int8", "_int4")} | {"w8a8_gemm_fp16"}


# layout, B, H, Hkv, S, D, causal, window: every layout, GQA, a window,
# lengths that are not a multiple of any tile (136, 200, 520, 40) and a
# head_dim that is not a multiple of 16 (24); then the edges of the bf16
# register-fragment kernels: the widest padded head dim (256) and one
# padded to 128 (96), a sequence shorter than one tile (8), a window
# smaller than a tile and not a multiple of 16 (40 at S=300), a GQA group
# of 3, a long non-causal sequence, D=256 causal and windowed, and
# BERT-base's attention at batch 2 (bnsd, not causal, D=64), and S=77,
# a multiple of neither the fp32 forward's 128 query rows a block nor its
# 32 (D=24) or 16 (D=256) key rows a tile
FLASH_CASES = [
    ("bnsd", 2, 3, 3, 136, 64, True, None),
    ("bnsd", 2, 2, 2, 64, 128, False, None),
    ("bsnd", 2, 4, 2, 200, 128, True, 48),
    ("sbnd", 2, 4, 1, 72, 32, True, None),
    ("bsnd", 1, 2, 2, 520, 128, True, None),
    ("sbnd", 1, 4, 2, 40, 24, False, None),
    ("bsnd", 1, 2, 1, 136, 256, False, None),
    ("bnsd", 2, 2, 2, 200, 96, True, None),
    ("bsnd", 2, 2, 2, 8, 64, True, None),
    ("bsnd", 1, 4, 2, 300, 128, True, 40),
    ("bsnd", 2, 6, 2, 256, 128, True, None),
    ("bnsd", 1, 2, 2, 1024, 128, False, None),
    ("bsnd", 1, 2, 1, 200, 256, True, None),
    ("bsnd", 1, 4, 2, 300, 256, True, 40),
    ("bnsd", 2, 12, 12, 512, 64, False, None),
    ("sbnd", 2, 4, 2, 77, 24, True, None),
    ("bsnd", 1, 4, 2, 77, 256, False, None),
]


def _flash_inputs(dev, g, layout, b, h, hkv, s, d, dtype):
    def shape(n):
        return {"bnsd": (b, n, s, d), "bsnd": (b, s, n, d),
                "sbnd": (s, b, n, d)}[layout]
    q, k, v = (torch.randn(shape(n), device=dev, generator=g).to(dtype)
               for n in (h, hkv, hkv))
    return q, k, v


# elementwise |kernel - plain| <= atol * rms + rtol * |plain| (rms of the
# plain row, the last axis, at least 1e-2 of the tensor's), as (rtol, atol)
# per tensor: fp32 differs in summation order only; bf16 out, dq, dk and
# dv are rounded once to bf16 and the kernels round P and dS to bf16 for
# the tensor cores where the plain versions keep fp32, an error on the
# scale of the row's terms; lse is fp32 (the smoke's FLASH_TOL)
FLASH_TOL = {
    torch.float32: {"out": (1e-5, 1e-5), "lse": (1e-6, 1e-6),
                    "dq": (1e-5, 1e-5), "dk": (1e-5, 1e-5),
                    "dv": (1e-5, 1e-5)},
    torch.bfloat16: {"out": (2e-2, 3e-2), "lse": (1e-6, 1e-6),
                     "dq": (2e-2, 3e-2), "dk": (2e-2, 3e-2),
                     "dv": (2e-2, 3e-2)},
}


def _close(got, want, tol, what):
    rtol, atol = tol
    g, w = got.float(), want.float()
    row = w.square().mean(-1, keepdim=True).sqrt()
    row = row.clamp_min(1e-2 * w.square().mean().sqrt())
    bound = atol * row + rtol * w.abs()
    used = ((g - w).abs() / bound).max().item()
    assert used <= 1.0, f"{what}: {used:.3f} of the bound {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"{c[0]}-h{c[2]}/{c[3]}-s{c[4]}-d{c[5]}"
                              for c in FLASH_CASES])
def test_flash_kernels_match_plain_on_card(dev, case):
    """The forward, dQ and dK/dV kernels against their plain versions on
    the same inputs, each tensor elementwise within FLASH_TOL.  The
    backward kernels get the plain forward's out and lse, so each kernel
    is held on its own.  The first query of a causal case sees one key,
    so its dQ is 0 up to fp64 rounding: both sides form dp - delta in
    fp64 there (the fp32 kernels for a pair that holds at least 1/16 of
    its query's probability).  A second launch of each kernel is
    bit-identical."""
    layout, b, h, hkv, s, d, causal, window = case
    g = torch.Generator(device=dev).manual_seed(s + d)
    for dtype, tol in FLASH_TOL.items():
        q, k, v = _flash_inputs(dev, g, layout, b, h, hkv, s, d, dtype)
        out, lse = flash_fwd(q, k, v, causal, None, window, layout)
        ref, rlse = flash_fwd_plain(q, k, v, causal, None, window, layout)
        torch.cuda.synchronize()
        _close(out, ref, tol["out"], f"{dtype} out")
        _close(lse, rlse, tol["lse"], f"{dtype} lse")
        again = flash_fwd(q, k, v, causal, None, window, layout)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        do = torch.randn(ref.shape, device=dev, generator=g).to(dtype)
        got = flash_bwd(q, k, v, ref, rlse, do, causal, None, window, layout)
        want = flash_bwd_plain(q, k, v, ref, rlse, do, causal, None, window,
                               layout)
        torch.cuda.synchronize()
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            assert x.shape == y.shape and x.dtype == dtype
            _close(x, y, tol[name], f"{dtype} {name}")
        again = flash_bwd(q, k, v, ref, rlse, do, causal, None, window,
                          layout)
        for x, y in zip(got, again):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_sdpa_on_card_launches_flash_or_raises(dev):
    """sdpa on CUDA tensors takes the flash kernels at any length, with q
    and k of other lengths, with a mask (the score bias, one that requires
    grad too), causal attention with more queries than keys, fp16, and
    head dims the tiles do not take (padded); it raises where the kernels
    cannot go (no plain fallback): a head dim above 256, fp64."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = _flash_inputs(dev, g, "bsnd", 2, 4, 2, 64, 64, torch.bfloat16)
    reset_launch_counts()
    sdpa(q, k, v, is_causal=True, layout="bsnd")
    sdpa(q, k, v, mask=torch.ones(64, 64, dtype=torch.bool, device=dev),
         layout="bsnd")
    q7, k7, v7 = _flash_inputs(dev, g, "bnsd", 2, 4, 4, 197, 64,
                               torch.bfloat16)
    sdpa(q7, k7, v7)
    assert KERNELS["flash_fwd"] == 3
    sdpa(q[..., :12], k[..., :12], v[..., :12], layout="bsnd")
    sdpa(q7, k7[:, :, :64], v7[:, :, :64])
    sdpa(q7[:, :, :1], k7, v7, mask=torch.zeros(2, 1, 1, 197, device=dev))
    sdpa(q7, k7[:, :, :64], v7[:, :, :64], is_causal=True)
    sdpa(q7.half(), k7.half(), v7.half())
    mask = torch.zeros(2, 1, 1, 197, device=dev, requires_grad=True)
    qg = q7.detach().requires_grad_()
    sdpa(qg, k7, v7, mask=mask).float().sum().backward()
    assert KERNELS["flash_fwd"] == 9 and KERNELS["flash_bwd_dq_dbias"] == 1
    assert mask.grad is not None and mask.grad.shape == mask.shape
    with pytest.raises(NotImplementedError, match="head_dim"):
        sdpa(*(torch.zeros(1, 2, 16, 264, device=dev) for _ in range(3)))
    with pytest.raises(NotImplementedError, match="float64"):
        sdpa(q7.double(), k7.double(), v7.double())
    assert KERNELS["flash_fwd"] == 9


# the biased cases: layout, B, H, Hkv, S, D, causal, mask kind ("pad": a
# [B, 1, 1, S] float mask of 0 / -1e4 on 0-S/2 padded keys a row, ERNIE's;
# "bool": an [S, S] boolean mask, a decoder's; "full": a float [B, H, S, S]
# one; None), at ViT-base's S=197 and a small ERNIE-like S=512 batch; the
# GQA cases (H=12 over Hkv=4, seq-major: bnsd takes no GQA) have each
# query head of a KV group read its own slice of a full bias
BIAS_CASES = [
    ("bnsd", 2, 12, 12, 197, 64, False, None),
    ("bnsd", 2, 12, 12, 512, 64, False, "pad"),
    ("bnsd", 1, 4, 4, 256, 64, False, "bool"),
    ("bsnd", 1, 4, 4, 136, 128, True, "full"),
    ("bnsd", 1, 2, 2, 77, 256, False, "pad"),
    ("bsnd", 2, 12, 4, 197, 64, False, "pad"),
    ("bsnd", 2, 12, 4, 197, 64, False, "full"),
    ("sbnd", 2, 12, 4, 256, 64, False, "pad"),
    ("sbnd", 2, 12, 4, 256, 64, True, "full"),
]


def _heads_bias(mask, q, layout, k=None, causal=False):
    """The kernels' view of ``mask``'s score bias (None for none)."""
    from paddle_tpu_torch.kernels.flash import _bias_of, _heads_shape

    if mask is None:
        return None
    return _bias_of(mask, q, layout, k, causal).expand(
        _heads_shape(q, layout, k))


def _bias(dev, g, kind, b, h, s):
    if kind == "pad":
        n = torch.randint(s // 2, s + 1, (b, 1), device=dev, generator=g)
        keep = torch.arange(s, device=dev)[None, :] < n
        return torch.where(keep, 0.0, -1e4)[:, None, None]
    if kind == "bool":
        m = torch.rand(s, s, device=dev, generator=g) > 0.4
        return m | torch.eye(s, dtype=torch.bool, device=dev)
    if kind == "full":
        return torch.randn(b, h, s, s, device=dev, generator=g)
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("case", BIAS_CASES,
                         ids=[f"{c[0]}-h{c[2]}kv{c[3]}-s{c[4]}-d{c[5]}-"
                              f"{c[7]}{'-causal' if c[6] else ''}"
                              for c in BIAS_CASES])
def test_flash_kernels_with_bias_match_plain_on_card(dev, case):
    """The forward, dQ and dK/dV kernels with a score bias (the case's
    mask as the kernels read it, in place through its strides) against
    their plain versions on the same inputs and bias, fp32 and bf16,
    within FLASH_TOL; a second launch is bit-identical."""
    layout, b, h, hkv, s, d, causal, kind = case
    g = torch.Generator(device=dev).manual_seed(s + d)
    for dtype, tol in FLASH_TOL.items():
        q, k, v = _flash_inputs(dev, g, layout, b, h, hkv, s, d, dtype)
        bias = _heads_bias(_bias(dev, g, kind, b, h, s), q, layout)
        out, lse = flash_fwd(q, k, v, causal, None, None, layout, bias)
        ref, rlse = flash_fwd_plain(q, k, v, causal, None, None, layout,
                                    bias)
        torch.cuda.synchronize()
        _close(out, ref, tol["out"], f"{dtype} out")
        _close(lse, rlse, tol["lse"], f"{dtype} lse")
        do = torch.randn(ref.shape, device=dev, generator=g).to(dtype)
        got = flash_bwd(q, k, v, ref, rlse, do, causal, None, None, layout,
                        bias)
        want = flash_bwd_plain(q, k, v, ref, rlse, do, causal, None, None,
                               layout, bias)
        torch.cuda.synchronize()
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            _close(x, y, tol[name], f"{dtype} {name}")
        again = flash_bwd(q, k, v, ref, rlse, do, causal, None, None, layout,
                          bias)
        for x, y in zip(got, again):
            assert torch.equal(x, y)


# q and k of other lengths: layout, B, H, Hkv, Sq, Sk, D, causal, window,
# mask kind ("pad": a [B, 1, 1, Sk] float mask, 0 / -1e4 on 0-Sk/2 padded
# keys a row; "full": a float [B, H, Sq, Sk] one; "neginf": the decoder's
# -inf mask above the diagonal, aligned at the bottom right, with -inf on
# the padded keys, so that whole tiles of a row score -inf): the
# Transformer's cross-attention (Sq=200 over a memory of 256), a chunk
# against a longer cache (causal, with and without a window), one decode
# step (Sq=1) against 256 keys and against a growing cache (causal), GQA
# in both seq-major layouts, more queries than keys (not causal), and the
# -inf mask at D=64 and D=256
CROSS_CASES = [
    ("bnsd", 2, 8, 8, 200, 256, 64, False, None, "pad"),
    ("bnsd", 2, 4, 4, 64, 300, 128, True, None, None),
    ("bsnd", 1, 4, 2, 100, 333, 128, True, 48, None),
    ("bnsd", 3, 8, 8, 1, 256, 64, False, None, "pad"),
    ("bnsd", 2, 8, 8, 1, 77, 64, True, None, None),
    ("bsnd", 2, 12, 4, 96, 200, 64, False, None, "full"),
    ("sbnd", 2, 4, 2, 40, 136, 32, True, None, "full"),
    ("sbnd", 2, 4, 2, 150, 72, 32, False, None, "pad"),
    ("bnsd", 2, 8, 8, 200, 200, 64, False, None, "neginf"),
    ("bnsd", 1, 4, 4, 72, 190, 256, False, None, "neginf"),
]


def _cross_mask(dev, g, kind, b, h, sq, sk):
    if kind in ("pad", "neginf"):
        n = torch.randint(sk // 2, sk + 1, (b, 1), device=dev, generator=g)
        keep = torch.arange(sk, device=dev)[None, :] < n
        if kind == "pad":
            return torch.where(keep, 0.0, -1e4)[:, None, None]
        qpos = torch.arange(sk - sq, sk, device=dev)[:, None]
        band = torch.arange(sk, device=dev)[None, :] <= qpos
        keep = keep[:, None, None] & band
        return torch.where(keep, 0.0, float("-inf"))
    if kind == "full":
        return torch.randn(b, h, sq, sk, device=dev, generator=g)
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("case", CROSS_CASES,
                         ids=[f"{c[0]}-h{c[2]}kv{c[3]}-q{c[4]}k{c[5]}-d{c[6]}"
                              f"-{c[9]}{'-causal' if c[7] else ''}"
                              f"{'-w' + str(c[8]) if c[8] else ''}"
                              for c in CROSS_CASES])
def test_flash_kernels_cross_lengths_match_plain_on_card(dev, case):
    """The forward, dQ and dK/dV kernels with q and k of other lengths (a
    causal band aligned at the bottom right), with and without a score
    bias, against their plain versions on the same inputs, fp32 and bf16,
    within FLASH_TOL; nothing is NaN where whole tiles score -inf; a
    second launch is bit-identical."""
    layout, b, h, hkv, sq, sk, d, causal, window, kind = case
    g = torch.Generator(device=dev).manual_seed(sq + sk + d)

    def shape(n, s):
        return {"bnsd": (b, n, s, d), "bsnd": (b, s, n, d),
                "sbnd": (s, b, n, d)}[layout]

    for dtype, tol in FLASH_TOL.items():
        q = torch.randn(shape(h, sq), device=dev, generator=g).to(dtype)
        k, v = (torch.randn(shape(hkv, sk), device=dev, generator=g).to(dtype)
                for _ in range(2))
        bias = _heads_bias(_cross_mask(dev, g, kind, b, h, sq, sk), q, layout,
                           k, causal)
        out, lse = flash_fwd(q, k, v, causal, None, window, layout, bias)
        ref, rlse = flash_fwd_plain(q, k, v, causal, None, window, layout,
                                    bias)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        _close(out, ref, tol["out"], f"{dtype} out")
        _close(lse, rlse, tol["lse"], f"{dtype} lse")
        do = torch.randn(ref.shape, device=dev, generator=g).to(dtype)
        got = flash_bwd(q, k, v, ref, rlse, do, causal, None, window, layout,
                        bias)
        want = flash_bwd_plain(q, k, v, ref, rlse, do, causal, None, window,
                               layout, bias)
        torch.cuda.synchronize()
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            assert x.shape == y.shape and torch.isfinite(x).all()
            _close(x, y, tol[name], f"{dtype} {name}")
        again = flash_bwd(q, k, v, ref, rlse, do, causal, None, window,
                          layout, bias)
        for x, y in zip(got, again):
            assert torch.equal(x, y)


def _update_ratios(cfg, names, got, want, init):
    """Per leaf, ||(got - init) - (want - init)|| / ||want - init||.  The
    key part of the QKV bias is left out: it adds q.b_k to a whole row of
    scores, which the softmax cancels, so its gradient is zero but for
    rounding, and AdamW steps each side by ~lr on its own noise there."""
    ratios = {}
    for name, a, b, a0 in zip(names, got, want, init):
        if name.endswith("qkv_b"):
            keep = torch.ones(a.numel(), dtype=torch.bool)
            keep[cfg.hidden_size:
                 cfg.hidden_size + cfg.num_kv_heads * cfg.head_dim] = False
            a, b, a0 = a[keep], b[keep], a0[keep]
        ratios[name] = ((a - b).norm() / (b - a0).norm()).item()
    return ratios


@pytest.mark.cuda
@pytest.mark.parametrize("over,remat,update_rtol", [
    ({}, False, 1e-3),
    ({"seq_major": True, "num_kv_heads": 2, "attn_window": 24}, True, 1e-3),
    ({"int8": True}, "dots", 5e-2),
], ids=["flagship-like", "seq_major-gqa-window-remat", "int8-dots"])
def test_train_step_on_card_matches_cpu(dev, over, remat, update_rtol):
    """The fp32 train step on the card (flash kernels, w8a8_gemm) against
    the same step on the CPU (plain attention and GEMM), 2 steps from the
    same weights: losses to 1e-4 relative, and each leaf's update to
    ``update_rtol`` as ||card update - CPU update|| / ||CPU update||.
    Under W8A8 a summation-order difference now and then rounds an
    activation to the other int8 value, which moves every gradient
    downstream of it, and AdamW's first, sign-like steps flip where a
    gradient is that small; the readings per leaf are printed."""
    import numpy as np

    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTParams
    from paddle_tpu_torch.models.gpt import build_functional_train_step

    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, max_seq_len=64, **over)
    cpu = GPTParams(cfg, device="cpu", dtype=torch.float32, seed=2)
    card = GPTParams(cfg, device=dev, dtype=torch.float32, seed=2)
    card.load_state_dict(cpu.state_dict())
    names = {p.data_ptr(): n for n, p in cpu.named_parameters()}
    names = [names[p.data_ptr()] for p in cpu.leaves()]
    init = [p.detach().clone() for p in cpu.leaves()]
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, (2, 64))
    labels = rng.randint(0, 512, (2, 64))
    out = {}
    for name, model in (("card", card), ("cpu", cpu)):
        step, params, opt = build_functional_train_step(
            model, remat=remat, ce_chunk_rows=32)
        reset_launch_counts()
        losses = []
        for _ in range(2):
            params, opt, loss = step(params, opt, ids, labels)
            losses.append(float(loss))
        out[name] = (losses, [p.cpu() for p in params], dict(KERNELS))
    (lc, pc, kc), (lh, ph, kh) = out["card"], out["cpu"]
    assert kc["flash_bwd_dq"] == kc["flash_bwd_dkv"] == 4
    assert kc["flash_fwd"] == (8 if remat else 4)
    assert kc["w8a8_gemm"] == (2 * 2 * 4 * 2 if over.get("int8") else 0)
    assert not any(kh.values())                 # the CPU launches nothing
    np.testing.assert_allclose(lc, lh, rtol=1e-4)
    ratios = _update_ratios(cfg, names, pc, ph, init)
    print("update ratios, card vs cpu:",
          {n: float(f"{r:.3e}") for n, r in ratios.items()})
    assert max(ratios.values()) <= update_rtol, ratios


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["bf16", "int8", "int4"])
def test_handoff_roundtrip_on_card(dev, bits):
    """export_pages -> host numpy -> ingest_pages into other pages of
    another pool on the card is byte-equal, page bytes and scales alike,
    for bf16 (which travels as its uint16 bit patterns), int8 and int4."""
    from paddle_tpu_torch.serving import KVPool

    g = torch.Generator(device=dev).manual_seed(3)
    kw = dict(num_pages=12, page_size=32, dtype=torch.bfloat16, device=dev,
              num_kv_heads=2, kv_bits=bits)
    src, dst = KVPool(2, 4, 128, **kw), KVPool(2, 4, 128, **kw)
    for buf in src.buffers.values():
        if buf.dtype == torch.int8:
            buf.copy_(torch.randint(-128, 128, buf.shape, device=dev,
                                    generator=g, dtype=torch.int8))
        else:
            buf.copy_(torch.randn(buf.shape, device=dev, generator=g))
    pages = src.alloc(5)
    payload = src.export_pages(pages)
    if bits is None:
        assert payload["buffers"]["k"].dtype.name == "uint16"
        assert payload["layout"]["page_dtype"] == "bfloat16"
    into = dst.alloc(7)[2:]
    dst.ingest_pages(payload, into)
    for name, buf in src.buffers.items():
        a, b = buf[:, pages], dst.buffers[name][:, into]
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    assert src.payload_nbytes(payload) == sum(
        buf[:, pages].numel() * buf.element_size()
        for buf in src.buffers.values())


@pytest.mark.cuda
def test_double_buffer_leaves_the_decode_in_flight(dev, monkeypatch):
    """With double_buffer=True the decode dispatched in one step is still
    running on the card when the next step retires it: no host sync sits
    between dispatch and retire.  A spin kernel queued ahead of each
    dispatch keeps the card busy, so the engine's flag
    (``retires_in_flight``), not a time, shows it; any sync in dispatch or
    in the next step's admission would have drained the spin first."""
    from paddle_tpu_torch.models import GPTConfig, GPTParams
    from paddle_tpu_torch.serving import ServingEngine

    cfg = GPTConfig(vocab_size=4096, hidden_size=512, num_layers=4,
                    num_heads=4, max_seq_len=256)
    model = GPTParams(cfg, seed=0)
    eng = ServingEngine(model, max_slots=2, page_size=32, double_buffer=True)
    rid = eng.add_request(torch.arange(40).numpy(), 8)
    eng.step()                       # admit, prefill, first dispatch
    assert eng._inflight is not None
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))
    dispatch = eng._decode_call

    def spin_then_dispatch(remaining):
        torch.cuda._sleep(200_000_000)          # ~0.1 s of GPU cycles
        return dispatch(remaining)

    eng._decode_call = spin_then_dispatch
    eng.step()                       # retire (not pending), dispatch
    before = eng.retires_in_flight
    eng.step()                       # retire the spun dispatch
    assert eng.retires_in_flight == before + 1
    assert syncs == [] and eng.device_syncs == 0
    assert eng.stats["last_decode_sync_s"] > 0
    eng._decode_call = dispatch
    done = eng.run()
    assert done[rid].reason == "length" and len(done[rid].tokens) == 8


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 96, 50257), (300, 96, 50257),
                                   (8, 1600, 50257), (1024, 1600, 40),
                                   (8, 2048, 50304), (1024, 2048, 50304)],
                         ids=["m8-k96-n50257", "m300-k96-n50257",
                              "m8-k1600-n50257", "m1024-k1600-n40",
                              "head-m8", "head-m1024"])
def test_w8a8_gemm_ragged_and_head_shapes_are_exact_on_card(dev, monkeypatch,
                                                            m, k, n):
    """K and N off the kernel's granularity (a GPT-2 vocabulary of 50257,
    K = 96 and 1600) are padded by the wrapper and stay bit-exact against
    the plain version, and so does the tied int8 head of GPT-1.3B (N =
    50304, K = 2048) at decode and prefill rows; the plain version is
    never reached from the CUDA path."""
    from paddle_tpu_torch.kernels import KERNELS, int8_gemm

    g = torch.Generator(device=dev).manual_seed(m + k + n)
    wq, ws = _gemm_weight(dev, g, n, k)
    x = torch.randn(m, k, device=dev, generator=g)
    x[-1] = 0.0
    plain = int8_gemm.w8a8_gemm_plain
    ref, rxq, rsx = plain(x, wq, ws, return_quantized=True)
    bref = plain(x.bfloat16(), wq, ws)
    monkeypatch.setattr(int8_gemm, "w8a8_gemm_plain",
                        lambda *a, **kw: pytest.fail("plain on the card"))
    before = KERNELS["w8a8_gemm"]
    out, xq, sx = w8a8_gemm(x, wq, ws, return_quantized=True)
    torch.cuda.synchronize()
    assert out.shape == (m, n) and xq.shape == (m, k)
    assert torch.equal(xq, rxq) and torch.equal(sx, rsx)
    assert torch.equal(out, ref)
    assert torch.equal(w8a8_gemm(x.bfloat16(), wq, ws), bref)
    assert KERNELS["w8a8_gemm"] == before + 2


@pytest.mark.cuda
def test_sdpa_with_dropout_launches_no_flash_kernel(dev, monkeypatch):
    """Attention dropout takes the reference's non-kernel path on the card
    too: no flash kernel launches, and with the same injected uniforms the
    card's output matches the CPU's (fp32, 1e-5: summation order)."""
    from paddle_tpu_torch.framework import random as trand
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.kernels.attention import sdpa_dropout

    def uniform(key, shape, device):
        gen = torch.Generator().manual_seed(key)
        return torch.rand(tuple(shape), generator=gen).to(device)

    monkeypatch.setattr(trand, "uniform", uniform)
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = _flash_inputs(dev, g, "bsnd", 2, 4, 2, 64, 64, torch.float32)
    reset_launch_counts()
    out = sdpa(q, k, v, is_causal=True, layout="bsnd", dropout_p=0.1, key=9)
    torch.cuda.synchronize()
    assert not any(KERNELS.values())
    ref = sdpa_dropout(q.cpu(), k.cpu(), v.cpu(), 0.1, 9, is_causal=True,
                       layout="bsnd")
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-5)
    sdpa(q, k, v, is_causal=True, layout="bsnd")
    assert KERNELS["flash_fwd"] == 1


@pytest.mark.cuda
def test_frontend_stream_on_card_equals_its_finished_request(dev):
    """``serve()`` in a background thread (its event loop on another thread
    than the engine's) streams tokens equal to the engine's
    FinishedRequest and to a direct run of the same prompt; the kernels
    launched."""
    import asyncio
    import json
    import threading

    import numpy as np

    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTParams
    from paddle_tpu_torch.serving import ServingEngine, serve

    cfg = GPTConfig(vocab_size=4096, hidden_size=512, num_layers=2,
                    num_heads=4, max_seq_len=256)
    model = GPTParams(cfg, seed=0, dtype=torch.float32)
    prompt = np.arange(3, 43) % 4096
    want = ServingEngine(model, max_slots=2, page_size=32).run(
        [(prompt, 12)])
    want = next(iter(want.values())).tokens
    eng = ServingEngine(model, max_slots=2, page_size=32)
    finished, started = {}, threading.Event()
    orig = eng.step

    def step():
        fins = orig()
        finished.update((f.rid, f) for f in fins)
        return fins

    eng.step = step
    box = {}

    def on_start(fe, shutdown):
        box["port"], box["shutdown"] = fe.port, shutdown
        started.set()

    th = threading.Thread(target=serve, args=(eng,),
                          kwargs=dict(port=0, banner=False,
                                      on_start=on_start), daemon=True)
    th.start()
    assert started.wait(60)

    async def call():
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       box["port"])
        body = json.dumps({"prompt": [int(t) for t in prompt],
                           "max_tokens": 12}).encode()
        writer.write(b"POST /v1/completions HTTP/1.1\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), 120)
        writer.close()
        return raw

    reset_launch_counts()
    try:
        raw = asyncio.run(call())
    finally:
        box["shutdown"]()
        th.join(60)
    assert not th.is_alive()
    head, _, body = raw.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200")
    events = [b[6:] for b in body.decode().split("\n\n")
              if b.startswith("data: ")]
    assert events[-1] == "[DONE]"
    final = json.loads(events[-2])
    streamed = [json.loads(e)["token"] for e in events[:-2]]
    assert streamed == final["tokens"]
    np.testing.assert_array_equal(finished[final["id"]].tokens, streamed)
    np.testing.assert_array_equal(np.asarray(streamed), want)
    assert KERNELS["paged_attention"] > 0 and KERNELS["paged_prefill"] > 0


@pytest.mark.cuda
def test_kernel_int32_products_are_exact_on_card(dev):
    """Row-parallel W8A8's int32 partial sums through the ``w8a8_gemm``
    kernel (``mp_layers._kernel_products``) equal the integer product,
    extremes included, over several K chunks."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import (
        _kernel_products)
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    g = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in ((5, 3000, 40), (64, 4096, 2048), (1, 1024, 16)):
        xq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                           dtype=torch.int8)
        xq[0], wq[0] = 127, 127                  # the largest sums
        reset_launch_counts()
        got = _kernel_products(xq, wq)
        assert KERNELS["w8a8_gemm"] == -(-k // 1024)
        want = (xq.cpu().double() @ wq.cpu().double().t()).to(torch.int32)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_flash_from_shards_matches_whole_sequence_on_card(dev, dtype,
                                                               causal):
    """The ring's flash composition (4 shards in one process: the
    diagonal block causal, earlier blocks whole, later ones skipped)
    against the plain flash versions on the whole sequence, fp32 at 1e-5
    and bf16 at the smoke's FLASH_TOL (3e-2 of the row's rms, at least
    1e-2 of the tensor's, plus 2e-2 of each value)."""
    from paddle_tpu_torch.kernels import ring

    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v, do = (torch.randn(2, 4, 512, 64, device=dev, generator=g)
                   .to(dtype) for _ in range(4))
    qs, ks, vs, dos = ([x.contiguous() for x in t.chunk(4, dim=2)]
                       for t in (q, k, v, do))
    outs, lses = ring._local_ring_forward(qs, ks, vs, causal=causal)
    dqs, dks, dvs = ring._local_ring_backward(qs, ks, vs, outs, lses, dos,
                                              causal=causal)
    out, lse = flash_fwd_plain(q, k, v, causal)
    want = (out, *flash_bwd_plain(q, k, v, out, lse, do, causal))
    got = [torch.cat(t, 2) for t in (outs, dqs, dks, dvs)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                       msg=name)
        else:
            rms = b.square().mean().sqrt()
            row = b.square().mean(-1, keepdim=True).sqrt().clamp_min(
                1e-2 * rms)
            used = ((a - b).abs() / (3e-2 * row + 2e-2 * b.abs())).max()
            assert used <= 1.0, (name, used.item())
    torch.testing.assert_close(torch.cat(lses, 2).reshape(8, 512), lse,
                               rtol=1e-5, atol=1e-5)


# -- the pre-quantized launch (the int8 inference ops) ------------------------


@pytest.mark.parametrize("path", ["split", "wgmma"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 16), (5, 100, 40), (16, 768, 2304),
                                   (300, 3072, 768), (1000, 200, 1000)])
@pytest.mark.cuda
def test_w8a8_gemm_prequant_matches_plain_on_card(dev, m, k, n, path):
    """Rows quantized beforehand (per tensor) through either GEMM body at
    ragged M, K and N: the int32 sums bit for bit (unit scales, every
    |sum| below 2^24 so that fp32 holds it exactly), and the rescaled
    output bit for bit, both products rounded one at a time."""
    from paddle_tpu_torch.kernels.int8_gemm import (gemm_plan, pad_operands,
                                                    w8a8_gemm_prequant,
                                                    w8a8_gemm_prequant_plain)

    g = torch.Generator(device=dev).manual_seed(m * 7 + k)
    xq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                       dtype=torch.int8)
    sx = torch.rand(m, 1, device=dev, generator=g) * 0.02 + 1e-3
    ws = torch.rand(n, device=dev, generator=g) * 0.02 + 1e-3
    xp, wp, _ = pad_operands(xq, wq, ws)
    plan = gemm_plan(m, wp.shape[0], xp.shape[1], path=path)
    ones_m, ones_n = torch.ones(m, 1, device=dev), torch.ones(n, device=dev)
    acc = w8a8_gemm_prequant(xq, ones_m, wq, ones_n, plan=plan)
    _, want_acc = w8a8_gemm_prequant_plain(xq, ones_m, wq, ones_n,
                                           return_acc=True)
    assert want_acc.abs().max().item() < 2 ** 24
    assert torch.equal(acc, want_acc.float())
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        out = w8a8_gemm_prequant(xq, sx, wq, ws, out_dtype=dt, plan=plan)
        want = w8a8_gemm_prequant_plain(xq, sx, wq, ws, out_dtype=dt)
        assert out.dtype == dt and torch.equal(out, want)


@pytest.mark.cuda
def test_quantized_matmul_forms_on_card_match_cpu(dev):
    """The registered quantized_matmul on the card against its CPU run:
    per tensor, with a calibrated XScale and the batched [B, K, N] form
    bit for bit (the same rescale order on both), per_token within fp32
    rounding of the rescale (the card's rescale rounds after each
    product, as w8a8_gemm's)."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.ops.quant_ops import quantized_matmul_kernel

    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 7, 96, generator=g)
    w = torch.randint(-127, 128, (96, 40), generator=g, dtype=torch.int8)
    ws = torch.rand(40, generator=g) * 0.01
    wb = torch.randint(-127, 128, (2, 96, 40), generator=g, dtype=torch.int8)
    wsb = torch.rand(2, 40, generator=g) * 0.01
    cases = [({"X": x, "Y": w, "WScale": ws}, {}, 0),
             ({"X": x, "Y": w, "WScale": ws,
               "XScale": torch.tensor([2.5])}, {}, 0),
             ({"X": x, "Y": wb, "WScale": wsb}, {}, 0),
             ({"X": x, "Y": w, "WScale": ws}, {"per_token": True}, 1e-6)]
    for ins, attrs, rtol in cases:
        cpu = quantized_matmul_kernel(ins, attrs)["Out"]
        reset_launch_counts()
        card = quantized_matmul_kernel(
            {k: v.to(dev) for k, v in ins.items()}, attrs)["Out"]
        launched = KERNELS["w8a8_gemm"] + KERNELS["w8a8_gemm_prequant"]
        assert launched == (2 if ins["Y"].dim() == 3 else 1)
        torch.testing.assert_close(card.cpu(), cpu, rtol=rtol, atol=0)


@pytest.mark.cuda
def test_int8_predictor_on_card_matches_cpu(dev, tmp_path):
    """A small MLP saved by jit.save, run by an int8 Predictor on the card
    and on the CPU: quantized_matmul launches the pre-quantized GEMM, and
    the outputs agree bit for bit (the same quantization decisions and
    rescale order)."""
    import numpy as np

    import paddle_tpu_torch as tp
    from paddle_tpu_torch import inference, jit, nn
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    tp.set_device("cpu")
    tp.seed(0)
    model = nn.Sequential(nn.Linear(64, 128), nn.ReLU(), nn.Linear(128, 32))
    model.eval()
    path = str(tmp_path / "mlp")
    jit.save(model, path, input_spec=[jit.InputSpec([None, 64], "float32")])
    x = np.random.RandomState(0).randn(24, 64).astype("float32")
    outs = {}
    for device in ("cpu", "gpu"):
        tp.set_device(device)
        cfg = inference.Config(path)
        if device == "cpu":
            cfg.disable_gpu()
        cfg.enable_int8(min_weight_elements=0)
        pred = inference.create_predictor(cfg)
        reset_launch_counts()
        (outs[device],) = pred.run([x])
        assert pred._n_int8 == 2
        assert KERNELS["w8a8_gemm_prequant"] == (2 if device == "gpu" else 0)
    np.testing.assert_array_equal(outs["gpu"], outs["cpu"])


def _cpu_and_card(build):
    """``build()`` made on the CPU (seed 0), and a copy of it on the card
    with the same weights."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.weights import load_paddle_state_dict

    nets = {}
    for device in ("cpu", "gpu"):
        tp.set_device(device)
        tp.seed(0)
        nets[device] = build()
    load_paddle_state_dict(nets["gpu"], {
        k: v.numpy() for k, v in nets["cpu"].state_dict().items()})
    return nets


def _worst(got, want):
    import numpy as np

    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.cuda
def test_lstm_step_on_card_matches_cpu(dev):
    """One step of a 2-layer LSTM language model (forward, backward, SGD
    with a global-norm clip) on the card against the CPU: the loss and
    every updated parameter within 1e-4 of its largest value (TF32 off,
    phase 15 (b)'s tolerance)."""
    import numpy as np

    import paddle_tpu_torch as tp
    from paddle_tpu_torch import nn

    class LM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(100, 32)
            self.lstm = nn.LSTM(32, 32, 2)
            self.head = nn.Linear(32, 100)

        def forward(self, ids):
            out, _ = self.lstm(self.embedding(ids))
            return self.head(out)

    nets = _cpu_and_card(LM)
    ids = np.random.RandomState(0).randint(0, 100, (4, 9))
    got = {}
    for device, net in nets.items():
        tp.set_device(device)
        opt = tp.optimizer.SGD(1.0, parameters=net.parameters(),
                               grad_clip=nn.ClipGradByGlobalNorm(5.0))
        logits = net(tp.to_tensor(ids[:, :-1]))
        loss = nn.functional.cross_entropy(
            tp.reshape(logits, [-1, 100]),
            tp.reshape(tp.to_tensor(ids[:, 1:]), [-1, 1]))
        loss.backward()
        opt.step()
        got[device] = {"loss": loss.numpy(), **{
            k: v.numpy() for k, v in net.state_dict().items()}}
    for k, want in got["cpu"].items():
        assert _worst(got["gpu"][k], want) <= 1e-4, k


@pytest.mark.cuda
def test_conv3d_forward_and_backward_on_card_match_cpu(dev):
    """A Conv3D + MaxPool3D block, forward and backward, on the card (cuDNN,
    TF32 off) against the CPU within 1e-4 of each tensor's largest."""
    import numpy as np

    import paddle_tpu_torch as tp
    from paddle_tpu_torch import nn

    nets = _cpu_and_card(lambda: nn.Sequential(
        nn.Conv3D(3, 8, 3, padding=1), nn.ReLU(), nn.MaxPool3D((1, 2, 2)),
        nn.Conv3D(8, 4, [3, 1, 2], stride=[1, 2, 1], padding=[1, 0, 1])))
    x = np.random.RandomState(1).randn(2, 3, 4, 8, 8).astype("float32")
    got = {}
    for device, net in nets.items():
        tp.set_device(device)
        xt = tp.to_tensor(x, stop_gradient=False)
        out = net(xt)
        tp.sum(out * out).backward()
        got[device] = {"out": out.numpy(), "x": xt.grad.numpy(), **{
            n: p.grad.numpy() for n, p in net.named_parameters()}}
    for k, want in got["cpu"].items():
        assert _worst(got["gpu"][k], want) <= 1e-4, k


@pytest.mark.cuda
def test_beam_search_step_on_card_matches_cpu(dev):
    """One step of beam search (beam 3) through a 2-layer
    ``nn.TransformerDecoder`` over its caches: on the card the encoder
    launches 2 ``flash_fwd`` and the step 4 (2 against the growing
    ``Cache``, 2 against the ``StaticCache`` with the pad bias); ids equal
    and scores within 1e-5 of the CPU's."""
    import numpy as np

    import paddle_tpu_torch as tp
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(50, 64)
            self.transformer = nn.Transformer(64, 4, 2, 2, 64, dropout=0.0)

        def logits(self, h):
            return tp.matmul(h, self.embedding.weight, transpose_y=True)

    nets = _cpu_and_card(Seq2Seq)
    src = np.random.RandomState(2).randint(3, 50, (2, 7))
    bias = np.zeros((2, 1, 1, 7), "float32")
    bias[1, ..., 4:] = -1e9
    mha = nn.MultiHeadAttention
    got = {}
    for device, model in nets.items():
        tp.set_device(device)
        model.eval()
        reset_launch_counts()
        with tp.no_grad():
            m = tp.to_tensor(bias)
            memory = model.transformer.encoder(
                model.embedding(tp.to_tensor(src)), m)
            caches = model.transformer.decoder.gen_cache(memory)
            states = [memory, m] + [t for inc, st in caches
                                    for t in (inc.k, inc.v, st.k, st.v)]

            def cell(ids, states):
                cache = [(mha.Cache(*states[2 + 4 * i:4 + 4 * i]),
                          mha.StaticCache(*states[4 + 4 * i:6 + 4 * i]))
                         for i in range(2)]
                h, new = model.transformer.decoder(
                    model.embedding(ids), states[0], None, states[1], cache)
                return tp.squeeze(h, [1]), states[:2] + [
                    t for inc, st in new for t in (inc.k, inc.v, st.k, st.v)]

            dec = nn.BeamSearchDecoder(
                cell, 1, 2, 3, embedding_fn=lambda t: tp.unsqueeze(t, [-1]),
                output_fn=model.logits)
            ids, scores = nn.dynamic_decode(dec, inits=states,
                                            max_step_num=1)
        got[device] = ids.numpy(), scores.numpy(), KERNELS["flash_fwd"]
    assert got["gpu"][2] == 2 + 4 and got["cpu"][2] == 0
    np.testing.assert_array_equal(got["gpu"][0], got["cpu"][0])
    np.testing.assert_allclose(got["gpu"][1], got["cpu"][1], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_detection_ops_match_cpu_on_card(dev):
    """The detection ops on the card against the same ops on the CPU: the
    NMS's counts, rows and indices exactly (on the same boxes and scores),
    the others within 1e-5 of each output's largest magnitude, and
    ``deform_conv2d``'s gradients too."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.dygraph.tensor import Tensor
    from paddle_tpu_torch.vision import ops

    rng = np.random.RandomState(3)
    xy = rng.rand(2, 300, 2).astype("float32") * 500
    boxes = np.concatenate([xy, xy + rng.rand(2, 300, 2).astype("float32")
                            * 120 + 4], -1)
    scores = rng.rand(2, 6, 300).astype("float32")
    feat = rng.randn(2, 16, 20, 24).astype("float32")
    rois = np.concatenate([rng.rand(40, 2) * 200, rng.rand(40, 2) * 150
                           + 200], 1).astype("float32")
    x = rng.randn(2, 8, 9, 9).astype("float32")
    off = (rng.randn(2, 18, 9, 9) * 1.5).astype("float32")
    mask = rng.rand(2, 9, 9, 9).astype("float32")
    w = (rng.randn(12, 8, 3, 3) * 0.1).astype("float32")

    def run(device):
        def t(a, grad=False):
            return Tensor(torch.as_tensor(a, device=device),
                          stop_gradient=not grad)
        out, nums, idx = ops.multiclass_nms(
            t(boxes), t(scores), 0.05, 200, 100, nms_threshold=0.45,
            normalized=False, background_label=-1, return_index=True)
        ra = ops.roi_align(t(feat), t(rois),
                           boxes_num=t(np.array([25, 15], "int32")),
                           output_size=7, spatial_scale=1 / 16)
        leaves = [t(a, True) for a in (x, off, w, mask)]
        y = ops.deform_conv2d(leaves[0], leaves[1], leaves[2], padding=1,
                              mask=leaves[3])
        paddle.sum(y * y).backward()
        return ([out, nums, idx, ra, y] + [v.grad for v in leaves])

    got = [a._t.cpu() for a in run(dev)]
    paddle.set_device("cpu")
    try:
        want = [a._t for a in run(torch.device("cpu"))]
    finally:
        paddle.set_device("gpu")
    assert all(a.device.type == "cpu" for a in want)
    for i in range(3):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)
    for g, w_ in zip(got[3:], want[3:]):
        assert float((g - w_).abs().max()) <= 1e-5 * float(w_.abs().max())


@pytest.mark.cuda
def test_asp_gradient_merge_ema_on_card_match_cpu(dev):
    """An MLP pruned 2:4, stepped by GradientMerge(decorate(Momentum),
    k=2) with an EMA, 4 micro-steps on the card against the CPU: the masks
    equal bit for bit, every parameter and EMA shadow within 1e-5 of its
    largest value (TF32 off; momentum's update is linear in the gradient,
    so a zero-initialised bias is held as tightly as a weight), sparsity
    held after each update."""
    import numpy as np

    import paddle_tpu_torch as tp
    from paddle_tpu_torch import incubate, nn
    from paddle_tpu_torch.incubate import asp

    def build():
        return nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 8))

    nets = _cpu_and_card(build)
    r = np.random.RandomState(0)
    batches = [(r.randn(8, 16).astype("float32"),
                r.randn(8, 8).astype("float32")) for _ in range(4)]
    got = {}
    for device, net in nets.items():
        tp.set_device(device)
        asp._helper.reset()
        helper = asp.prune_model(net, 2, 4)
        opt = incubate.GradientMergeOptimizer(asp.decorate(
            tp.optimizer.Momentum(0.05, parameters=net.parameters())),
            k_steps=2)
        ema = incubate.ExponentialMovingAverage(net.parameters(), 0.9)
        for i, (x, y) in enumerate(batches):
            nn.functional.mse_loss(net(tp.to_tensor(x)),
                                   tp.to_tensor(y)).backward()
            opt.step()
            if i % 2 == 1:
                ema.update()
                for k, p in helper._params.items():
                    assert asp.check_sparsity(p, 2, 4)
        got[device] = {
            "masks": [m.cpu().numpy() for m in helper._masks.values()],
            "params": [p.numpy() for p in net.parameters()],
            "ema": [s.cpu().numpy() for s in ema._shadow.values()]}
        asp._helper.reset()
    for a, b in zip(got["gpu"]["masks"], got["cpu"]["masks"]):
        np.testing.assert_array_equal(a, b)
    for key in ("params", "ema"):
        for a, b in zip(got["gpu"][key], got["cpu"][key]):
            assert _worst(a, b) <= 1e-5, key


@pytest.mark.cuda
def test_custom_op_on_a_card_tensor_matches_relu(dev, tmp_path):
    """A custom C++ ReLU (``cpp_extension.load``, g++) on a CUDA tensor:
    the op runs on a host copy and its output and gradient come back to
    the card, equal to ``F.relu``'s bit for bit."""
    import os

    import paddle_tpu_torch as tp
    from paddle_tpu_torch.utils import cpp_extension

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "custom_op_src", "relu2_op.cc")
    ext = cpp_extension.load("relu2_ext", [src],
                             build_directory=str(tmp_path))
    tp.set_device("gpu")
    x = torch.randn(64, 128, device=dev)
    g = torch.randn(64, 128, device=dev)
    tx = tp.Tensor(x, stop_gradient=False)
    out = ext.relu2(tx)
    out.backward(tp.Tensor(g))
    assert out._t.device.type == "cuda" and tx.grad._t.device.type == "cuda"
    xr = x.clone().requires_grad_(True)
    ref = torch.nn.functional.relu(xr)
    ref.backward(g)
    assert torch.equal(out._t, ref) and torch.equal(tx.grad._t, xr.grad)

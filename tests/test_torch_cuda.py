"""The port's CUDA kernels against their plain versions, on the card.

Skips where PyTorch sees no CUDA device.  This file imports neither JAX nor
the reference package, so it also runs on a machine that has only the
port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from paddle_tpu_torch.kernels import (paged_attention, paged_attention_mq,
                                      paged_attention_mq_plain,
                                      paged_attention_plain, paged_prefill,
                                      paged_prefill_plain, w8a8_gemm,
                                      w8a8_gemm_plain)
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


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 6144), (8192, 2048), (128, 48)])
def test_w8a8_gemm_is_exact_on_card(dev, k, n):
    """The W8A8 kernel equals its plain version bit for bit: the quantized
    activations and their scales, and the fp32 output (the same int32
    sums, converted and rescaled in the same order); bf16 output is the
    same fp32 rounded once."""
    g = torch.Generator(device=dev).manual_seed(k + n)
    w = torch.randn(n, k, device=dev, generator=g) * 0.02
    ws = w.abs().amax(1).clamp_min(1e-8) / 127.0
    wq = torch.round(w / ws[:, None]).clamp(-127, 127).to(torch.int8)
    for m in (1, 8, 40, 128):
        x = torch.randn(m, k, device=dev, generator=g)
        x[-1] = 0.0                      # all-zero row: the 1e-8 clamp
        out, xq, sx = w8a8_gemm(x, wq, ws, return_quantized=True)
        ref, rxq, rsx = w8a8_gemm_plain(x, wq, ws, return_quantized=True)
        assert torch.equal(xq, rxq) and torch.equal(sx, rsx)
        assert torch.equal(out, ref)
        xb = x.to(torch.bfloat16)
        assert torch.equal(w8a8_gemm(xb, wq, ws), w8a8_gemm_plain(xb, wq, ws))
    with pytest.raises(ValueError):
        w8a8_gemm(x[:, :-1].contiguous(), wq, ws)      # K != wq's K

"""The port's quantization numerics against the JAX reference.

``paddle_tpu_torch.ops.quant_ops`` must make the reference's decisions bit
for bit (``max(absmax, 1e-8) / 127`` or ``/ 7`` scales, a true division,
round half to even, the clip, the split-halves nibble layout), so every
test of those functions here is exact.  ``w8a8_gemm_plain`` is held
against the reference's ``w8a8_gemm_ref`` and its Pallas kernel run by the
interpreter: the quantized activations and the int32 sums are identical and
the output agrees to 1e-6 relative.  The plain versions of the quantized
paged decode and prefill kernels are held at rtol = atol = 1e-5 against
``paged_attention_ref`` / ``paged_prefill_ref`` and the interpreted Pallas
kernels over group {1, 2} x window x bits {8, 4}.  The CUDA kernels
themselves are compared with the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import int8_gemm as jgemm
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.kernels import paged_prefill as jpp
from paddle_tpu.ops import quant_ops as jq
from paddle_tpu_torch.kernels import (KERNELS, paged_attention,
                                      paged_attention_plain, paged_prefill,
                                      paged_prefill_plain, w8a8_gemm,
                                      w8a8_gemm_plain)
from paddle_tpu_torch.ops import quant_ops as tq
from torch_parity import interpretable  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)

def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _activations(rng, qmax):
    """Rows that exercise every decision: random rows at several scales,
    an all-zero row (the 1e-8 clamp), a row with absmax ``qmax`` whose
    scale is exactly 1 so ``x / s`` lands on .5 ties (half to even), and
    the same ties negated."""
    x = rng.randn(6, 64).astype(np.float32) * np.float32([[1e-3], [0.02],
                                                          [1.0], [3.0],
                                                          [50.0], [1e4]])
    zero = np.zeros((1, 64), np.float32)
    ties = np.zeros((1, 64), np.float32)
    ties[0, :9] = [qmax, 0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, -0.5]
    return np.concatenate([x, zero, ties, -ties])


def _assert_same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# quant ops: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_per_token_is_bit_exact(dtype):
    x = _activations(np.random.RandomState(0), 127.0).reshape(3, 3, 64)
    tx = _t(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    txq, tsx = tq.quantize_per_token(tx)
    jxq, jsx = jq.quantize_per_token(jx)
    _assert_same(txq, jxq)
    _assert_same(tsx, jsx)
    # the ties row: scale exactly 1, halves rounded to even
    assert tsx.reshape(-1)[7] == 1.0
    np.testing.assert_array_equal(txq.reshape(9, 64)[7, :9].numpy(),
                                  [127, 0, 2, 2, 4, 4, 6, 6, 0])
    # the all-zero row: scale is the 1e-8 clamp over 127, values 0
    assert tsx.reshape(-1)[6] == np.float32(np.float32(1e-8) / np.float32(127))
    assert not txq.reshape(9, 64)[6].any()


def test_quantize_int4_per_token_is_bit_exact():
    x = _activations(np.random.RandomState(1), 7.0)
    tpk, tsx = tq.quantize_int4_per_token(_t(x))
    jpk, jsx = jq.quantize_int4_per_token(jnp.asarray(x))
    _assert_same(tpk, jpk)
    _assert_same(tsx, jsx)
    assert tpk.shape == (9, 32) and tsx.shape == (9, 1)
    vals = tq.unpack_int4(tpk)
    np.testing.assert_array_equal(vals[7, :9].numpy(),
                                  [7, 0, 2, 2, 4, 4, 6, 6, 0])
    assert int(vals.abs().max()) <= 7
    _assert_same(tq.dequantize_int4(tpk, tsx),
                 jq.dequantize_int4(jpk, jsx))


def test_pack_int4_all_nibble_pairs_and_every_byte():
    """All 225 pairs of int4 values (-7..7) through pack and unpack, and
    every one of the 256 bytes through unpack: the int32 -> int8 wrap of
    a packed byte and the nibble sign extension match the reference."""
    v = np.arange(-7, 8, dtype=np.int8)
    lo, hi = np.meshgrid(v, v, indexing="ij")
    q = np.stack([lo.reshape(-1), hi.reshape(-1)], axis=1)      # (225, 2)
    tp = tq.pack_int4(_t(q))
    _assert_same(tp, jq.pack_int4(jnp.asarray(q)))
    _assert_same(tq.unpack_int4(tp), q)
    every = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    _assert_same(tq.unpack_int4(_t(every)), jq.unpack_int4(jnp.asarray(every)))
    # split halves: byte i holds d = i (low) and d = i + D/2 (high)
    q8 = np.array([[1, -2, 3, -4, -5, 6, -7, 0]], np.int8)
    packed = tq.pack_int4(_t(q8)).numpy().view(np.uint8)[0]
    np.testing.assert_array_equal(packed & 0xF,
                                  np.int8([1, -2, 3, -4]).view(np.uint8) & 0xF)
    np.testing.assert_array_equal(packed >> 4,
                                  np.int8([-5, 6, -7, 0]).view(np.uint8) & 0xF)


@pytest.mark.parametrize("axis", [1, 0])
def test_quantize_per_channel_is_bit_exact(axis):
    rng = np.random.RandomState(2 + axis)
    w = (rng.randn(96, 48) * 0.05).astype(np.float32)
    w[:, 5] = 0.0                      # an all-zero output channel
    w[7, :] = 0.0
    twq, tws = tq.quantize_per_channel(_t(w), axis=axis)
    jwq, jws = jq.quantize_per_channel(jnp.asarray(w), axis=axis)
    _assert_same(twq, jwq)
    _assert_same(tws, jws)


def test_w8a8_apply_matches_reference():
    """The decode path's ``x @ W``: the port's weight is the reference's
    (K, N) int8 weight transposed to (N, K)."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 64).astype(np.float32)
    wq, ws = jq.quantize_per_channel(jnp.asarray(rng.randn(64, 32) * 0.1),
                                     axis=1)
    ref = np.asarray(jq.w8a8_apply(jnp.asarray(x), wq, ws))
    out = tq.w8a8_apply(_t(x), _t(np.asarray(wq).T), _t(np.asarray(ws)))
    assert out.shape == (2, 5, 32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)
    bf = tq.w8a8_apply(_t(x), _t(np.asarray(wq).T), _t(np.asarray(ws)),
                       out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# W8A8 GEMM: the plain version against the reference's ref and kernel
# ---------------------------------------------------------------------------


def _gemm_operands(rng, m, k, n):
    x = rng.randn(m, k).astype(np.float32) * 2.0
    x[-1] = 0.0                                    # the 1e-8 clamp
    wq, ws = jq.quantize_per_channel(
        jnp.asarray(rng.randn(k, n).astype(np.float32) * 0.05), axis=1)
    return x, np.asarray(wq), np.asarray(ws)


@pytest.mark.parametrize("m,k,n", [(16, 256, 256), (8, 128, 384)])
def test_w8a8_gemm_plain_matches_reference(m, k, n, interpretable):
    x, wq, ws = _gemm_operands(np.random.RandomState(m + k + n), m, k, n)
    out, txq, tsx = w8a8_gemm_plain(_t(x), _t(wq.T), _t(ws),
                                    return_quantized=True)
    jxq, jsx = jq.quantize_per_token(jnp.asarray(x))
    _assert_same(txq, jxq)
    _assert_same(tsx, jsx)
    # the int32 sums are identical
    acc = txq.double() @ _t(wq.T).double().t()
    jacc = jax.lax.dot_general(jxq, jnp.asarray(wq), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy().astype(np.int64),
                                  np.asarray(jacc).astype(np.int64))
    jargs = (jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws))
    ref = np.asarray(jgemm.w8a8_gemm_ref(*jargs))
    kern = np.asarray(jgemm.w8a8_gemm(*jargs, interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(out.numpy(), kern, rtol=1e-6, atol=0)


def test_w8a8_gemm_cpu_takes_the_plain_version_without_launching():
    x, wq, ws = _gemm_operands(np.random.RandomState(7), 5, 64, 48)
    before = dict(KERNELS)
    out = w8a8_gemm(_t(x), _t(wq.T), _t(ws))
    assert torch.equal(out, w8a8_gemm_plain(_t(x), _t(wq.T), _t(ws)))
    bf = w8a8_gemm(_t(x).bfloat16(), _t(wq.T), _t(ws))
    assert bf.dtype == torch.bfloat16
    assert KERNELS == before
    with pytest.raises(ValueError):
        w8a8_gemm(_t(x).to("meta"), _t(wq.T).to("meta"), _t(ws).to("meta"))


# ---------------------------------------------------------------------------
# quantized paged pages: the plain versions against the reference
# ---------------------------------------------------------------------------


def _qpages(rng, P, HKV, PS, D, bits):
    """Random pages quantized by the REFERENCE's rule, as numpy: values
    int8 (P, Hkv, ps, D) or packed int4 (…, D/2), scales (P, Hkv, ps, 1)."""
    quant = jq.quantize_int4_per_token if bits == 4 else jq.quantize_per_token
    out = []
    for _ in range(2):
        vals, sc = quant(jnp.asarray(rng.randn(P, HKV, PS, D)
                                     .astype(np.float32)))
        out += [np.asarray(vals), np.asarray(sc)]
    return out                                     # kq, ks, vq, vs


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("window", [None, 12], ids=["full", "win"])
@pytest.mark.parametrize("group", [1, 2], ids=["mha", "gqa2"])
def test_quantized_decode_plain_matches_reference(group, window, bits,
                                                  interpretable):
    rng = np.random.RandomState(17 * group + bits)
    B, HKV, D, PS, MAXP, P = 3, 2, 16, 8, 4, 10
    q = rng.randn(B, HKV * group, D).astype(np.float32)
    kq, ks, vq, vs = _qpages(rng, P, HKV, PS, D, bits)
    bt = rng.randint(1, P, (B, MAXP)).astype(np.int32)
    lens = np.array([5, 17, 32], np.int32)
    out = paged_attention(_t(q), _t(kq), _t(vq), _t(bt), _t(lens),
                          k_scales=_t(ks), v_scales=_t(vs),
                          window=window).numpy()
    j = [jnp.asarray(a) for a in (q, kq, vq, bt, lens)]
    jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
               window=window)
    ref = np.asarray(jpa.paged_attention_ref(*j, **jkw))
    kern = np.asarray(jpa.paged_attention(*j, interpret=True, **jkw))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, kern, **TOL)


@pytest.mark.parametrize("start,chunk", [(6, 8), (13, 5)],
                         ids=["start6", "ragged5"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("window", [None, 5], ids=["full", "win"])
@pytest.mark.parametrize("group", [1, 2], ids=["mha", "gqa2"])
def test_quantized_prefill_plain_matches_reference(group, window, bits,
                                                   start, chunk,
                                                   interpretable):
    rng = np.random.RandomState(53 * group + bits + start)
    HKV, D, PS, MAXP, P = 2, 16, 8, 4, 9
    q = rng.randn(chunk, HKV * group, D).astype(np.float32)
    kq, ks, vq, vs = _qpages(rng, P, HKV, PS, D, bits)
    bt = rng.randint(1, P, (MAXP,)).astype(np.int32)
    out = paged_prefill(_t(q), _t(kq), _t(vq), _t(bt), start,
                        k_scales=_t(ks), v_scales=_t(vs),
                        window=window).numpy()
    j = [jnp.asarray(a) for a in (q, kq, vq, bt)]
    jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
               window=window)
    ref = np.asarray(jpp.paged_prefill_ref(*j, start, **jkw))
    kern = np.asarray(jpp.paged_prefill(*j, start, interpret=True, **jkw))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, kern, **TOL)


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_gather_pages_dequantizes_as_the_reference(bits):
    """The dense gather with dequant (int4 unpacked first) is exactly the
    reference's ``gather_pages``."""
    rng = np.random.RandomState(bits)
    kq, ks, _, _ = _qpages(rng, 6, 2, 8, 16, bits)
    bt = rng.randint(0, 6, (3, 4)).astype(np.int32)
    from paddle_tpu_torch.kernels import gather_pages
    out = gather_pages(_t(kq), _t(bt), _t(ks), 16)
    ref = jpa.gather_pages(jnp.asarray(kq), jnp.asarray(bt), jnp.asarray(ks),
                           16)
    _assert_same(out, ref)


def test_quantized_page_wrappers_validate_their_operands():
    """The kind of a page pool is read from its shape: a last dim of D is
    int8, D/2 packed int4; a pool that is neither, or scales of the wrong
    shape, is refused before any launch."""
    from paddle_tpu_torch.kernels.paged_attention import _check_pages

    rng = np.random.RandomState(9)
    q = _t(rng.randn(2, 4, 32).astype(np.float32))
    sc = torch.ones(5, 2, 8, 1)
    i8 = torch.zeros(5, 2, 8, 32, dtype=torch.int8)
    i4 = torch.zeros(5, 2, 8, 16, dtype=torch.int8)
    assert _check_pages("t", q, i8, i8, 4, 32, sc, sc) == 8
    assert _check_pages("t", q, i4, i4, 4, 32, sc, sc) == 4
    with pytest.raises(ValueError):
        _check_pages("t", q, i8[..., :8], i8[..., :8], 4, 32, sc, sc)
    with pytest.raises(ValueError):
        _check_pages("t", q, i8, i8, 4, 32, sc[:, :1], sc[:, :1])
    with pytest.raises(ValueError):
        _check_pages("t", q, i8, i8, 4, 32, sc, None)
    with pytest.raises(TypeError):
        _check_pages("t", q, i8.float(), i8.float(), 4, 32, sc, sc)

"""The port's flash attention with q and k of other lengths (Sq != Sk)
against the reference, on the CPU.

The reference's ``_sdpa_reference`` places its queries at positions
``Sk - Sq .. Sk - 1``, so a causal band is aligned at the bottom right.
Here the plain versions (``flash_fwd_plain``, ``flash_bwd_plain``) and
autograd through ``attention`` are held against ``_sdpa_reference`` and
its ``jax.vjp`` at Sq < Sk (causal, and with a window), Sq > Sk (not
causal), Sq = 1 (a decode step), a [B, 1, 1, Sk] pad bias, a full
[B, H, Sq, Sk] bias, GQA in both seq-major layouts, and a -inf decoder
mask (whole rows of -inf key blocks); fp32, 1e-5: the two sides differ
in summation order only.  The gates decide as the reference's:
``kernel_reason`` (what ``sdpa`` on the card asks) takes these lengths
and refuses causal attention with more queries than keys, while
``supported``, ``unsupported_reason`` and ``flash_attention`` refuse
other lengths as ``paddle_tpu.kernels.flash`` does.  ``sdpa`` on CPU
tensors matches the reference's ``sdpa`` at these shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import attention as jatt
from paddle_tpu.kernels import flash as jflash
from paddle_tpu_torch.kernels import attention as tatt
from paddle_tpu_torch.kernels import flash as tflash

TOL = dict(rtol=1e-5, atol=1e-5)

# name, layout, B, H, Hkv, Sq, Sk, D, causal, window, mask kind
CASES = [
    ("causal_chunk", "bnsd", 2, 2, 2, 12, 40, 16, True, None, None),
    ("causal_window", "bsnd", 1, 4, 2, 9, 33, 16, True, 6, None),
    ("more_queries", "sbnd", 2, 2, 1, 30, 11, 32, False, None, None),
    ("decode_step", "bnsd", 3, 4, 4, 1, 37, 16, False, None, "pad"),
    ("decode_causal", "bnsd", 2, 2, 2, 1, 20, 16, True, None, None),
    ("cross_pad", "bnsd", 2, 3, 3, 20, 26, 16, False, None, "pad"),
    ("cross_full_gqa", "bsnd", 2, 6, 2, 14, 23, 16, False, None, "full"),
    ("causal_full_gqa", "sbnd", 2, 4, 2, 10, 17, 16, True, None, "full"),
    ("neginf", "bnsd", 2, 2, 2, 24, 24, 16, False, None, "neginf"),
    ("neginf_offset", "bsnd", 2, 4, 4, 13, 29, 16, False, None, "neginf"),
]


def _to_layout(a, layout):
    return {"bnsd": a, "bsnd": a.transpose(0, 2, 1, 3),
            "sbnd": a.transpose(2, 0, 1, 3)}[layout]


def _from_layout(a, layout):
    return {"bnsd": a, "bsnd": a.transpose(0, 2, 1, 3),
            "sbnd": a.transpose(1, 2, 0, 3)}[layout]


def _t(a, layout):
    return torch.from_numpy(np.ascontiguousarray(_to_layout(a, layout)))


def _mask(kind, b, h, sq, sk, rng):
    """The case's mask as numpy, in the reference's bnsd terms: "pad" 0 /
    -1e4 on 0-Sk/2 padded keys a row ([B, 1, 1, Sk]); "full" a random
    float [B, H, Sq, Sk]; "neginf" -inf above the bottom-right-aligned
    diagonal and on the padded keys ([B, 1, Sq, Sk]), so that a row's
    first key blocks and the padded ones score -inf."""
    if kind in ("pad", "neginf"):
        keep = np.arange(sk)[None, :] < rng.randint(sk // 2, sk + 1, (b, 1))
        if kind == "pad":
            return np.where(keep, 0.0, -1e4).astype(np.float32)[:, None,
                                                                 None]
        band = np.arange(sk)[None, :] <= np.arange(sk - sq, sk)[:, None]
        keep = keep[:, None, None] & band
        return np.where(keep, 0.0, -np.inf).astype(np.float32)
    if kind == "full":
        return rng.randn(b, h, sq, sk).astype(np.float32)
    return None


def _ref_mask(mask, h, hkv):
    """With GQA the reference's logits are [B, Hkv, H/Hkv, Sq, Sk]: a mask
    over q's heads gains that split."""
    if mask is None or h == hkv or mask.ndim < 4:
        return mask
    b, mh = mask.shape[:2]
    return mask.reshape(b, *((hkv, h // hkv) if mh == h else (1, 1)),
                        *mask.shape[2:])


def _case(case, seed):
    _, layout, b, h, hkv, sq, sk, d, causal, window, kind = case
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k, v = (rng.randn(b, hkv, sk, d).astype(np.float32) for _ in range(2))
    return layout, causal, window, q, k, v, _mask(kind, b, h, sq, sk, rng)


def _ref_lse(q, k, causal, window, mask):
    """logsumexp of the reference's scaled, masked scores, (B*H, Sq)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    logits = jnp.einsum("bngqd,bnkd->bngqk",
                        q.reshape(b, hkv, h // hkv, sq, d), k) / np.sqrt(d)
    logits = logits.reshape(b, h, sq, sk)
    if causal:
        i = np.arange(sk - sq, sk)[:, None]
        j = np.arange(sk)[None, :]
        keep = j <= i
        if window is not None:
            keep = keep & (j > i - window)
        logits = jnp.where(keep, logits, -jnp.inf)
    if mask is not None:
        logits = logits + mask
    return jax.nn.logsumexp(logits, axis=-1).reshape(b * h, sq)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_versions_match_reference_at_other_lengths(case):
    """flash_fwd_plain (out and lse) against _sdpa_reference and the
    masked scores' logsumexp; flash_bwd_plain and autograd through
    ``attention`` against jax.vjp of the reference."""
    layout, causal, window, q, k, v, mask = _case(case, seed=3)
    g = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    rmask = _ref_mask(mask, q.shape[1], k.shape[1])

    def ref_fn(q, k, v):
        return jatt._sdpa_reference(
            q, k, v, mask=None if rmask is None else jnp.asarray(rmask),
            is_causal=causal, window=window)

    @jax.jit
    def ref_and_grads(q, k, v, g):
        out, vjp = jax.vjp(ref_fn, q, k, v)
        return out, _ref_lse(q, k, causal, window, mask), vjp(g)

    ref, ref_lse, want = ref_and_grads(*(jnp.asarray(a)
                                         for a in (q, k, v, g)))
    want = [np.asarray(x) for x in want]
    assert all(np.isfinite(w).all() for w in want)

    tq, tk, tv = (_t(a, layout) for a in (q, k, v))
    bias = None if mask is None else tflash._bias_of(
        torch.from_numpy(mask), tq, layout, tk, causal).expand(
            tflash._heads_shape(tq, layout, tk))
    out, lse = tflash.flash_fwd_plain(tq, tk, tv, causal, None, window,
                                      layout, bias)
    assert lse.shape == (q.shape[0] * q.shape[1], q.shape[2])
    np.testing.assert_allclose(_from_layout(out.numpy(), layout),
                               np.asarray(ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
    plain = tflash.flash_bwd_plain(tq, tk, tv, out, lse, _t(g, layout),
                                   causal, None, window, layout, bias)
    aq, ak, av = (x.clone().requires_grad_() for x in (tq, tk, tv))
    tflash.attention(aq, ak, av, causal=causal, layout=layout, window=window,
                     bias=bias).backward(_t(g, layout))
    for got_p, got_a, w in zip(plain, (aq.grad, ak.grad, av.grad), want):
        np.testing.assert_allclose(_from_layout(got_p.numpy(), layout), w,
                                   **TOL)
        np.testing.assert_allclose(_from_layout(got_a.numpy(), layout), w,
                                   **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sdpa_on_cpu_matches_reference_at_other_lengths(case):
    """``sdpa`` on CPU tensors (the plain attention, seq-major layouts
    transposed in and out) against the reference's ``sdpa``."""
    layout, causal, window, q, k, v, mask = _case(case, seed=5)
    rmask = _ref_mask(mask, q.shape[1], k.shape[1])
    want = jax.jit(lambda q, k, v: jatt.sdpa(
        q, k, v, mask=None if rmask is None else jnp.asarray(rmask),
        is_causal=causal, layout=layout, window=window))(
            *(jnp.asarray(_to_layout(a, layout)) for a in (q, k, v)))
    got = tatt.sdpa(*(_t(a, layout) for a in (q, k, v)),
                    mask=None if rmask is None else torch.from_numpy(rmask),
                    is_causal=causal, layout=layout, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gates_at_other_lengths_decide_as_the_reference():
    """kernel_reason takes q and k of other lengths (with a mask that
    broadcasts to [B, H, Sq, Sk]), causal with Sq > Sk included;
    supported / unsupported_reason / flash_attention refuse other lengths
    as the reference's supported and flash_attention do."""
    for layout, qs, ks in (("bnsd", (2, 4, 64, 16), (2, 4, 128, 16)),
                           ("bsnd", (2, 64, 4, 16), (2, 128, 2, 16)),
                           ("sbnd", (1, 2, 4, 16), (128, 2, 2, 16))):
        q, k = torch.zeros(qs), torch.zeros(ks)
        sk = k.shape[tflash._layout_s_axis(layout)]
        assert tflash.kernel_reason(q, k, layout=layout) is None
        assert tflash.kernel_reason(q, k, layout=layout,
                                    is_causal=True) is None
        long_q = torch.zeros(k.shape[:2] + q.shape[2:]) if layout != "bnsd" \
            else torch.zeros(q.shape[:2] + k.shape[2:])
        short_k = torch.zeros(q.shape[:2] + k.shape[2:]) if layout != "bnsd" \
            else torch.zeros(k.shape[:2] + q.shape[2:])
        assert tflash.kernel_reason(long_q, short_k, layout=layout,
                                    is_causal=True) is None
        assert tflash.kernel_reason(long_q, short_k, layout=layout) is None
        pad = torch.zeros(2, 1, 1, sk)
        assert tflash.kernel_reason(q, k, pad, layout) is None
        assert "broadcast" in tflash.kernel_reason(
            q, k, torch.zeros(2, 1, 1, sk + 1), layout)
        for a, b in ((q, k), (k, q)):
            want = jflash.supported(jnp.zeros(a.shape), jnp.zeros(b.shape),
                                    layout=layout)
            assert tflash.supported(a, b, layout=layout) == want is False
            assert "lengths" in tflash.unsupported_reason(a, b,
                                                          layout=layout)
            with pytest.raises(ValueError, match="lengths"):
                tflash.flash_attention(a, b, b, layout=layout)
    q, k = torch.zeros(2, 4, 1, 16), torch.zeros(2, 4, 256, 16)
    bias = tflash._bias_of(torch.zeros(2, 1, 1, 256), q, "bnsd", k).expand(
        tflash._heads_shape(q, "bnsd", k))
    assert bias.shape == (2, 4, 1, 256) and bias.stride()[1] == 0
    # causal Sq > Sk: the rows that see no key average V (no mask)
    out = tflash.attention(k, q, q + torch.arange(16.0), causal=True)
    assert torch.allclose(out[:, :, 0], torch.arange(16.0).expand(2, 4, 16))
    with pytest.raises(ValueError, match="one shape"):
        tflash.flash_fwd_cuda(q, k, k[:, :, :8], False, 0.25, None, "bnsd")

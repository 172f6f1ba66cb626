"""The port's flash attention (plain versions, autograd, gate) and sdpa
against the reference, on the CPU.

* ``flash_fwd_plain`` against the reference's jnp attention
  (``_sdpa_reference``) and ``jax.nn.logsumexp`` of its masked, scaled
  scores; ``flash_bwd_plain`` and autograd through ``flash_attention``
  against ``jax.vjp`` of ``_sdpa_reference``; every layout, causal or
  not, a window, GQA in the seq-major layouts, a custom scale.  fp32,
  1e-5: the two sides differ only in summation order.
* ``supported``, ``_pick_block`` and ``flash_attention``'s ValueErrors
  decide as the reference's over a grid of shapes.
* The plain versions against the reference's interpreted Pallas bodies
  (``_fwd_call``, ``_bwd_call``, ``_fwd_call_smajor``,
  ``_bwd_call_smajor`` with ``interpret=True``), in test functions of
  their own.
* ``sdpa`` on CPU tensors against the reference's ``sdpa``.
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
from torch_parity import interpretable  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)

# layout, B, H, Hkv, S, D, causal, window, scale
CASES = [
    ("bnsd", 2, 2, 2, 24, 16, True, None, None),
    ("bnsd", 2, 3, 3, 16, 32, False, None, None),
    ("bnsd", 1, 2, 2, 40, 16, True, 7, 0.3),
    ("bsnd", 2, 4, 2, 24, 16, True, None, None),
    ("bsnd", 2, 4, 1, 32, 16, False, None, 0.5),
    ("bsnd", 1, 2, 2, 40, 24, True, 9, None),
    ("sbnd", 2, 4, 4, 24, 16, True, None, None),
    ("sbnd", 2, 6, 2, 16, 16, True, 5, None),
    ("sbnd", 1, 2, 1, 32, 32, False, None, 0.2),
]
IDS = [f"{c[0]}-h{c[2]}/{c[3]}-{'causal' if c[6] else 'full'}"
       f"{'-w' + str(c[7]) if c[7] else ''}{'-scale' if c[8] else ''}"
       for c in CASES]


def _to_layout(a, layout):
    """A [B, H, S, D] array in ``layout``."""
    return {"bnsd": a, "bsnd": a.transpose(0, 2, 1, 3),
            "sbnd": a.transpose(2, 0, 1, 3)}[layout]


def _from_layout(a, layout):
    return {"bnsd": a, "bsnd": a.transpose(0, 2, 1, 3),
            "sbnd": a.transpose(1, 2, 0, 3)}[layout]


def _inputs(case, seed=0):
    layout, b, h, hkv, s, d = case[:6]
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, s, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32))


def _t(a, layout):
    return torch.from_numpy(np.ascontiguousarray(_to_layout(a, layout)))


def _ref(q, k, v, causal, window, scale):
    return _ref_fn(causal, window, scale)(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))


def _ref_fn(causal, window, scale):
    return lambda q, k, v: jatt._sdpa_reference(
        q, k, v, scale=scale, is_causal=causal, window=window)


def _ref_lse(q, k, causal, window, scale):
    """logsumexp of the reference's masked, scaled scores, (B*H, S)."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    sc = scale if scale is not None else 1.0 / np.sqrt(d)
    qg = jnp.asarray(q).reshape(b, hkv, h // hkv, s, d)
    logits = jnp.einsum("bngqd,bnkd->bngqk", qg, jnp.asarray(k)) * sc
    if causal:
        i, j = np.arange(s)[:, None], np.arange(s)[None, :]
        keep = j <= i
        if window is not None:
            keep = keep & (j > i - window)
        logits = jnp.where(keep, logits, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(b * h, s)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_fwd_plain_matches_reference_and_logsumexp(case):
    layout, *_, causal, window, scale = case
    q, k, v = _inputs(case)
    out, lse = tflash.flash_fwd_plain(_t(q, layout), _t(k, layout),
                                      _t(v, layout), causal, scale, window,
                                      layout)
    np.testing.assert_allclose(_from_layout(out.numpy(), layout),
                               np.asarray(_ref(q, k, v, causal, window,
                                               scale)), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               _ref_lse(q, k, causal, window, scale), **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_grads_match_reference_vjp(case):
    """flash_bwd_plain from the plain forward's out and lse, and autograd
    through flash_attention, both against jax.vjp of the reference."""
    layout, *_, causal, window, scale = case
    q, k, v = _inputs(case, seed=1)
    g = np.random.RandomState(2).randn(*q.shape).astype(np.float32)
    _, vjp = jax.vjp(_ref_fn(causal, window, scale), jnp.asarray(q),
                     jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    tq, tk, tv = (_t(a, layout).requires_grad_() for a in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=causal, scale=scale,
                                 layout=layout, window=window)
    out.backward(_t(g, layout))
    grads = [x.grad for x in (tq, tk, tv)]
    o, lse = tflash.flash_fwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                    causal, scale, window, layout)
    plain = tflash.flash_bwd_plain(tq.detach(), tk.detach(), tv.detach(), o,
                                   lse, _t(g, layout), causal, scale, window,
                                   layout)
    for got_a, got_p, ref in zip(grads, plain, want):
        np.testing.assert_allclose(_from_layout(got_a.numpy(), layout), ref,
                                   **TOL)
        np.testing.assert_allclose(_from_layout(got_p.numpy(), layout), ref,
                                   **TOL)


# the card's masked D=256 flash cases (tests/test_torch_cuda.py), with
# fewer heads: causal at S=200, and window 40 at S=300
FIRST_ROW_CASES = [("bsnd", 1, 2, 1, 200, 256, True, None, None),
                   ("bsnd", 1, 2, 1, 300, 256, True, 40, None)]


def _row_close(got, want, rtol, atol):
    """The card test's elementwise bound: |got - want| <= atol * rms +
    rtol * |want|, with the rms of want's row (at least 1e-2 of the
    tensor's); returns the worst share of the bound used."""
    row = np.sqrt(np.mean(np.square(want), -1, keepdims=True))
    row = np.maximum(row, 1e-2 * np.sqrt(np.mean(np.square(want))))
    return float(np.max(np.abs(got - want) / (atol * row + rtol * np.abs(want))))


@pytest.mark.parametrize("case", FIRST_ROW_CASES,
                         ids=["causal-s200-d256", "window40-s300-d256"])
def test_first_query_dq_matches_reference_exactly(case):
    """fp32 gradients at the masked D=256 shapes, the first query's dQ
    included.  That query sees one key: the reference's autodiff forms
    ``p * (dp - sum(p * dp))`` with p = 1 there, so ``jax.vjp`` gives a dQ
    of 0 exactly; flash_bwd_plain forms ``dp - delta`` in fp64 and gives 0
    up to fp64 rounding.  Every dQ, dK and dV element then agrees with the
    reference within the card's fp32 FLASH_TOL bound, 1e-5 of its row's
    rms, the first row included."""
    layout, *_, causal, window, scale = case
    q, k, v = _inputs(case, seed=3)
    g = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    _, vjp = jax.vjp(_ref_fn(causal, window, scale), jnp.asarray(q),
                     jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    assert not want[0][:, :, 0].any()
    tq, tk, tv = (_t(a, layout) for a in (q, k, v))
    o, lse = tflash.flash_fwd_plain(tq, tk, tv, causal, scale, window, layout)
    got = tflash.flash_bwd_plain(tq, tk, tv, o, lse, _t(g, layout), causal,
                                 scale, window, layout)
    got = [_from_layout(x.numpy(), layout) for x in got]
    assert np.abs(got[0][:, :, 0]).max() <= 1e-12
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert _row_close(x, ref, 1e-5, 1e-5) <= 1.0, name


def test_dq_launch_hands_the_kernel_out(monkeypatch):
    """The dQ kernel's launch passes q, k, v, out, dout, lse, delta, dq,
    the strides of the five [B, S, H, D] views and dq (out stays in the
    C entry point's interface; the kernels read delta), then a null bias
    and its zero strides."""
    import ctypes
    import types

    from paddle_tpu_torch.kernels import _build

    calls = []

    def kernel(name):
        def launch(*a):      # the strides live for the call only
            ptr = ctypes.cast(a[8], ctypes.POINTER(ctypes.c_longlong))
            bptr = ctypes.cast(a[10], ctypes.POINTER(ctypes.c_longlong))
            calls.append((name, a, [ptr[i] for i in range(18)]
                          + [bptr[i] for i in range(4)]))
            return 0
        return launch

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    b, s, h, hkv, d = 2, 16, 4, 2, 16
    q, out, do = (torch.randn(b, s, h, d) for _ in range(3))
    k, v = (torch.randn(b, s, hkv, d) for _ in range(2))
    lse, delta = torch.zeros(b * h, s), torch.zeros(b * h, s, 2)
    dq = tflash.flash_bwd_dq_cuda(q, k, v, out, lse, delta, do, True, 0.25,
                                  None, "bsnd")
    (name, args, strides), = calls
    assert name == "flash_bwd_dq" and dq.shape == q.shape
    assert args[3] == out.data_ptr() and args[4] == do.data_ptr()
    assert args[5] == lse.data_ptr() and args[6] == delta.data_ptr()
    assert strides == [st for t in (q, k, v, out, do, dq)
                       for st in t.stride()[:3]] + [0] * 4
    assert args[9] is None
    assert args[11:16] == (b, h, hkv, s, d)



def test_fwd_launch_reads_bnsd_head_views_in_place(monkeypatch):
    """bnsd q, k, v that are transposed head views of one fused QKV
    tensor, as the paddle GPT hands them over, reach the forward kernel
    in place (their own pointers and [B, S, H, D] strides, B and H not
    flattened into a copy), and lse keeps its rows b * H + h."""
    import ctypes
    import types

    from paddle_tpu_torch.kernels import _build

    calls = []

    def kernel(name):
        def launch(*a):
            ptr = ctypes.cast(a[5], ctypes.POINTER(ctypes.c_longlong))
            calls.append((name, a, [ptr[i] for i in range(12)]))
            return 0
        return launch

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    b, s, h, d = 2, 16, 4, 16
    qkv = torch.randn(b, s, 3 * h * d)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in torch.split(qkv, h * d, dim=-1))
    out, lse = tflash.flash_fwd_cuda(q, k, v, True, 0.25, None, "bnsd")
    (name, args, strides), = calls
    assert name == "flash_fwd" and out.shape == q.shape
    assert lse.shape == (b * h, s)
    assert args[:3] == tuple(t.data_ptr() for t in (q, k, v))
    assert strides == [st for t in (q, k, v, out)
                       for st in t.transpose(1, 2).stride()[:3]]
    assert args[6] is None
    assert args[8:13] == (b, h, h, s, d)

def _shapes():
    for layout in ("bnsd", "bsnd", "sbnd"):
        for s in (4, 8, 12, 24, 40, 100, 520):
            for d in (8, 12, 16, 24, 80, 260):
                for nh, nkv in ((4, 4), (4, 2), (4, 3)):
                    shape = {"bnsd": lambda n: (2, n, s, d),
                             "bsnd": lambda n: (2, s, n, d),
                             "sbnd": lambda n: (s, 2, n, d)}[layout]
                    yield layout, shape(nh), shape(nkv)


def test_supported_and_pick_block_match_reference():
    for s in range(1, 1100, 7):
        assert tflash._pick_block(s) == jflash._pick_block(s)
        assert tflash._pick_block(s, 64) == jflash._pick_block(s, 64)
    n = 0
    for layout, qs, ks in _shapes():
        for mask, drop in ((None, 0.0), (np.ones(1), 0.0), (None, 0.1)):
            want = jflash.supported(np.zeros(qs), np.zeros(ks), mask=mask,
                                    dropout_p=drop, layout=layout)
            got = tflash.supported(torch.empty(qs), torch.empty(ks),
                                   mask=mask, dropout_p=drop, layout=layout)
            assert got == want, (layout, qs, ks, mask, drop)
            n += want
    assert n > 0
    # 3-D q under a seq-major layout, and 2-D q
    for layout in ("bnsd", "bsnd", "sbnd"):
        for shape in ((4, 16, 16), (16, 16)):
            assert (tflash.supported(torch.empty(shape), torch.empty(shape),
                                     layout=layout)
                    == jflash.supported(np.zeros(shape), np.zeros(shape),
                                        layout=layout))


def test_flash_attention_validation_matches_reference(monkeypatch):
    """ValueError where the reference raises one, for the same shapes and
    options; the reference's kernels are stubbed out, so only its checks
    run."""
    monkeypatch.setattr(jflash, "_flash", lambda *a: a[-3])
    monkeypatch.setattr(jflash, "_flash_smajor", lambda *a: a[-3])

    def raises(fn):
        try:
            fn()
        except ValueError:
            return True
        return False

    n = 0
    for layout, qs, ks in _shapes():
        if 0 in qs:
            continue
        for causal, window, bq in ((True, None, None), (False, 8, None),
                                   (True, 4, None), (False, None, 16)):
            kw = dict(causal=causal, window=window, block_q=bq,
                      layout=layout)
            want = raises(lambda: jflash.flash_attention(
                jnp.zeros(qs), jnp.zeros(ks), jnp.zeros(ks), **kw))
            got = raises(lambda: tflash.flash_attention(
                torch.zeros(qs), torch.zeros(ks), torch.zeros(ks), **kw))
            assert got == want, (layout, qs, ks, kw)
            n += want
    assert n > 0
    # cross-attention lengths
    q, k = torch.zeros(2, 2, 16, 16), torch.zeros(2, 2, 24, 16)
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k, k)


# ---------------------------------------------------------------------------
# the reference's interpreted Pallas bodies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 10)],
                         ids=["causal", "full", "window10"])
def test_plain_matches_interpreted_pallas_bnsd(causal, window, interpretable):
    """_fwd_call and _bwd_call (the bnsd sites) in interpret mode, blocks
    of 8 over S=32, against the plain versions."""
    rng = np.random.RandomState(3)
    bh, s, d = 3, 32, 16
    q, k, v, do = (rng.randn(bh, s, d).astype(np.float32) for _ in range(4))
    scale = 0.25
    with jflash._x64_off():
        out, lse = jflash._fwd_call(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), scale, causal, 8, 8,
                                    True, bh, s, d, s // 8, window)
        dq, dk, dv = jflash._bwd_call(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), out, lse,
                                      jnp.asarray(do), scale, causal, 8, 8,
                                      True, window)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tout, tlse = tflash.flash_fwd_plain(tq, tk, tv, causal, scale, window)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[:, 0], **TOL)
    got = tflash.flash_bwd_plain(tq, tk, tv, tout, tlse, tdo, causal, scale,
                                 window)
    for a, b in zip(got, (dq, dk, dv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("seq_first,nkv,window",
                         [(False, 4, None), (False, 2, 6), (True, 4, None),
                          (True, 1, 9)],
                         ids=["bsnd", "bsnd-gqa2-w6", "sbnd", "sbnd-gqa1-w9"])
def test_plain_matches_interpreted_pallas_smajor(seq_first, nkv, window,
                                                 interpretable):
    """_fwd_call_smajor and _bwd_call_smajor (the seq-major sites, the GQA
    head map and the group sums) in interpret mode, blocks of 8 over S=24,
    against the plain versions."""
    rng = np.random.RandomState(4)
    b, s, nh, d = 2, 24, 4, 16
    lead = (s, b) if seq_first else (b, s)
    layout = "sbnd" if seq_first else "bsnd"
    q, do = (rng.randn(*lead, nh * d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(*lead, nkv * d).astype(np.float32) for _ in range(2))
    scale = 0.25
    args = dict(seq_first=seq_first, nkv=nkv, window=window)
    out, lse = jflash._fwd_call_smajor(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), nh, scale, True, 8, 8,
                                       True, **args)
    dq, dk, dv = jflash._bwd_call_smajor(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
        jnp.asarray(do), nh, scale, True, 8, 8, True, **args)
    tq, tdo = (torch.from_numpy(a).reshape(*lead, nh, d) for a in (q, do))
    tk, tv = (torch.from_numpy(a).reshape(*lead, nkv, d) for a in (k, v))
    tout, tlse = tflash.flash_fwd_plain(tq, tk, tv, True, scale, window,
                                        layout)
    np.testing.assert_allclose(tout.reshape(*lead, nh * d).numpy(),
                               np.asarray(out), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[:, 0], **TOL)
    got = tflash.flash_bwd_plain(tq, tk, tv, tout, tlse, tdo, True, scale,
                                 window, layout)
    for a, ref in zip(got, (dq, dk, dv)):
        np.testing.assert_allclose(a.reshape(np.asarray(ref).shape).numpy(),
                                   np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# sdpa
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,nkv,window",
                         [("bnsd", 4, None), ("bnsd", 2, None),
                          ("bsnd", 2, 5), ("sbnd", 1, None), ("sbnd", 4, 7)])
def test_sdpa_on_cpu_matches_reference(layout, nkv, window):
    """The port's sdpa on CPU tensors (the plain attention, GQA by reshape
    even in bnsd) against the reference's sdpa on the CPU, values and
    gradients."""
    q, k, v = _inputs((layout, 2, 4, nkv, 20, 16), seed=5)
    g = np.random.RandomState(6).randn(*q.shape).astype(np.float32)
    ref = jatt.sdpa(*(jnp.asarray(_to_layout(a, layout)) for a in (q, k, v)),
                    is_causal=True, layout=layout, window=window)
    _, vjp = jax.vjp(lambda *a: jatt.sdpa(*a, is_causal=True, layout=layout,
                                          window=window),
                     *(jnp.asarray(_to_layout(a, layout)) for a in (q, k, v)))
    tq, tk, tv = (_t(a, layout).requires_grad_() for a in (q, k, v))
    out = tatt.sdpa(tq, tk, tv, is_causal=True, layout=layout, window=window)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    out.backward(_t(g, layout))
    for x, want in zip((tq, tk, tv), vjp(jnp.asarray(_to_layout(g, layout)))):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mask_kind", ["bool", "float"])
def test_sdpa_plain_masks_and_bf16_match_reference(mask_kind):
    """Explicit masks (boolean: -1e9 where False; float: added), and bf16
    inputs: scores scaled in bf16, softmax in fp32, probabilities cast
    back to bf16 (one bf16 rounding apart, 1e-2)."""
    q, k, v = _inputs(("bnsd", 2, 2, 2, 12, 16), seed=7)
    rng = np.random.RandomState(8)
    mask = (rng.rand(12, 12) > 0.3) if mask_kind == "bool" else \
        rng.randn(12, 12).astype(np.float32)
    ref = jatt._sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               mask=jnp.asarray(mask))
    got = tatt.sdpa_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                          mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    bq, bk, bv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jatt._sdpa_reference(bq, bk, bv, is_causal=True)
    got = tatt.sdpa_plain(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                          is_causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_sdpa_refuses_what_is_not_ported():
    q = torch.zeros(1, 2, 16, 16)
    # attention dropout is ported as the reference routes it, through
    # sdpa_dropout (the jnp path there); the flash kernels still refuse it
    torch.testing.assert_close(tatt.sdpa(q, q, q, dropout_p=0.1, key=5),
                               tatt.sdpa_dropout(q, q, q, 0.1, 5),
                               rtol=0, atol=0)
    assert tflash.unsupported_reason(q, q, dropout_p=0.1) is not None
    assert "head_dim" in tflash.unsupported_reason(torch.zeros(1, 2, 16, 12),
                                                   torch.zeros(1, 2, 16, 12))
    assert "mask" in tflash.unsupported_reason(q, q, mask=q)


# ---------------------------------------------------------------------------
# the score bias: the plain versions with a mask, against the reference's
# _sdpa_reference (which takes masks) and its jax.vjp
# ---------------------------------------------------------------------------

# name, layout, B, H, Hkv, S, D, causal, mask kind: "pad" a [B, 1, 1, S]
# float mask of 0 / -1e4 on padded keys (ERNIE's), "bool" an [S, S]
# boolean mask (a decoder's), "full" a random float [B, H, S, S] mask,
# None no mask (S=197: ViT-base/16's tokens, no block of 8 divides it);
# the gqa cases (seq-major: bnsd takes no GQA, as in the reference) have
# each query head of a KV group add its own bias slice
BIAS_CASES = [
    ("pad_b11s", "bnsd", 2, 3, 3, 24, 16, False, "pad"),
    ("bool_ss", "bnsd", 2, 2, 2, 20, 16, False, "bool"),
    ("s197", "bnsd", 1, 2, 2, 197, 16, False, None),
    ("s197_pad", "bnsd", 2, 2, 2, 197, 16, False, "pad"),
    ("full_causal", "bsnd", 2, 4, 4, 24, 16, True, "full"),
    ("bool_sbnd", "sbnd", 2, 2, 2, 16, 32, False, "bool"),
    ("gqa_pad_bsnd", "bsnd", 2, 6, 2, 24, 16, False, "pad"),
    ("gqa_full_sbnd", "sbnd", 2, 6, 2, 20, 16, False, "full"),
    ("gqa_full_bsnd_causal", "bsnd", 2, 6, 3, 20, 16, True, "full"),
]


def _mask(kind, b, h, s, seed):
    """The case's mask as numpy, in the reference's bnsd terms."""
    rng = np.random.RandomState(seed)
    if kind == "pad":
        keep = np.arange(s)[None, :] < rng.randint(s // 2, s + 1, (b, 1))
        return np.where(keep, 0.0, -1e4).astype(np.float32)[:, None, None]
    if kind == "bool":
        m = rng.rand(s, s) > 0.4
        m[np.arange(s), np.arange(s)] = True       # no row fully masked
        return m
    if kind == "full":
        return rng.randn(b, h, s, s).astype(np.float32)
    return None


def _bias_case(case, seed):
    name, layout, b, h, hkv, s, d, causal, kind = case
    q, k, v = _inputs((layout, b, h, hkv, s, d), seed)
    return layout, causal, q, k, v, _mask(kind, b, h, s, seed + 1)


def _ref_mask(mask, h, hkv):
    """The mask as _sdpa_reference takes it: with GQA its logits are
    [B, Hkv, H/Hkv, S, S], so a mask over q's [B, H] (or [B, 1]) heads
    gains that split; an [S, S] mask broadcasts as it is."""
    if mask is None or h == hkv or mask.ndim < 4:
        return mask
    b, mh = mask.shape[:2]
    return mask.reshape(b, *((hkv, h // hkv) if mh == h else (1, 1)),
                        *mask.shape[2:])


def _ref_masked_lse(q, k, causal, mask):
    """logsumexp of the reference's scaled scores with the mask applied
    as _sdpa_reference applies it, (B*H, S)."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    logits = jnp.einsum("bngqd,bnkd->bngqk",
                        jnp.asarray(q).reshape(b, hkv, h // hkv, s, d),
                        jnp.asarray(k)) / np.sqrt(d)
    logits = logits.reshape(b, h, s, s)
    if causal:
        logits = jnp.where(np.tril(np.ones((s, s), bool)), logits, -jnp.inf)
    if mask is not None:
        logits = (jnp.where(mask, logits, -1e9) if mask.dtype == bool
                  else logits + mask)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(b * h, s)


def _heads_bias(mask, q, layout="bnsd", k=None):
    """The kernels' view of ``mask``'s score bias (None for none): the
    ``expand`` of ``_bias_of``'s to the heads' [B, H, Sq, Sk]."""
    if mask is None:
        return None
    return tflash._bias_of(mask, q, layout, k).expand(
        tflash._heads_shape(q, layout, k))


@pytest.mark.parametrize("case", BIAS_CASES, ids=[c[0] for c in BIAS_CASES])
def test_plain_with_bias_matches_reference(case):
    """flash_fwd_plain with the mask's bias (_bias_of) against
    _sdpa_reference with the mask, and lse against the masked scores'
    logsumexp; flash_bwd_plain and autograd through ``attention`` against
    jax.vjp of the reference.  fp32, 1e-5: summation order only (a boolean
    mask's -1e9 is added to the score where the reference replaces it,
    which leaves a masked key's probability 0 either way)."""
    layout, causal, q, k, v, mask = _bias_case(case, seed=11)
    g = np.random.RandomState(13).randn(*q.shape).astype(np.float32)
    rmask = _ref_mask(mask, q.shape[1], k.shape[1])
    ref_fn = (lambda q, k, v: jatt._sdpa_reference(
        q, k, v, mask=None if rmask is None else jnp.asarray(rmask),
        is_causal=causal))
    ref, vjp = jax.vjp(ref_fn, *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    tq, tk, tv = (_t(a, layout) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    bias = _heads_bias(tmask, tq, layout)
    out, lse = tflash.flash_fwd_plain(tq, tk, tv, causal, None, None, layout,
                                      bias)
    np.testing.assert_allclose(_from_layout(out.numpy(), layout),
                               np.asarray(ref), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               _ref_masked_lse(q, k, causal, mask), **TOL)
    plain = tflash.flash_bwd_plain(tq, tk, tv, out, lse, _t(g, layout),
                                   causal, None, None, layout, bias)
    aq, ak, av = (x.clone().requires_grad_() for x in (tq, tk, tv))
    tatt_out = tflash.attention(aq, ak, av, causal=causal, layout=layout,
                                bias=bias)
    tatt_out.backward(_t(g, layout))
    for got_p, got_a, w in zip(plain, (aq.grad, ak.grad, av.grad), want):
        np.testing.assert_allclose(_from_layout(got_p.numpy(), layout), w,
                                   **TOL)
        np.testing.assert_allclose(_from_layout(got_a.numpy(), layout), w,
                                   **TOL)


def test_mask_bias_is_a_view_and_kernel_reason_decides():
    """_bias_of reads a float mask in place (an expand view: stride 0 on
    every broadcast dimension, the mask's own storage), turns a boolean
    one into 0 / -1e9 at its own shape, and puts a 3-D bnsd q's scores at
    [B*H, 1, S, S]; kernel_reason takes any length, q and k of other
    lengths, causal attention with more queries than keys, a mask that
    broadcasts (one that requires grad too) and any head dim up to 256,
    and refuses a mask that does not broadcast and head dims above 256."""
    b, h, s, d = 2, 3, 197, 64
    q = torch.zeros(b, h, s, d)
    pad = torch.zeros(b, 1, 1, s)
    bias = _heads_bias(pad, q)
    assert bias.shape == (b, h, s, s) and bias.stride() == (s, 0, 0, 1)
    assert bias.data_ptr() == pad.data_ptr()
    dec = torch.rand(s, s) > 0.5
    bias = _heads_bias(dec, q)
    assert bias.dtype == torch.float32 and bias.stride() == (0, 0, s, 1)
    assert set(bias.unique().tolist()) == {0.0, -1e9}
    seq = q.transpose(1, 2)                            # bsnd
    assert _heads_bias(pad, seq, "bsnd").stride() == (s, 0, 0, 1)
    q3 = torch.zeros(b * h, s, d)
    assert _heads_bias(torch.zeros(s, s), q3).shape == (b * h, 1, s, s)

    assert tflash.kernel_reason(q, q) is None           # S=197
    assert tflash.kernel_reason(q, q, pad) is None
    assert tflash.kernel_reason(seq, seq, pad, "bsnd") is None
    assert tflash.kernel_reason(q, torch.zeros(b, h, 64, d)) is None
    assert tflash.kernel_reason(q, torch.zeros(b, h, 64, d),
                                is_causal=True) is None
    assert "lengths" in tflash.unsupported_reason(q, torch.zeros(b, h, 64, d))
    assert tflash.kernel_reason(torch.zeros(1, 2, 16, 12),
                                torch.zeros(1, 2, 16, 12)) is None
    assert "head_dim" in tflash.kernel_reason(torch.zeros(1, 2, 16, 264),
                                              torch.zeros(1, 2, 16, 264))
    assert tflash.kernel_reason(q, q, pad.requires_grad_()) is None
    assert "broadcast" in tflash.kernel_reason(q, q, torch.zeros(b, 5, s, s))
    assert "broadcast" in tflash.kernel_reason(
        q, q, torch.zeros(1, b, h, s, s))
    # the reference's own gate is kept for its callers
    assert "mask" in tflash.unsupported_reason(q, q, mask=pad)
    assert "sequence length" in tflash.unsupported_reason(q, q)


def test_fwd_launch_hands_the_kernel_the_bias(monkeypatch):
    """A [B, 1, 1, S] float mask reaches the forward and backward kernels
    as its own pointer with element strides (S, 0, 0, 1), at S=197; a
    boolean [S, S] one as a 0 / -1e9 fp32 tensor with (0, 0, S, 1); a
    bias that is not an fp32 view of the scores is refused."""
    import ctypes
    import types

    from paddle_tpu_torch.kernels import _build

    calls = []

    def kernel(name):
        def launch(*a):
            at = 6 if name == "flash_fwd" else 9
            ptr = ctypes.cast(a[at + 1], ctypes.POINTER(ctypes.c_longlong))
            calls.append((name, a[at], [ptr[i] for i in range(4)]))
            return 0
        return launch

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    b, h, s, d = 2, 4, 197, 64
    q, k, v = (torch.randn(b, h, s, d) for _ in range(3))
    pad = torch.zeros(b, 1, 1, s)
    bias = _heads_bias(pad, q)
    tflash.flash_fwd_cuda(q, k, v, False, 0.125, None, "bnsd", bias)
    tflash.flash_bwd(q, k, v, q, torch.zeros(b * h, s), q, False, 0.125,
                     None, "bnsd", bias)
    # flash_bwd on CPU tensors takes the plain version: launch it directly
    delta = torch.zeros(b * h, s, 2)
    tflash.flash_bwd_dq_cuda(q, k, v, q, torch.zeros(b * h, s), delta, q,
                             False, 0.125, None, "bnsd", bias)
    tflash.flash_bwd_dkv_cuda(q, k, v, torch.zeros(b * h, s), delta, q,
                              False, 0.125, None, "bnsd", bias)
    dec = _heads_bias(torch.ones(s, s, dtype=torch.bool), q)
    tflash.flash_fwd_cuda(q, k, v, False, 0.125, None, "bnsd", dec)
    assert [c[0] for c in calls] == ["flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv", "flash_fwd"]
    for _, ptr, strides in calls[:3]:
        assert ptr == pad.data_ptr() and strides == [s, 0, 0, 1]
    assert calls[3][1] == dec.data_ptr() and calls[3][2] == [0, 0, s, 1]
    # the launchers take the bias's fp32 [B, H, S, S] view, not the mask
    with pytest.raises(ValueError, match="bias"):
        tflash.flash_fwd_cuda(q, k, v, False, 0.125, None, "bnsd", pad)
    with pytest.raises(ValueError, match="bias"):
        tflash.flash_bwd_dkv_cuda(q, k, v, torch.zeros(b * h, s), delta, q,
                                  False, 0.125, None, "bnsd", bias.double())

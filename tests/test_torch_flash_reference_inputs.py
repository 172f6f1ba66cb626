"""The card's attention takes every input the reference's takes, held
against ``_sdpa_reference`` and its ``jax.vjp`` on the CPU.

``paddle_tpu_torch.kernels.flash.attend`` is what ``sdpa`` runs on CUDA
tensors (the kernels); on CPU tensors it runs the same wrappers through
the kernels' plain versions, which hold the kernels' decisions (fp32
scores, P in q's dtype, the fill of rows that see no key, dBias as
p (dp - delta) summed to the mask's shape).  Each case feeds both
packages the same seeded numpy inputs: the output, and the gradients of
q, k, v and a float mask (``jax.vjp`` of the reference), within:

* fp32: 2e-5 absolute + 1e-4 relative (summation order);
* bf16: 3e-2 + 2e-2 (the reference rounds its logits and probabilities
  to bf16, the kernels keep fp32 scores: a few bf16 units);
* fp16: 8e-3 + 5e-3 (the same at fp16's finer rounding).

Inputs stay in fp16's range (|logits| well under 65504): the reference's
fp16 logits would overflow where the kernels' fp32 scores do not.  The
fully masked fp16 row is a recorded choice (its own test): the
reference's -1e9 fill is -inf in fp16 and its row NaN; the kernels keep
the fill in fp32 and average V.  ``sdpa`` on CPU tensors (the reference's
attention, ported) is held to the same cases.  The last test pins
``kernel_reason``: None for every case here, and the cases it still
names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.attention import _sdpa_reference

from paddle_tpu_torch.kernels import flash, sdpa

TOL = {"float32": (2e-5, 1e-4), "bfloat16": (3e-2, 2e-2),
       "float16": (8e-3, 5e-3)}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
      "float16": jnp.float16}

# name, q, k, v shapes, dtype, mask shape (reference terms; None: none),
# causal, layout
CASES = [
    ("fp16_bnsd", (2, 3, 16, 16), (2, 3, 16, 16), (2, 3, 16, 16),
     "float16", None, True, "bnsd"),
    ("fp16_bsnd", (2, 16, 3, 16), (2, 16, 3, 16), (2, 16, 3, 16),
     "float16", None, False, "bsnd"),
    ("fp16_sbnd", (16, 2, 3, 16), (16, 2, 3, 16), (16, 2, 3, 16),
     "float16", None, True, "sbnd"),
    ("fp16_gqa_bsnd", (2, 16, 6, 16), (2, 16, 2, 16), (2, 16, 2, 16),
     "float16", (2, 1, 1, 1, 16), True, "bsnd"),
    ("fp16_gqa_bnsd", (2, 6, 16, 16), (2, 2, 16, 16), (2, 2, 16, 16),
     "float16", None, False, "bnsd"),
    ("mask_pad_fp32", (2, 3, 12, 16), (2, 3, 10, 16), (2, 3, 10, 16),
     "float32", (2, 1, 1, 10), False, "bnsd"),
    ("mask_pad_bf16", (2, 3, 12, 16), (2, 3, 10, 16), (2, 3, 10, 16),
     "bfloat16", (2, 1, 1, 10), False, "bnsd"),
    ("mask_pad_fp16", (2, 3, 12, 16), (2, 3, 10, 16), (2, 3, 10, 16),
     "float16", (2, 1, 1, 10), False, "bnsd"),
    ("mask_hss_fp32", (2, 3, 12, 16), (2, 3, 12, 16), (2, 3, 12, 16),
     "float32", (3, 12, 12), True, "bnsd"),
    ("mask_hss_bf16", (2, 3, 12, 16), (2, 3, 12, 16), (2, 3, 12, 16),
     "bfloat16", (3, 12, 12), False, "bnsd"),
    ("mask_hss_fp16", (2, 3, 12, 16), (2, 3, 12, 16), (2, 3, 12, 16),
     "float16", (3, 12, 12), False, "bnsd"),
    ("mask_full_fp32", (2, 3, 12, 16), (2, 3, 9, 16), (2, 3, 9, 16),
     "float32", (2, 3, 12, 9), False, "bnsd"),
    ("mask_full_bf16", (2, 12, 3, 16), (2, 9, 3, 16), (2, 9, 3, 16),
     "bfloat16", (2, 3, 12, 9), False, "bsnd"),
    ("mask_full_fp16", (2, 3, 12, 16), (2, 3, 9, 16), (2, 3, 9, 16),
     "float16", (2, 3, 12, 9), False, "bnsd"),
    ("nokey_fp32", (2, 3, 12, 16), (2, 3, 7, 16), (2, 3, 7, 16),
     "float32", None, True, "bnsd"),
    ("nokey_bf16", (2, 3, 12, 16), (2, 3, 7, 16), (2, 3, 7, 16),
     "bfloat16", None, True, "bnsd"),
    ("nokey_mask_fp32", (2, 3, 12, 16), (2, 3, 7, 16), (2, 3, 7, 16),
     "float32", (2, 1, 1, 7), True, "bnsd"),
    ("nokey_mask_bf16", (2, 12, 3, 16), (2, 7, 3, 16), (2, 7, 3, 16),
     "bfloat16", (2, 3, 12, 7), True, "bsnd"),
    ("d8", (2, 3, 16, 8), (2, 3, 16, 8), (2, 3, 16, 8), "float32", None,
     True, "bnsd"),
    ("d12", (2, 3, 16, 12), (2, 3, 16, 12), (2, 3, 16, 12), "float32",
     (2, 1, 1, 16), False, "bnsd"),
    ("d20_bf16", (2, 3, 16, 20), (2, 3, 16, 20), (2, 3, 16, 20),
     "bfloat16", None, False, "bnsd"),
    ("dv40", (2, 3, 16, 24), (2, 3, 16, 24), (2, 3, 16, 40), "float32",
     None, True, "bnsd"),
    ("gqa_bnsd", (2, 6, 16, 16), (2, 2, 16, 16), (2, 2, 16, 16), "float32",
     (2, 2, 3, 16, 16), True, "bnsd"),
    ("gqa_bnsd_3d", (6, 16, 16), (2, 16, 16), (2, 16, 16), "float32",
     (2, 1, 1, 16), False, "bnsd"),
    ("q2d", (16, 16), (12, 16), (12, 16), "float32", (16, 12), True,
     "bnsd"),
    ("broadcast_5d", (2, 2, 3, 8, 16), (1, 2, 3, 8, 16), (2, 1, 3, 8, 16),
     "float32", (2, 1, 1, 8, 8), False, "bnsd"),
]


def _to_bnsd(a, layout):
    if layout == "bsnd":
        return jnp.swapaxes(a, 1, 2)
    if layout == "sbnd":
        return jnp.transpose(a, (1, 2, 0, 3))
    return a


def _from_bnsd(a, layout):
    if layout == "bsnd":
        return jnp.swapaxes(a, 1, 2)
    if layout == "sbnd":
        return jnp.transpose(a, (2, 0, 1, 3))
    return a


def _inputs(case, seed=0):
    _, qs, ks, vs, dt, ms, causal, layout = case
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(*s).astype(np.float32) for s in (qs, ks, vs))
    mask = None if ms is None else rng.randn(*ms).astype(np.float32)
    return q, k, v, mask


def _reference(case, q, k, v, mask, do):
    """The reference's output and its jax.vjp for (q, k, v[, mask])."""
    _, _, _, _, dt, _, causal, layout = case

    def f(q, k, v, *m):
        o = _sdpa_reference(_to_bnsd(q, layout), _to_bnsd(k, layout),
                            _to_bnsd(v, layout), mask=m[0] if m else None,
                            is_causal=causal)
        return _from_bnsd(o, layout)

    args = [jnp.asarray(a, JD[dt]) for a in (q, k, v)]
    if mask is not None:
        args.append(jnp.asarray(mask, JD[dt]))
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do, JD[dt]))
    return ([np.asarray(out, np.float32)]
            + [np.asarray(g, np.float32) for g in grads])


def _port(case, q, k, v, mask, do, fn):
    """The port's output and autograd gradients for (q, k, v[, mask]),
    through ``fn`` (flash.attend or sdpa)."""
    _, _, _, _, dt, _, causal, layout = case
    dtype = getattr(torch, dt)
    leaves = [torch.tensor(a).to(dtype).requires_grad_()
              for a in (q, k, v) + (() if mask is None else (mask,))]
    out = fn(*leaves[:3], mask=leaves[3] if mask is not None else None,
             is_causal=causal, layout=layout)
    grads = torch.autograd.grad(out, leaves, torch.tensor(do).to(dtype))
    return [t.detach().float().numpy() for t in (out,) + grads]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_attend_matches_reference_and_its_vjp(case):
    q, k, v, mask = _inputs(case)
    do = np.random.RandomState(1).randn(
        *_reference_shape(case, q, k, v, mask)).astype(np.float32)
    want = _reference(case, q, k, v, mask, do)
    got = _port(case, q, k, v, mask, do, flash.attend)
    atol, rtol = TOL[case[4]]
    for name, g, w in zip(["out", "dq", "dk", "dv", "dmask"], got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                   err_msg=f"{case[0]} {name}")


def _reference_shape(case, q, k, v, mask):
    _, _, _, _, dt, _, causal, layout = case
    o = _sdpa_reference(_to_bnsd(jnp.asarray(q), layout),
                        _to_bnsd(jnp.asarray(k), layout),
                        _to_bnsd(jnp.asarray(v), layout),
                        mask=None if mask is None else jnp.asarray(mask),
                        is_causal=causal)
    return _from_bnsd(o, layout).shape


@pytest.mark.parametrize("case", CASES[:6] + CASES[14:18] + CASES[-3:],
                         ids=[c[0] for c in CASES[:6] + CASES[14:18]
                              + CASES[-3:]])
def test_sdpa_on_cpu_matches_reference(case):
    """sdpa on CPU tensors is the reference's attention (sdpa_plain):
    the same cases, the same tolerances."""
    q, k, v, mask = _inputs(case)
    do = np.random.RandomState(1).randn(
        *_reference_shape(case, q, k, v, mask)).astype(np.float32)
    want = _reference(case, q, k, v, mask, do)
    got = _port(case, q, k, v, mask, do, sdpa)
    atol, rtol = TOL[case[4]]
    for name, g, w in zip(["out", "dq", "dk", "dv", "dmask"], got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                   err_msg=f"{case[0]} {name}")


def test_fp16_row_with_no_key_is_a_recorded_choice():
    """Causal fp16 with Sq > Sk: the reference's fill is -inf in fp16, so
    its rows with no key are NaN (and so are v's gradients); the kernels
    keep the fill in fp32: those rows average V, and every other output
    agrees with the reference."""
    case = ("nokey_fp16", (2, 3, 12, 16), (2, 3, 7, 16), (2, 3, 7, 16),
            "float16", None, True, "bnsd")
    q, k, v, _ = _inputs(case)
    do = np.random.RandomState(1).randn(2, 3, 12, 16).astype(np.float32)
    want = _reference(case, q, k, v, None, do)
    got = _port(case, q, k, v, None, do, flash.attend)
    nokey = 12 - 7
    assert np.isnan(want[0][:, :, :nokey]).all()
    assert np.isnan(want[3]).any()                  # dv meets the NaN rows
    assert np.isfinite(got[0]).all() and np.isfinite(got[3]).all()
    mean_v = torch.tensor(v).half().float().mean(-2, keepdim=True).numpy()
    np.testing.assert_allclose(got[0][:, :, :nokey],
                               np.broadcast_to(mean_v, (2, 3, nokey, 16)),
                               atol=4e-3)
    atol, rtol = TOL["float16"]
    np.testing.assert_allclose(got[0][:, :, nokey:], want[0][:, :, nokey:],
                               atol=atol, rtol=rtol)
    for g, w in zip(got[1:3], want[1:3]):       # dq, dk: finite in both
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


BOOL_NOKEY = [  # name, q shape, k/v shape, mask shape, dtype, layout
    ("pad_fp32", (2, 3, 12, 16), (2, 3, 7, 16), (2, 1, 1, 7), "float32",
     "bnsd"),
    ("full_bf16", (2, 12, 3, 16), (2, 7, 3, 16), (2, 3, 12, 7), "bfloat16",
     "bsnd"),
    ("rows_fp32", (2, 3, 12, 16), (2, 3, 7, 16), (12, 7), "float32",
     "bnsd"),
]


@pytest.mark.parametrize("case", BOOL_NOKEY, ids=[c[0] for c in BOOL_NOKEY])
def test_boolean_mask_leaves_rows_with_no_key_their_fill(case):
    """Causal Sq > Sk with a boolean mask: the reference's ``where`` keeps
    the -1e9 fill at every key of a row that sees none (a uniform
    softmax), whatever the mask says there; attend's bias is 0 in those
    rows.  Output and q, k, v gradients against the reference and its
    jax.vjp, the tolerances of the float cases."""
    name, qs, ks, ms, dt, layout = case
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(*s).astype(np.float32) for s in (qs, ks, ks))
    mask = rng.rand(*ms) > 0.4
    # key 0 stays: a row whose mask hides every key its band shows is a
    # recorded choice of its own (ROADMAP, "Recorded choices")
    mask[..., 0] = True
    ref_case = (name, qs, ks, ks, dt, None, True, layout)
    do = rng.randn(*qs).astype(np.float32)

    def f(q, k, v):
        o = _sdpa_reference(_to_bnsd(q, layout), _to_bnsd(k, layout),
                            _to_bnsd(v, layout), mask=jnp.asarray(mask),
                            is_causal=True)
        return _from_bnsd(o, layout)

    out, vjp = jax.vjp(f, *(jnp.asarray(a, JD[dt]) for a in (q, k, v)))
    want = [np.asarray(x, np.float32)
            for x in (out,) + vjp(jnp.asarray(do, JD[dt]))]
    dtype = getattr(torch, dt)
    leaves = [torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v)]
    got = flash.attend(*leaves, mask=torch.tensor(mask), is_causal=True,
                       layout=layout)
    grads = torch.autograd.grad(got, leaves, torch.tensor(do).to(dtype))
    atol, rtol = TOL[ref_case[4]]
    for part, g, w in zip(["out", "dq", "dk", "dv"], (got,) + grads, want):
        np.testing.assert_allclose(g.detach().float().numpy(), w, atol=atol,
                                   rtol=rtol, err_msg=f"{name} {part}")


def test_plain_versions_give_the_mask_gradient_at_its_shape():
    """flash_bwd_plain's dbias_shape: p (dp - delta) summed to the bias's
    shape, equal to the sum of its full-shape gradient; the rows that see
    no key add to dV and dBias and nothing to dQ or dK."""
    rng = np.random.RandomState(3)
    q = torch.tensor(rng.randn(2, 3, 10, 16).astype(np.float32))
    k, v = (torch.tensor(rng.randn(2, 3, 6, 16).astype(np.float32))
            for _ in range(2))
    bias = torch.tensor(rng.randn(2, 1, 1, 6).astype(np.float32))
    view = bias.expand(2, 3, 10, 6)
    out, lse = flash.flash_fwd_plain(q, k, v, True, 0.25, None, "bnsd",
                                     view)
    do = torch.tensor(rng.randn(2, 3, 10, 16).astype(np.float32))
    full = flash.flash_bwd_plain(q, k, v, out, lse, do, True, 0.25, None,
                                 "bnsd", view, dbias_shape=(2, 3, 10, 6))
    small = flash.flash_bwd_plain(q, k, v, out, lse, do, True, 0.25, None,
                                  "bnsd", view, dbias_shape=(2, 1, 1, 6))
    assert small[3].shape == (2, 1, 1, 6)
    torch.testing.assert_close(small[3], full[3].sum((1, 2), keepdim=True))
    assert torch.count_nonzero(full[0][:, :, :4]) == 0     # dQ, no-key rows
    assert torch.count_nonzero(full[3][:, :, :4]) > 0      # dBias there


def test_kernel_reason_takes_the_reference_inputs_and_names_the_rest():
    for case in CASES:
        _, qs, ks, vs, dt, ms, causal, layout = case
        q, k, v = (torch.zeros(s, dtype=getattr(torch, dt))
                   for s in (qs, ks, vs))
        mask = None if ms is None else torch.zeros(ms, requires_grad=True)
        assert flash.kernel_reason(q, k, mask, layout, causal, v) is None, \
            case[0]
    z = torch.zeros
    still = [
        ("head_dim 264", (z(1, 2, 8, 264),) * 3, {}),
        ("float64", (z(1, 2, 8, 16, dtype=torch.float64),) * 3, {}),
        ("other dtypes", (z(1, 2, 8, 16), z(1, 2, 8, 16).half(),
                          z(1, 2, 8, 16)), {}),
        ("other batch sizes", (z(2, 8, 2, 16), z(1, 8, 2, 16),
                               z(1, 8, 2, 16)), {"layout": "bsnd"}),
        ("GQA needs a divisor", (z(1, 6, 8, 16), z(1, 4, 8, 16),
                                 z(1, 4, 8, 16)), {}),
        ("does not broadcast", (z(1, 2, 8, 16),) * 3,
         {"mask": z(1, 3, 8, 8)}),
        ("broadcast", (z(2, 2, 8, 16), z(3, 2, 8, 16), z(3, 2, 8, 16)), {}),
    ]
    for want, (q, k, v), kw in still:
        reason = flash.kernel_reason(q, k, kw.get("mask"),
                                     kw.get("layout", "bnsd"), False, v)
        assert reason is not None and want in reason, (want, reason)

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

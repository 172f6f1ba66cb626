"""Ring attention in the port over four gloo ranks spawned on the CPU (the
sequence split over the mesh's mp axis), against the reference: its
einsum ``ring_attention`` on its own mp=4 mesh and ``_sdpa_reference``
for the values, ``jax.vjp`` of ``_sdpa_reference`` for the gradients
(2e-5 relative and absolute: fp32 sums in another order).  The shapes of
``tests/test_ring_attention.py``: B=2, H=3, S=64, D=16.

Cases: the einsum engine (``ring_attention``) causal and full in bnsd and
sbnd, GQA (3 query heads over 1 K/V head) and a sliding window in both
layouts; the flash engine (``ring_flash_attention``, the flash kernels'
plain versions on the CPU) causal and full in both layouts.  The P2P ring
equals the one-process driver (every rank's shards in one process, the
smoke's form on the card) bit for bit, and a length the ring does not
divide raises ValueError.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_workers as W

from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.kernels import ring as jring
from paddle_tpu.kernels.attention import _sdpa_reference
from paddle_tpu_torch.kernels import ring as tring

B, H, S, D, RING = 2, 3, 64, 16, 4
TOL = dict(rtol=2e-5, atol=2e-5)

# name: engine flash?, causal, layout, K/V heads, window
CASES = {
    "einsum_full_bnsd": (False, False, "bnsd", H, None),
    "einsum_causal_bnsd": (False, True, "bnsd", H, None),
    "einsum_full_sbnd": (False, False, "sbnd", H, None),
    "einsum_causal_sbnd": (False, True, "sbnd", H, None),
    "einsum_gqa_bnsd": (False, True, "bnsd", 1, None),
    "einsum_gqa_sbnd": (False, False, "sbnd", 1, None),
    "einsum_window_bnsd": (False, True, "bnsd", H, 9),
    "einsum_window_sbnd": (False, True, "sbnd", 1, 20),
    "flash_full_bnsd": (True, False, "bnsd", H, None),
    "flash_causal_bnsd": (True, True, "bnsd", H, None),
    "flash_full_sbnd": (True, False, "sbnd", H, None),
    "flash_causal_sbnd": (True, True, "sbnd", H, None),
}


def _inputs(name, hkv):
    rng = np.random.RandomState(list(CASES).index(name))
    f = np.float32
    return (rng.randn(B, H, S, D).astype(f), rng.randn(B, hkv, S, D).astype(f),
            rng.randn(B, hkv, S, D).astype(f), rng.randn(B, H, S, D).astype(f))


def _layout(a, layout):
    return np.ascontiguousarray(a.transpose(2, 0, 1, 3)) if layout == "sbnd" \
        else a


@pytest.fixture(scope="module")
def ringed(tmp_path_factory):
    cases = {}
    for name, (flash, causal, layout, hkv, window) in CASES.items():
        q, k, v, w = _inputs(name, hkv)
        cases[name] = {"flash": flash, "causal": causal, "layout": layout,
                       "window": window,
                       **{n: _layout(a, layout) for n, a in
                          zip("qkvw", (q, k, v, w))}}
    got = W.run(tmp_path_factory.mktemp("ring"), RING, "ring",
                {"ring": RING, "cases": cases})
    return cases, got


def _bnsd(a, layout):
    return np.asarray(a).transpose(1, 2, 0, 3) if layout == "sbnd" else a


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_reference_values_and_gradients(ringed, name):
    cases, got = ringed
    _, causal, layout, hkv, window = CASES[name]
    q, k, v, w = _inputs(name, hkv)

    def ref(q, k, v):
        return _sdpa_reference(q, k, v, is_causal=causal, window=window)

    out, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(w))
    for res in got:
        o, dq, dk, dv = (_bnsd(a, layout) for a in res[name])
        np.testing.assert_allclose(o, np.asarray(out), **TOL)
        for g, want in zip((dq, dk, dv), grads):
            np.testing.assert_allclose(g, np.asarray(want), **TOL)
        # every rank holds the whole output and gradients
        np.testing.assert_array_equal(res[name][0], got[0][name][0])


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.startswith("einsum")])
def test_einsum_ring_matches_reference_ring(ringed, name):
    cases, got = ringed
    _, causal, layout, _, window = CASES[name]
    c = cases[name]
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": RING, "pp_degree": 1,
                        "sharding_degree": 1}
    jfleet.init(is_collective=True, strategy=s)
    want = np.asarray(jring.ring_attention(c["q"], c["k"], c["v"], axis="mp",
                                           causal=causal, layout=layout,
                                           window=window))
    np.testing.assert_allclose(got[0][name][0], want, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_p2p_ring_equals_the_one_process_driver(ringed, name):
    """The ranks' shards in one process through the same per-rank
    functions: output and gradients bit for bit."""
    cases, got = ringed
    flash, causal, layout, _, window = CASES[name]
    c = cases[name]
    ax = 0 if layout == "sbnd" else 2

    def shards(a):
        t = torch.from_numpy(a)
        return [tring._bnsd(x, layout).contiguous()
                for x in t.chunk(RING, dim=ax)]

    qs, ks, vs, ws = (shards(c[n]) for n in "qkvw")
    outs, lses = tring._local_ring_forward(qs, ks, vs, causal=causal,
                                           window=window, flash=flash)
    dqs, dks, dvs = tring._local_ring_backward(qs, ks, vs, outs, lses, ws,
                                               causal=causal, window=window,
                                               flash=flash)

    def whole(parts):
        return torch.cat([tring._from_bnsd(p, layout) for p in parts],
                         dim=ax).numpy()

    for part, i in ((outs, 0), (dqs, 1), (dks, 2), (dvs, 3)):
        np.testing.assert_array_equal(got[0][name][i], whole(part))


def test_ring_refuses_a_length_it_does_not_divide(ringed):
    _, got = ringed
    for res in got:
        assert "must divide the ring size 4" in res["ragged"]

"""fp16 through the port's serving path, against the JAX reference on the
same weights (the reference model cast by ``Layer.astype("float16")``, its
weights carried into an fp16 ``GPTParams`` by ``load_jax_params``):

* the engine: port ServingEngine == port dense decoder == JAX
  ServingEngine, token for token, with an fp16 page pool, for float pages,
  chunked prefill, W8A8 with int8 pages, W8A8 with int4 pages and
  ``spec_k=2``, with ``check_invariants()`` after every step;
* the plain versions of the paged decode, verify and prefill kernels with
  fp16 queries against the reference's ``*_ref`` over group {1, 2} x
  window x page kind {fp16, int8, int4}, at 2e-3, one fp16 unit at
  outputs of 2-4 (the two differ in fp32 summation order only, which now
  and then moves a probability's or an output's fp16 rounding by one
  unit; most cases are equal);
* ``w8a8_gemm_plain`` with fp16 activations equals ``w8a8_gemm_ref`` bit
  for bit (quantized rows, scales and the fp16 output);
* an fp16 KV handoff: export -> host -> ingest is bit-exact, crosses to
  and from the reference's pools, and an fp16 payload is refused by a
  bf16 or an fp32 pool.

The CUDA kernels with fp16 queries and activations are held against these
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.kernels import int8_gemm as jgemm
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.kernels import paged_prefill as jpp
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTForPretraining as JModel
from paddle_tpu.ops import quant_ops as jq
from paddle_tpu.serving import KVPool as JKVPool
from paddle_tpu_torch.kernels import (paged_attention_mq_plain,
                                      paged_attention_plain,
                                      paged_prefill_plain, w8a8_gemm_plain)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTParams
from paddle_tpu_torch.serving import KVPool
from paddle_tpu_torch.weights import load_jax_params
from torch_parity import (CFG, assert_all_equal, dense, interpretable,  # noqa: F401
                          prompts_of, serve_both)

F16 = np.float16
PAGE_TOL = dict(rtol=2e-3, atol=2e-3)


def _fp16_pair(seed=3):
    """(reference model cast to fp16, fp16 port model on the CPU holding
    its weights)."""
    paddle.seed(seed)
    jm = JModel(JConfig(**CFG, dropout=0.0))
    jm.eval()
    jm.astype("float16")
    tree = jax.tree_util.tree_map(np.asarray, jgen._decoder_setup(jm)[0])
    assert tree["wte"].dtype == F16
    tm = GPTParams(GPTConfig(**CFG), device="cpu", dtype=torch.float16)
    load_jax_params(tm, tree)
    return jm, tm


# plain pages, a chunk of 8 that cuts every prompt, W8A8 with int8 and with
# int4 pages, speculation over a motif prompt
MODES = [{}, {"chunk_tokens": 8}, {"int8": True},
         {"int8": True, "kv_bits": 4}, {"spec_k": 2}]
MODE_IDS = ["fp16_pages", "chunk8", "w8a8_kv8", "w8a8_kv4", "spec2"]


@pytest.mark.parametrize("kw", MODES, ids=MODE_IDS)
def test_fp16_engine_matches_dense_decoder_and_reference(kw, interpretable):
    jm, tm = _fp16_pair()
    rng = np.random.RandomState(0)
    prompts = prompts_of(rng, [5, 19, 11])
    prompts[1] = np.tile(prompts[1][:4], 5)[:19]          # drafts for spec
    got, want, eng, jeng = serve_both(jm, tm, prompts, 10, **kw)
    layout = eng.pool.layout()
    assert layout["page_dtype"] == ("int8" if kw.get("int8") else "float16")
    assert layout == jeng.pool.layout()
    int8 = kw.get("int8", False)
    assert_all_equal(got, want,
                     dense(tm, prompts, 10, int8=int8,
                           kv_bits=kw.get("kv_bits")))
    if kw.get("spec_k"):
        assert eng.stats["spec_accepted"] > 0
        assert eng.stats["spec_drafted"] == jeng.stats["spec_drafted"]


def _pages(rng, p, hkv, ps, d, bits):
    """fp16 K and V pages, or pages quantized by the reference's rule with
    their fp32 scales: numpy (kp, vp, {k_scales, v_scales})."""
    if bits is None:
        return (rng.randn(p, hkv, ps, d).astype(F16),
                rng.randn(p, hkv, ps, d).astype(F16), {})
    quant = jq.quantize_int4_per_token if bits == 4 else jq.quantize_per_token
    (kq, ks), (vq, vs) = (quant(jnp.asarray(rng.randn(p, hkv, ps, d)
                                            .astype(np.float32)))
                          for _ in range(2))
    return (np.asarray(kq), np.asarray(vq),
            dict(k_scales=np.asarray(ks), v_scales=np.asarray(vs)))


def _both(fn, ref, args, kw):
    """The port's plain version on torch tensors and the reference on jnp
    arrays, from the same numpy inputs."""
    tt = lambda a: torch.from_numpy(np.array(a)) \
        if isinstance(a, np.ndarray) else a
    got = fn(*map(tt, args), **{k: tt(v) for k, v in kw.items()})
    want = ref(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args), **{k: jnp.asarray(v) if isinstance(
                     v, np.ndarray) else v for k, v in kw.items()})
    assert got.dtype == torch.float16
    want = np.asarray(want)
    assert want.dtype == F16 and want.shape == tuple(got.shape)
    return got.numpy(), want


@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp16", "int8", "int4"])
@pytest.mark.parametrize("window", [None, 12], ids=["full", "win"])
@pytest.mark.parametrize("group", [1, 2], ids=["mha", "gqa2"])
def test_fp16_page_plains_match_reference(group, window, bits, kind):
    """fp16 queries over fp16, int8 and int4 pages: decode (lengths 5-32),
    verify (T=3 rows), prefill (a chunk of 6 from start 13): out in fp16
    within PAGE_TOL of the reference's ``*_ref``."""
    rng = np.random.RandomState(7 * group + (bits or 0) + len(kind))
    b, hkv, d, ps, maxp, p = 3, 2, 16, 8, 5, 12
    kp, vp, sc = _pages(rng, p, hkv, ps, d, bits)
    kw = dict(sc, window=window)
    if kind == "prefill":
        q = rng.randn(6, hkv * group, d).astype(F16)
        bt = rng.randint(1, p, (maxp,)).astype(np.int32)
        got, want = _both(paged_prefill_plain, jpp.paged_prefill_ref,
                          (q, kp, vp, bt, 13), kw)
    else:
        t = 3 if kind == "verify" else None
        shape = (b, hkv * group, d) if t is None else (b, t, hkv * group, d)
        q = rng.randn(*shape).astype(F16)
        bt = rng.randint(1, p, (b, maxp)).astype(np.int32)
        lens = np.array([5, 17, maxp * ps - (t or 0)], np.int32)
        fn, ref = ((paged_attention_plain, jpa.paged_attention_ref)
                   if t is None else
                   (paged_attention_mq_plain, jpa.paged_attention_mq_ref))
        got, want = _both(fn, ref, (q, kp, vp, bt, lens), kw)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), **PAGE_TOL)


def test_fp16_w8a8_plain_equals_reference_bit_for_bit():
    """Rows at six scales (the largest, finite in fp16, overflows it at
    the output, which both round to inf), an all-zero row (the 1e-8
    clamp) and .5 ties after the division: xq, sx and the fp16 output bit
    for bit."""
    rng = np.random.RandomState(4)
    x = (rng.randn(8, 64) * np.float32([[1e-3], [0.02], [1.0], [3.0],
                                         [50.0], [2e4], [0.0], [1.0]]))
    x[7, :9] = [127.0, 0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, -0.5]
    x = np.clip(x, -6e4, 6e4).astype(F16)
    w = rng.randn(64, 48).astype(np.float32)
    wq, ws = (np.asarray(a) for a in jq.quantize_per_channel(
        jnp.asarray(w), axis=1))
    out, xq, sx = w8a8_gemm_plain(torch.from_numpy(x),
                                  torch.from_numpy(wq.T.copy()),
                                  torch.from_numpy(ws),
                                  return_quantized=True)
    ref = np.asarray(jgemm.w8a8_gemm_ref(jnp.asarray(x), jnp.asarray(wq),
                                         jnp.asarray(ws)))
    rxq, rsx = (np.asarray(a) for a in jq.quantize_per_token(jnp.asarray(x)))
    assert out.dtype == torch.float16 and ref.dtype == F16
    np.testing.assert_array_equal(xq.numpy(), rxq)
    np.testing.assert_array_equal(sx.numpy(), rsx)
    assert np.isinf(ref[5]).any()
    np.testing.assert_array_equal(out.numpy().view(np.uint16),
                                  ref.view(np.uint16))


def _filled(pool, seed):
    g = torch.Generator().manual_seed(seed)
    for buf in pool.buffers.values():
        buf.copy_(torch.randn(buf.shape, generator=g))
    return pool


def test_fp16_handoff_round_trip_and_layout_guard():
    """An fp16 pool's pages go out as numpy float16 with the layout
    ``page_dtype`` "float16" and come back bit for bit into other pages;
    a bf16 or an fp32 pool refuses the payload before it writes."""
    kw = dict(num_pages=10, page_size=8, device="cpu")
    src = _filled(KVPool(2, 4, 16, dtype=torch.float16, **kw), 1)
    dst = KVPool(2, 4, 16, dtype=torch.float16, **kw)
    pages, into = src.alloc(3), dst.alloc(6)[3:]
    payload = src.export_pages(pages)
    assert payload["layout"]["page_dtype"] == "float16"
    assert all(a.dtype == F16 for a in payload["buffers"].values())
    dst.ingest_pages(payload, into)
    for name, buf in src.buffers.items():
        assert torch.equal(buf[:, pages].view(torch.int16),
                           dst.buffers[name][:, into].view(torch.int16))
    for other in (torch.bfloat16, torch.float32):
        pool = KVPool(2, 4, 16, dtype=other, **kw)
        before = {n: b.clone() for n, b in pool.buffers.items()}
        with pytest.raises(ValueError, match="page_dtype"):
            pool.ingest_pages(payload, pool.alloc(3))
        assert all(torch.equal(before[n], b)
                   for n, b in pool.buffers.items())


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_fp16_handoff_crosses_packages(direction):
    """fp16 pages exported by one package's pool are ingested by the
    other's bit for bit (the wire format is numpy float16 in both)."""
    rng = np.random.RandomState(5)
    shape = (2, 10, 4, 8, 16)                      # L, P, Hkv, ps, D
    k, v = (rng.randn(*shape).astype(F16) for _ in range(2))
    port = KVPool(2, 4, 16, 10, 8, dtype=torch.float16, device="cpu")
    ref = JKVPool(2, 4, 16, 10, 8, dtype=jnp.float16)
    assert port.layout() == ref.layout()
    src, dst = (ref, port) if direction == "ref_to_port" else (port, ref)
    if src is port:
        port.buffers["k"].copy_(torch.from_numpy(k))
        port.buffers["v"].copy_(torch.from_numpy(v))
    else:
        ref.buffers["k"], ref.buffers["v"] = jnp.asarray(k), jnp.asarray(v)
    pages, into = src.alloc(3), dst.alloc(5)[2:]
    dst.ingest_pages(src.export_pages(pages), into)
    for name, want in (("k", k), ("v", v)):
        got = np.asarray(dst.buffers[name])[:, into]
        np.testing.assert_array_equal(got.view(np.uint16),
                                      want[:, pages].view(np.uint16))

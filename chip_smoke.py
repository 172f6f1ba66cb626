#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; each prints
its seconds):

1. build: compile every CUDA source of the port (one ``nvcc`` each, all at
   once) and print the build seconds, each kernel's registers and spills
   as ``ptxas`` reports them, and the card's name and power limit;
2. kernels: each kernel variant against its plain PyTorch version on the
   card at the serving and training shapes.
   - paged decode and chunk prefill over float, int8 and int4 pages (H=16,
     D=128, page 32, 8 slots, ragged lengths up to 2048; a GQA case with
     Hkv=4 and a window=256 case; prefill chunks of 128 and 40 rows at
     starts 0 and 300), and the multi-query verify kernel at T=5 over the
     same three page kinds; decode and verify also at the serving runs'
     own context lengths (64-576), prefill at the serving runs' own chunks
     (128 rows at starts 0-512).  Tolerances: fp32 queries 1e-5 (kernel
     and plain version differ only in summation order, quantized pages
     dequantize exactly); bf16 2e-2 against the plain version computed in
     fp32 from the same inputs (the kernel rounds probabilities to bf16
     for the tensor cores, the plain version keeps them in fp32, and the
     kernel rounds its output).  Each kernel is timed, by CUDA-graph
     replay with the eager time beside, at the 2048-token lengths (the
     kernels line), and also in the GQA case and at the serving lengths
     and chunks (logged);
   - ``w8a8_gemm`` at GPT-1.3B's four projection shapes, M=8 (decode) and
     M=128 (prefill), and a ragged M=40, and at the training flagship's
     four projections at M=12288 with bf16 activations (run (d) of phase
     6, timed beside ``torch._int_mm``, summed over a layer with its
     bound): the quantized activations, their scales and the output equal
     the plain version bit for bit.  Then the profile of its quantize and
     GEMM kernels, and the sweep of its plan (``_gemm_sweep``: both paths
     at M = 8-256 and the crossover found, the split count at M=8, the
     wgmma tile width at M=128 and M=12288);
   - the flash forward, dQ and dK/dV kernels on q/k/v head views of one
     fused QKV tensor, as the model hands them over: the training
     flagship shape (B=12, H=12, S=1024, D=128, causal, bf16) in bsnd and
     in sbnd, sbnd with GQA (Hkv=4) and window=256 at B=12 (the shapes of
     training runs (a)-(c)), an fp32 case, bsnd and sbnd GQA cases, a
     window=256 case, a ragged S=520 and the bench's long_seq_4k point
     (B=2, S=4096); out, lse, dQ, dK and dV each on its own (the backward
     kernels from the plain forward's out and lse), elementwise within
     ``atol * rms + rtol * |plain|`` with the rms of the plain row
     (``FLASH_TOL``); then each kernel timed beside SDPA at the flagship
     shape, at S=4096 and at the flagship shape with D=64;
3. serving: GPT-1.3B at full width (24 layers, hidden 2048, 16 heads) with
   random bf16 weights from a fixed seed, 16 requests per run through the
   paged engine (8 slots, page 32, chunk 128; prompts of 64-512 tokens,
   half of them behind a shared 128-token prefix; 32-64 new tokens each),
   in the engine's modes: (a) bf16 weights and pages, (b) ``int8=True``
   (W8A8 projections, int8 pages), (c) ``int8=True, kv_bits=4``, (d)
   ``spec_k=4`` (the other half of the prompts repeat a short motif, so
   that the drafter proposes), and two shorter speculative runs over
   quantized pages, (e) ``int8=True, spec_k=4`` and (f) ``int8=True,
   kv_bits=4, spec_k=4`` (8 requests each).  Launch counts are zeroed just
   before each run and read just after it: exactly the run's kernel
   variants must have launched.  (a)-(d) are then profiled over 8 more
   requests;
4. parity on the card, fp32, 1.3B width, 2 layers, 4 prompts, 24 greedy
   tokens each: the engine (kernels) against the dense decoder, and the
   speculative engine against the plain engine.  With random weights a
   near-tie between two logits can flip an argmax under another summation
   order, so at least 99% of the tokens must agree up to each request's
   first divergence (divergences are printed).  The W8A8 engine (int8 and
   int4 pages) is held against the dense decoder by teacher forcing
   instead, at least 90% of the positions agreeing: quantized activations
   turn such float-level differences into int8 rounding differences, and
   one early divergence would end the greedy comparison;
5. cluster: the rest of the serving engine.  (1) Exact checks on phase
   4's fp32 model: the handoff round trip (``export_pages`` -> host numpy
   -> ``ingest_pages`` into other pages) byte-equal for bf16, int8 and
   int4 pages and their scales; ``make_cluster(model, 2,
   disaggregate=True)``, ``double_buffer=True`` and a snapshot taken at
   step 5, restored and drained, each token for token the monolithic
   engine's output on phase 4's prompts; a seeded ``FaultPlan.random``
   chaos run of an int8 engine under WFQ over two tenants (staggered
   arrivals, deadlines, a cancel, a bounded queue) that must give every
   request exactly one terminal, pass ``check_invariants`` after every
   step and leak no page.  (2) GPT-1.3B in bf16 on phase 3's 16 requests,
   16 slots (one per request, so that the engine and the cluster's
   prefill replica run the same chunks): (a) one engine, (g) the
   disaggregated cluster (one prefill and one decode replica on the one
   card) and (h) (a) with ``double_buffer=True``, in the order a, h, g,
   h, a; each with its launches asserted, its
   replicas' decode-step and prefill-chunk ms, ``decode_sync_s``,
   handoffs and handoff bytes logged, its tokens held against (a)'s by
   the 99% agreement of phase 4 (the chunk schedules differ, so bf16 may
   flip a near tie), and a profile of 8 more requests.  (3) The export
   and ingest ms of one request's 18 pages at full width for the three
   page kinds, and the snapshot and restore seconds of run (a)'s engine;
5b. front end and decoding.  (1) Exact checks on phase 4's fp32 model:
   ``serve()`` in a background thread (its event loop on another thread
   than the engine's) takes phase 4's prompts as concurrent streamed
   completions, each stream token for token its ``FinishedRequest`` and
   the direct engine's output; a stream reset mid-way gives its pages
   back within two steps; a full queue (``max_queue=0``) answers 429;
   ``/metrics`` counts the streams and ``/healthz`` answers 200; the same
   streams through ``make_cluster(model, 2, disaggregate=True)``.  Beam
   search (beam 4, EOS a greedy first token) on the card against the same
   call on the CPU, held as phase 4 holds greedy runs, and beam 1 equal to
   greedy decoding.  The dropout=0.1 train step on the card against the
   CPU with the same injected masks (phase 6's parity tolerances), and
   remat=True against remat=False on the card at one seed.  (2) GPT-1.3B
   on phase 3's 16 requests at 16 slots, sent at once over HTTP, bf16 and
   ``int8=True``: client-side time to first token and between tokens
   (p50, p99) beside the engine's decode-step and prefill-chunk ms, each
   stream equal to its ``FinishedRequest``, launches asserted, bf16
   agreeing with phase 5's run (a) at 99% or more.  (3) Beam search on
   GPT-1.3B (B=2, beam 4, 128-token prompts, 32 new tokens), bf16 and
   W8A8 (96 ``w8a8_gemm`` launches a forward asserted): ms per generated
   position.  (4) ``w8a8_gemm`` as the tied int8 head (N=50304, K=2048)
   at M=8 and 1024, bit-exact, timed by CUDA-graph replay beside
   ``torch._int_mm`` with its bound; and at the ragged shapes the wrapper
   pads (N=50257, K=96 and 1600), bit-exact; GPT-1.3B's eager forward
   with ``int8_lm_head`` launching 4 x 24 + 1 ``w8a8_gemm``.  (5)
   Training run (e): run (a) of phase 6 with ``dropout=0.1`` and
   ``remat=True`` (without remat the materialised attention took the
   peak to 72 GiB), which launches no flash kernel (dropout takes the
   reference's non-kernel attention);
6. training: first the train step in fp32 on the card against the same
   step on the CPU (flagship width, 2 layers, batch 1, seq 512, 2 steps;
   losses to 1e-4 relative, and each leaf's update, ||card - CPU|| over
   ||CPU||, to ``UPDATE_RTOL``), then the 760M training flagship (vocab
   50304, hidden 1536, 24 layers, 12 heads, seq 1024, batch 12, bf16
   parameters with fp32 AdamW masters, remat off, CE chunks of 2048 rows)
   in four runs: (a) batch-major, (b) ``seq_major=True``, (c)
   ``seq_major=True, num_kv_heads=4, attn_window=256, remat=True`` and (d)
   ``int8=True`` (W8A8 with straight-through gradients).  Each takes 1
   warm-up and 4 timed steps on one seeded batch, prints step ms,
   tokens/s, MFU (the bench's flop count over 989 TFLOP/s) and peak
   memory, asserts finite, falling losses and exactly the run's launches
   (24 per step of each flash kernel, the forward twice under remat, 96
   ``w8a8_gemm`` per step in (d)), and profiles one more step.

Before the last line it prints the card's name and power limit and one
JSON object ``{"kernels": [...]}`` with each kernel variant's launches on
the serving or training run that first reaches it (and, under
``launches_in``, on phase 5's runs (g) and (h)), its error against the
plain version, its time (the paged kernels' and ``w8a8_gemm``'s by
CUDA-graph replay, which takes the host's enqueue cost out of calls that
short, with their yardsticks timed the same way), the plain version's
time, its bound (bytes moved over 3.35 TB/s or operations over
the peak of their type, whichever is larger) and the time
of one PyTorch call computing the same function, which the port itself
never calls: ``scaled_dot_product_attention`` on pre-gathered, dequantized
dense K/V (the gather and the dequant excluded) for the attention kernels,
``torch._int_mm`` on the pre-quantized operands (the quantize excluded) for
``w8a8_gemm``, ``scaled_dot_product_attention(is_causal=True)`` for the
flash forward and its backward (forward and backward less the forward,
both by CUDA-graph replay) for the two backward kernels.  The last line
is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12              # H100 SXM dense int8 tensor-core peak
KINDS = {None: "", 8: "_int8", 4: "_int4"}   # page kind -> variant suffix
PROJ = {"qkv": (2048, 6144), "proj": (2048, 2048), "fc1": (2048, 8192),
        "fc2": (8192, 2048)}    # GPT-1.3B projections, (K, N)
TRAIN_PROJ = {"qkv": (1536, 4608), "proj": (1536, 1536), "fc1": (1536, 6144),
              "fc2": (6144, 1536)}    # the training flagship's, (K, N)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds of ``fn`` over ``iters`` calls (CUDA events
    around the whole run, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, replays=5):
    """Mean device milliseconds of ``fn`` with the host's enqueue cost
    taken out: ``iters`` calls captured in one CUDA graph (after a warm-up
    on a side stream), CUDA events around ``replays`` replays.  For calls
    of a few tens of microseconds, whose eager timing measures how fast
    the host enqueues them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=replays, warmup=1) / iters


def bound_ms(nbytes, ops, peak):
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate for their type, whichever is larger."""
    b, o = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(b, o) * 1e3, "bytes" if b >= o else "operations"


def _check(label, err, tol):
    log(f"{label}: max_abs_err {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{err}")


# -- phase 1 -----------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s total, per source "
        + json.dumps({k: round(v, 2) for k, v in _build.build_seconds.items()}))
    for name in _build.SOURCES:
        ptxas = _build.BUILD_DIR / f"{name}.ptxas.txt"
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "Compiling entry function" in line:
                    log(f"  {name}: {line.split(chr(39))[1]}")
                elif "registers" in line or "spill" in line:
                    log(f"    {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    return card


# -- phase 2 -----------------------------------------------------------------

def _pages(torch, g, n_pages, hkv, dtype, bits):
    """K and V pages (n_pages, Hkv, 32, 128) of kind ``bits`` and the
    scales of a quantized kind: float pages in ``dtype``, or random fp32
    pages quantized by the port's own rule."""
    from paddle_tpu_torch.ops import quantize_int4_per_token, quantize_per_token

    dev = torch.device("cuda")
    k, v = (torch.randn(n_pages, hkv, 32, 128, device=dev, generator=g)
            for _ in range(2))
    if bits is None:
        return k.to(dtype), v.to(dtype), {}
    quant = quantize_int4_per_token if bits == 4 else quantize_per_token
    (kq, ks), (vq, vs) = quant(k), quant(v)
    return kq, vq, dict(k_scales=ks, v_scales=vs)


def _float(pages, sc):
    """Float pages as fp32 for the plain version; quantized ones as they
    are (the plain version dequantizes them in fp32)."""
    return pages if sc else pages.float()


def _page_bytes(bits, d, elt):
    """Device bytes of one position of one KV head on one side."""
    return d * elt if bits is None else (d if bits == 8 else d // 2) + 4


def _dense_kv(gather_pages, pages, bt, sc, side, dtype):
    """A slot batch's K or V gathered dense (and dequantized) in ``dtype``:
    the operand of the SDPA yardstick, built outside its timing."""
    return gather_pages(pages, bt, sc.get(side + "_scales"), 128).to(dtype)


def _time_case(label, kernel, plain, library, nbytes, ops):
    """The kernel, its plain version and the library call, each by
    CUDA-graph replay (what the kernels line reports), with its eager time
    beside: an eager call of a few tens of microseconds measures how fast
    the host enqueues it."""
    calls = dict(kernel=kernel, plain=plain, library=library)
    graph = {key: graph_ms(fn) for key, fn in calls.items()}
    eager = {key: time_ms(fn) for key, fn in calls.items()}
    bms, by = bound_ms(nbytes, ops, BF16_FLOPS)
    log(f"{label}: graph replay (eager) kernel {graph['kernel']:.4f} "
        f"({eager['kernel']:.4f}) ms, plain {graph['plain']:.4f} "
        f"({eager['plain']:.4f}) ms, sdpa on gathered K/V "
        f"{graph['library']:.4f} ({eager['library']:.4f}) ms, bound "
        f"{bms:.4f} ms ({by}; {nbytes} bytes)")
    return dict(ms=graph["kernel"], plain_ms=graph["plain"], bound_ms=bms,
                bound_by=by, library_ms=graph["library"])


# decode and verify: H=16, D=128, page 32, 64-entry block tables (GPT-1.3B
# in the engine); the timed lengths, and lengths of the serving runs' own
# contexts (prompts of 64-512 tokens plus up to 64 new ones)
PAGED_H, PAGED_D, PAGED_MAXP = 16, 128, 64
TIMED_LENGTHS = [2048, 1, 777, 1500, 33, 1024, 2000, 64]
SERVING_LENGTHS = [64, 576, 200, 448, 96, 320, 512, 130]
VERIFY_T = 5


def _attention_case(torch, gen, table, bits, hkv, window, dtype, lengths,
                    t=None):
    """Decode (``t`` None) or verify (``t`` draft rows) over pages of kind
    ``bits`` at ``lengths``, held against the plain version computed in
    fp32 from the same inputs; returns the call's operands and the max
    abs error."""
    from paddle_tpu_torch.kernels import (paged_attention, paged_attention_mq,
                                          paged_attention_mq_plain,
                                          paged_attention_plain)

    dev = torch.device("cuda")
    b = len(lengths)
    n_pages = 1 + b * PAGED_MAXP
    g = gen()
    kp, vp, sc = _pages(torch, g, n_pages, hkv, dtype, bits)
    shape = (b, PAGED_H, PAGED_D) if t is None else (b, t, PAGED_H, PAGED_D)
    q = torch.randn(*shape, device=dev, generator=g).to(dtype)
    bt = table((b, PAGED_MAXP), n_pages)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    fn, plain = ((paged_attention, paged_attention_plain) if t is None else
                 (paged_attention_mq, paged_attention_mq_plain))
    out = fn(q, kp, vp, bt, lens, window=window, **sc)
    ref = plain(q.float(), _float(kp, sc), _float(vp, sc), bt, lens,
                window=window, **sc)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    return dict(q=q, kp=kp, vp=vp, sc=sc, bt=bt, lens=lens, fn=fn,
                plain=plain, lengths=lengths, t=t, bits=bits), err


def _time_attention(torch, label, case):
    """Time one unwindowed decode or verify case of :func:`_attention_case`
    beside SDPA on its gathered, dequantized dense K/V (GQA: K/V repeated
    to the query heads outside the timing)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import gather_pages

    q, kp, vp, sc, bt, lens = (case[k] for k in
                               ("q", "kp", "vp", "sc", "bt", "lens"))
    fn, plain, t, lengths = case["fn"], case["plain"], case["t"], \
        case["lengths"]
    b, h, d, hkv = len(lengths), PAGED_H, PAGED_D, kp.shape[1]
    kd = _dense_kv(gather_pages, kp, bt, sc, "k", q.dtype)
    vd = _dense_kv(gather_pages, vp, bt, sc, "v", q.dtype)
    if hkv != h:
        kd, vd = (x.repeat_interleave(h // hkv, dim=1) for x in (kd, vd))
    pos = torch.arange(kd.shape[2], device=q.device)
    if t is None:
        mask = (pos[None, :] < lens[:, None].long())[:, None, None, :]
        qd, n_q = q[:, :, None], 1
        union = vis = sum(lengths)
    else:
        qpos = lens[:, None].long() + torch.arange(t, device=q.device)[None]
        mask = (pos[None, None, :] <= qpos[:, :, None])[:, None]
        qd, n_q = q.transpose(1, 2), t
        union = sum(n + t for n in lengths)
        vis = sum(n + i + 1 for n in lengths for i in range(t))
    nbytes = (2 * union * hkv * _page_bytes(case["bits"], d, 2)
              + 2 * b * n_q * h * d * 2 + bt.numel() * 4 + b * 4)
    return _time_case(
        label, lambda: fn(q, kp, vp, bt, lens, **sc),
        lambda: plain(q, kp, vp, bt, lens, **sc),
        lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
        nbytes, 4 * vis * h * d)


def phase_paged(np, torch):
    """Decode, prefill and verify kernels over the three page kinds."""
    dev = torch.device("cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    rng = np.random.RandomState(0)
    maxp = PAGED_MAXP
    results = {}
    cases = (("mha", 16, None, bf16), ("gqa4", 4, None, bf16),
             ("window256", 16, 256, bf16), ("mha_fp32", 16, None, fp32))

    def gen():
        return torch.Generator(device=dev).manual_seed(
            int(rng.randint(1 << 30)))

    def table(shape, n_pages):
        return torch.tensor(1 + rng.permutation(n_pages - 1).reshape(shape),
                            dtype=torch.int32, device=dev)

    # decode and verify (T=5): per page kind MHA bf16 (timed), GQA (timed,
    # logged), window, fp32 queries at the timed lengths; then MHA bf16 at
    # the serving runs' lengths (timed, logged).  Verify's lengths leave
    # room for the T rows in the 64-page tables.
    mq_lens = [min(n, maxp * 32 - VERIFY_T) for n in TIMED_LENGTHS]
    for kind, t, lengths in (("paged_attention", None, TIMED_LENGTHS),
                             ("paged_attention_mq", VERIFY_T, mq_lens)):
        what = "decode" if t is None else f"verify T={t}"
        for bits, suffix in KINDS.items():
            name = kind + suffix
            worst = 0.0
            for label, hkv, window, dtype in cases:
                case, err = _attention_case(torch, gen, table, bits, hkv,
                                            window, dtype, lengths, t)
                _check(f"{name} {label}{'' if t is None else f' T={t}'}",
                       err, 1e-5 if dtype == fp32 else 2e-2)
                if dtype == bf16:
                    worst = max(worst, err)
                shape = (f"B=8 H=16 Hkv={hkv} D=128 page 32, bf16 queries, "
                         f"lengths {lengths}")
                if label == "mha":
                    results[name] = _time_attention(
                        torch, f"{name} timed case, {what}: {shape}", case)
                elif label == "gqa4":
                    _time_attention(torch, f"{name} GQA case, {what}: "
                                    f"{shape}", case)
                del case
            case, err = _attention_case(torch, gen, table, bits, 16, None,
                                        bf16, SERVING_LENGTHS, t)
            _check(f"{name} serving lengths", err, 2e-2)
            worst = max(worst, err)
            _time_attention(torch, f"{name} serving-length case, {what}: "
                            f"B=8 H=Hkv=16 D=128 page 32, bf16 queries, "
                            f"lengths {SERVING_LENGTHS}", case)
            del case
            results[name]["max_abs_err"] = worst
            torch.cuda.empty_cache()

    results.update(_prefill_cases(torch, gen, table))
    return results


def _prefill_case(torch, g, table, bits, hkv, window, dtype, cc, st):
    """One prefill chunk of ``cc`` rows at ``st`` over a slot's 64-entry
    table of pages of kind ``bits``, held against the plain version
    computed in fp32 from the same inputs; returns the call's operands and
    the max abs error."""
    from paddle_tpu_torch.kernels import paged_prefill, paged_prefill_plain

    maxp = PAGED_MAXP
    kp, vp, sc = _pages(torch, g, 1 + maxp, hkv, dtype, bits)
    q = torch.randn(cc, PAGED_H, PAGED_D, device="cuda",
                    generator=g).to(dtype)
    bt = table((maxp,), 1 + maxp)
    out = paged_prefill(q, kp, vp, bt, st, window=window, **sc)
    ref = paged_prefill_plain(q.float(), _float(kp, sc), _float(vp, sc), bt,
                              st, window=window, **sc)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    return dict(q=q, kp=kp, vp=vp, sc=sc, bt=bt, st=st, bits=bits), err


def _time_prefill(torch, label, case):
    """Time one unwindowed prefill case of :func:`_prefill_case` beside
    SDPA on its gathered, dequantized dense K/V."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import (gather_pages, paged_prefill,
                                          paged_prefill_plain)

    q, kp, vp, sc, bt, st = (case[k] for k in
                             ("q", "kp", "vp", "sc", "bt", "st"))
    cc, h, d, hkv = q.shape[0], PAGED_H, PAGED_D, kp.shape[1]
    s_vis = st + cc
    kd = _dense_kv(gather_pages, kp, bt[None], sc, "k", q.dtype)[:, :, :s_vis]
    vd = _dense_kv(gather_pages, vp, bt[None], sc, "v", q.dtype)[:, :, :s_vis]
    if hkv != h:
        kd, vd = (x.repeat_interleave(h // hkv, dim=1) for x in (kd, vd))
    qpos = st + torch.arange(cc, device=q.device)[:, None]
    mask = torch.arange(s_vis, device=q.device)[None, :] <= qpos
    qd = q.transpose(0, 1)[None]
    vis = sum(st + i + 1 for i in range(cc))
    nbytes = (2 * s_vis * hkv * _page_bytes(case["bits"], d, 2)
              + 2 * cc * h * d * 2 + bt.numel() * 4)
    return _time_case(
        label, lambda: paged_prefill(q, kp, vp, bt, st, **sc),
        lambda: paged_prefill_plain(q, kp, vp, bt, st, **sc),
        lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
        nbytes, 4 * vis * h * d)


# prefill: C in {128, 40} x start in {0, 300}, GQA, window, fp32 queries;
# timed at C=128, start 300 (the kernels line) and, logged, at the serving
# runs' own chunks (128 rows of prompts of up to 640 tokens) and with GQA
PREFILL_CASES = ([(f"c{cc}_s{st}", 16, None, "bf16", cc, st)
                  for cc in (128, 40) for st in (0, 300)]
                 + [("gqa4_c128_s300", 4, None, "bf16", 128, 300),
                    ("window256_c128_s300", 16, 256, "bf16", 128, 300),
                    ("fp32_c40_s300", 16, None, "fp32", 40, 300)])
PREFILL_SERVING_STARTS = (0, 128, 256, 384, 512)


def _prefill_cases(torch, gen, table):
    """The prefill kernel over the three page kinds: every case of
    PREFILL_CASES held against the plain version, the timed case, and the
    serving chunks and the GQA case timed and logged; returns each kind's
    entry of the kernels line."""
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    results = {}
    for bits, suffix in KINDS.items():
        name = "paged_prefill" + suffix
        worst = 0.0
        for label, hkv, window, dt, cc, st in PREFILL_CASES:
            case, err = _prefill_case(torch, gen(), table, bits, hkv, window,
                                      dtypes[dt], cc, st)
            _check(f"{name} {label}", err, 1e-5 if dt == "fp32" else 2e-2)
            if dt == "bf16":
                worst = max(worst, err)
            shape = (f"C={cc} start={st} H=16 Hkv={hkv} D=128 page 32, bf16 "
                     "queries")
            if label == "c128_s300":
                results[name] = _time_prefill(
                    torch, f"{name} timed case: {shape}", case)
            elif label == "gqa4_c128_s300":
                _time_prefill(torch, f"{name} GQA case: {shape}", case)
            del case
        for st in PREFILL_SERVING_STARTS:
            case, err = _prefill_case(torch, gen(), table, bits, 16, None,
                                      torch.bfloat16, 128, st)
            _check(f"{name} serving chunk at {st}", err, 2e-2)
            worst = max(worst, err)
            _time_prefill(torch, f"{name} serving chunk: C=128 start={st} "
                          "H=Hkv=16 D=128 page 32, bf16 queries", case)
            del case
        results[name]["max_abs_err"] = worst
        torch.cuda.empty_cache()
    return results


GEMM_SWEEP_M = (8, 16, 32, 64, 128, 256)


def _gemm_weights(torch, g, proj):
    """Each projection's per-channel int8 weight (N, K) and scales, as
    the model quantizes them: {name: (wq, ws, k, n)}."""
    from paddle_tpu_torch.ops import quantize_per_channel

    out = {}
    for name, (k, n) in proj.items():
        w = torch.randn(n, k, device="cuda", generator=g) * 0.02
        wq, ws = quantize_per_channel(w.bfloat16().float(), axis=0)
        out[name] = (wq.contiguous(), ws, k, n)
    return out


def _layer_ms(torch, g, weights, m, timer, **plan):
    """One layer's four projections at ``m`` bf16 rows under ``plan``'s
    overrides of gemm_plan, summed: ms by ``timer`` (graph_ms or
    time_ms)."""
    from paddle_tpu_torch.kernels.int8_gemm import gemm_plan, w8a8_gemm

    total = 0.0
    for wq, ws, k, n in weights.values():
        x = torch.randn(m, k, device="cuda", generator=g).bfloat16()
        pl = gemm_plan(m, n, k, **plan)
        total += timer(lambda: w8a8_gemm(x, wq, ws, plan=pl))
    return total


def _gemm_sweep(torch, g, weights, train):
    """The measured decisions of gemm_plan, logged: the crossover M
    between the split and the wgmma path at the 1.3B projections (graph
    replay), the split path's split count at M=8, and the wgmma tile width
    at a prefill chunk's 128 rows (graph replay) and at the training rows
    (CUDA events).  Returns the crossover the sweep found."""
    from paddle_tpu_torch.kernels import int8_gemm as ig

    faster = {}
    for m in GEMM_SWEEP_M:
        t = {p: _layer_ms(torch, g, weights, m, graph_ms, path=p)
             for p in ("split", "wgmma")}
        pick = "split" if m <= ig.GEMM_CROSSOVER else "wgmma"
        faster[m] = min(t, key=t.get)
        log(f"w8a8_gemm sweep, one decode layer at M={m}: split "
            f"{t['split']:.4f} ms, wgmma {t['wgmma']:.4f} ms; the plan takes "
            f"{pick}, faster: {faster[m]}")
    found = max([m for m in GEMM_SWEEP_M if faster[m] == "split"], default=0)
    log(f"w8a8_gemm crossover: split is faster up to M={found} of "
        f"{GEMM_SWEEP_M}; GEMM_CROSSOVER = {ig.GEMM_CROSSOVER}")
    base = {name: ig.gemm_plan(8, n, k).n_split
            for name, (_, _, k, n) in weights.items()}
    log(f"w8a8_gemm M=8 plan splits: {base}")
    for label, f in (("1", lambda s: 1), ("half", lambda s: max(1, s // 2)),
                     ("plan", lambda s: s), ("double", lambda s: 2 * s)):
        total = 0.0
        for name, (wq, ws, k, n) in weights.items():
            total += _layer_ms(torch, g, {name: weights[name]}, 8, graph_ms,
                               n_split=f(base[name]))
        log(f"w8a8_gemm sweep, M=8 layer, splits {label}: {total:.4f} ms")
    for m, layer, timer in ((128, weights, graph_ms),
                            (TRAIN_BATCH * TRAIN_SEQ, train,
                             lambda fn: time_ms(fn, 5))):
        for bn in ig.WGMMA_BN_CHOICES:
            ms = _layer_ms(torch, g, layer, m, timer, path="wgmma", bn=bn)
            log(f"w8a8_gemm sweep, M={m} layer, wgmma 128 x {bn}: "
                f"{ms:.4f} ms")
    return found


def phase_gemm(np, torch):
    """``w8a8_gemm`` against its plain version, exactly, at the 1.3B
    projection shapes (M = 8, 40 and 128, fp32 and bf16 activations) and
    the training flagship's (M = 12288, bf16); timed at M=8 (one decode
    step's four projections of a layer, summed for the kernels line) and at
    M=128, by CUDA-graph replay, with the host's cost per call (eager time
    less replay time) beside; at M=12288 by CUDA events.  Then the sweep
    of the plan's decisions (``_gemm_sweep``)."""
    from paddle_tpu_torch.kernels import w8a8_gemm, w8a8_gemm_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    weights = _gemm_weights(torch, g, PROJ)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, bytes=0,
               ops=0, host_us=0.0)
    prefill = dict(ms=0.0, library_ms=0.0, bytes=0, ops=0)
    for proj, (wq, ws, k, n) in weights.items():
        wb = (wq.float() * ws[:, None]).t().contiguous().bfloat16()
        for m in (8, 40, 128):
            x = torch.randn(m, k, device=dev, generator=g)
            x[-1] = 0.0                              # the 1e-8 clamp
            out, xq, sx = w8a8_gemm(x, wq, ws, return_quantized=True)
            ref, rxq, rsx = w8a8_gemm_plain(x, wq, ws, return_quantized=True)
            xb = x.to(torch.bfloat16)
            exact = (torch.equal(xq, rxq) and torch.equal(sx, rsx)
                     and torch.equal(out, ref)
                     and torch.equal(w8a8_gemm(xb, wq, ws),
                                     w8a8_gemm_plain(xb, wq, ws)))
            err = (out - ref).abs().max().item()
            log(f"w8a8_gemm {proj} M={m} K={k} N={n}: bit-exact {exact} "
                f"(max_abs_err {err:.3e})")
            if not exact:
                raise AssertionError(f"w8a8_gemm {proj} M={m} is not exact")
            if m == 40:
                continue
            # the yardstick: torch._int_mm on the quantized operands, which
            # needs M > 16: M=8 pads to 32 rows (quantize excluded)
            xq_pad = torch.zeros(max(m, 32), k, dtype=torch.int8, device=dev)
            xq_pad[:m] = xq
            calls = dict(bf16_matmul=lambda: xb @ wb,
                         kernel=lambda: w8a8_gemm(xb, wq, ws),
                         int_mm=lambda: torch._int_mm(xq_pad, wq.t()),
                         plain=lambda: w8a8_gemm_plain(xb, wq, ws))
            # device time from CUDA-graph replays, eager times beside; the
            # kernel and _int_mm in turns, twice each (the mean), after the
            # bf16 matmul and before the plain version's fp64 product, so
            # that the two meet the card in the same state
            dev_ms = {key: graph_ms(fn) for key, fn in calls.items()}
            for key in ("kernel", "int_mm"):
                dev_ms[key] = (dev_ms[key] + graph_ms(calls[key])) / 2
            eager = {key: time_ms(fn) for key, fn in calls.items()}
            ms, plain_ms, lib_ms = (dev_ms["kernel"], dev_ms["plain"],
                                    dev_ms["int_mm"])
            nbytes = m * k * 2 + n * k + n * 4 + m * n * 2
            bms, by = bound_ms(nbytes, 2 * m * n * k, INT8_OPS)
            host_us = (eager["kernel"] - ms) * 1e3
            log(f"  timed bf16 x, graph replay (eager): kernel {ms:.4f} "
                f"({eager['kernel']:.4f}) ms, plain {plain_ms:.4f} "
                f"({eager['plain']:.4f}) ms, _int_mm {lib_ms:.4f} "
                f"({eager['int_mm']:.4f}) ms (M padded to {max(m, 32)}), "
                f"bf16 matmul {dev_ms['bf16_matmul']:.4f} "
                f"({eager['bf16_matmul']:.4f}) ms, bound {bms:.4f} ms ({by}); "
                f"host cost per call (eager - replay) {host_us:.2f} us")
            acc = tot if m == 8 else prefill
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", bms), ("library_ms", lib_ms),
                             ("bytes", nbytes), ("ops", 2 * m * n * k),
                             ("host_us", host_us)):
                if key in acc:
                    acc[key] += val
    # the training flagship's projections at its M = 12 x 1024 rows, bf16
    # activations and the live weight quantized as w8a8_matmul does
    m = TRAIN_BATCH * TRAIN_SEQ
    train_weights = _gemm_weights(torch, g, TRAIN_PROJ)
    train = dict(ms=0.0, library_ms=0.0, bytes=0, ops=0)
    layer = []
    for proj, (wq, ws, k, n) in train_weights.items():
        x = torch.randn(m, k, device=dev, generator=g).bfloat16()
        layer.append((x, wq, ws))
        got = w8a8_gemm(x, wq, ws, return_quantized=True)
        want = w8a8_gemm_plain(x, wq, ws, return_quantized=True)
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        ms = time_ms(lambda: w8a8_gemm(x, wq, ws), 5)
        lib_ms = time_ms(lambda: torch._int_mm(got[1], wq.t()), 5)
        log(f"w8a8_gemm training {proj} M={m} K={k} N={n}, bf16: bit-exact "
            f"{exact}; kernel {ms:.4f} ms, _int_mm on the quantized operands "
            f"{lib_ms:.4f} ms")
        if not exact:
            raise AssertionError(f"w8a8_gemm training {proj} is not exact")
        for key, val in (("ms", ms), ("library_ms", lib_ms),
                         ("bytes", m * k * 2 + n * k + n * 4 + m * n * 2),
                         ("ops", 2 * m * n * k)):
            train[key] += val
        del got, want
    # the quantize's and the GEMM's device time (a dependent GEMM's span
    # starts early, so it includes some of its wait for the quantize)
    _profile(torch, f"w8a8_gemm, one training layer (M={m}), 5 times",
             lambda: [w8a8_gemm(*a) for _ in range(5) for a in layer])
    del layer
    bms, by = bound_ms(train["bytes"], train["ops"], INT8_OPS)
    log(f"w8a8_gemm one training layer's forward (M={m}, qkv + proj + fc1 + "
        f"fc2, bf16 x): {train['ms']:.4f} ms, _int_mm {train['library_ms']:.4f}"
        f" ms ({train['ms'] / train['library_ms']:.2f}x), bound {bms:.4f} ms "
        f"({by}), {train['ops'] / train['ms'] / 1e9:.1f} TOP/s; 96 launches "
        "a step in training run (d)")
    pms, pby = bound_ms(prefill["bytes"], prefill["ops"], INT8_OPS)
    log(f"w8a8_gemm one prefill layer (M=128, qkv + proj + fc1 + fc2): "
        f"{prefill['ms']:.4f} ms, _int_mm {prefill['library_ms']:.4f} ms, "
        f"bound {pms:.4f} ms ({pby})")
    bms, by = bound_ms(tot["bytes"], tot["ops"], INT8_OPS)
    log(f"w8a8_gemm one decode layer (M=8, qkv + proj + fc1 + fc2): "
        f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, _int_mm "
        f"{tot['library_ms']:.4f} ms, bound {bms:.4f} ms; host cost "
        f"{tot['host_us'] / 4:.2f} us a call (eager - replay)")
    decode = [(torch.randn(8, k, device=dev, generator=g).bfloat16(), wq, ws)
              for wq, ws, k, _ in weights.values()]
    _profile(torch, "w8a8_gemm, one decode layer (M=8), 20 times",
             lambda: [w8a8_gemm(*a) for _ in range(20) for a in decode])
    _gemm_sweep(torch, g, weights, train_weights)
    return {"w8a8_gemm": dict(ms=tot["ms"], plain_ms=tot["plain_ms"],
                              bound_ms=bms, bound_by=by,
                              library_ms=tot["library_ms"], max_abs_err=0.0)}


# flash kernels: layout, B, H, Hkv, S, causal, window, dtype (D = 128); the
# first and the last three are the shapes of training runs (a), (b) and
# (c) and the bench's long_seq_4k point (bench.py), which is timed too
FLASH_CASES = (
    ("flagship", "bsnd", 12, 12, 12, 1024, True, None, "bf16"),
    ("fp32", "bsnd", 2, 4, 4, 512, True, None, "fp32"),
    ("bsnd_gqa4", "bsnd", 4, 12, 4, 1024, True, None, "bf16"),
    ("sbnd_gqa4", "sbnd", 4, 12, 4, 1024, True, None, "bf16"),
    ("window256", "bsnd", 4, 12, 12, 1024, True, 256, "bf16"),
    ("ragged520", "bsnd", 2, 12, 12, 520, True, None, "bf16"),
    ("sbnd_flagship", "sbnd", 12, 12, 12, 1024, True, None, "bf16"),
    ("sbnd_gqa4_window256", "sbnd", 12, 12, 4, 1024, True, 256, "bf16"),
    ("long_seq_4k", "bsnd", 2, 12, 12, 4096, True, None, "bf16"),
)
# elementwise |kernel - plain| <= atol * rms + rtol * |plain|, with the rms
# of the plain row (the last axis: a head's D values, or lse over S), per
# tensor and dtype: (rtol, atol).  fp32: summation order only.  bf16: out,
# dq, dk and dv are rounded once to bf16 (2^-8 of the value, 2^-7 at the
# foot of a binade), and the kernels round P and dS to bf16 for the
# tensor cores (the forward's P against its running maximum where the
# plain version uses the row's final one, the backward's where the plain
# version keeps fp32): an error on the scale of the terms summed, which
# the row's rms follows where a value cancels (an early key's dV sums
# O(1) terms of many queries); lse stays fp32.
# At atol 1e-2 the worst shares of the bound on an H100 were 0.93 (out),
# 0.85 (dq), 0.69 (dk) and 1.04 (dv) over these cases, hence 3e-2
FLASH_TOL = {
    "fp32": {"out": (1e-5, 1e-5), "lse": (1e-6, 1e-6), "dq": (1e-5, 1e-5),
             "dk": (1e-5, 1e-5), "dv": (1e-5, 1e-5)},
    "bf16": {"out": (2e-2, 3e-2), "lse": (1e-6, 1e-6), "dq": (2e-2, 3e-2),
             "dk": (2e-2, 3e-2), "dv": (2e-2, 3e-2)},
}


def _flash_close(label, got, want, rtol, atol):
    """Holds ``got`` to ``want`` elementwise within ``atol * rms +
    rtol * |want|`` (``rms`` of ``want``'s row, at least 1e-2 of the
    tensor's: a row that is zero, as the first query's dQ under a causal
    mask, is held to the summation noise around it); logs the max abs
    error, the tensor's rms and the worst share of the bound used, and
    returns the max abs error."""
    g, w = got.float(), want.float()
    rms = w.square().mean().sqrt()
    row = w.square().mean(-1, keepdim=True).sqrt().clamp_min(1e-2 * rms)
    err = (g - w).abs()
    used = (err / (atol * row + rtol * w.abs())).max().item()
    top = err.max().item()
    log(f"{label}: max_abs_err {top:.3e}, rms {rms:.3e}, worst {used:.3f} "
        f"of the bound (rtol {rtol:g}, atol {atol:g} * row rms)")
    if not used <= 1.0:
        raise AssertionError(f"{label} disagrees with its plain version")
    return top


def _qkv_views(torch, g, layout, b, h, hkv, s, d, dtype):
    """q, k, v as the model hands them to attention: head views of one
    fused projection output ([B, S, W] for bsnd, [S, B, W] for sbnd)."""
    lead = (s, b) if layout == "sbnd" else (b, s)
    qkv = torch.randn(*lead, (h + 2 * hkv) * d, device="cuda",
                      generator=g).to(dtype)
    q, k, v = torch.split(qkv, [h * d, hkv * d, hkv * d], dim=-1)
    return (q.reshape(*lead, h, d), k.reshape(*lead, hkv, d),
            v.reshape(*lead, hkv, d))


def phase_flash(np, torch):
    """The forward, dQ and dK/dV kernels against their plain versions in
    every case (the backward kernels take the plain forward's out and lse,
    so each kernel is held on its own), and timed at the flagship shape
    (the kernels line), at the long-sequence point and at the flagship
    shape with head dim 64 (logged)."""
    from paddle_tpu_torch.kernels import flash_bwd_plain, flash_fwd_plain
    from paddle_tpu_torch.kernels.flash import flash_bwd, flash_fwd_cuda

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    d = 128
    for case, layout, b, h, hkv, s, causal, window, dt in FLASH_CASES:
        g = torch.Generator(device="cuda").manual_seed(s + h + hkv)
        dtype = dtypes[dt]
        q, k, v = _qkv_views(torch, g, layout, b, h, hkv, s, d, dtype)
        scale = 1.0 / np.sqrt(d)
        out, lse = flash_fwd_cuda(q, k, v, causal, scale, window, layout)
        ref, rlse = flash_fwd_plain(q, k, v, causal, scale, window, layout)
        do = torch.randn(ref.shape, device="cuda", generator=g).to(dtype)
        got = flash_bwd(q, k, v, ref, rlse, do, causal, scale, window, layout)
        want = flash_bwd_plain(q, k, v, ref, rlse, do, causal, scale, window,
                               layout)
        torch.cuda.synchronize()
        for name, part, a, r in (("flash_fwd", "out", out, ref),
                                 ("flash_fwd", "lse", lse, rlse),
                                 ("flash_bwd_dq", "dq", got[0], want[0]),
                                 ("flash_bwd_dkv", "dk", got[1], want[1]),
                                 ("flash_bwd_dkv", "dv", got[2], want[2])):
            err = _flash_close(
                f"{name} {part} {case} ({layout}, B={b} H={h} Hkv={hkv} "
                f"S={s} D={d}, {dt}, window {window})", a, r,
                *FLASH_TOL[dt][part])
            if dt == "bf16":
                worst[name] = max(worst[name], err)
        del q, k, v, out, lse, ref, rlse, do, got, want
    torch.cuda.empty_cache()

    results = _time_flash(np, torch, FLASH_CASES[0], worst)
    _time_flash(np, torch, FLASH_CASES[-1], worst)
    _time_flash(np, torch, FLASH_CASES[0], worst, d=64)
    return results


def _time_flash(np, torch, case, worst, d=128):
    """The three kernels, their plain versions and SDPA timed on one
    case's strided views at head dim ``d``; returns each kernel's entry of
    the kernels line."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_bwd_plain, flash_fwd_plain
    from paddle_tpu_torch.kernels.flash import (flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda, flash_delta,
                                                flash_fwd_cuda)

    label, layout, b, h, hkv, s, causal, window, _ = case
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = _qkv_views(torch, g, layout, b, h, hkv, s, d, torch.bfloat16)
    scale = 1.0 / np.sqrt(d)
    out, lse = flash_fwd_cuda(q, k, v, causal, scale, window, layout)
    do = torch.randn(out.shape, device="cuda", generator=g).bfloat16()
    delta = flash_delta(out, do, layout)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))      # SDPA's view
    lib = [x.detach().requires_grad_() for x in (qh, kh, vh)]
    doh = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*lib, is_causal=True)
        torch.autograd.grad(o, lib, doh)

    ms = {"flash_fwd": time_ms(lambda: flash_fwd_cuda(
              q, k, v, causal, scale, window, layout)),
          "flash_bwd_dq": time_ms(lambda: flash_bwd_dq_cuda(
              q, k, v, out, lse, delta, do, causal, scale, window, layout)),
          "flash_bwd_dkv": time_ms(lambda: flash_bwd_dkv_cuda(
              q, k, v, lse, delta, do, causal, scale, window, layout))}
    plain_fwd = time_ms(lambda: flash_fwd_plain(q, k, v, causal, scale,
                                                window, layout), iters=3)
    plain_bwd = time_ms(lambda: flash_bwd_plain(q, k, v, out, lse, do,
                                                causal, scale, window,
                                                layout), iters=3)
    # the library by CUDA-graph replay: an eager SDPA forward + backward
    # is bound by the host's enqueue of autograd
    lib_fwd = graph_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    lib_bwd = graph_ms(sdpa_fwd_bwd) - lib_fwd
    elems = b * s * h * d * 2                    # bytes of one bf16 operand
    rows = b * h * s * 4                         # bytes of lse or delta
    half = b * h * s * s * d / 2                 # causal: half the pairs
    work = {"flash_fwd": (4 * elems + rows, 4 * half),
            "flash_bwd_dq": (5 * elems + 2 * rows, 6 * half),
            "flash_bwd_dkv": (6 * elems + 2 * rows, 8 * half)}
    results = {}
    for name, (nbytes, ops) in work.items():
        bms, by = bound_ms(nbytes, ops, BF16_FLOPS)
        fwd = name == "flash_fwd"
        results[name] = dict(ms=ms[name],
                             plain_ms=plain_fwd if fwd else plain_bwd,
                             bound_ms=bms, bound_by=by,
                             library_ms=lib_fwd if fwd else lib_bwd,
                             max_abs_err=worst[name])
        log(f"{name} timed case {label}: B={b} H={h} S={s} D={d} causal "
            f"bf16, q/k/v head views of one QKV tensor: {ms[name]:.4f} ms "
            f"({ops / ms[name] / 1e9:.1f} TFLOP/s), plain "
            f"{results[name]['plain_ms']:.4f} ms (the whole "
            f"{'forward' if fwd else 'backward'}), sdpa by graph replay "
            f"{'forward' if fwd else 'fwd+bwd - fwd'} "
            f"{results[name]['library_ms']:.4f} ms, bound {bms:.4f} ms "
            f"({by}; {ops:.4g} flop, {nbytes} bytes)")
    return results


# -- phase 3 -----------------------------------------------------------------

def _requests(np, rng, cfg, shared, n=16, motif=False):
    """``n`` (prompt, max_new_tokens) pairs: prompts of 64-512 tokens, the
    even ones behind the ``shared`` 128-token prefix, 32-64 new tokens;
    with ``motif`` the odd ones repeat a random 4-12 token motif."""
    out = []
    for i in range(n):
        if i % 2 == 0:
            tail = rng.randint(0, cfg.vocab_size, (int(rng.randint(32, 385)),))
            prompt = np.concatenate([shared, tail])
        else:
            size = int(rng.randint(64, 513))
            if motif:
                unit = rng.randint(0, cfg.vocab_size,
                                   (int(rng.randint(4, 13)),))
                prompt = np.tile(unit, size // unit.size + 1)[:size]
            else:
                prompt = rng.randint(0, cfg.vocab_size, (size,))
        out.append((prompt, int(rng.randint(32, 65))))
    return out


def _profile(torch, what, fn):
    """Run ``fn`` under torch.profiler and print the device's busy share of
    the host-clock wall time and the device time by kernel; returns the
    busy share.  The profiler slows the host, so the idle share is an upper
    bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: host-side op events would cost the profiler
    # tens of seconds to assemble for the quantized runs
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    share = busy / (1e3 * wall)
    log(f"  profile: {what}, wall {1e3 * wall:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * share:.1f}%)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {ms:9.2f} ms {100 * ms / max(busy, 1e-9):5.1f}%  {name[:90]}")
    # the paged kernels: the split-KV body and its merge for bf16 queries
    # (decode and verify in its tile split, prefill in its row split:
    # template argument false or true), the FMA bodies for fp32 ones
    for kind, keys in (("decode / verify", ("false>", "paged_decode",
                                            "paged_mq")),
                       ("prefill", ("true>", "paged_prefill"))):
        ms = sum(t for name, t in by_name.items()
                 if ("ptt::" in name or "paged_" in name)
                 and any(k in name for k in keys))
        if ms:
            log(f"  paged {kind} kernels: {ms:.2f} ms "
                f"({100 * ms / max(busy, 1e-9):.1f}% of device time)")
    return share


# label, engine options, requests, motif prompts, kernel variants it runs
SERVING_RUNS = (
    ("a", {}, 16, False, {"paged_attention", "paged_prefill"}),
    ("b", {"int8": True}, 16, False,
     {"w8a8_gemm", "paged_attention_int8", "paged_prefill_int8"}),
    ("c", {"int8": True, "kv_bits": 4}, 16, False,
     {"w8a8_gemm", "paged_attention_int4", "paged_prefill_int4"}),
    ("d", {"spec_k": 4}, 16, True, {"paged_prefill", "paged_attention_mq"}),
    ("e", {"int8": True, "spec_k": 4}, 8, True,
     {"w8a8_gemm", "paged_prefill_int8", "paged_attention_mq_int8"}),
    ("f", {"int8": True, "kv_bits": 4, "spec_k": 4}, 8, True,
     {"w8a8_gemm", "paged_prefill_int4", "paged_attention_mq_int4"}),
)


def _serve(np, torch, model, label, opts, n_req, motif, expected):
    """One serving run of the 1.3B model: returns the launch counts of the
    kernel variants it ran."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.serving import ServingEngine

    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(model, max_slots=8, page_size=32, chunk_tokens=128,
                        **opts)
    rng = np.random.RandomState(1)
    shared = rng.randint(0, cfg.vocab_size, (128,))
    rids = [eng.add_request(p, n) for p, n in
            _requests(np, rng, cfg, shared, n=n_req, motif=motif)]

    reset_launch_counts()
    done = {}
    t0 = time.perf_counter()
    while eng.has_work:
        for fin in eng.step():
            done[fin.rid] = fin
        eng.check_invariants()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: n for name, n in KERNELS.items() if n}

    reasons = {done[r].reason for r in rids}
    if set(done) != set(rids) or reasons != {"length"}:
        raise AssertionError(f"run ({label}): requests ended {reasons}")
    if set(launches) != expected:
        raise AssertionError(f"run ({label}) launched {sorted(launches)}, "
                             f"expected {sorted(expected)}")
    s = eng.stats
    if n_req > eng.max_slots and s["prefix_hit_tokens"] <= 0:
        # a second admission wave finds the first wave's shared prefix
        raise AssertionError(f"run ({label}): no prefix-cache hit")
    if eng.scheduler.n_active or eng.pool.pages_in_use:
        raise AssertionError(f"run ({label}): the pool did not drain clean")
    for fin in done.values():
        if len(fin.tokens) == 0 or not ((0 <= fin.tokens)
                                        & (fin.tokens < cfg.vocab_size)).all():
            raise AssertionError(f"request {fin.rid} produced bad tokens")
    log(f"serving ({label}) {json.dumps(opts)}: {n_req} requests in "
        f"{wall:.2f} s, {s['tokens_generated']} tokens; decode "
        f"{s['decode_tokens'] / s['decode_s']:.1f} tokens/s over "
        f"{s['decode_calls']} steps, mean decode step "
        f"{1e3 * s['decode_s'] / s['decode_calls']:.3f} ms, mean prefill "
        f"chunk {1e3 * s['prefill_s'] / s['prefill_calls']:.3f} ms over "
        f"{s['prefill_calls']} chunks; pool {eng.pool.bytes_per_token()} "
        f"bytes/token; prefix hit tokens {s['prefix_hit_tokens']} of "
        f"{s['prompt_tokens']}; preemptions {s['preemptions']}; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if eng.spec_k:
        log(f"  spec: drafted {s['spec_drafted']}, accepted "
            f"{s['spec_accepted']}, rejected {s['spec_rejected']} "
            f"(acceptance {s['spec_accepted'] / max(1, s['spec_drafted']):.3f})")
    log(f"  launches: {json.dumps(launches)}")
    if label in "abcd":
        more = _requests(np, rng, cfg, shared, n=8, motif=motif)
        _profile(torch, f"{len(more)} more requests", lambda: eng.run(more))
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_serving(np, torch):
    """Every serving run; returns each kernel variant's launch count on the
    first run that reaches it, and that run's label."""
    from paddle_tpu_torch.models import GPTForPretraining, gpt_1p3b

    t0 = time.perf_counter()
    model = GPTForPretraining(gpt_1p3b(), seed=0)          # bf16 on the card
    torch.cuda.synchronize()
    log(f"serving: gpt_1p3b bf16 built in {time.perf_counter() - t0:.2f} s")
    first = {}
    for label, opts, n_req, motif, expected in SERVING_RUNS:
        t1 = time.perf_counter()
        launches = _serve(np, torch, model, label, opts, n_req, motif,
                          expected)
        for name, n in launches.items():
            first.setdefault(name, (n, label))
        log(f"  run ({label}) took {time.perf_counter() - t1:.2f} s")
    del model
    torch.cuda.empty_cache()
    return first


# -- phase 4 -----------------------------------------------------------------

def _agreement(np, label, got, want):
    """Tokens that agree up to each request's first divergence, as a share;
    fails below 99%."""
    agree = total = 0
    for i, (a, b) in enumerate(zip(got, want)):
        diff = np.nonzero(a != b)[0]
        first = int(diff[0]) if diff.size else len(b)
        agree += first
        total += len(b)
        if diff.size:
            log(f"parity {label}: request {i} diverges at token {first}: "
                f"{a[first]} against {b[first]}")
    share = agree / total
    log(f"parity {label}: {agree}/{total} tokens agree up to the first "
        f"divergence ({100 * share:.2f}%)")
    if share < 0.99:
        raise AssertionError(f"parity {label}: agreement {share:.4f} < 0.99")


def _forced(np, torch, model, label, prompts, got, int8, kv_bits):
    """Teacher forcing: the dense decoder reads each prompt and the
    engine's own tokens in one forward, and its greedy choice at every
    position is compared with the engine's token there.  Quantized
    activations turn a float-level difference of summation order into a
    different int8 rounding now and then, which moves near-tied logits of
    a random model; so at least 90% of the positions must agree (the
    reference's own budget for int8 argmax agreement), and each
    disagreement is printed with the dense decoder's gap between its top
    logit and the engine's token."""
    from paddle_tpu_torch.models.generation import _decoder_setup, _empty_cache

    params, make_run = _decoder_setup(model, int8=int8)
    run = make_run(params)
    agree = total = 0
    for i, (p, toks) in enumerate(zip(prompts, got)):
        seq = np.concatenate([p, toks[:-1]])
        ids = torch.as_tensor(seq[None], device=model.device).long()
        kc, vc = _empty_cache(model.cfg, 1, seq.size, model.dtype,
                              model.device, int8=int8, kv_bits=kv_bits)
        logits = run(ids, 0, kc, vc)[0][0, p.size - 1:]       # (T, V)
        want = logits.argmax(-1).cpu().numpy()
        for j in np.nonzero(want != toks)[0]:
            row = logits[j]
            gap = (row.max() - row[int(toks[j])]).item()
            log(f"parity {label}: request {i} position {j}: engine "
                f"{toks[j]}, dense {want[j]}, dense logit gap {gap:.3e} "
                f"(logit std {row.std().item():.3e})")
        agree += int((want == toks).sum())
        total += toks.size
    share = agree / total
    log(f"parity {label}: {agree}/{total} positions agree under teacher "
        f"forcing ({100 * share:.2f}%)")
    if share < 0.9:
        raise AssertionError(f"parity {label}: agreement {share:.4f} < 0.9")


def _parity_model(np, torch):
    """Phase 4's model (fp32, GPT-1.3B width, 2 layers, seed 1; TF32 off
    everywhere from here on) and its 4 prompts."""
    import dataclasses

    from paddle_tpu_torch.models import GPTForPretraining, gpt_1p3b

    # fp32 products in full fp32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = GPTForPretraining(dataclasses.replace(gpt_1p3b(), num_layers=2),
                              seed=1, dtype=torch.float32)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, model.cfg.vocab_size, (n,))
               for n in (17, 64, 100, 250)]
    # two of them repeat a motif, so that the speculative run drafts
    prompts[1] = np.tile(prompts[1][:6], 11)[:64]
    prompts[3] = np.tile(prompts[3][:9], 28)[:250]
    return model, prompts


def phase_parity(np, torch):
    from paddle_tpu_torch.models import generate
    from paddle_tpu_torch.serving import ServingEngine

    model, prompts = _parity_model(np, torch)

    def serve(**opts):
        eng = ServingEngine(model, max_slots=4, page_size=32,
                            chunk_tokens=128, **opts)
        rids = [eng.add_request(p, 24) for p in prompts]
        done = eng.run()
        return [done[r].tokens for r in rids], eng

    plain, _ = serve()
    dense = [generate(model, p[None], 24)[0, len(p):].cpu().numpy()
             for p in prompts]
    _agreement(np, "engine vs dense decoder, bf16 path", plain, dense)
    for opts in ({"int8": True}, {"int8": True, "kv_bits": 4}):
        got, eng = serve(**opts)
        _forced(np, torch, model, f"engine vs dense decoder, "
                f"{json.dumps(opts)}", prompts, got, True, eng.kv_bits)
    spec, eng = serve(spec_k=4)
    log(f"parity spec: drafted {eng.stats['spec_drafted']}, accepted "
        f"{eng.stats['spec_accepted']}")
    _agreement(np, "spec_k=4 engine vs plain engine", spec, plain)


# -- phase 5 -----------------------------------------------------------------

def _roundtrip(torch, layers, bits, reps=1):
    """One request's pages (18: 576 positions at page 32) through
    ``export_pages`` -> host numpy -> ``ingest_pages`` into other pages of
    a second pool, at GPT-1.3B's width (16 heads, D=128) over ``layers``
    layers: byte-equal, page bytes and scales, or fail.  Returns the mean
    export and ingest ms over ``reps`` round trips (host clock, each
    synchronised) and the payload's bytes."""
    from paddle_tpu_torch.serving import KVPool

    g = torch.Generator(device="cuda").manual_seed(7)
    kw = dict(num_pages=40, page_size=32, dtype=torch.bfloat16, kv_bits=bits)
    src, dst = KVPool(layers, 16, 128, **kw), KVPool(layers, 16, 128, **kw)
    for buf in src.buffers.values():
        if buf.dtype == torch.int8:
            buf.copy_(torch.randint(-128, 128, buf.shape, dtype=torch.int8,
                                    device="cuda", generator=g))
        else:
            buf.copy_(torch.randn(buf.shape, device="cuda", generator=g))
    pages, into = src.alloc(18), dst.alloc(25)[7:]
    exp = ing = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        payload = src.export_pages(pages)           # ends in host numpy
        t1 = time.perf_counter()
        dst.ingest_pages(payload, into)
        torch.cuda.synchronize()
        exp += t1 - t0
        ing += time.perf_counter() - t1
    for name, buf in src.buffers.items():
        if not torch.equal(buf[:, pages].view(torch.uint8),
                           dst.buffers[name][:, into].view(torch.uint8)):
            raise AssertionError(f"handoff round trip, kv_bits={bits}: "
                                 f"buffer {name} differs")
    return 1e3 * exp / reps, 1e3 * ing / reps, src.payload_nbytes(payload)


def _drain(target, done):
    """Step an engine or a router to completion, auditing it after every
    step; each rid must reach exactly one terminal."""
    while target.has_work:
        for fin in target.step():
            if fin.rid in done:
                raise AssertionError(f"rid {fin.rid}: two terminals")
            done[fin.rid] = fin
        target.check_invariants()
    return done


def _same_tokens(np, label, got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: request {i} differs: {a} "
                                 f"against {b}")
    log(f"exact {label}: {sum(len(b) for b in want)} tokens of "
        f"{len(want)} requests equal")


def _exact_checks(np, torch):
    """Part (1): phase 4's fp32 model, TF32 off.  Every comparison is
    token for token."""
    from paddle_tpu_torch.serving import (TERMINAL_REASONS, FaultPlan,
                                          ServingEngine, make_cluster)

    for bits in (None, 8, 4):
        _roundtrip(torch, 2, bits)
    log("exact handoff round trip (2 layers): bf16, int8 and int4 pages "
        "and scales byte-equal")
    model, prompts = _parity_model(np, torch)
    kw = dict(max_slots=4, page_size=32, chunk_tokens=128)

    def serve(target):
        rids = [target.add_request(p, 24) for p in prompts]
        done = _drain(target, {})
        return [done[r].tokens for r in rids]

    want = serve(ServingEngine(model, **kw))
    router = make_cluster(model, 2, disaggregate=True, **kw)
    _same_tokens(np, "make_cluster(2, disaggregate=True) vs the monolithic "
                 "engine", serve(router), want)
    if router.stats["handoffs"] != len(prompts):
        raise AssertionError(f"cluster handed off {router.stats}")
    _same_tokens(np, "double_buffer=True vs False",
                 serve(ServingEngine(model, double_buffer=True, **kw)), want)
    eng = ServingEngine(model, **kw)
    rids = [eng.add_request(p, 24) for p in prompts]
    done = {}
    for _ in range(5):
        for fin in eng.step():
            done[fin.rid] = fin
    snap = eng.snapshot()
    del eng
    done = _drain(ServingEngine.restore(model, snap), done)
    _same_tokens(np, "snapshot at step 5, restored and drained, vs the "
                 "uninterrupted run", [done[r].tokens for r in rids], want)

    plan = FaultPlan.random(0, n_steps=40, p_alloc=0.2, p_raise=0.12,
                            p_latency=0.15, max_latency_s=0.01)
    eng = ServingEngine(model, int8=True, faults=plan, num_pages=24,
                        max_queue=6, tenants={"a": 1.0, "b": 3.0}, **kw)
    rng = np.random.RandomState(3)
    rids = []

    def arrive(i):
        rids.append(eng.add_request(
            rng.randint(0, model.cfg.vocab_size, (int(rng.randint(8, 200)),)),
            int(rng.randint(4, 24)), tenant="ab"[i % 2],
            deadline_s=(0.02 if i % 4 == 3 else None)))

    done, steps = {}, 0
    while eng.has_work or steps < 8:
        steps += 1
        for i in range(2 * steps - 2, 2 * steps) if steps <= 8 else ():
            arrive(i)
        if steps == 4:
            eng.cancel(rids[0])
        for fin in eng.step():
            if fin.rid in done or fin.reason not in TERMINAL_REASONS:
                raise AssertionError(f"chaos: bad terminal {fin}")
            done[fin.rid] = fin
        eng.check_invariants()
    if set(done) != set(rids) or eng.pool.pages_in_use:
        raise AssertionError("chaos: a request without a terminal, or a "
                             "leaked page")
    if not (plan.injected["alloc_fail"] and plan.injected["raise"]):
        raise AssertionError(f"chaos: no fault fired {plan.injected}")
    reasons = {}
    for fin in done.values():
        reasons[fin.reason] = reasons.get(fin.reason, 0) + 1
    log(f"exact chaos (int8, WFQ a:b = 1:3, FaultPlan.random(0)): "
        f"{len(rids)} requests, one terminal each {json.dumps(reasons)}, "
        f"{steps} steps, faults {json.dumps(plan.injected)}, "
        f"step_faults {eng.stats['step_faults']}, preemptions "
        f"{eng.stats['preemptions']}, no page leaked; vt "
        f"{json.dumps(eng.scheduler.policy.vt)}")
    del model, eng, router
    torch.cuda.empty_cache()


def _replica_line(label, eng):
    s = eng.stats
    dec = (f"decode step {1e3 * s['decode_s'] / s['decode_calls']:.3f} ms "
           f"over {s['decode_calls']} steps, decode_sync_s "
           f"{s['decode_sync_s']:.4f} (retires in flight "
           f"{eng.retires_in_flight}), " if s["decode_calls"] else "")
    pre = (f"prefill chunk {1e3 * s['prefill_s'] / s['prefill_calls']:.3f} "
           f"ms over {s['prefill_calls']} chunks, "
           if s["prefill_calls"] else "")
    log(f"  {label} [{eng.role}]: {dec}{pre}handoffs_out "
        f"{s['handoffs_out']}, handoffs_in {s['handoffs_in']}, "
        f"handoff_bytes {s['handoff_bytes']}, tokens "
        f"{s['tokens_generated']}")


# label, what it builds, kernel variants it runs; (a) and (h) run twice,
# in turns around (g), so that an order effect shows as a difference
# between a run and its repeat
CLUSTER_RUNS = (
    ("a", "ServingEngine(model)", {"paged_attention", "paged_prefill"}),
    ("h", "ServingEngine(model, double_buffer=True)",
     {"paged_attention", "paged_prefill"}),
    ("g", "make_cluster(model, 2, disaggregate=True)",
     {"paged_attention", "paged_prefill"}),
    ("h2", "ServingEngine(model, double_buffer=True)",
     {"paged_attention", "paged_prefill"}),
    ("a2", "ServingEngine(model)", {"paged_attention", "paged_prefill"}),
)


def phase_cluster(np, torch):
    """Part (1) the exact checks; part (2) runs (a), (g) and (h) of
    GPT-1.3B in bf16 on phase 3's 16 requests; part (3) the handoff's
    export / ingest times at full width and the snapshot / restore
    seconds of run (a)'s pool.  Returns each kernel variant's launches in
    (g) and (h), and run (a)'s tokens."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models import GPTForPretraining, gpt_1p3b
    from paddle_tpu_torch.serving import (ServingEngine, make_cluster,
                                          restore_engine, snapshot_engine)

    _exact_checks(np, torch)
    model = GPTForPretraining(gpt_1p3b(), seed=0)          # bf16 on the card
    cfg = model.cfg
    # 16 slots, one per request: every request is admitted at step 1 in
    # the engine and in the cluster's prefill replica alike, so both run
    # the same prefill chunks (at phase 3's 8 slots the prefill replica,
    # freed at each handoff, admits the second wave earlier, its chunks
    # fall elsewhere, and bf16 rounding flips near ties of this random
    # model in a tenth of the tokens)
    kw = dict(max_slots=16, page_size=32, chunk_tokens=128)
    builds = {"a": lambda: ServingEngine(model, **kw),
              "g": lambda: make_cluster(model, 2, disaggregate=True, **kw),
              "h": lambda: ServingEngine(model, double_buffer=True, **kw)}
    tokens, launched, keep = {}, {}, None
    for label, what, expected in CLUSTER_RUNS:
        rng = np.random.RandomState(1)
        shared = rng.randint(0, cfg.vocab_size, (128,))
        target = builds[label[0]]()
        rids = [target.add_request(p, n)
                for p, n in _requests(np, rng, cfg, shared, n=16)]
        reset_launch_counts()
        t0 = time.perf_counter()
        done = _drain(target, {})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: n for name, n in KERNELS.items() if n}
        if set(launches) != expected:
            raise AssertionError(f"run ({label}) launched {sorted(launches)}"
                                 f", expected {sorted(expected)}")
        if {done[r].reason for r in rids} != {"length"}:
            raise AssertionError(f"run ({label}): a request did not finish")
        tokens[label] = [done[r].tokens for r in rids]
        launched[label] = launches
        log(f"cluster run ({label}) {what}: 16 requests in {wall:.2f} s, "
            f"launches {json.dumps(launches)}")
        replicas = getattr(target, "replicas", [target])
        for i, eng in enumerate(replicas):
            _replica_line(f"replica {i}", eng)
        if label != "a":
            _agreement(np, f"run ({label}) vs run (a)", tokens[label],
                       tokens["a"])
        more = _requests(np, rng, cfg, shared, n=8)
        _profile(torch, f"run ({label}), 8 more requests",
                 lambda: target.run(more))
        if label == "a":
            keep = target
        else:
            del target
        torch.cuda.empty_cache()

    for bits in (None, 8, 4):
        _roundtrip(torch, cfg.num_layers, bits)                 # warm-up
        exp, ing, nbytes = _roundtrip(torch, cfg.num_layers, bits, reps=5)
        log(f"handoff of one request's 18 pages, 24 layers, "
            f"{'bf16' if bits is None else f'int{bits}'} pages: "
            f"{nbytes} bytes, export {exp:.3f} ms, ingest {ing:.3f} ms "
            f"(host clock, mean of 5 after a warm-up)")
    t0 = time.perf_counter()
    snap = snapshot_engine(keep)
    t1 = time.perf_counter()
    back = restore_engine(model, snap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"snapshot of run (a)'s engine ({keep.pool.hbm_bytes()} pool "
        f"bytes): {t1 - t0:.3f} s; restore {t2 - t1:.3f} s")
    del snap, back, keep, model
    torch.cuda.empty_cache()
    return {label: launched[label] for label in ("g", "h")}, tokens["a"]


# -- phase 5b ----------------------------------------------------------------

def _pct(vals, q):
    """The ``q``-th percentile of ``vals`` (linear interpolation)."""
    import numpy as np

    return float(np.percentile(np.asarray(vals, dtype=np.float64), q))


async def _sse_request(port, payload, cut_after=None):
    """One streamed completion over a fresh connection.  Returns the
    status, the streamed tokens with their arrival times (host clock),
    the final event and the send time.  ``cut_after``: reset the
    connection (SO_LINGER 0) once that many tokens have arrived."""
    import asyncio
    import socket
    import struct

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode()
    t_send = time.perf_counter()
    writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    buf, status, tokens, times, final = b"", None, [], [], None
    while True:
        chunk = await asyncio.wait_for(reader.read(65536), 600)
        if not chunk:
            break
        buf += chunk
        if status is None and b"\r\n\r\n" in buf:
            head, _, buf = buf.partition(b"\r\n\r\n")
            status = int(head.split(b"\r\n")[0].split()[1])
        while status == 200 and b"\n\n" in buf:
            event, _, buf = buf.partition(b"\n\n")
            data = event.decode().strip()[len("data: "):]
            if data == "[DONE]":
                continue
            doc = json.loads(data)
            if doc["object"] == "completion.chunk":
                tokens.append(doc["token"])
                times.append(time.perf_counter())
            else:
                final = doc
        if cut_after is not None and len(tokens) >= cut_after:
            writer.get_extra_info("socket").setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
            writer.transport.abort()
            return dict(status=status, tokens=tokens, times=times,
                        final=None, t_send=t_send, body=buf)
    writer.close()
    return dict(status=status, tokens=tokens, times=times, final=final,
                t_send=t_send, body=buf)


async def _http_get(port, path):
    import asyncio

    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 60)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b"\r\n")[0].split()[1]), head, body


class _Served:
    """``serve()`` on an ephemeral port in a background thread (its event
    loop there, the engine built in this one); ``port`` once bound.  On
    exit the server is shut down and its thread joined; a server that
    died or did not stop fails the phase."""

    def __init__(self, target):
        self.target, self.port = target, None

    def __enter__(self):
        import threading

        from paddle_tpu_torch.serving import serve

        ready, self._box = threading.Event(), {}

        def on_start(fe, shutdown):
            self.port, self._shutdown = fe.port, shutdown
            ready.set()

        def run():
            try:
                serve(self.target, port=0, banner=False, on_start=on_start)
            except BaseException as e:       # reported by __exit__
                self._box["error"] = e
                ready.set()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not ready.wait(120) or self.port is None:
            raise AssertionError(f"serve() did not start: {self._box}")
        return self

    def __exit__(self, *exc):
        self._shutdown()
        self._thread.join(120)
        if self._thread.is_alive() or "error" in self._box:
            raise AssertionError(f"serve() did not stop cleanly: "
                                 f"{self._box}")
        return False


def _streams(port, payloads):
    """The payloads as concurrent streamed completions."""
    import asyncio

    async def go():
        return await asyncio.gather(*(_sse_request(port, p)
                                      for p in payloads))

    return asyncio.run(go())


def _recording(target):
    """Wrap ``target.step`` so that every FinishedRequest is kept:
    returns the dict it fills."""
    finished, step = {}, target.step

    def recorded():
        fins = step()
        finished.update((f.rid, f) for f in fins)
        return fins

    target.step = recorded
    return finished


def _check_streams(np, label, results, finished, want=None):
    """Every stream answered 200, streamed exactly its final event's and
    its FinishedRequest's tokens (and ``want``'s, where given)."""
    for i, r in enumerate(results):
        if r["status"] != 200 or r["final"] is None:
            raise AssertionError(f"{label}: stream {i} status {r['status']}")
        toks = np.asarray(r["tokens"])
        fin = finished[r["final"]["id"]]
        if not (np.array_equal(toks, r["final"]["tokens"])
                and np.array_equal(toks, fin.tokens)):
            raise AssertionError(f"{label}: stream {i} differs from its "
                                 f"FinishedRequest")
        if want is not None and not np.array_equal(toks, want[i]):
            raise AssertionError(f"{label}: stream {i} differs from the "
                                 f"direct engine: {toks} against {want[i]}")


def _front_exact(np, torch):
    """Part (1) on phase 4's fp32 model: streams, a cut stream, a 429, the
    scrape and the health check, the cluster; beam search on the card
    against the CPU; the dropout train step on the card against the CPU
    with injected masks, and remat against none."""
    import asyncio

    from paddle_tpu_torch.serving import ServingEngine, make_cluster

    model, prompts = _parity_model(np, torch)
    kw = dict(max_slots=4, page_size=32, chunk_tokens=128)
    payloads = [{"prompt": [int(t) for t in p], "max_tokens": 24}
                for p in prompts]
    direct = ServingEngine(model, **kw)
    rids = [direct.add_request(p, 24) for p in prompts]
    done = direct.run()
    want = [done[r].tokens for r in rids]

    eng = ServingEngine(model, **kw)
    finished = _recording(eng)
    with _Served(eng) as srv:
        results = _streams(srv.port, payloads)
        _check_streams(np, "front end, 4 concurrent streams", results,
                       finished, want)
        log(f"exact front end: 4 concurrent streams, "
            f"{sum(len(w) for w in want)} tokens, each equal to its "
            f"FinishedRequest and to the direct engine")
        _, _, body = asyncio.run(_http_get(srv.port, "/healthz"))
        base = json.loads(body)["pages_in_use"]
        cut = asyncio.run(_sse_request(srv.port, dict(payloads[3],
                                                      max_tokens=200),
                                       cut_after=2))
        step_at_cut = eng._step_idx
        for _ in range(2000):
            _, _, body = asyncio.run(_http_get(srv.port, "/healthz"))
            health = json.loads(body)
            if health["pages_in_use"] == base and eng.stats["cancelled"]:
                break
            time.sleep(0.005)
        after = health["step"] - step_at_cut
        log(f"exact front end: a stream reset after {len(cut['tokens'])} "
            f"tokens; pages_in_use back at its baseline {base} "
            f"{after} step(s) after the reset, cancelled "
            f"{eng.stats['cancelled']}")
        if health["pages_in_use"] != base or eng.stats["cancelled"] != 1 \
                or after > 2:
            raise AssertionError(f"the cut stream was not released within "
                                 f"two steps: {health}, {after} steps")
        status, _, body = asyncio.run(_http_get(srv.port, "/metrics"))
        lines = body.decode().splitlines()
        count = ('serving_http_requests{code="200",'
                 'route="/v1/completions"} 5')
        if status != 200 or count not in lines:
            raise AssertionError("/metrics does not count the 5 streams")
        status, _, body = asyncio.run(_http_get(srv.port, "/healthz"))
        if status != 200 or json.loads(body)["status"] != "ok":
            raise AssertionError(f"/healthz {status} {body}")
    log("exact front end: /metrics counts the 5 streams, /healthz 200")
    full = ServingEngine(model, max_queue=0, **kw)
    with _Served(full) as srv:
        r = asyncio.run(_sse_request(srv.port, payloads[0]))
    if r["status"] != 429 or full.stats["rejected"]:
        raise AssertionError(f"max_queue=0: status {r['status']}")
    log("exact front end: a full queue (max_queue=0) answers 429 and "
        "enqueues nothing")
    router = make_cluster(model, 2, disaggregate=True, **kw)
    finished = _recording(router)
    with _Served(router) as srv:
        results = _streams(srv.port, payloads)
    _check_streams(np, "front end over make_cluster(2, disaggregate=True)",
                   results, finished, want)
    if router.stats["handoffs"] != len(prompts):
        raise AssertionError(f"cluster handed off {router.stats}")
    log("exact front end: the same 4 streams through make_cluster(model, 2, "
        "disaggregate=True) equal the direct engine")
    del eng, full, router, direct
    _beam_parity(np, torch, model, prompts)
    del model
    torch.cuda.empty_cache()
    _dropout_parity(np, torch)


def _beam_parity(np, torch, model, prompts):
    """Beam search (beam 4, EOS a greedy first token) on the card against
    the same call on the CPU, held as phase 4 holds greedy runs; beam 1
    equal to greedy decoding on the card."""
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         build_beam_search_fn, generate)

    ids = np.stack([prompts[0], prompts[2][:17]]).astype(np.int64)
    eos = int(generate(model, ids, 1)[0, -1])
    cpu = GPTForPretraining(model.cfg, device="cpu", dtype=torch.float32)
    cpu.load_state_dict(model.state_dict())
    kw = dict(beam_size=4, eos_token_id=eos, length_penalty=1.0)
    got = build_beam_search_fn(model, 12, **kw)(ids).cpu().numpy()[:, 17:]
    want = build_beam_search_fn(cpu, 12, **kw)(ids).numpy()[:, 17:]
    log(f"beam search, card vs CPU (EOS {eos}): card {got.tolist()}, CPU "
        f"{want.tolist()}")
    _agreement(np, "beam search (beam 4, EOS frozen) card vs CPU", got, want)
    one = build_beam_search_fn(model, 12, beam_size=1)(ids).cpu().numpy()
    _same_tokens(np, "beam_size=1 vs greedy decoding on the card",
                 list(one), list(generate(model, ids, 12).cpu().numpy()))
    del cpu


def _injected_uniform(torch):
    """Uniforms that depend on the key alone, the same on the card and
    the CPU: drawn on the CPU from the key, then moved."""
    def uniform(key, shape, device):
        gen = torch.Generator().manual_seed(int(key))
        return torch.rand(tuple(shape), generator=gen).to(device)

    return uniform


def _dropout_parity(np, torch):
    """The dropout=0.1 train step on the card (fp32, no TF32) against the
    CPU with the same injected masks, phase 6's parity tolerances; then
    remat=True against remat=False on the card at one seed with the
    card's own generator."""
    from paddle_tpu_torch.framework import random as trand
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.models.gpt import build_functional_train_step

    cfg = GPTConfig(**{**TRAIN_CFG, "num_layers": 2, "dropout": 0.1})
    cpu = GPTForPretraining(cfg, device="cpu", dtype=torch.float32, seed=3)
    card = GPTForPretraining(cfg, device="cuda", dtype=torch.float32, seed=3)
    card.load_state_dict(cpu.state_dict())
    names = {p.data_ptr(): n for n, p in cpu.named_parameters()}
    names = [names[p.data_ptr()] for p in cpu.leaves()]
    init = [p.detach().clone() for p in cpu.leaves()]
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (1, 512)).astype("int32")
    labels = rng.randint(0, cfg.vocab_size, (1, 512)).astype("int64")

    def train(model, remat, steps=2):
        trand.seed(11)
        step, params, opt = build_functional_train_step(
            model, lr=1e-4, remat=remat, ce_chunk_rows=2048)
        params = [p.clone() for p in params]
        losses = []
        for _ in range(steps):
            params, opt, loss = step(params, opt, ids, labels)
            losses.append(float(loss))
        return losses, [p.cpu() for p in params]

    real = trand.uniform
    trand.uniform = _injected_uniform(torch)
    try:
        reset_launch_counts()
        lc, pc = train(card, False)
        launched = {k: n for k, n in KERNELS.items() if n}
        lh, ph = train(cpu, False)
    finally:
        trand.uniform = real
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    ratios = update_ratios(torch, cfg, names, pc, ph, init)
    log(f"dropout train step, card vs CPU with injected masks: losses "
        f"{lc} / {lh}, loss rel err {rel:.3e} (tol 1e-4), worst update "
        f"ratio {max(ratios.values()):.3e} (tol {UPDATE_RTOL:g}); card "
        f"launches {json.dumps(launched)}")
    if not (rel <= 1e-4 and max(ratios.values()) <= UPDATE_RTOL):
        raise AssertionError("the dropout train step on the card disagrees "
                             "with the CPU")
    if launched:
        raise AssertionError(f"dropout launched kernels: {launched}")
    (l0, p0), (l1, p1) = train(card, False), train(card, True)
    diff = max((a - b).abs().max().item() for a, b in zip(p0, p1))
    log(f"dropout train step on the card, remat=True vs remat=False at one "
        f"seed: losses {l1} / {l0}, largest parameter difference {diff:.3e}")
    if l0 != l1 or diff > 1e-6:
        raise AssertionError("remat changed the dropout step")
    del cpu, card
    torch.cuda.empty_cache()


HTTP_RUNS = (("bf16", {}, {"paged_attention", "paged_prefill"}),
             ("int8", {"int8": True},
              {"w8a8_gemm", "paged_attention_int8", "paged_prefill_int8"}))


def _front_serving(np, torch, model, tokens_a):
    """Part (2): GPT-1.3B on phase 3's 16 requests over HTTP, 16 slots,
    sent at once; client-side time to first token and between tokens
    beside the engine's own step times; bf16 against phase 5's run (a)."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.serving import ServingEngine

    cfg = model.cfg
    for label, opts, expected in HTTP_RUNS:
        rng = np.random.RandomState(1)
        shared = rng.randint(0, cfg.vocab_size, (128,))
        reqs = _requests(np, rng, cfg, shared, n=16)
        eng = ServingEngine(model, max_slots=16, page_size=32,
                            chunk_tokens=128, **opts)
        finished = _recording(eng)
        with _Served(eng) as srv:
            reset_launch_counts()
            t0 = time.perf_counter()
            results = _streams(srv.port, [
                {"prompt": [int(t) for t in p], "max_tokens": n}
                for p, n in reqs])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: n for name, n in KERNELS.items() if n}
        _check_streams(np, f"HTTP run ({label})", results, finished)
        if set(launches) != expected:
            raise AssertionError(f"HTTP run ({label}) launched "
                                 f"{sorted(launches)}, expected "
                                 f"{sorted(expected)}")
        ttft = [1e3 * (r["times"][0] - r["t_send"]) for r in results]
        tbt = [1e3 * (b - a) for r in results
               for a, b in zip(r["times"], r["times"][1:])]
        s = eng.stats
        log(f"HTTP run ({label}) {json.dumps(opts)}: 16 concurrent streams "
            f"in {wall:.2f} s, {s['tokens_generated']} tokens; client time "
            f"to first token p50 {_pct(ttft, 50):.1f} ms, p99 "
            f"{_pct(ttft, 99):.1f} ms; between tokens p50 "
            f"{_pct(tbt, 50):.2f} ms, p99 {_pct(tbt, 99):.2f} ms; engine "
            f"decode step {1e3 * s['decode_s'] / s['decode_calls']:.3f} ms "
            f"over {s['decode_calls']} steps, prefill chunk "
            f"{1e3 * s['prefill_s'] / s['prefill_calls']:.3f} ms over "
            f"{s['prefill_calls']} chunks; launches {json.dumps(launches)}")
        if label == "bf16":
            _agreement(np, "HTTP run (bf16) vs phase 5's run (a)",
                       [np.asarray(r["tokens"]) for r in results], tokens_a)
        del eng
        torch.cuda.empty_cache()


def _beam_serving(np, torch, model):
    """Part (3): beam search on GPT-1.3B (B=2, beam 4, 128-token prompts,
    32 new tokens), bf16 and W8A8, timed after a warm-up call."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models import build_beam_search_fn

    rng = np.random.RandomState(4)
    ids = rng.randint(0, model.cfg.vocab_size, (2, 128))
    for label, int8 in (("bf16", False), ("int8", True)):
        fn = build_beam_search_fn(model, 32, beam_size=4, int8=int8)
        fn(ids)                                                # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(ids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: n for name, n in KERNELS.items() if n}
        want = {"w8a8_gemm": 4 * model.cfg.num_layers * 32} if int8 else {}
        if launches != want:
            raise AssertionError(f"beam search ({label}) launched "
                                 f"{launches}, expected {want}")
        new = out[:, 128:].cpu().numpy()
        if new.shape != (2, 32) or not ((0 <= new) & (new < model.cfg.
                                                      vocab_size)).all():
            raise AssertionError(f"beam search ({label}): bad output")
        log(f"beam search ({label}), B=2, beam 4, 128-token prompts, 32 new "
            f"tokens: {1e3 * wall:.1f} ms, {1e3 * wall / 32:.3f} ms per "
            f"generated position, {1e3 * wall / 64:.3f} ms per output token; "
            f"launches {json.dumps(launches)}")


HEAD_SHAPES = ((8, 2048, 50304), (1024, 2048, 50304))
RAGGED_SHAPES = ((8, 96, 50257), (1024, 96, 50257), (8, 1600, 50257),
                 (1024, 1600, 50257))


def _head_gemm(np, torch):
    """Part (4): ``w8a8_gemm`` as GPT-1.3B's tied int8 head (N=50304,
    K=2048) at M=8 and M=1024, bit-exact against its plain version and
    timed by CUDA-graph replay beside ``torch._int_mm`` on the
    pre-quantized operands, with its bound; then the ragged shapes the
    wrapper pads (N=50257, K=96 and 1600), bit-exact."""
    from paddle_tpu_torch.kernels import w8a8_gemm, w8a8_gemm_plain
    from paddle_tpu_torch.kernels.int8_gemm import gemm_plan
    from paddle_tpu_torch.ops import quantize_per_channel

    g = torch.Generator(device="cuda").manual_seed(9)
    rows = {}
    for m, k, n in HEAD_SHAPES + RAGGED_SHAPES:
        w = torch.randn(n, k, device="cuda", generator=g) * 0.02
        wq, ws = quantize_per_channel(w.bfloat16().float(), axis=0)
        wq = wq.contiguous()
        x = torch.randn(m, k, device="cuda", generator=g).bfloat16()
        got = w8a8_gemm(x, wq, ws, return_quantized=True)
        want = w8a8_gemm_plain(x, wq, ws, return_quantized=True)
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"w8a8_gemm M={m} K={k} N={n} (plan of the padded shape: "
            f"{gemm_plan(m, -(-n // 16) * 16, -(-k // 64) * 64).path}): "
            f"bit-exact {exact}")
        if not exact:
            raise AssertionError(f"w8a8_gemm M={m} K={k} N={n} is not exact")
        if (m, k, n) not in HEAD_SHAPES:
            continue
        xq_pad = torch.zeros(max(m, 32), k, dtype=torch.int8, device="cuda")
        xq_pad[:m] = got[1]
        kern = lambda: w8a8_gemm(x, wq, ws)                    # noqa: E731
        lib = lambda: torch._int_mm(xq_pad, wq.t())            # noqa: E731
        ms = (graph_ms(kern, iters=10) + graph_ms(kern, iters=10)) / 2
        lib_ms = (graph_ms(lib, iters=10) + graph_ms(lib, iters=10)) / 2
        plain_ms = time_ms(lambda: w8a8_gemm_plain(x, wq, ws), 3, 1)
        nbytes = m * k * 2 + n * k + n * 4 + m * n * 2
        bms, by = bound_ms(nbytes, 2 * m * n * k, INT8_OPS)
        rows[m] = dict(ms=ms, library_ms=lib_ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by)
        log(f"  int8 head M={m}: kernel {ms:.4f} ms (graph replay), "
            f"_int_mm {lib_ms:.4f} ms (M padded to {max(m, 32)}), plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{2 * m * n * k / ms / 1e9:.1f} TOP/s")
    log(f"int8 head: {json.dumps(rows)}")


def _int8_head_forward(np, torch, model):
    """GPT-1.3B's eager forward with ``int8`` and ``int8_lm_head`` (the
    bf16 model's weights, its config switched): the four projections of
    each block and the tied head launch ``w8a8_gemm``, attention the flash
    forward; finite logits of the vocabulary's width."""
    import dataclasses

    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, int8=True, int8_lm_head=True)
    ids = np.random.RandomState(6).randint(0, cfg.vocab_size, (2, 128))
    try:
        with torch.no_grad():
            model(ids)                                       # warm-up
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            logits = model(ids)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        model.cfg = cfg
    launches = {name: n for name, n in KERNELS.items() if n}
    want = {"w8a8_gemm": 4 * cfg.num_layers + 1,
            "flash_fwd": cfg.num_layers}
    if launches != want:
        raise AssertionError(f"int8-head forward launched {launches}, "
                             f"expected {want}")
    if logits.shape != (2, 128, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError("int8-head forward: bad logits")
    log(f"int8-head forward of GPT-1.3B (B=2, S=128, W8A8 blocks and head): "
        f"{1e3 * wall:.1f} ms; launches {json.dumps(launches)}")


def phase_frontend(np, torch, tokens_a):
    """Phase 5b: part (1) the exact checks; (2) HTTP serving of GPT-1.3B;
    (3) beam search on GPT-1.3B; (4) the int8 head's GEMM; (5) training
    run (e), run (a) of phase 6 with dropout=0.1."""
    from paddle_tpu_torch.models import GPTForPretraining, gpt_1p3b

    _front_exact(np, torch)
    model = GPTForPretraining(gpt_1p3b(), seed=0)          # bf16 on the card
    _front_serving(np, torch, model, tokens_a)
    _beam_serving(np, torch, model)
    _int8_head_forward(np, torch, model)
    del model
    torch.cuda.empty_cache()
    _head_gemm(np, torch)
    # run (e): the materialised attention keeps ~0.98 GiB a layer for the
    # backward (fp32 softmax, bf16 dropped probabilities, the keep mask),
    # 23.6 GiB over 24 layers above run (a)'s 44 GiB: 72.1 GiB measured
    # without remat on an H100, past the ~70 GiB line, so remat=True
    _train(np, torch, "e", {"dropout": 0.1}, True, {})


# -- phase 6 -----------------------------------------------------------------

# the training flagship: vocab 50304, hidden 1536, 24 layers, 12 heads
# (D = 128), seq 1024, batch 12, bf16 parameters with fp32 AdamW masters,
# remat off, CE chunks of 2048 rows
TRAIN_CFG = dict(vocab_size=50304, hidden_size=1536, num_layers=24,
                 num_heads=12, max_seq_len=1024)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 12, 1024, 5
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# label, config overrides, remat, kernels that launch (per step: 24 of
# each flash kernel, the forward twice under remat, and 4 x 24 w8a8_gemm
# per forward with int8)
TRAIN_RUNS = (
    ("a", {}, False, {"flash_fwd": 24, "flash_bwd_dq": 24,
                      "flash_bwd_dkv": 24}),
    ("b", {"seq_major": True}, False,
     {"flash_fwd": 24, "flash_bwd_dq": 24, "flash_bwd_dkv": 24}),
    ("c", {"seq_major": True, "num_kv_heads": 4, "attn_window": 256}, True,
     {"flash_fwd": 48, "flash_bwd_dq": 24, "flash_bwd_dkv": 24}),
    ("d", {"int8": True}, False,
     {"flash_fwd": 24, "flash_bwd_dq": 24, "flash_bwd_dkv": 24,
      "w8a8_gemm": 96}),
)


def _flops_per_token(cfg, seq):
    """Training flops per token: 6 N over the blocks' 12 h^2 weights per
    layer, the attention term and the LM head (the repo's bench count)."""
    h, n_layers, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    return (6.0 * n_layers * 12 * h * h + 12.0 * n_layers * h * seq
            + 6.0 * v * h)


# a leaf's update on the card against the CPU's, fp32 (see update_ratios)
UPDATE_RTOL = 2e-3


def update_ratios(torch, cfg, names, got, want, init):
    """Per leaf, ||(got - init) - (want - init)|| / ||want - init||, logged
    with the share of elements more than 1e-6 apart.  The key part of the
    QKV bias is left out: it adds q.b_k to a whole row of scores, which
    the softmax cancels, so its gradient is zero but for rounding, and
    AdamW steps each side by ~lr on its own noise there."""
    ratios = {}
    for name, a, b, a0 in zip(names, got, want, init):
        if name.endswith("qkv_b"):
            keep = torch.ones(a.numel(), dtype=torch.bool)
            keep[cfg.hidden_size:
                 cfg.hidden_size + cfg.num_kv_heads * cfg.head_dim] = False
            a, b, a0 = a[keep], b[keep], a0[keep]
        ratios[name] = ((a - b).norm() / (b - a0).norm()).item()
        share = ((a - b).abs() > 1e-6).float().mean().item()
        log(f"  update {name}: ratio {ratios[name]:.3e}, share of elements "
            f"more than 1e-6 apart {share:.3e}")
    worst = max(ratios, key=ratios.get)
    log(f"  worst update ratio {ratios[worst]:.3e} on {worst}")
    return ratios


def _train_parity(np, torch):
    """The train step in fp32 on the card (flash kernels, fp32 products,
    no TF32) against the same step on the CPU (plain attention) from the
    same weights and batch: flagship width, 2 layers, batch 1, seq 512, 2
    steps.  Losses agree to 1e-4 relative, and each leaf's update to
    UPDATE_RTOL: ||card update - CPU update|| / ||CPU update|| (see
    :func:`update_ratios`)."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.models.gpt import build_functional_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**{**TRAIN_CFG, "num_layers": 2})
    cpu = GPTForPretraining(cfg, device="cpu", dtype=torch.float32, seed=3)
    card = GPTForPretraining(cfg, device="cuda", dtype=torch.float32, seed=3)
    card.load_state_dict(cpu.state_dict())
    names = {p.data_ptr(): n for n, p in cpu.named_parameters()}
    names = [names[p.data_ptr()] for p in cpu.leaves()]
    init = [p.detach().clone() for p in cpu.leaves()]
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (1, 512)).astype("int32")
    labels = rng.randint(0, cfg.vocab_size, (1, 512)).astype("int64")
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        step, params, opt = build_functional_train_step(
            model, lr=1e-4, remat=False, ce_chunk_rows=2048)
        t0 = time.perf_counter()
        losses = []
        for _ in range(2):
            params, opt, loss = step(params, opt, ids, labels)
            losses.append(float(loss))
        runs[name] = (losses, [p.cpu() for p in params])
        log(f"train parity: {name} losses {losses} "
            f"({time.perf_counter() - t0:.2f} s)")
    (lc, pc), (lh, ph) = runs["card"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    ratios = update_ratios(torch, cfg, names, pc, ph, init)
    log(f"train parity: card vs cpu, loss rel err {rel:.3e} (tol 1e-4), "
        f"worst update ratio {max(ratios.values()):.3e} (tol {UPDATE_RTOL:g})")
    if not (rel <= 1e-4 and max(ratios.values()) <= UPDATE_RTOL):
        raise AssertionError("the train step on the card disagrees with the "
                             "CPU")


def _train(np, torch, label, over, remat, per_step):
    """One training run at full width: 1 warm-up and 4 timed steps on one
    seeded batch; returns the kernels' launch counts."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.models.gpt import build_functional_train_step

    cfg = GPTConfig(**TRAIN_CFG, **over)
    torch.cuda.reset_peak_memory_stats()
    model = GPTForPretraining(cfg, seed=0)                # bf16 on the card
    step, params, opt = build_functional_train_step(
        model, lr=1e-4, remat=remat, ce_chunk_rows=2048)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    labels = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    ids = torch.as_tensor(ids.astype("int32"), device=model.device)
    labels = torch.as_tensor(labels.astype("int64"), device=model.device)

    reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, ids, labels)
        losses.append(float(loss))                      # synchronises
        times.append(time.perf_counter() - t0)
    launches = {name: n for name, n in KERNELS.items() if n}
    want = {name: n * TRAIN_STEPS for name, n in per_step.items()}
    if launches != want:
        raise AssertionError(f"training ({label}) launched {launches}, "
                             f"expected {want}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"training ({label}): losses {losses}")
    step_s = float(np.mean(times[1:]))
    tps = TRAIN_BATCH * TRAIN_SEQ / step_s
    mfu = tps * _flops_per_token(cfg, TRAIN_SEQ) / BF16_FLOPS
    log(f"training ({label}) {json.dumps(over)} remat={remat}: losses "
        f"{[round(x, 4) for x in losses]}; step {1e3 * step_s:.1f} ms "
        f"(timed steps {[round(1e3 * t, 1) for t in times[1:]]}, warm-up "
        f"{1e3 * times[0]:.1f} ms), {tps:.0f} tokens/s, MFU {100 * mfu:.2f}% "
        f"of 989 TFLOP/s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  launches: {json.dumps(launches)}")
    _profile(torch, "one more step",
             lambda: step(params, opt, ids, labels))
    del model, step, params, opt
    torch.cuda.empty_cache()
    return launches


def phase_training(np, torch):
    """The slice parity check, then training runs (a)-(d); returns each
    kernel's launch count on the first run that reaches it, and that
    run's label."""
    _train_parity(np, torch)
    first = {}
    for label, over, remat, per_step in TRAIN_RUNS:
        t0 = time.perf_counter()
        for name, n in _train(np, torch, label, over, remat,
                              per_step).items():
            first.setdefault(name, (n, label))
        log(f"  run ({label}) took {time.perf_counter() - t0:.2f} s")
    return first


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    clock = time.perf_counter()

    def done(phase):
        nonlocal clock
        now = time.perf_counter()
        log(f"phase {phase}: {now - clock:.2f} s")
        clock = now

    card = phase_build()
    done("1 build")
    kernels = phase_paged(np, torch)
    kernels.update(phase_gemm(np, torch))
    kernels.update(phase_flash(np, torch))
    done("2 kernels")
    first = phase_serving(np, torch)
    done("3 serving")
    phase_parity(np, torch)
    done("4 parity")
    cluster, tokens_a = phase_cluster(np, torch)
    done("5 cluster")
    phase_frontend(np, torch, tokens_a)
    done("5b front end and decoding")
    trained = phase_training(np, torch)
    done("6 training")
    line = []
    for name, k in kernels.items():
        src = name.split("_int")[0]
        entry = {"paged_attention": 213, "paged_attention_mq": 372}
        replaces = {"paged_prefill": "paddle_tpu/kernels/paged_prefill.py:166",
                    "w8a8_gemm": "paddle_tpu/kernels/int8_gemm.py:85",
                    "flash_fwd": "paddle_tpu/kernels/flash.py:74",
                    "flash_bwd_dq": "paddle_tpu/kernels/flash.py:177",
                    "flash_bwd_dkv": "paddle_tpu/kernels/flash.py:224"}.get(
            src, f"paddle_tpu/kernels/paged_attention.py:{entry.get(src)}")
        if name in FLASH:
            n, run = trained[name]
            src = "flash_fwd" if name == "flash_fwd" else "flash_bwd"
            log(f"{name}: {n} launches on training run ({run})")
        else:
            n, run = first[name]
            log(f"{name}: {n} launches on serving run ({run})")
        entry = {"name": name, "route": "cuda",
                 "source": f"paddle_tpu_torch/csrc/{src}.cu",
                 "replaces": replaces, "launches": n,
                 "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                 "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                 "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        more = {run: c[name] for run, c in cluster.items() if name in c}
        if more:
            # its launches in phase 5's runs (g) and (h)
            entry["launches_in"] = more
            log(f"{name}: {json.dumps(more)} launches in cluster runs")
        line.append(entry)
    log(card)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

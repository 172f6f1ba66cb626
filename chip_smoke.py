#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; each prints
its seconds):

1. build: compile every CUDA source of the port (one ``nvcc`` each, all at
   once) and print the build seconds, each kernel's registers and spills
   as ``ptxas`` reports them (the fp32 flash forward's instances
   ``flash_fwd_fp32<FwdTile32<DP, ...>>`` one per padded head dim), the
   flash backward's dynamic shared memory by dtype and head dim, and the
   card's name and power limit;
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
     window=256 case, a ragged S=520, phase 9's attention (the same
     shape in bnsd, head views of the fused QKV transposed as the paddle
     GPT hands them over, in fp32 and in bf16) and the bench's
     long_seq_4k point (B=2, S=4096); out, lse, dQ, dK and dV each on
     its own (the backward kernels from the plain forward's out and
     lse), elementwise within ``atol * rms + rtol * |plain|`` with the
     rms of the plain row (``FLASH_TOL``); then each kernel timed beside SDPA at the flagship
     shape, at S=4096, at the flagship shape with D=64, at the fp32
     case (its bounds at the kernels' arithmetic, three TF32 products an
     operation at 495 TFLOP/s, and logged beside it at 67 TFLOP/s of fp32
     FMAs) and at phase 9's two bnsd cases (rows of the kernels line);
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
   variants must have launched.  (a)-(d) are then profiled over 4 more
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
   ``w8a8_gemm`` per step in (d)), and profiles one more step; every run
   logs the memory still allocated when it begins and after it is freed
   (garbage collected first: a remat step's closures sit in reference
   cycles), so a peak is the run's own;
7. distributed: (1) a one-rank NCCL group on 127.0.0.1 through
   ``init_parallel_env()`` (NCCL, the card's default) and ``fleet.init``
   with every degree 1; the training flagship's width at 2 layers (batch
   12, seq 1024, bf16) trained 3 steps through the distributed step (the
   mesh installed, ``dp_axis="dp"``, ZeRO stage 0) and through the plain
   step from the same weights: losses and parameters bit for bit, flash
   launches asserted, each step's ms logged; tensor-parallel greedy
   decode at mp=1 equal to ``generate``.  (2) Row-parallel W8A8's int32
   partial sums through ``w8a8_gemm`` exact at M=8 and 12288.  (3) Ring
   flash from shards held in one process (ring 4, B=2, H=12, D=128;
   S=2048 bf16 causal and full, S=1024 fp32 causal): forward (out, lse)
   and backward (dQ, dK, dV) against the plain flash versions on the
   whole sequence from the same inputs with phase 2's ``FLASH_TOL``,
   launches asserted (10 of each kernel causal, 16 full); the bf16 ring
   and the bf16 whole-sequence kernels each against attention computed
   in fp32 from fp32 inputs (logged: is the ring's error within the
   whole-sequence kernels'?); then ring 4 forward + backward at S=8192
   timed against the whole-sequence flash kernels (CUDA events).
   ``--phase 7`` builds and runs this phase alone (no result line).
   Multi-rank parity runs on the CPU over gloo
   (``tests/test_torch_{collective,tp,zero,pp,tp_decode,ring}.py``):
   NCCL does not put two ranks on one card;
8. eager BERT, the paddle-shaped API (``paddle_tpu_torch.to_tensor``,
   ``nn``, ``loss.backward()``, ``optimizer``, ``amp``) driving
   ``examples/pretrain_bert.py``'s loop: (1) the CPU tests' small BERT
   (vocab 256, hidden 32, 2 layers, 2 heads, batch 2, seq 16, 4 masked)
   3 steps on the card and on the CPU from the same weights, losses
   within FLASH_TOL's fp32 1e-5; (2) the flash kernels at BERT-base's
   attention (B=32, H=12, S=512, D=64, bnsd, not causal) in fp32 and
   bf16, held to their plain versions and timed beside them and SDPA,
   and the fp32 forward, dQ and dK/dV again at two peaked softmaxes (q
   scaled so that the logits' std is 2.4 or 8): timed, with the share of
   pairs that take dp in fp64 in the backward (p >= 1/16), and measured
   against the plain version and, with it and SDPA, against the forward
   and the backward in fp64 (logged: at such logits fp32 itself is
   further than FLASH_TOL from fp64);
   (3) BERT-base at ``bench.py``'s ``_bert_bench`` shape (vocab 30528,
   hidden 768, 12 layers, 12 heads, seq 512, batch 32, 76 masked) in
   fp32 and under ``amp.auto_cast()`` (bf16): 12 steps of the example's
   schedule, the first 1 warm-up and 4 timed (step ms, tokens/s, MFU
   over 989 TFLOP/s for both, ``max_memory_allocated``, the busy share
   of one profiled step, the ops traced a step and their host cost),
   with 12 launches of each flash kernel a step and a falling loss
   asserted.  ``--phase 8`` builds and runs this phase alone (no result
   line);
9. fleet on ``nn.Layer``: a one-rank NCCL group (``fleet.init``, every
   degree 1) and the paddle-shaped GPT-760M (``models/gpt_layers.py``;
   the training flagship at full width: vocab 50304, hidden 1536, 24
   layers, 12 heads, seq 1024, fp32 weights from seeded paddle
   initializers, batch 12), AdamW(weight_decay=0.01) with
   ``ClipGradByGlobalNorm(1.0)``, each run from the same weights (carried
   by ``weights.load_paddle_state_dict``): (1) the plain eager loop
   (``loss.backward()``, ``opt.step()``); (2) the same through
   ``fleet.distributed_model`` (``DataParallelSPMD``) and
   ``fleet.distributed_optimizer`` (``HybridParallelOptimizer``): losses
   and parameters bit for bit run (1)'s; (3) ``PipelineParallel`` over
   ``GPTForPretrainingPipe(cfg, num_stages=1)``, 4 microbatches of 3:
   losses within rtol 2e-4 / atol 2e-4 of run (1)'s (the reference's
   bound for pipelined against single-device training), and the
   engine's cost over the plain step; (4) run (2) under
   ``amp.auto_cast()`` (bf16), its loss falling.  Each run takes 1
   warm-up and 3 timed steps (step ms, tokens/s, MFU over 989 TFLOP/s,
   ``max_memory_allocated``), asserts its flash launches (24 of each
   kernel a microbatch's forward and backward), and takes one more step
   under ``_OpClock`` (traced ops and their host cost) and one profiled
   (busy share, the flash kernels' share of device time).  (5) One
   ``GPTBlock`` at this width through ``fleet.utils.recompute``: its
   input's and parameters' gradients bit for bit the plain block's.
   ``--phase 9`` builds and runs this phase alone (no result line).
   Multi-rank pipelines, data parallelism, sharding and tensor
   parallelism on ``nn.Layer`` run on the CPU over gloo
   (``tests/test_torch_{pipeline,fleet,tp}.py``): NCCL does not put two
   ranks on one card;
10. data and the generic train step: (a) the DataLoader alone:
    ``FakeData`` at 224 x 224 x 3 (fp32, 1000 classes) through
    ``DataLoader(batch_size=256, num_workers=8, shuffle=True,
    drop_last=True, persistent_workers=True)`` with
    ``PADDLE_SHM_SLOT_MB`` set so that a batch fits a slot: batches/s
    after the first, the ring / queue counts (the queue's asserted 0),
    each batch's flag from the workers (``torch.cuda.is_initialized()``
    in the worker, from the collate function) asserted False, and no
    ``pt_dl_*`` segment left in ``/dev/shm`` once the loader is gone;
    (b) ResNet-50 through ``build_model_train_step`` at ``bench.py``'s
    ``_resnet50_bench`` configuration (NHWC, ``compute_dtype="bfloat16"``,
    momentum, lr 0.1, weight decay 1e-4, batch 256 at 224 px) fed by
    (a)'s loader: 3 warm-up and 10 timed steps on the host clock around
    synchronised steps (images/s, MFU: images/s x 6 x 4,089,184,256 MACs
    over 989 TFLOP/s, ``max_memory_allocated``), then the same step on
    one resident batch (the gap is the loader's cost to the card), and
    one profiled step (busy share, top device time); the loss finite;
    (c) BERT-base through ``build_model_train_step`` at
    ``_bert_bench``'s configuration (vocab 30528, hidden 768, 12 layers,
    seq 512, batch 32, 76 masked, AdamW lr 1e-4, weight decay 0.01,
    bf16) on resident seeded arrays: step ms, tokens/s, MFU, peak memory,
    busy share, and 12 launches of each flash kernel a step asserted;
    (d) ``resnet18(num_classes=10)`` at 32 px, batch 4, fp32, TF32 off,
    lr 1e-3: 3 steps of the generic step on the card and on the CPU, each
    step from the CPU's state (a free run multiplies the rounding
    differences about tenfold a step through the last stage's BatchNorm
    over 4 samples): losses within 1e-5 relative, each parameter's
    update within ``UPDATE_RTOL`` (``update_ratios``) and each BatchNorm
    buffer within 1e-4 relative.  ``--phase 10`` builds and runs this
    phase alone (no result line);
11. the transformer encoders: (1) the flash forward, dQ and dK/dV with
    an additive score bias against their plain versions with the same
    bias at FLASH_TOL (D=64, bnsd head views of one fused QKV tensor):
    ``vit_s197`` (B=4 H=12 S=197, no mask, bf16 and fp32),
    ``ernie_padmask`` (B=4 H=12 S=512, a [B, 1, 1, S] float mask of 0 /
    -1e4 with 0-256 padded keys a row, bf16 and fp32) and
    ``decoder_mask`` (an [S, S] boolean mask at S=256, bf16) and
    ``gqa_full`` (bsnd, H=12 over Hkv=4, a random float [B, H, S, S]
    mask at S=256, bf16 and fp32); then the bf16 kernels at ViT-base's attention
    (B=128 H=12 S=197) and ERNIE-3.0-base's (B=32 H=12 S=512, the pad
    mask), held to their plain versions at FLASH_TOL there and timed by
    CUDA events beside the plain versions, SDPA with the same float
    ``attn_mask``
    and the bound (rows ``flash_*_vit_bf16``, ``flash_*_ernie_bf16`` of
    the kernels line); (2) through ``build_model_train_step`` (AdamW,
    bf16 compute, fp32 masters, random seeded weights, STEP_WARM +
    STEP_TIMED steps on a resident batch, one profiled): (a) ViT-base/16
    at 224 px, 1000 classes, batch 128 (images/s, MFU by
    ``vit_flops_per_image``), (b) ERNIE-3.0-base (vocab 40000, task
    types, seq 512, batch 32, 76 masked; each row's real length drawn
    from 256-512, pad id 0 after it), with step ms, MFU, peak memory,
    busy share and 12 launches of each flash kernel a step asserted (for
    (b) every one carrying the pad mask's bias); (c) vit_tiny and
    ernie_3_0_micro through the generic step on the card and the CPU,
    fp32, as (d) of phase 10; (d) ``pretrain_bert.py --model ernie`` at
    a small size, 3 steps card vs CPU in fp32 (1e-5) and under bf16
    ``auto_cast`` (2e-2).  ``--phase 11`` builds and runs this phase
    alone (no result line);
12. the encoder-decoder and the rec models: (a) the flash forward, dQ
    and dK/dV with q and k of other lengths against their plain versions
    at FLASH_TOL, bf16 and fp32 (``CROSS_CASES``: Transformer-base's
    cross-attention B=96 H=8 Sq=200 Sk=256 with the source padding's
    bias, a causal chunk Sq=64 over Sk=256, a decode step Sq=1, GQA in
    bsnd, the decoder's -inf mask, Sq > Sk not causal), ``sdpa``
    refusing causal Sq > Sk, and the cross-attention, causal-chunk
    (bf16) and decode-step (fp32, forward) shapes timed beside the plain
    versions, SDPA with a float ``attn_mask`` and the bound (rows
    ``flash_*_cross_bf16``, ``flash_*_causal_offset_bf16``,
    ``flash_fwd_decode_fp32``); (b) Transformer-base (d 512, 8 heads,
    6 + 6 layers, FFN 2048, 37000 tied tokens, dropout 0.1) built from
    the API's layers, through ``build_model_train_step`` (AdamW, bf16)
    at batch 96 of 256 source and 200 target tokens with pad tails:
    step ms, tokens/s, MFU, peak memory, busy share, and 18 launches of
    each flash kernel a step asserted, all biased, 6 of them
    cross-attention; (c) its greedy decode of 32 tokens through
    ``TransformerDecoder.gen_cache`` (fp32, ``no_grad``): ms a token and
    12 launches a token asserted; (d) a small Transformer (2 + 2 layers,
    d 64) through the generic step card vs CPU (3 fp32 steps, losses
    within 1e-5) and its greedy decode card vs CPU (tokens equal, logits
    within 1e-5); (e) DeepFM and wide&deep at 26 fields x 1,000,000 rows
    (442.5M parameters, dense gradients), batch 4096, eagerly (Adam) and
    through the generic step (AdamW without decay): step ms,
    examples/s, peak memory, busy share; (f) a small DeepFM card vs CPU,
    10 Adam steps (losses within 1e-5) and its held-out AUC (within
    1e-4).  ``--phase 12`` builds and runs this phase alone (no result
    line).
13. graph mode (``phase_static``; ``--phase 13`` alone);
14. jit and deployment (``phase_jit``; ``--phase 14`` builds and runs it
    alone, no result line): (a) BERT-base (BERT_STEP's widths, seeded
    weights, eval) through ``jit.to_static`` with ``[None, 512]`` int64
    input specs at B=32 x 512 in fp32, against its eager forward at
    FLASH_TOL fp32 (and whether bit for bit), 12 ``flash_fwd`` launches a
    call and no backward launch asserted, then ``jit.save`` / ``jit.load``
    (the loaded layer bit for bit); (b) ``paddle.inference``'s Predictor
    over that saved model in fp32 (bit for bit (a)), under
    ``enable_bf16()`` and under ``enable_int8()`` (4 L + 1
    ``quantized_matmul`` ops and as many ``w8a8_gemm_prequant`` launches a
    run), each with ms a batch, sequences/s, peak memory, busy share, ops
    a run and host us an op, the bf16 and int8 errors against fp32, and
    the int8 Predictor at B=2 against the CPU's (their relative norm
    distance within twice the CPU's own int8-vs-fp32 distance); (c) the
    pre-quantized GEMM at BERT-base's four projections (M = 16384): the
    int32 sums and the output bit for bit against the plain version,
    timed beside ``torch._int_mm`` and the bound (row
    ``w8a8_gemm_prequant``, the layer summed); (d) int8 GPT-1.3B (the
    paddle layers at ``gpt_1p3b(int8=True, int8_lm_head=True)``, fp32)
    through ``to_static`` at B=4 x 1024: 97 ``w8a8_matmul`` ops and no
    one-off op, 97 ``w8a8_gemm`` and 24 ``flash_fwd`` launches a forward,
    the logits bit for bit the eager forward's, ms a forward and
    tokens/s; (e) dy2static's tensor if / while / for / break cases on
    the card against the CPU, ``infer_int8.py --device gpu`` and
    ``fluid_word2vec.py --device gpu --steps 60`` (its losses within 1e-4
    relative of the CPU's from the same weights).
15. the rest of the eager API (``phase_eager_rest``; ``--phase 15``
    alone);
16. process-level distributed training (``phase_dist_training``;
    ``--phase 16`` builds and runs it alone, no result line; see the
    comment above ``P16_GPT``): GPT-1.3B through the port's launcher
    and ``examples/train_gpt.py`` ((a) bf16, (b) ``--int8 --seq-major``),
    the sharded checkpoint bit for bit (c), a static program of the
    ``c_*`` ops against the program without them (d), and
    ``examples/train_multiprocess_dp.py`` through the launcher (e); the
    1.3B attention's flash rows ``flash_*_gpt1p3b_bf16``, with (a)'s
    launches and (b)'s under ``launches_in``.
17. hapi and the rest of vision (``phase_hapi``; ``--phase 17`` builds
    and runs it alone, no result line; see the comment above ``HAPI``):
    the fp32 flash kernels at ViT-base's attention (B=32 H=12 S=197 D=64,
    bnsd, not causal) against their plain versions and timed (rows
    ``flash_*_vitfit_fp32``); (a) ViT-base/16 through ``paddle.Model`` in
    dygraph mode, fp32, on a ``DatasetFolder`` of seeded ``.npy`` images
    through ``vision.transforms``: the first forward card vs CPU (1e-4 of
    the logits' largest magnitude), ``fit`` with ``ModelCheckpoint``,
    ``LRScheduler`` and ``EarlyStopping`` (12 launches of each flash kernel
    a train batch and 12 forwards an eval batch asserted by a callback),
    ``evaluate``, ``predict``, ``save`` / ``load`` into a fresh Model whose
    predictions are bit for bit the first's; ms a batch, images/s, MFU,
    peak memory, the busy share of one profiled batch; (b) 3 train_batch
    calls through the static adapter from (a)'s initial weights against
    an eager Model's (losses within 1e-5, 12 launches of each kernel a
    batch in both); (c) the detection ops on the card against the port on
    the CPU at published shapes (YOLOv3's ``yolo_box`` heads and
    ``multiclass_nms``, ``roi_align`` on a C4 map, ``generate_proposals``,
    DCNv2 forward and backward): counts and indices equal, values within
    1e-5 of each output's largest magnitude, ms each; (d) ``paddle.flops``
    and ``paddle.summary`` of ViT-base/16 equal on both devices; (e) the
    tensor-parallel layers as a static program on a one-rank NCCL group,
    bit for bit the eager layers.
18. the rest of the breadth (``phase_breadth``; ``--phase 18`` builds and
    runs it alone, no result line; see the comment above ``ASP_BERT``):
    the bf16 flash kernels at BERT-base's attention against their plain
    versions and timed again (the rows ``flash_*_bert_bf16`` stand on this
    reading); (a) BERT-base (vocab 30522) at batch 32 x 512 under bf16
    ``auto_cast``, pruned by ``incubate.asp.prune_model(model, 2, 4)`` and
    stepped by ``GradientMergeOptimizer(asp.decorate(AdamW), k_steps=4)``
    with an ``ExponentialMovingAverage``: 8 micro-steps (2 updates) with
    12 launches of each flash kernel a micro-step asserted, 2:4 sparsity,
    density 0.5 and the masks' zeros held after each update, the EMA's
    apply / restore bit for bit, the pruned set equal to the CPU's; ms a
    micro-step and an update, tokens/s, MFU, peak memory, the busy share
    of a merge window and the update's device time by part; the narrow
    BERT (2 layers, width 128) in fp32 card vs CPU (losses and EMA
    shadows within 1e-5, masks bit for bit); (b) ResNet-50 fp32 (batch
    64 at 224 px) for 10 steps of ``LookAhead(Momentum)`` with
    ``ModelAverage``, then exported by ``paddle.onnx.export`` under the
    average: the numpy runner within 1e-4 of the card's logits, and the
    CPU's export of the same weights the same bytes; (c) the fused softmax
    masks at GPT-1.3B's causal scores (fp32, bf16) and ERNIE-3.0-base's
    padded ones, forward and backward card vs CPU at the flash
    tolerances; ``Categorical`` over [4096, 50304] (equal draws for one
    seed, pooled shares within 7 standard errors, ``log_prob`` /
    ``entropy`` / ``kl_divergence`` card vs CPU within 1e-5), ``Normal``
    and ``Uniform`` over [4096, 1024]; (d) ``utils.run_check()`` and a
    custom C++ ReLU (``cpp_extension.load``, g++) on a CUDA tensor, bit
    for bit ``F.relu``'s forward and gradient.
19. the reference's inputs on the card (``phase_sdpa_inputs``; ``--phase
    19`` builds and runs it alone, no result line): (b) ``sdpa`` on the
    card against ``sdpa_plain`` in fp32 for every input the card refused
    before this phase existed (fp16, trainable masks of three shapes,
    causal Sq > Sk, head dims 8 / 12 / 20 and a v head dim of its own,
    bnsd GQA, 2-D q) and head_dim 264 refused with nothing launched; the
    fp16 kernels at BERT-base's attention, dBias with a [B, 1, 1, S] and
    an [H, S, S] trainable bias and causal Sq = 256 over Sk = 200, held
    to their plain versions and timed beside SDPA (the rows
    ``flash_*_{bertbase,dbias_pad,dbias_hss,nokey}_fp16``); (c) dBias and
    causal Sq > Sk at ``CROSS_CASES``'s shapes and bnsd GQA in bf16, fp16
    and fp32 against the plain versions; (a) the small BERT card vs CPU
    in fp16 O1 with a GradScaler whose first step overflows (the scale
    sequences equal), then BERT-base at phase 8's shape in fp16 O1 with a
    dynamic GradScaler (6 steps: step ms, tokens/s, MFU over the fp16
    peak, peak memory, the busy share of one more step), O2 under
    ``amp.decorate(dtype="float16")`` (2 steps) and O1 with a trainable
    [H, S, S] attention bias (2 steps, ``flash_bwd_dq_dbias`` launched),
    each with the loss scale after every step and its launches asserted.

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
both by CUDA-graph replay) for the two backward kernels.  The flash
kernels have more rows each: at BERT-base's attention in fp32 and in
bf16 (``flash_fwd_bert_fp32`` ...), with their launches on phase 8's
runs (and, for bf16, under ``launches_in`` on phase 10's BERT-base step), and at GPT-760M's (phase 9's bnsd cases of phase 2) in fp32 and in
bf16 (``flash_fwd_gpt760m_fp32`` ...), with their launches on phase 9's
plain fp32 run and its bf16 run (and under ``launches_in`` on its other
fp32 runs), and at ViT-base's and ERNIE-3.0-base's attention in bf16
(``flash_fwd_vit_bf16`` ...), with their launches on phase 11's runs (a)
and (b) (and, for ERNIE, under ``launches_in`` on (c) and (d)), and at
phase 12's shapes, with their launches on its runs (b) and (c), and at
ViT-base's attention in fp32 (``flash_fwd_vitfit_fp32`` ...), with their
launches on phase 17 (a) (and under ``launches_in`` on (b)), the BERT-base
bf16 rows also carrying phase 18 (a)'s launches under ``launches_in``; their
bounds are at the peak of the arithmetic each uses:
bf16 tensor cores (989 TFLOP/s), the fp32 kernels' three TF32 products
an operation (495 / 3 TFLOP/s).
The last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
TF32_FLOPS = 495e12             # H100 SXM dense TF32 tensor-core peak
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
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
            entries = reports = 0
            for line in ptxas.read_text().splitlines():
                if "Compiling entry function" in line:
                    log(f"  {name}: {line.split(chr(39))[1]}")
                    entries += 1
                elif "registers" in line or "spill" in line:
                    log(f"    {line.strip()}")
                    reports += "registers" in line
            # nvcc --split-compile runs ptxas in threads: each entry must
            # still come with its own register report
            log(f"  {name}: {entries} entry functions, {reports} register "
                "reports")
            if entries != reports:
                raise AssertionError(f"ptxas -v of {name}.cu: {entries} "
                                     f"entries but {reports} reports")
    smem = _build.kernel("flash_bwd_smem")
    log("  flash_bwd dynamic shared memory, bytes by padded D (dQ, dK/dV): "
        + "; ".join(f"{dt} " + ", ".join(
            f"{d}: {smem(d, code, 0)}, {smem(d, code, 1)}"
            for d in (32, 64, 128, 256))
            for dt, code in (("fp32", 0), ("bf16", 1))))
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
# (c) and the bench's long_seq_4k point (bench.py), which is timed too;
# the two gpt760m_bnsd cases are phase 9's attention in fp32 (runs 1-3 and
# the recompute) and in bf16 (run 4, auto_cast), timed as kernels-line rows
FLASH_CASES = (
    ("flagship", "bsnd", 12, 12, 12, 1024, True, None, "bf16"),
    ("fp32", "bsnd", 2, 4, 4, 512, True, None, "fp32"),
    ("bsnd_gqa4", "bsnd", 4, 12, 4, 1024, True, None, "bf16"),
    ("sbnd_gqa4", "sbnd", 4, 12, 4, 1024, True, None, "bf16"),
    ("window256", "bsnd", 4, 12, 12, 1024, True, 256, "bf16"),
    ("ragged520", "bsnd", 2, 12, 12, 520, True, None, "bf16"),
    ("gpt760m_bnsd_fp32", "bnsd", 12, 12, 12, 1024, True, None, "fp32"),
    ("gpt760m_bnsd_bf16", "bnsd", 12, 12, 12, 1024, True, None, "bf16"),
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
# 0.85 (dq), 0.69 (dk) and 1.04 (dv) over these cases, hence 3e-2.
# fp16: the same roundings at fp16's 2^-11, 8 times finer: a quarter of
# bf16's bound.  dbias: fp32 sums of p (dp - delta) over the bias's
# broadcast dimensions, by atomics in any order on the card, pairwise in
# the plain version; the 16-bit kernels take dp - delta in fp32 (the fp32
# ones in fp64 where p is heavy, as for dQ), and where a row sees few keys
# it cancels to ~1e-5 of the tensor's rms: at atol 1e-3 a bf16 decoder
# mask's row used 1.5 of the bound on an H100, hence 1e-2.
FLASH_TOL = {
    "fp32": {"out": (1e-5, 1e-5), "lse": (1e-6, 1e-6), "dq": (1e-5, 1e-5),
             "dk": (1e-5, 1e-5), "dv": (1e-5, 1e-5), "dbias": (1e-4, 1e-4)},
    "bf16": {"out": (2e-2, 3e-2), "lse": (1e-6, 1e-6), "dq": (2e-2, 3e-2),
             "dk": (2e-2, 3e-2), "dv": (2e-2, 3e-2), "dbias": (1e-3, 1e-2)},
    "fp16": {"out": (5e-3, 8e-3), "lse": (1e-6, 1e-6), "dq": (5e-3, 8e-3),
             "dk": (5e-3, 8e-3), "dv": (5e-3, 8e-3), "dbias": (1e-3, 1e-2)},
}
DTYPES = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16"}


def _flash_close(label, got, want, rtol, atol):
    """Holds ``got`` to ``want`` elementwise within ``atol * rms +
    rtol * |want|`` (``rms`` of ``want``'s row, at least 1e-2 of the
    tensor's: a row that is zero, as the first query's dQ under a causal
    mask, is held to the summation noise around it); logs the max abs
    error, the tensor's rms and the worst share of the bound used, and
    returns the max abs error."""
    used, top, rms = _flash_share(got, want, rtol, atol)
    log(f"{label}: max_abs_err {top:.3e}, rms {rms:.3e}, worst {used:.3f} "
        f"of the bound (rtol {rtol:g}, atol {atol:g} * row rms)")
    if not used <= 1.0:
        raise AssertionError(f"{label} disagrees with its plain version")
    return top


def _flash_share(got, want, rtol, atol):
    """The worst share of :func:`_flash_close`'s bound that ``got`` uses
    against ``want``, the max abs error and ``want``'s rms."""
    g, w = got.float(), want.float()
    rms = w.square().mean().sqrt()
    row = w.square().mean(-1, keepdim=True).sqrt().clamp_min(1e-2 * rms)
    err = (g - w).abs()
    used = (err / (atol * row + rtol * w.abs())).max().item()
    return used, err.max().item(), rms.item()


def _qkv_views(torch, g, layout, b, h, hkv, s, d, dtype):
    """q, k, v as the model hands them to attention: head views of one
    fused projection output ([B, S, W] for bsnd and bnsd, [S, B, W] for
    sbnd); for bnsd each [B, S, H, D] view transposed to [B, H, S, D], as
    the paddle GPT (models/gpt_layers.py) transposes them."""
    lead = (s, b) if layout == "sbnd" else (b, s)
    qkv = torch.randn(*lead, (h + 2 * hkv) * d, device="cuda",
                      generator=g).to(dtype)
    q, k, v = torch.split(qkv, [h * d, hkv * d, hkv * d], dim=-1)
    views = (q.reshape(*lead, h, d), k.reshape(*lead, hkv, d),
             v.reshape(*lead, hkv, d))
    if layout == "bnsd":
        return tuple(t.transpose(1, 2) for t in views)
    return views


def phase_flash(np, torch):
    """The forward, dQ and dK/dV kernels against their plain versions in
    every case (the backward kernels take the plain forward's out and lse,
    so each kernel is held on its own), and timed at the flagship shape
    (the kernels line), at the long-sequence point and at the flagship
    shape with head dim 64 (logged), and at phase 9's two bnsd cases (their
    own rows of the kernels line, ``flash_fwd_gpt760m_fp32`` ...)."""
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    errs = {}           # case -> kernel -> max abs error
    for case in FLASH_CASES:
        errs[case[0]] = _flash_case(np, torch, case)
        if case[-1] == "bf16":
            worst = {name: max(worst[name], errs[case[0]][name])
                     for name in worst}
    torch.cuda.empty_cache()

    results = _time_flash(np, torch, FLASH_CASES[0], worst)
    _time_flash(np, torch, FLASH_CASES[-1], worst)
    _time_flash(np, torch, FLASH_CASES[0], worst, d=64)
    _time_flash(np, torch, FLASH_CASES[1], worst)
    for case in FLASH_CASES:
        if case[0].startswith("gpt760m_bnsd_"):
            rows = _time_flash(np, torch, case, errs[case[0]])
            results.update({f"{name}_gpt760m_{case[-1]}": row
                            for name, row in rows.items()})
    return results


def _flash_case(np, torch, case, d=128):
    """One case's forward, dQ and dK/dV against their plain versions (the
    backward kernels from the plain forward's out and lse); each kernel's
    max abs error."""
    from paddle_tpu_torch.kernels import flash_bwd_plain, flash_fwd_plain
    from paddle_tpu_torch.kernels.flash import flash_bwd, flash_fwd_cuda

    label, layout, b, h, hkv, s, causal, window, dt = case
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dt]
    g = torch.Generator(device="cuda").manual_seed(s + h + hkv)
    q, k, v = _qkv_views(torch, g, layout, b, h, hkv, s, d, dtype)
    scale = 1.0 / np.sqrt(d)
    out, lse = flash_fwd_cuda(q, k, v, causal, scale, window, layout)
    ref, rlse = flash_fwd_plain(q, k, v, causal, scale, window, layout)
    do = torch.randn(ref.shape, device="cuda", generator=g).to(dtype)
    got = flash_bwd(q, k, v, ref, rlse, do, causal, scale, window, layout)
    want = flash_bwd_plain(q, k, v, ref, rlse, do, causal, scale, window,
                           layout)
    torch.cuda.synchronize()
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for name, part, a, r in (("flash_fwd", "out", out, ref),
                             ("flash_fwd", "lse", lse, rlse),
                             ("flash_bwd_dq", "dq", got[0], want[0]),
                             ("flash_bwd_dkv", "dk", got[1], want[1]),
                             ("flash_bwd_dkv", "dv", got[2], want[2])):
        err = _flash_close(
            f"{name} {part} {label} ({layout}, B={b} H={h} Hkv={hkv} "
            f"S={s} D={d}, {dt}, window {window})", a, r,
            *FLASH_TOL[dt][part])
        errs[name] = max(errs[name], err)
    return errs


def _time_flash(np, torch, case, worst, d=128, timer=time_ms):
    """The three kernels (by ``timer``: CUDA events around eager calls,
    or ``graph_ms``), their plain versions and SDPA timed on one case's
    strided views at head dim ``d`` in the case's dtype; returns each
    kernel's entry of the kernels line."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_bwd_plain, flash_fwd_plain
    from paddle_tpu_torch.kernels.flash import (flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda, flash_delta,
                                                flash_fwd_cuda)

    label, layout, b, h, hkv, s, causal, window, dt = case
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dt]
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = _qkv_views(torch, g, layout, b, h, hkv, s, d, dtype)
    scale = 1.0 / np.sqrt(d)
    out, lse = flash_fwd_cuda(q, k, v, causal, scale, window, layout)
    do = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
    delta = flash_delta(out, do, layout)
    if layout == "bnsd":
        qh, kh, vh, doh = q, k, v, do                        # SDPA's view
    else:
        qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))
    lib = [x.detach().requires_grad_() for x in (qh, kh, vh)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*lib, is_causal=True)
        torch.autograd.grad(o, lib, doh)

    ms = {"flash_fwd": timer(lambda: flash_fwd_cuda(
              q, k, v, causal, scale, window, layout)),
          "flash_bwd_dq": timer(lambda: flash_bwd_dq_cuda(
              q, k, v, out, lse, delta, do, causal, scale, window, layout)),
          "flash_bwd_dkv": timer(lambda: flash_bwd_dkv_cuda(
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
    elems = b * s * h * d * q.element_size()     # bytes of one operand
    rows = b * h * s * (8 if dt == "fp32" else 4)  # delta (fp32: hi + lo)
    half = b * h * s * s * d / 2                 # causal: half the pairs
    work = {"flash_fwd": (4 * elems + b * h * s * 4, 4 * half),
            "flash_bwd_dq": (5 * elems + b * h * s * 4 + rows, 6 * half),
            "flash_bwd_dkv": (6 * elems + b * h * s * 4 + rows, 8 * half)}
    results = {}
    for name, (nbytes, ops) in work.items():
        bms, by, peak = _flash_bound(dt, nbytes, ops)
        fwd = name == "flash_fwd"
        results[name] = dict(ms=ms[name],
                             plain_ms=plain_fwd if fwd else plain_bwd,
                             bound_ms=bms, bound_by=by,
                             library_ms=lib_fwd if fwd else lib_bwd,
                             max_abs_err=worst[name])
        log(f"{name} timed case {label}: B={b} H={h} S={s} D={d} causal "
            f"{dt}, q/k/v head views of one QKV tensor: {ms[name]:.4f} ms "
            f"({'graph replay' if timer is graph_ms else 'CUDA events'}, "
            f"{ops / ms[name] / 1e9:.1f} TFLOP/s), plain "
            f"{results[name]['plain_ms']:.4f} ms (the whole "
            f"{'forward' if fwd else 'backward'}), sdpa by graph replay "
            f"{'forward' if fwd else 'fwd+bwd - fwd'} "
            f"{results[name]['library_ms']:.4f} ms, bound {bms:.4f} ms "
            f"({by}; {ops:.4g} flop at {peak}, {nbytes} bytes)")
    return results


def _flash_bound(dt, nbytes, ops):
    """A flash kernel's bound in ms at the peak of the arithmetic it uses:
    bf16 tensor cores, or for fp32 three TF32 products an operation
    (3xTF32); ``bound_ms``'s pair and the peak named (for fp32 with the
    bound at the card's fp32 FMAs beside)."""
    if dt in ("bf16", "fp16"):
        return (*bound_ms(nbytes, ops, BF16_FLOPS), f"989 TFLOP/s {dt}")
    return (*bound_ms(nbytes, ops, TF32_FLOPS / 3),
            f"495 / 3 TFLOP/s, 3xTF32; {ops / FP32_FLOPS * 1e3:.4f} ms at "
            "67 TFLOP/s of fp32 FMAs")


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
    ms = sum(t for name, t in by_name.items() if "flash_" in name)
    if ms:
        log(f"  flash kernels: {ms:.2f} ms ({100 * ms / max(busy, 1e-9):.1f}% "
            f"of device time)")
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
PROFILED_REQUESTS = 4           # the profiled window after runs (a)-(d)
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
        # 4 requests: the profiler's assembly of the quantized runs'
        # windows is most of phase 3's time, and grows with the window
        more = _requests(np, rng, cfg, shared, n=PROFILED_REQUESTS,
                         motif=motif)
        _profile(torch, f"{len(more)} more requests", lambda: eng.run(more))
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_serving(np, torch):
    """Every serving run; returns each kernel variant's launch count on the
    first run that reaches it, and that run's label."""
    from paddle_tpu_torch.models import GPTParams, gpt_1p3b

    t0 = time.perf_counter()
    model = GPTParams(gpt_1p3b(), seed=0)          # bf16 on the card
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

    from paddle_tpu_torch.models import GPTParams, gpt_1p3b

    # fp32 products in full fp32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = GPTParams(dataclasses.replace(gpt_1p3b(), num_layers=2),
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
    from paddle_tpu_torch.models import GPTParams, gpt_1p3b
    from paddle_tpu_torch.serving import (ServingEngine, make_cluster,
                                          restore_engine, snapshot_engine)

    _exact_checks(np, torch)
    model = GPTParams(gpt_1p3b(), seed=0)          # bf16 on the card
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
    from paddle_tpu_torch.models import (GPTParams,
                                         build_beam_search_fn, generate)

    ids = np.stack([prompts[0], prompts[2][:17]]).astype(np.int64)
    eos = int(generate(model, ids, 1)[0, -1])
    cpu = GPTParams(model.cfg, device="cpu", dtype=torch.float32)
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
    from paddle_tpu_torch.models import GPTConfig, GPTParams
    from paddle_tpu_torch.models.gpt import build_functional_train_step

    cfg = GPTConfig(**{**TRAIN_CFG, "num_layers": 2, "dropout": 0.1})
    cpu = GPTParams(cfg, device="cpu", dtype=torch.float32, seed=3)
    card = GPTParams(cfg, device="cuda", dtype=torch.float32, seed=3)
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
    from paddle_tpu_torch.models import GPTParams, gpt_1p3b

    _front_exact(np, torch)
    model = GPTParams(gpt_1p3b(), seed=0)          # bf16 on the card
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
    AdamW steps each side by ~lr on its own noise there; so is a key
    projection's bias (``k_proj.bias``) whole."""
    ratios = {}
    for name, a, b, a0 in zip(names, got, want, init):
        if name.endswith("k_proj.bias"):
            # a bias on the keys alone: the softmax cancels all of it
            log(f"  update {name}: left out (its gradient is rounding)")
            continue
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
    from paddle_tpu_torch.models import GPTConfig, GPTParams
    from paddle_tpu_torch.models.gpt import build_functional_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**{**TRAIN_CFG, "num_layers": 2})
    cpu = GPTParams(cfg, device="cpu", dtype=torch.float32, seed=3)
    card = GPTParams(cfg, device="cuda", dtype=torch.float32, seed=3)
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
    from paddle_tpu_torch.models import GPTConfig, GPTParams
    from paddle_tpu_torch.models.gpt import build_functional_train_step

    cfg = GPTConfig(**TRAIN_CFG, **over)
    carried = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    model = GPTParams(cfg, seed=0)                # bf16 on the card
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
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (after "
        f"reset_peak_memory_stats; {carried:.2f} GiB allocated before the "
        f"run began)")
    log(f"  launches: {json.dumps(launches)}")
    _profile(torch, "one more step",
             lambda: step(params, opt, ids, labels))
    del model, step, params, opt, loss
    _free(torch)
    log(f"  after run ({label}): {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB still allocated")
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


# -- phase 7 -----------------------------------------------------------------

# ring flash on the card from shards held in one process: label, B, H, S,
# causal, dtype (D = 128, ring 4)
RING = 4
RING_CASES = (("bf16_causal", 2, 12, 2048, True, "bf16"),
              ("bf16_full", 2, 12, 2048, False, "bf16"),
              ("fp32_causal", 2, 12, 1024, True, "fp32"))
RING_TIMED = (2, 12, 8192)            # B, H, S: causal bf16, ring 4
RING_STEPS = 3


def _one_rank_group(torch):
    """A one-rank NCCL group on 127.0.0.1 through ``init_parallel_env()``
    (the card's default backend) and ``fleet.init`` with every degree 1;
    returns the installed mesh."""
    from paddle_tpu_torch.distributed import fleet, init_parallel_env
    from paddle_tpu_torch.distributed.launch_utils import find_free_port
    from paddle_tpu_torch.distributed.mesh import get_mesh

    os.environ.update({"MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(find_free_port()), "RANK": "0",
                       "WORLD_SIZE": "1", "LOCAL_RANK": "0"})
    env = init_parallel_env(timeout=120)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=s)
    import torch.distributed as dist

    log(f"distributed: {dist.get_backend()} group of {dist.get_world_size()} "
        f"rank(s), rank {env.rank} on {env.device}, mesh "
        f"{get_mesh().shape}")
    return get_mesh()


def _dist_step_parity(np, torch, mesh):
    """The training flagship's width at 2 layers, bf16, through the
    distributed step (the mesh installed, dp_axis="dp", ZeRO stage 0) and
    the non-distributed step from the same weights: losses and parameters
    bit for bit over RING_STEPS steps, flash launches asserted, each
    step's ms logged.  Then tensor-parallel greedy decode at mp=1 against
    ``generate``, token for token."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models import GPTConfig, GPTParams, generate
    from paddle_tpu_torch.models.generation import build_generate_fn
    from paddle_tpu_torch.models.gpt import build_functional_train_step

    cfg = GPTConfig(**{**TRAIN_CFG, "num_layers": 2})
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    labels = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    ids = torch.as_tensor(ids.astype("int32"), device="cuda")
    labels = torch.as_tensor(labels.astype("int64"), device="cuda")
    runs = {}
    for name in ("plain", "distributed"):
        model = GPTParams(cfg, seed=0)
        if name == "plain":
            mesh_mod.set_mesh(None)
            step, params, opt = build_functional_train_step(
                model, lr=1e-4, remat=False, ce_chunk_rows=2048)
            mesh_mod.set_mesh(mesh)
        else:
            step, params, opt = build_functional_train_step(
                model, lr=1e-4, remat=False, ce_chunk_rows=2048,
                dp_axis="dp", sharding_stage=0)
        reset_launch_counts()
        losses, times = [], []
        for _ in range(RING_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, ids, labels)
            losses.append(float(loss))
            times.append(1e3 * (time.perf_counter() - t0))
        launches = {k: KERNELS[k] for k in FLASH}
        want = {k: cfg.num_layers * RING_STEPS for k in FLASH}
        if launches != want:
            raise AssertionError(f"{name} step launched {launches}, expected "
                                 f"{want}")
        runs[name] = (losses, [p.clone() for p in params])
        log(f"one-rank {name} step (2 layers, hidden {cfg.hidden_size}, batch "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}, bf16): losses {losses}, step ms "
            f"{[round(t, 3) for t in times]} (first includes warm-up), "
            f"launches {json.dumps(launches)}")
        del model, step, opt
    (lp, pp), (ld, pd) = runs["plain"], runs["distributed"]
    same = [torch.equal(a, b) for a, b in zip(pp, pd)]
    log(f"one-rank distributed vs plain step: losses equal {lp == ld}, "
        f"{sum(same)} of {len(same)} parameters bit-identical")
    if lp != ld or not all(same):
        raise AssertionError("the one-rank distributed step differs from the "
                             "plain step")
    del pp, pd
    model = GPTParams(GPTConfig(**{**TRAIN_CFG, "num_layers": 2,
                                           "use_parallel": True}), seed=0)
    model.eval()
    prompts = torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, 64)),
                              device="cuda")
    tp = build_generate_fn(model, 32)(prompts)
    plain = generate(model, prompts, 32)
    if not torch.equal(tp, plain):
        raise AssertionError("tensor-parallel decode at mp=1 differs from "
                             "generate")
    log(f"tensor-parallel greedy decode at mp=1: {tp.shape[0]} x 32 tokens "
        f"equal generate's (model.tp {model.tp})")
    del model
    torch.cuda.empty_cache()


def _ring_shards(torch, g, b, h, s, dtype):
    """q, k, v, dO (B, H, S, D=128) and their ring shards along S."""
    full = [torch.randn(b, h, s, 128, device="cuda", generator=g).to(dtype)
            for _ in range(4)]
    return full, [[x.contiguous() for x in t.chunk(RING, dim=2)]
                  for t in full]


def _ring_parity(np, torch):
    """Ring flash forward and backward from shards in one process against
    the plain flash versions on the whole sequence (the same inputs,
    computed in fp32), with phase 2's FLASH_TOL; each launch counted."""
    from paddle_tpu_torch.kernels import (KERNELS, flash_bwd_plain,
                                          flash_fwd_plain, reset_launch_counts)
    from paddle_tpu_torch.kernels import ring

    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    worst = {}
    for label, b, h, s, causal, dt in RING_CASES:
        g = torch.Generator(device="cuda").manual_seed(s + causal)
        (q, k, v, do), (qs, ks, vs, dos) = _ring_shards(torch, g, b, h, s,
                                                        dtypes[dt])
        reset_launch_counts()
        outs, lses = ring._local_ring_forward(qs, ks, vs, causal=causal)
        dqs, dks, dvs = ring._local_ring_backward(qs, ks, vs, outs, lses, dos,
                                                  causal=causal)
        torch.cuda.synchronize()
        blocks = RING * (RING + 1) // 2 if causal else RING * RING
        launches = {k: KERNELS[k] for k in FLASH}
        if launches != {k: blocks for k in FLASH}:
            raise AssertionError(f"ring {label} launched {launches}, "
                                 f"expected {blocks} of each")
        # the plain versions on the whole sequence from the same inputs
        # (computing in fp32 and rounding where the kernels round), as
        # phase 2 holds each kernel
        out, lse = flash_fwd_plain(q, k, v, causal)
        dq, dk, dv = flash_bwd_plain(q, k, v, out, lse, do, causal)
        got = {"out": torch.cat(outs, 2), "lse": torch.cat(lses, 2).reshape(
            b * h, s), "dq": torch.cat(dqs, 2), "dk": torch.cat(dks, 2),
            "dv": torch.cat(dvs, 2)}
        want = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        for part in got:
            err = _flash_close(f"ring flash {part} {label} (ring {RING}, B={b} "
                               f"H={h} S={s} D=128, {dt})", got[part],
                               want[part], *FLASH_TOL[dt][part])
            worst[part] = max(worst.get(part, 0.0), err)
        log(f"  ring {label}: {json.dumps(launches)} launches")
        del q, k, v, do, qs, ks, vs, dos, outs, lses, dqs, dks, dvs
        del out, lse, dq, dk, dv, got, want
        torch.cuda.empty_cache()
    return worst


def _ring_vs_fp32(np, torch):
    """The bf16 ring and the bf16 whole-sequence flash kernels, each held
    to the plain version computed in fp32 from the fp32 inputs (phase 7's
    ring shapes, causal and full): the error of each against the true
    attention, and whether the ring's is within the whole-sequence
    kernels'.  Logged, not gated: both carry bf16's rounding of out, P
    and dS, which FLASH_TOL's bf16 bounds (held against the plain version
    on the same bf16 rounding) do not cover."""
    from paddle_tpu_torch.kernels import flash_bwd_plain, flash_fwd_plain
    from paddle_tpu_torch.kernels import ring
    from paddle_tpu_torch.kernels.flash import flash_bwd, flash_fwd_cuda

    verdict = {}
    for label, b, h, s, causal, dt in RING_CASES:
        if dt != "bf16":
            continue
        g = torch.Generator(device="cuda").manual_seed(s + causal)
        (q, k, v, do), (qs, ks, vs, dos) = _ring_shards(torch, g, b, h, s,
                                                        torch.bfloat16)
        scale = 1.0 / np.sqrt(128)
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        out, lse = flash_fwd_plain(q32, k32, v32, causal)
        want = dict(zip(("dq", "dk", "dv"), flash_bwd_plain(
            q32, k32, v32, out, lse, do32, causal)), out=out)
        wo, wl = flash_fwd_cuda(q, k, v, causal, scale, None, "bnsd")
        whole = dict(zip(("dq", "dk", "dv"), flash_bwd(
            q, k, v, wo, wl, do, causal, scale, None, "bnsd")), out=wo)
        outs, lses = ring._local_ring_forward(qs, ks, vs, causal=causal)
        rq, rk, rv = ring._local_ring_backward(qs, ks, vs, outs, lses, dos,
                                               causal=causal)
        rng = {"out": torch.cat(outs, 2), "dq": torch.cat(rq, 2),
               "dk": torch.cat(rk, 2), "dv": torch.cat(rv, 2)}
        for part in ("out", "dq", "dk", "dv"):
            w = want[part]
            ew = (whole[part].float() - w).abs().max().item()
            er = (rng[part].float() - w).abs().max().item()
            rms = w.square().mean().sqrt().item()
            verdict[f"{label} {part}"] = er <= ew
            log(f"C.3 {label} {part} (B={b} H={h} S={s} D=128) against fp32 "
                f"attention: whole-sequence bf16 kernels max_abs_err "
                f"{ew:.3e}, ring {RING} {er:.3e} ({er / max(ew, 1e-30):.2f}x"
                f"), rms {rms:.3e}; ring within the whole-sequence "
                f"kernels' error: {er <= ew}")
        del q, k, v, do, qs, ks, vs, dos, q32, k32, v32, do32, out, lse
        del want, wo, wl, whole, outs, lses, rq, rk, rv, rng
        torch.cuda.empty_cache()
    log(f"C.3 ring within the whole-sequence kernels' error: "
        f"{sum(verdict.values())} of {len(verdict)} tensors")
    return verdict


def _ring_timing(np, torch, card):
    """Ring 4 forward + backward at S=8192 (shards in one process, every
    rank's blocks) against the whole-sequence flash kernels, CUDA
    events."""
    from paddle_tpu_torch.kernels import ring
    from paddle_tpu_torch.kernels.flash import flash_bwd, flash_fwd_cuda

    b, h, s = RING_TIMED
    g = torch.Generator(device="cuda").manual_seed(1)
    (q, k, v, do), (qs, ks, vs, dos) = _ring_shards(torch, g, b, h, s,
                                                    torch.bfloat16)
    scale = 1.0 / np.sqrt(128)

    def ring_fwd():
        return ring._local_ring_forward(qs, ks, vs, causal=True)

    outs, lses = ring_fwd()

    def ring_bwd():
        return ring._local_ring_backward(qs, ks, vs, outs, lses, dos,
                                         causal=True)

    out, lse = flash_fwd_cuda(q, k, v, True, scale, None, "bnsd")
    ms = {"ring fwd": time_ms(ring_fwd, iters=5, warmup=1),
          "ring bwd": time_ms(ring_bwd, iters=5, warmup=1),
          "whole fwd": time_ms(lambda: flash_fwd_cuda(
              q, k, v, True, scale, None, "bnsd"), iters=5, warmup=1),
          "whole bwd": time_ms(lambda: flash_bwd(
              q, k, v, out, lse, do, True, scale, None, "bnsd"), iters=5,
              warmup=1)}
    ring_ms = ms["ring fwd"] + ms["ring bwd"]
    whole_ms = ms["whole fwd"] + ms["whole bwd"]
    log(f"ring flash timing (B={b} H={h} S={s} D=128 causal bf16, ring "
        f"{RING}, every rank's shards in one process; {card}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + f"; ring fwd+bwd {ring_ms:.4f} ms vs whole-sequence flash "
        f"fwd+bwd {whole_ms:.4f} ms ({ring_ms / whole_ms:.3f}x)")
    del q, k, v, do, qs, ks, vs, dos, outs, lses, out, lse
    torch.cuda.empty_cache()
    return ms


def _int32_products(np, torch):
    """Row-parallel W8A8's int32 partial sums (mp > 1 on several cards)
    through the ``w8a8_gemm`` kernel, against the integer product: at a
    decode layer's fc2 split over mp=2 (M=8, K=4096, N=2048) and at
    training rows (M=12288, K=3072), exactly."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import (
        INT32_CHUNK, _kernel_products)
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    g = torch.Generator(device="cuda").manual_seed(2)
    for m, k, n in ((8, 4096, 2048), (12288, 3072, 1536)):
        xq = torch.randint(-127, 128, (m, k), device="cuda", generator=g,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), device="cuda", generator=g,
                           dtype=torch.int8)
        xq[0], wq[0] = 127, 127
        reset_launch_counts()
        got = _kernel_products(xq, wq)
        torch.cuda.synchronize()
        n_launch = KERNELS["w8a8_gemm"]
        want = (xq.double() @ wq.double().t()).to(torch.int32)
        exact = torch.equal(got, want)
        log(f"row-parallel int32 sums M={m} K={k} N={n}: {n_launch} "
            f"w8a8_gemm launches (K chunks of {INT32_CHUNK}), exact {exact}")
        if not exact or n_launch != -(-k // INT32_CHUNK):
            raise AssertionError("the int32 partial sums through w8a8_gemm "
                                 "are not the integer product")
        del xq, wq, got, want


def phase_distributed(np, torch, card):
    """Phase 7: a one-rank NCCL group through the distributed step and TP
    decode, then ring flash on the card from shards in one process."""
    import torch.distributed as dist

    mesh = _one_rank_group(torch)
    try:
        _dist_step_parity(np, torch, mesh)
    finally:
        from paddle_tpu_torch.distributed import mesh as mesh_mod

        mesh_mod.set_mesh(None)
        dist.destroy_process_group()
    _int32_products(np, torch)
    worst = _ring_parity(np, torch)
    log(f"ring flash worst max_abs_err per tensor: {json.dumps(worst)}")
    _ring_vs_fp32(np, torch)
    _ring_timing(np, torch, card)
    log(card)


# -- phase 8 -----------------------------------------------------------------

# the eager API's BERT: the CPU tests' small config, and BERT-base at the
# bench's shape (bench.py _bert_bench: vocab 30528, hidden 768, 12 layers,
# 12 heads, seq 512, batch 32, 76 masked tokens a sequence)
BERT_SMALL = ["--hidden", "32", "--layers", "2", "--heads", "2", "--vocab",
              "256", "--seq", "16", "--batch", "2", "--masked", "4"]
BERT_BASE = ["--hidden", "768", "--layers", "12", "--heads", "12", "--vocab",
             "30528", "--seq", "512", "--batch", "32", "--masked", "76"]
BERT_STEPS = 5                  # 1 warm-up and 4 timed
# the example's schedule over 12 steps (warm-up 5): the first 5 are timed;
# the loss must fall over the 12, as it does in the reference (a 12-layer
# post-LN BERT climbs over its first warm-up steps, in both packages)
BERT_TRAIN = 12


def bert_flops_per_token(h, n_layers, s, v, m_frac):
    """Training flops per token, bench.py's count: 6 x (per layer 12 h^2
    + 2 s h, plus the MLM head's h^2 + h v over the masked share)."""
    return 6.0 * (n_layers * (12.0 * h * h + 2.0 * s * h)
                  + m_frac * (h * h + h * v))


class _OpClock:
    """Counts the eager ops a step traces and the host time spent inside
    the tracer (dispatch, kernel enqueue, autograd recording), by wrapping
    ``tracer.trace_op``; the optimizer's update ops (``run_eager_kernel``)
    are counted apart."""

    def __init__(self):
        from paddle_tpu_torch.dygraph import tracer

        self.tracer = tracer
        self.ops = self.updates = 0
        self.seconds = 0.0

    def __enter__(self):
        tr = self.tracer
        self._trace, self._run = tr.trace_op, tr.run_eager_kernel

        def trace_op(*a, **k):
            t0 = time.perf_counter()
            try:
                return self._trace(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t0
                self.ops += 1

        def run_eager_kernel(*a, **k):
            self.updates += 1
            return self._run(*a, **k)

        tr.trace_op, tr.run_eager_kernel = trace_op, run_eager_kernel
        return self

    def __exit__(self, *exc):
        self.tracer.trace_op = self._trace
        self.tracer.run_eager_kernel = self._run
        return False


def _bert_run(np, torch, argv, steps, amp=False, device="gpu", state=None,
              profile=False):
    """The port's pretrain_bert example built and driven through the eager
    API on ``device``: ``steps`` steps of its loop; returns the model's
    initial state (numpy), the losses, the step seconds, the flash
    launches and, for a full run on the card, what one more step costs."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.examples import pretrain_bert as ex
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.weights import (load_paddle_state_dict,
                                          state_dict_to_numpy)

    paddle.set_device(device)
    args = ex.parse(argv + ["--steps", str(steps), "--device", device])
    old = unique_name.switch()
    try:
        cfg, model, crit, sched, opt = ex.build(args)
        if state is not None:
            load_paddle_state_dict(model, state)
        init = state_dict_to_numpy(model) if state is None else state
        batch = ex.make_batch(cfg, args.batch, args.seq, args.masked,
                              args.seed)
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, times = [], []
        for _ in range(steps):
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = ex.train_step(model, crit, opt, sched, batch, amp=amp)
            losses.append(float(loss.numpy()))          # synchronises
            times.append(time.perf_counter() - t0)
        launches = {k: KERNELS[k] for k in FLASH}
        extra = None
        if profile:
            peak = torch.cuda.max_memory_allocated() / 2**30
            with _OpClock() as clock:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ex.train_step(model, crit, opt, sched, batch, amp=amp)
                torch.cuda.synchronize()
                host = time.perf_counter() - t0
            busy = _profile(torch, "one more step", lambda: ex.train_step(
                model, crit, opt, sched, batch, amp=amp))
            extra = {"peak_gib": peak, "busy": busy, "ops": clock.ops,
                     "updates": clock.updates, "op_us": 1e6 * clock.seconds
                     / max(clock.ops, 1), "trace_s": clock.seconds,
                     "step_s": host, "cfg": cfg, "args": args}
        return init, losses, times, launches, extra
    finally:
        unique_name.switch(old)
        paddle.set_device("gpu")


def _free(torch):
    """Collect the garbage (autograd graphs and closures sit in reference
    cycles), then return the freed blocks to the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _bert_parity(np, torch):
    """(1) The small BERT (the CPU tests' config) for 3 steps of the
    example's loop on the card (the flash kernels) and on the CPU (their
    plain versions) from the same weights: losses within FLASH_TOL's fp32
    tolerance (1e-5 relative), and 2 layers' flash launches a step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init, cpu, _, _, _ = _bert_run(np, torch, BERT_SMALL, 3, device="cpu")
    _, card, _, launches, _ = _bert_run(np, torch, BERT_SMALL, 3,
                                        state=init)
    _free(torch)
    rtol = FLASH_TOL["fp32"]["out"][0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    log(f"eager BERT small, card vs cpu: losses card {card} cpu {cpu}, "
        f"rel err {rel:.3e} (tol {rtol:g}); launches {json.dumps(launches)}")
    if not rel <= rtol:
        raise AssertionError("the eager BERT step on the card disagrees with "
                             "the CPU")
    if launches != {k: 3 * 2 for k in FLASH}:
        raise AssertionError(f"small BERT launched {launches}")


def _bert_base(np, torch, amp, card):
    """(2) BERT-base at the bench's shape through the eager API, fp32 or
    under ``amp.auto_cast()`` (bf16): the example's loop for BERT_TRAIN
    steps, the first 1 warm-up and 4 timed; asserts 12 launches of each
    flash kernel a step and a finite loss that falls (the last three
    below the first);
    logs step ms, tokens/s, MFU, peak memory, the busy share of one
    profiled step, and the eager ops a step traces with their host cost.
    Returns the run's flash launches."""
    label = "bf16 auto_cast" if amp else "fp32"
    _, losses, times, launches, x = _bert_run(np, torch, BERT_BASE,
                                              BERT_TRAIN, amp=amp,
                                              profile=True)
    _free(torch)
    cfg, args = x["cfg"], x["args"]
    want = {k: 12 * BERT_TRAIN for k in FLASH}
    if launches != want:
        raise AssertionError(f"BERT-base ({label}) launched {launches}, "
                             f"expected {want}")
    if not (np.all(np.isfinite(losses))
            and max(losses[-3:]) < losses[0]):
        raise AssertionError(f"BERT-base ({label}): losses {losses}")
    times = times[:BERT_STEPS]
    step_s = float(np.mean(times[1:]))
    tokens = args.batch * args.seq
    fpt = bert_flops_per_token(cfg.hidden_size, cfg.num_layers, args.seq,
                               cfg.vocab_size, args.masked / args.seq)
    mfu = tokens / step_s * fpt / BF16_FLOPS
    log(f"eager BERT-base ({label}; B={args.batch} S={args.seq} "
        f"{args.masked} masked, {card}): losses "
        f"{[round(v, 4) for v in losses]}; step {1e3 * step_s:.1f} ms "
        f"(timed {[round(1e3 * t, 1) for t in times[1:]]}, warm-up "
        f"{1e3 * times[0]:.1f} ms), {tokens / step_s:.0f} tokens/s, MFU "
        f"{100 * mfu:.2f}% of the bf16 peak 989 TFLOP/s (the fp32 run too); "
        f"max_memory_allocated {x['peak_gib']:.2f} GiB; device busy "
        f"{100 * x['busy']:.1f}% of one profiled step; {x['ops']} traced ops "
        f"and {x['updates']} optimizer update ops a step, "
        f"{x['op_us']:.1f} us host per traced op ({1e3 * x['trace_s']:.1f} "
        f"ms of a {1e3 * x['step_s']:.1f} ms step inside the tracer); "
        f"launches {json.dumps(launches)}")
    return launches


def _time_flash_bert(np, torch, dt):
    """The three flash kernels at BERT-base's attention (B=32, H=12,
    S=512, D=64, bnsd, not causal) in ``dt``: held to their plain versions
    with FLASH_TOL, timed by CUDA events beside the plain versions and
    SDPA; returns their kernels-line entries."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_bwd_plain, flash_fwd_plain
    from paddle_tpu_torch.kernels.flash import (flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda, flash_delta,
                                                flash_fwd_cuda)

    b, h, s, d = 32, 12, 512, 64
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dt]
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=g).to(
        dtype) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    out, lse = flash_fwd_cuda(q, k, v, False, scale, None, "bnsd")
    ref, rlse = flash_fwd_plain(q, k, v, False, scale, None, "bnsd")
    delta = flash_delta(ref, do, "bnsd")
    dq = flash_bwd_dq_cuda(q, k, v, ref, rlse, delta, do, False, scale,
                           None, "bnsd")
    dk, dv = flash_bwd_dkv_cuda(q, k, v, rlse, delta, do, False, scale, None,
                                "bnsd")
    want = flash_bwd_plain(q, k, v, ref, rlse, do, False, scale, None, "bnsd")
    err = {}
    for name, part, a, r in (("flash_fwd", "out", out, ref),
                             ("flash_fwd", "lse", lse, rlse),
                             ("flash_bwd_dq", "dq", dq, want[0]),
                             ("flash_bwd_dkv", "dk", dk, want[1]),
                             ("flash_bwd_dkv", "dv", dv, want[2])):
        e = _flash_close(f"{name} {part} BERT-base (bnsd, B={b} H={h} S={s} "
                         f"D={d}, not causal, {dt})", a, r,
                         *FLASH_TOL[dt][part])
        err[name] = max(err.get(name, 0.0), e)
    lib = [x.detach().requires_grad_() for x in (q, k, v)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*lib)
        torch.autograd.grad(o, lib, do)

    calls = {"flash_fwd": lambda: flash_fwd_cuda(
                 q, k, v, False, scale, None, "bnsd"),
             "flash_bwd_dq": lambda: flash_bwd_dq_cuda(
                 q, k, v, out, lse, delta, do, False, scale, None, "bnsd"),
             "flash_bwd_dkv": lambda: flash_bwd_dkv_cuda(
                 q, k, v, lse, delta, do, False, scale, None, "bnsd")}
    # two passes each, the second reported: in a whole smoke run the
    # first pass of the fp32 forward here once read 10-15% above every
    # later reading of it at this shape (PERF.md)
    ms = {}
    for name, fn in calls.items():
        first, ms[name] = time_ms(fn), time_ms(fn)
        log(f"{name} BERT-base ({dt}): passes {first:.4f}, {ms[name]:.4f} "
            "ms")
    plain_fwd = time_ms(lambda: flash_fwd_plain(q, k, v, False, scale, None,
                                                "bnsd"), iters=3)
    plain_bwd = time_ms(lambda: flash_bwd_plain(q, k, v, out, lse, do, False,
                                                scale, None, "bnsd"), iters=3)
    lib_fwd = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    lib_bwd = graph_ms(sdpa_fwd_bwd) - lib_fwd
    elems = b * h * s * d * q.element_size()     # bytes of one operand
    rows = b * h * s * (8 if dt == "fp32" else 4)  # delta (fp32: hi + lo)
    full = b * h * s * s * d                     # every query-key pair
    work = {"flash_fwd": (4 * elems + b * h * s * 4, 4 * full),
            "flash_bwd_dq": (5 * elems + b * h * s * 4 + rows, 6 * full),
            "flash_bwd_dkv": (6 * elems + b * h * s * 4 + rows, 8 * full)}
    results = {}
    for name, (nbytes, ops) in work.items():
        bms, by, peak = _flash_bound(dt, nbytes, ops)
        fwd = name == "flash_fwd"
        results[f"{name}_bert_{dt}"] = dict(
            ms=ms[name], plain_ms=plain_fwd if fwd else plain_bwd,
            bound_ms=bms, bound_by=by,
            library_ms=lib_fwd if fwd else lib_bwd, max_abs_err=err[name])
        log(f"{name} BERT-base ({dt}): B={b} H={h} S={s} D={d} bnsd not "
            f"causal: {ms[name]:.4f} ms ({ops / ms[name] / 1e9:.1f} TFLOP/s), "
            f"plain {plain_fwd if fwd else plain_bwd:.4f} ms (the whole "
            f"{'forward' if fwd else 'backward'}), sdpa "
            f"{'forward' if fwd else 'fwd+bwd - fwd'} by graph replay "
            f"{lib_fwd if fwd else lib_bwd:.4f} ms, bound {bms:.4f} ms "
            f"({by}; {ops:.4g} flop at {peak}, {nbytes} bytes; "
            f"{100 * bms / ms[name]:.1f}% of it)")
    if dt == "fp32":
        _time_peaked(np, torch, q, k, v, do, scale, ms)
    del q, k, v, do, out, lse, ref, rlse, delta, dq, dk, dv, want, lib
    torch.cuda.empty_cache()
    return results


def _time_peaked(np, torch, q, k, v, do, scale, random_ms):
    """The fp32 forward, dQ and dK/dV at BERT-base's attention with q
    scaled so that the logits' std is 2.4 (scale 0.3 at D=64) or 8 (near
    one key a query), as trained heads concentrate: timed beside
    ``random_ms`` (std 1), with the share of pairs at p >= 1/16, which
    take dp in fp64 in the backward (csrc/flash_bwd.cu, heavy_dp64).
    Logs, as shares of FLASH_TOL fp32, the kernels against the plain
    version and both, and SDPA (its forward's out, its backward), against
    the forward's out and lse and the backward computed in fp64 from the
    same inputs: where the logits are large, fp32 itself misses
    FLASH_TOL's premise (a summation order apart), so here the kernels
    are held instead to be no further from fp64 than twice the plain
    version's distance, or twice FLASH_TOL where the plain version is
    within it."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_bwd_plain, flash_fwd_plain
    from paddle_tpu_torch.kernels.flash import (flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda, flash_delta,
                                                flash_fwd_cuda)

    b, h, s, _ = q.shape
    tol = FLASH_TOL["fp32"]
    for std in (2.4, 8.0):
        qp = q * std
        ref, rlse = flash_fwd_plain(qp, k, v, False, scale, None, "bnsd")
        delta = flash_delta(ref, do, "bnsd")
        got = (flash_fwd_cuda(qp, k, v, False, scale, None, "bnsd")
               + (flash_bwd_dq_cuda(qp, k, v, ref, rlse, delta, do, False,
                                    scale, None, "bnsd"),)
               + flash_bwd_dkv_cuda(qp, k, v, rlse, delta, do, False, scale,
                                    None, "bnsd"))
        want = (ref, rlse) + flash_bwd_plain(qp, k, v, ref, rlse, do, False,
                                             scale, None, "bnsd")
        lib = [x.detach().requires_grad_() for x in (qp, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib)
        sdpa = ((lib_out.detach(), None)
                + torch.autograd.grad(lib_out, lib, do))
        # the forward and the backward in fp64 from q, k, v and dO alone
        q64, k64, v64, do64 = (x.double() for x in (qp, k, v, do))
        s64 = q64 @ k64.transpose(-1, -2) * scale
        p = torch.softmax(s64, -1)
        heavy = (p >= 1 / 16).sum().item()
        top = p.amax(-1).mean().item()
        dp = do64 @ v64.transpose(-1, -2)
        o64 = p @ v64
        ds = p * (dp - (do64 * o64).sum(-1, keepdim=True)) * scale
        exact = (o64, torch.logsumexp(s64, -1).reshape(b * h, s), ds @ k64,
                 ds.transpose(-1, -2) @ q64, p.transpose(-1, -2) @ do64)
        del q64, k64, v64, do64, s64, p, dp, o64, ds
        for i, part in enumerate(("out", "lse", "dq", "dk", "dv")):
            share = {}
            for name, x, y in (("kernel vs plain", got[i], want[i]),
                               ("kernel vs fp64", got[i], exact[i]),
                               ("plain vs fp64", want[i], exact[i]),
                               ("sdpa vs fp64", sdpa[i], exact[i])):
                if x is not None:
                    share[name] = _flash_share(x, y, *tol[part])[0]
            kind = "flash_fwd" if i < 2 else "flash_bwd"
            log(f"{kind} {part} BERT-base fp32, logits' std {std}: worst "
                "share of FLASH_TOL fp32 " + ", ".join(
                    f"{name} {v:.3f}" for name, v in share.items()))
            if not share["kernel vs fp64"] <= 2 * max(1.0,
                                                     share["plain vs fp64"]):
                raise AssertionError(f"{kind} {part} at logits' std {std} "
                                     "is further from fp64 than the plain "
                                     "version allows")
        ms = {"flash_fwd": time_ms(lambda: flash_fwd_cuda(
                  qp, k, v, False, scale, None, "bnsd")),
              "flash_bwd_dq": time_ms(lambda: flash_bwd_dq_cuda(
                  qp, k, v, ref, rlse, delta, do, False, scale, None, "bnsd")),
              "flash_bwd_dkv": time_ms(lambda: flash_bwd_dkv_cuda(
                  qp, k, v, rlse, delta, do, False, scale, None, "bnsd"))}
        for name, t in ms.items():
            log(f"{name} BERT-base (fp32), logits' std {std}: {t:.4f} ms "
                f"({100 * (t / random_ms[name] - 1):+.1f}% against std 1's "
                f"{random_ms[name]:.4f}); pairs at p >= 1/16 (dp in fp64 in "
                f"the backward): {heavy} of {b * h * s * s} "
                f"({100 * heavy / (b * h * s * s):.3f}%, "
                f"{heavy / (b * h * s):.2f} a query); mean top p {top:.3f}")
        del qp, ref, rlse, delta, got, want, lib, lib_out, sdpa, exact
    torch.cuda.empty_cache()


def phase_bert(np, torch, card):
    """Phase 8, eager BERT: (1) the small BERT card vs CPU; (2) BERT-base
    in fp32 and under bf16 ``auto_cast``; the flash kernels at BERT-base's
    attention shape in fp32 and bf16.  Returns the kernels-line entries
    and each run's flash launches."""
    _bert_parity(np, torch)
    kernels = {}
    for dt in ("fp32", "bf16"):
        kernels.update(_time_flash_bert(np, torch, dt))
    runs = {"fp32": _bert_base(np, torch, False, card),
            "bf16": _bert_base(np, torch, True, card)}
    log(card)
    return kernels, runs


# -- phase 9 -----------------------------------------------------------------

# fleet on nn.Layer: the paddle-shaped GPT-760M (TRAIN_CFG at full width,
# seq 1024) in fp32 (paddle's default dtype), batch 12; the pipeline as 4
# microbatches of 3; AdamW(weight_decay=0.01) with the global-norm clip
FLEET_STEPS = 4                 # 1 warm-up and 3 timed
FLEET_ACC, FLEET_MB = 4, 3


def _fleet_opt(params):
    import paddle_tpu_torch as paddle

    return paddle.optimizer.AdamW(
        learning_rate=1e-4, parameters=params, weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))


def _fleet_build(pipe=False, state=None):
    """The paddle GPT (or its pipe at one stage) and the criterion under
    fresh unique names, seeded; ``state`` (numpy, the reference's
    GPTForPretraining keys) loaded through ``weights``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import gpt_layers
    from paddle_tpu_torch.weights import load_paddle_state_dict

    cfg = gpt_layers.GPTConfig(**TRAIN_CFG)
    with unique_name.guard():
        paddle.seed(0)
        model = (gpt_layers.GPTForPretrainingPipe(cfg, num_stages=1) if pipe
                 else gpt_layers.GPTForPretraining(cfg))
        crit = gpt_layers.GPTPretrainingCriterion()
    if state is not None:
        load_paddle_state_dict(model, state)
    return cfg, model, crit


def _fleet_steps(np, torch, step, label, cfg, launches_per_step):
    """FLEET_STEPS of ``step()`` (returns the loss Tensor): losses, the
    timed steps' ms, the flash launches asserted, then one more step under
    ``_OpClock`` and one profiled; logs what each costs."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    carried = torch.cuda.memory_allocated() / 2**30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(FLEET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        losses.append(float(loss.numpy()))                # synchronises
        times.append(time.perf_counter() - t0)
    launches = {k: KERNELS[k] for k in FLASH}
    want = {k: launches_per_step * FLEET_STEPS for k in FLASH}
    if launches != want:
        raise AssertionError(f"{label} launched {launches}, expected {want}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    with _OpClock() as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    busy = _profile(torch, f"{label}, one more step", step)
    step_s = float(np.mean(times[1:]))
    tps = TRAIN_BATCH * TRAIN_SEQ / step_s
    mfu = tps * _flops_per_token(cfg, TRAIN_SEQ) / BF16_FLOPS
    log(f"fleet {label}: losses {[round(x, 5) for x in losses]}; step "
        f"{1e3 * step_s:.1f} ms (timed {[round(1e3 * t, 1) for t in times[1:]]}"
        f", warm-up {1e3 * times[0]:.1f} ms), {tps:.0f} tokens/s, MFU "
        f"{100 * mfu:.2f}% of 989 TFLOP/s; max_memory_allocated {peak:.2f} "
        f"GiB ({carried:.2f} GiB allocated before); device busy "
        f"{100 * busy:.1f}% of one profiled step; {clock.ops} traced ops and "
        f"{clock.updates} update ops a step, {1e6 * clock.seconds / max(clock.ops, 1):.1f} "
        f"us host per traced op ({1e3 * clock.seconds:.1f} ms of a "
        f"{1e3 * host:.1f} ms step inside the tracer); launches "
        f"{json.dumps(launches)}")
    return {"losses": losses, "step_s": step_s, "launches": launches,
            "ops": clock.ops, "updates": clock.updates}


def _fleet_eager(np, torch, ids, labels, state, fleet_wrap, amp=False):
    """Run 1 (the plain eager loop) or, with ``fleet_wrap``, the same
    through ``fleet.distributed_model`` / ``distributed_optimizer``;
    returns the run's numbers and its trained parameters (on the CPU)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import fleet

    cfg, model, crit = _fleet_build(state=state)
    opt = _fleet_opt(model.parameters())
    net = model
    if fleet_wrap:
        net = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
        kinds = (type(net).__name__, type(opt).__name__)
        if kinds != ("DataParallelSPMD", "HybridParallelOptimizer"):
            raise AssertionError(f"fleet wrapped the model as {kinds}")

    def step():
        with (paddle.amp.auto_cast() if amp else contextlib.nullcontext()):
            loss = crit(net(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    label = ("bf16 auto_cast, " if amp else "fp32, ") + (
        "DataParallelSPMD + HybridParallelOptimizer" if fleet_wrap
        else "plain")
    run = _fleet_steps(np, torch, step, label, cfg, cfg.num_layers)
    if fleet_wrap and net._n != 1:
        raise AssertionError("the one-rank data group is not one rank")
    trained = [p._t.detach().cpu() for p in model.parameters()]
    del model, net, opt, crit
    _free(torch)
    return run, trained


def _fleet_pipeline(np, torch, ids, labels, state):
    """Run 3: PipelineParallel over GPTForPretrainingPipe at one stage, 4
    microbatches of 3, built as the reference's test builds it."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpp

    cfg, pipe, _ = _fleet_build(pipe=True, state=state)
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1}
    s.pipeline_configs = {"accumulate_steps": FLEET_ACC,
                          "micro_batch_size": FLEET_MB}
    model = mpp.PipelineParallel(pipe, fleet.get_hybrid_communicate_group(),
                                 s)
    opt = _fleet_opt(pipe.parameters())
    run = _fleet_steps(np, torch, lambda: model.train_batch(
        (ids, labels), optimizer=opt), f"PipelineParallel (S=1, "
        f"{FLEET_ACC} x {FLEET_MB})", cfg, FLEET_ACC * cfg.num_layers)
    del model, pipe, opt
    _free(torch)
    return run


def _fleet_recompute(np, torch):
    """One GPTBlock at full width, fp32: its input's and parameters'
    gradients through ``fleet.utils.recompute`` bit for bit the plain
    block's; the flash launches of each (the forward twice under
    recompute)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.fleet.utils import recompute
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models import gpt_layers

    with unique_name.guard():
        paddle.seed(0)
        blk = gpt_layers.GPTBlock(gpt_layers.GPTConfig(**TRAIN_CFG))
    xb = np.random.RandomState(1).randn(
        TRAIN_BATCH, TRAIN_SEQ, TRAIN_CFG["hidden_size"]).astype("float32")
    runs = []
    for use in (False, True):
        for p in blk.parameters():
            p.clear_grad()
        reset_launch_counts()
        x = paddle.to_tensor(xb, stop_gradient=False)
        out = recompute(blk, x) if use else blk(x)
        out.sum().backward()
        runs.append(([p.grad._t.clone() for p in blk.parameters()],
                     x.grad._t.clone(), {k: KERNELS[k] for k in FLASH}))
    (pg, px, pl), (rg, rx, rl) = runs
    same = [torch.equal(a, b) for a, b in zip(pg + [px], rg + [rx])]
    log(f"fleet recompute: one GPTBlock (B={TRAIN_BATCH} S={TRAIN_SEQ} "
        f"hidden {TRAIN_CFG['hidden_size']}, fp32), {sum(same)} of "
        f"{len(same)} gradients bit-identical to the plain block's; "
        f"launches plain {json.dumps(pl)}, recompute {json.dumps(rl)}")
    if not all(same):
        raise AssertionError("recompute's gradients differ from the plain "
                             "block's")
    if pl != dict.fromkeys(FLASH, 1) or rl != {
            k: 2 if k == "flash_fwd" else 1 for k in FLASH}:
        raise AssertionError(f"recompute launched {rl}, plain {pl}")
    del blk, runs
    _free(torch)
    return {"plain": pl, "recompute": rl}


def phase_fleet(np, torch, card):
    """Phase 9: GPT-760M at full width through fleet on a one-rank NCCL
    group; returns each run's flash launches by the dtype the kernels ran
    in, the first run of each dtype first."""
    import paddle_tpu_torch as paddle
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.weights import state_dict_to_numpy

    _one_rank_group(torch)
    paddle.set_device("gpu")
    try:
        rng = np.random.RandomState(0)
        v = TRAIN_CFG["vocab_size"]
        ids = paddle.to_tensor(rng.randint(0, v, (TRAIN_BATCH, TRAIN_SEQ))
                               .astype("int64"))
        labels = paddle.to_tensor(rng.randint(0, v, (TRAIN_BATCH, TRAIN_SEQ))
                                  .astype("int64"))
        _, model, _ = _fleet_build()
        state = state_dict_to_numpy(model)
        del model
        _free(torch)
        plain, plain_w = _fleet_eager(np, torch, ids, labels, state, False)
        dp, dp_w = _fleet_eager(np, torch, ids, labels, state, True)
        same = [torch.equal(a, b) for a, b in zip(plain_w, dp_w)]
        log(f"fleet DataParallelSPMD (one rank) vs plain: losses equal "
            f"{plain['losses'] == dp['losses']}, {sum(same)} of {len(same)} "
            f"parameters bit-identical after {FLEET_STEPS} steps")
        if plain["losses"] != dp["losses"] or not all(same):
            raise AssertionError("fleet's one-rank data parallel run differs "
                                 "from the plain run")
        del plain_w, dp_w
        pipe = _fleet_pipeline(np, torch, ids, labels, state)
        got, want = np.array(pipe["losses"]), np.array(plain["losses"])
        err = np.abs(got - want) / (2e-4 + 2e-4 * np.abs(want))
        log(f"fleet PipelineParallel vs plain: losses {got.tolist()} vs "
            f"{want.tolist()}, worst share of the bound (rtol 2e-4, atol "
            f"2e-4) {err.max():.3f}; engine cost over the plain step "
            f"{1e3 * (pipe['step_s'] - plain['step_s']):+.1f} ms "
            f"({pipe['step_s'] / plain['step_s']:.3f}x), traced ops "
            f"{pipe['ops']} vs {plain['ops']}, update ops {pipe['updates']} "
            f"vs {plain['updates']}")
        if not err.max() <= 1.0:
            raise AssertionError("the one-stage pipeline misses the plain "
                                 "run's losses")
        bf16, _ = _fleet_eager(np, torch, ids, labels, state, True, amp=True)
        if not bf16["losses"][-1] < bf16["losses"][0]:
            raise AssertionError(f"bf16 fleet run: losses {bf16['losses']}")
        rec = _fleet_recompute(np, torch)
    finally:
        mesh_mod.set_mesh(None)
        dist.destroy_process_group()
    log(card)
    return {"fp32": {"fleet plain fp32": plain["launches"],
                     "fleet DataParallelSPMD fp32": dp["launches"],
                     "fleet PipelineParallel fp32": pipe["launches"],
                     "fleet recompute block fp32": rec["recompute"]},
            "bf16": {"fleet bf16 auto_cast": bf16["launches"]}}


# -- phase 10 ----------------------------------------------------------------

# the DataLoader and the generic step: bench.py's _resnet50_bench (ResNet-50
# v1.5, NHWC, bf16, momentum lr 0.1, wd 1e-4, batch 256 at 224 px) fed by
# FakeData through 8 spawned workers, and _bert_bench (BERT-base, AdamW lr
# 1e-4, wd 0.01, bf16, batch 32 x 512, 76 masked) through the same step
RESNET = dict(depth=50, batch=256, image=224, workers=8, classes=1000)
RESNET_MACS = 4089184256        # conv + fc MACs an image at 224 px (bench.py)
STEP_WARM, STEP_TIMED = 3, 10
BERT_STEP = dict(vocab=30528, hidden=768, layers=12, heads=12, seq=512,
                 batch=32, masked=76)


def _probe_collate(batch):
    """The default collate plus a flag from the worker: whether torch has
    made a CUDA context in this process (it must not)."""
    import numpy as np
    import torch

    from paddle_tpu_torch.io import default_collate_fn

    return default_collate_fn(batch) + (
        np.asarray(torch.cuda.is_initialized()),)


def _ce_loss(m, images, labels):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F

    return paddle.mean(F.softmax_with_cross_entropy(m(images), labels))


def _timed_steps(np, torch, step, state, batches):
    """Host-clock seconds of each synchronised step over ``batches`` (an
    iterator of batch tuples, fetched inside the timing); returns the
    state, the losses and the times."""
    params, bufs, opt = state
    losses, times = [], []
    for _ in range(STEP_WARM + STEP_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = next(batches)
        params, bufs, opt, loss = step(params, bufs, opt, *batch)
        losses.append(float(loss))                       # synchronises
        times.append(time.perf_counter() - t0)
    return (params, bufs, opt), losses, times


def _loader_alone(np, torch, loader, card):
    """(a): one epoch of the loader alone; batches/s after the first batch
    (which waits for the workers to start)."""
    flags, stamps = [], []
    t0 = time.perf_counter()
    for images, labels, flag in loader:
        stamps.append(time.perf_counter())
        flags.append(bool(flag.numpy()))
    torch.cuda.synchronize()
    n = len(stamps)
    rate = (n - 1) / (stamps[-1] - stamps[0])
    log(f"loader alone: {n} batches of {RESNET['batch']} x "
        f"{'x'.join(map(str, images.shape[1:]))} fp32 "
        f"({images.numpy().nbytes / 2**20:.1f} MiB a batch), first batch "
        f"after {stamps[0] - t0:.2f} s, then {rate:.2f} batches/s "
        f"({rate * RESNET['batch']:.0f} images/s); through the ring "
        f"{loader.ring_batches}, by queue {loader.queue_batches}; a worker "
        f"with a CUDA context: {any(flags)}; {card}")
    if loader.queue_batches or loader.ring_batches != n or any(flags):
        raise AssertionError("the loader's batches did not all come "
                             "through the ring, or a worker touched the "
                             "card")
    return rate


def _resnet50(np, torch, card):
    """(a) and (b): the loader alone, then ResNet-50 through the generic
    step fed by it, then on one resident batch."""
    import gc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.models.step_builder import build_model_train_step
    from paddle_tpu_torch.vision import models
    from paddle_tpu_torch.vision.datasets import FakeData

    b, px = RESNET["batch"], RESNET["image"]
    batch_mib = b * px * px * 3 * 4 / 2**20
    os.environ["PADDLE_SHM_SLOT_MB"] = str(int(batch_mib) + 8)
    shm = os.statvfs("/dev/shm")
    log(f"/dev/shm: {shm.f_bavail * shm.f_frsize / 2**30:.1f} GiB free; "
        f"rings: {RESNET['workers']} x 4 slots of "
        f"{os.environ['PADDLE_SHM_SLOT_MB']} MiB")
    data = FakeData(num_samples=b * (STEP_WARM + STEP_TIMED),
                    image_shape=(px, px, 3),
                    num_classes=RESNET["classes"])
    loader = DataLoader(data, batch_size=b, shuffle=True, drop_last=True,
                        num_workers=RESNET["workers"],
                        persistent_workers=True, collate_fn=_probe_collate)
    rate = _loader_alone(np, torch, loader, card)

    paddle.seed(0)
    model = getattr(models, f"resnet{RESNET['depth']}")(
        num_classes=RESNET["classes"], data_format="NHWC")
    step, params, bufs, opt = build_model_train_step(
        model, _ce_loss, optimizer="momentum", lr=0.1, weight_decay=1e-4,
        compute_dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fed = ((images, labels) for images, labels, _ in loader)
    state, losses, times = _timed_steps(np, torch, step,
                                        (params, bufs, opt), fed)
    fed.close()
    ring, queue = loader.ring_batches, loader.queue_batches
    del loader, fed
    gc.collect()
    left = sorted(f for f in os.listdir("/dev/shm") if f.startswith("pt_dl_"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    rng = np.random.RandomState(0)
    resident = (torch.as_tensor(rng.rand(b, px, px, 3).astype("float32"),
                                device="cuda"),
                torch.as_tensor(rng.randint(0, RESNET["classes"], (b, 1)),
                                device="cuda"))
    state, r_losses, r_times = _timed_steps(
        np, torch, step, state, iter([resident] * (STEP_WARM + STEP_TIMED)))
    busy = _profile(torch, "ResNet-50 step, resident batch",
                    lambda: step(*state, *resident))
    fed_s = float(np.mean(times[STEP_WARM:]))
    res_s = float(np.mean(r_times[STEP_WARM:]))

    def mfu(sec):
        return b / sec * 6 * RESNET_MACS / BF16_FLOPS

    log(f"ResNet-{RESNET['depth']} generic step (NHWC, bf16, momentum, "
        f"batch {b} at {px} px; {card}): fed by the loader "
        f"{1e3 * fed_s:.1f} ms a step (timed "
        f"{[round(1e3 * t, 1) for t in times[STEP_WARM:]]}, warm-up "
        f"{[round(1e3 * t, 1) for t in times[:STEP_WARM]]}), {b / fed_s:.0f} "
        f"images/s, MFU {100 * mfu(fed_s):.2f}%; resident batch "
        f"{1e3 * res_s:.1f} ms ({b / res_s:.0f} images/s, MFU "
        f"{100 * mfu(res_s):.2f}%); the loader's cost to the card "
        f"{1e3 * (fed_s - res_s):+.1f} ms a step (the loader alone "
        f"{rate:.2f} batches/s); max_memory_allocated {peak:.2f} GiB; "
        f"device busy {100 * busy:.1f}% of one profiled step; losses fed "
        f"{[round(x, 4) for x in losses]}, resident "
        f"{[round(x, 4) for x in r_losses]}; loader: ring {ring}, queue "
        f"{queue}; segments left in /dev/shm {left}")
    if not np.all(np.isfinite(losses + r_losses)):
        raise AssertionError("ResNet-50's loss is not finite")
    if queue or left:
        raise AssertionError(f"a batch went by queue ({queue}) or a ring "
                             f"was left in /dev/shm ({left})")
    del model, step, params, bufs, opt, state, resident
    _free(torch)


def _bert_step(np, torch, card):
    """(c): BERT-base through the generic step on resident arrays; returns
    the flash launches of one step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         BertPretrainingCriterion)
    from paddle_tpu_torch.models.step_builder import build_model_train_step

    c = BERT_STEP
    cfg = BertConfig(vocab_size=c["vocab"], hidden_size=c["hidden"],
                     num_layers=c["layers"], num_heads=c["heads"],
                     max_seq_len=c["seq"], dropout=0.0)
    paddle.seed(0)
    model = BertForPretraining(cfg)
    crit = BertPretrainingCriterion()

    def loss_builder(m, ids, token_type, pos, mlm_labels, nsp_labels):
        mlm_logits, nsp_logits = m(ids, token_type, masked_positions=pos)
        return crit(mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                    masked_lm_scale=float(int(pos.shape[0])
                                          * int(pos.shape[1])))

    step, params, bufs, opt = build_model_train_step(
        model, loss_builder, optimizer="adamw", lr=1e-4, weight_decay=0.01,
        compute_dtype="bfloat16")
    rng = np.random.RandomState(0)
    b, s, m = c["batch"], c["seq"], c["masked"]
    ids = rng.randint(0, c["vocab"], (b, s)).astype("int64")
    tt = (rng.rand(b, s) > 0.5).astype("int64")
    pos = np.stack([rng.choice(s, m, replace=False) + i * s
                    for i in range(b)]).astype("int64")
    mlm = ids.reshape(-1)[pos.reshape(-1)]
    nsp = rng.randint(0, 2, (b, 1)).astype("int64")
    arrays = tuple(torch.as_tensor(a, device="cuda")
                   for a in (ids, tt, pos, mlm, nsp))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    state, losses, times = _timed_steps(
        np, torch, step, (params, bufs, opt),
        iter([arrays] * (STEP_WARM + STEP_TIMED)))
    launches = {k: KERNELS[k] // (STEP_WARM + STEP_TIMED) for k in FLASH}
    total = {k: KERNELS[k] for k in FLASH}
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = _profile(torch, "BERT-base generic step",
                    lambda: step(*state, *arrays))
    step_s = float(np.mean(times[STEP_WARM:]))
    fpt = bert_flops_per_token(c["hidden"], c["layers"], s, c["vocab"],
                               m / s)
    mfu = b * s / step_s * fpt / BF16_FLOPS
    log(f"BERT-base generic step (AdamW, bf16, B={b} S={s} {m} masked; "
        f"{card}): {1e3 * step_s:.1f} ms a step (timed "
        f"{[round(1e3 * t, 1) for t in times[STEP_WARM:]]}, warm-up "
        f"{[round(1e3 * t, 1) for t in times[:STEP_WARM]]}), "
        f"{b * s / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of 989 "
        f"TFLOP/s (phase 8's eager bf16 auto_cast step: 174.0 ms, PERF.md); "
        f"max_memory_allocated {peak:.2f} GiB; device busy "
        f"{100 * busy:.1f}% of one profiled step; losses "
        f"{[round(x, 4) for x in losses]}; flash launches a step "
        f"{json.dumps(launches)}")
    want = {k: c["layers"] * (STEP_WARM + STEP_TIMED) for k in FLASH}
    if total != want:
        raise AssertionError(f"BERT-base's generic step launched {total}, "
                             f"expected {want}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"BERT-base's generic step: losses {losses}")
    del model, step, params, bufs, opt, state, arrays
    _free(torch)
    return total


def _step_parity(np, torch, label, factory, loss, batch, tol_loss=1e-5):
    """A model's generic step (momentum, lr 1e-3, fp32, TF32 off) for 3
    steps on the card and on the CPU, each step from the CPU's state
    (parameters, buffers, velocities): losses within ``tol_loss``
    relative, each parameter's update within ``UPDATE_RTOL``
    (``update_ratios``) and each buffer within 1e-4 relative.
    ``factory()`` builds the model under the current seed."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models.step_builder import build_model_train_step
    from paddle_tpu_torch.weights import load_paddle_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    state = None
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        with unique_name.guard():
            paddle.seed(0)
            model = factory()
        if state is None:
            state = {k: v.numpy() for k, v in model.state_dict().items()}
        else:
            load_paddle_state_dict(model, state)
        runs[dev] = (model, build_model_train_step(
            model, loss, optimizer="momentum", lr=1e-3,
            weight_decay=1e-4, compute_dtype=None))
    paddle.set_device("gpu")
    names = [n for n, _ in runs["cpu"][0].named_parameters()]
    (_, (cstep, cpar, cbuf, copt)), (_, (gstep, gpar, gbuf, gopt)) = (
        runs["cpu"], runs["gpu"])
    worst = {"loss": 0.0, "update": 0.0, "buffer": 0.0}
    for i in range(3):
        start = [p.clone() for p in cpar]
        for g, c in zip(gpar, cpar):
            g.copy_(c)
        gbuf = [b.cuda() for b in cbuf]
        for g, c in zip(gopt["v"], copt["v"]):
            g.copy_(c)
        # each step at its model's place: a forward makes tensors (the
        # position ids) on the current one
        paddle.set_device("cpu")
        cpar, cbuf, copt, closs = cstep(cpar, cbuf, copt, *batch)
        paddle.set_device("gpu")
        gpar, gbuf, gopt, gloss = gstep(gpar, gbuf, gopt, *batch)
        rel = abs(float(gloss) - float(closs)) / abs(float(closs))
        log(f"{label} generic step {i + 1}, card vs cpu: loss "
            f"{float(gloss):.7f} vs {float(closs):.7f} (rel {rel:.2e})")
        ratios = update_ratios(torch, None, names,
                               [p.cpu() for p in gpar], cpar, start)
        bufs = max([((g.cpu() - c).norm() / c.norm()).item()
                    for g, c in zip(gbuf, cbuf)], default=0.0)
        log(f"  worst buffer, relative: {bufs:.3e}")
        worst = {"loss": max(worst["loss"], rel),
                 "update": max(worst["update"], max(ratios.values())),
                 "buffer": max(worst["buffer"], bufs)}
    log(f"{label} generic step, card vs cpu over 3 steps: worst loss rel "
        f"{worst['loss']:.3e} (tol {tol_loss:g}), update ratio "
        f"{worst['update']:.3e} (tol {UPDATE_RTOL:g}), buffer "
        f"{worst['buffer']:.3e} (tol 1e-4)")
    if not (worst["loss"] <= tol_loss and worst["update"] <= UPDATE_RTOL
            and worst["buffer"] <= 1e-4):
        raise AssertionError(f"{label}'s generic step on the card disagrees "
                             "with the CPU")
    del runs
    _free(torch)
    return worst


def _resnet_parity(np, torch):
    """(d): resnet18 at 32 px, batch 4, fp32, TF32 off, lr 1e-3: 3 steps
    on the card and on the CPU, each from the CPU's state."""
    from paddle_tpu_torch.vision.models import resnet18

    rng = np.random.RandomState(0)
    batch = (rng.randn(4, 3, 32, 32).astype("float32"),
             rng.randint(0, 10, (4, 1)).astype("int64"))
    _step_parity(np, torch, "resnet18", lambda: resnet18(num_classes=10),
                 _ce_loss, batch)


def phase_data(np, torch, card):
    """Phase 10: the DataLoader over the shared-memory ring, ResNet-50 and
    BERT-base through ``build_model_train_step``, and the resnet18 step on
    the card against the CPU.  Returns the BERT-base step's flash
    launches."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    _resnet_parity(np, torch)
    _resnet50(np, torch, card)
    launches = _bert_step(np, torch, card)
    log(card)
    return launches


# -- phase 11 ----------------------------------------------------------------

# the transformer encoder family through the generic step, random seeded
# weights, bf16 compute, fp32 masters, AdamW: ViT-base/16 (224 px, 1000
# classes, batch 128: 197 tokens) and ERNIE-3.0-base (vocab 40000, 12 x
# 768, 12 heads, task-type embeddings, seq 512, batch 32, 76 masked; each
# row's real length drawn from 256-512 by the seed, pad id 0 after it, so
# that the default pad mask is the flash kernels' score bias)
VIT = dict(arch="vit_b_16", img=224, patch=16, classes=1000, batch=128,
           hidden=768, layers=12)
ERNIE = dict(vocab=40000, hidden=768, layers=12, heads=12, seq=512,
             batch=32, masked=76)
# the biased flash cases (D=64, head views of one fused QKV tensor, as the
# encoders hand them over): label, layout, B, H, Hkv, S, mask, dtypes; "pad"
# is a [B, 1, 1, S] float mask of 0 / -1e4 with 0-256 padded keys a row
# (ERNIE's), "bool" an [S, S] boolean mask (a decoder's), "full" a random
# float [B, H, S, S] one (with GQA, seq-major as the kernels take it:
# each query head of a KV group reads its own bias slice)
BIAS_CASES = (
    ("vit_s197", "bnsd", 4, 12, 12, 197, None, ("bf16", "fp32")),
    ("ernie_padmask", "bnsd", 4, 12, 12, 512, "pad", ("bf16", "fp32")),
    ("decoder_mask", "bnsd", 4, 12, 12, 256, "bool", ("bf16",)),
    ("gqa_full", "bsnd", 4, 12, 4, 256, "full", ("bf16", "fp32")),
)
ERNIE_SMALL = ["--model", "ernie", "--hidden", "64", "--layers", "2",
               "--heads", "2", "--vocab", "256", "--seq", "64", "--batch",
               "4", "--masked", "8"]


def _mask(torch, g, kind, b, s, h=1, sk=None):
    """The case's attention mask on the card (None for none) for s queries
    over ``sk`` keys (None: s): "pad" a [B, 1, 1, Sk] float mask of 0 /
    -1e4 with 0 to Sk/2 padded keys a row; "neginf" that plus -inf above
    the diagonal aligned at the bottom right ([B, 1, S, Sk], a decoder's
    ``generate_square_subsequent_mask`` and padding); "bool" an [S, S]
    boolean mask; "full" a random float [B, H, S, Sk] one."""
    sk = s if sk is None else sk
    if kind in ("pad", "neginf"):
        pad = torch.randint(0, sk // 2 + 1, (b, 1), device="cuda",
                            generator=g)
        keep = torch.arange(sk, device="cuda")[None, :] < sk - pad
        bias = torch.where(keep, 0.0, -1e4)[:, None, None, :]
        if kind == "pad":
            return bias
        return bias + torch.triu(torch.full((s, sk), float("-inf"),
                                            device="cuda"), 1 + sk - s)
    if kind == "bool":
        keep = torch.rand(s, s, device="cuda", generator=g) > 0.4
        return keep | torch.eye(s, dtype=torch.bool, device="cuda")
    if kind == "full":
        return torch.randn(b, h, s, sk, device="cuda", generator=g)
    return None


def _flash_biased(np, torch):
    """The forward, dQ and dK/dV kernels with a score bias against their
    plain versions with the same bias, each tensor within FLASH_TOL (the
    backward kernels from the plain forward's out and lse)."""
    from paddle_tpu_torch.kernels import flash_bwd_plain, flash_fwd_plain
    from paddle_tpu_torch.kernels.flash import (_bias_of, _heads_shape,
                                                flash_bwd, flash_fwd_cuda)

    d = 64
    for case, layout, b, h, hkv, s, kind, dts in BIAS_CASES:
        for dt in dts:
            dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dt]
            g = torch.Generator(device="cuda").manual_seed(s + h)
            q, k, v = _qkv_views(torch, g, layout, b, h, hkv, s, d, dtype)
            mask = _mask(torch, g, kind, b, s, h)
            bias = None if mask is None else _bias_of(
                mask, q, layout).expand(_heads_shape(q, layout))
            scale = 1.0 / np.sqrt(d)
            out, lse = flash_fwd_cuda(q, k, v, False, scale, None, layout,
                                      bias)
            ref, rlse = flash_fwd_plain(q, k, v, False, scale, None, layout,
                                        bias)
            do = torch.randn(ref.shape, device="cuda", generator=g).to(dtype)
            got = flash_bwd(q, k, v, ref, rlse, do, False, scale, None,
                            layout, bias)
            want = flash_bwd_plain(q, k, v, ref, rlse, do, False, scale,
                                   None, layout, bias)
            torch.cuda.synchronize()
            for name, part, a, r in (("flash_fwd", "out", out, ref),
                                     ("flash_fwd", "lse", lse, rlse),
                                     ("flash_bwd_dq", "dq", got[0], want[0]),
                                     ("flash_bwd_dkv", "dk", got[1], want[1]),
                                     ("flash_bwd_dkv", "dv", got[2],
                                      want[2])):
                _flash_close(
                    f"{name} {part} {case} ({layout}, B={b} H={h} Hkv={hkv} "
                    f"S={s} D={d}, not causal, {dt}, mask {kind})", a, r,
                    *FLASH_TOL[dt][part])
            del q, k, v, bias, out, lse, ref, rlse, do, got, want
    torch.cuda.empty_cache()


def _visible_pairs(sq, sk, causal):
    """The (query, key) pairs a head's kernels compute: all, or under a
    causal band aligned at the bottom right the visible ones, where a row
    that sees no key (Sq > Sk) has all Sk."""
    if not causal:
        return sq * sk
    return sum(min(max(i + sk - sq + 1, 0), sk) if i >= sq - sk else sk
               for i in range(sq))


def _time_flash_model(np, torch, label, q, k, v, mask, causal=False,
                      backward=True, train_mask=False):
    """The forward (and dQ, dK/dV) kernels at a model's attention (bnsd
    head views ``q`` [B, H, Sq, D] and ``k``, ``v`` [B, H, Sk, D] as the
    model hands them over, ``mask`` as the score bias): held to their
    plain versions with the same bias within FLASH_TOL (the backward
    kernels from the plain forward's out and lse), timed by CUDA events
    beside the plain versions and SDPA with a float ``attn_mask`` (the
    mask, and a causal band as a -inf mask aligned at the bottom right);
    returns their kernels-line rows ``flash_*_{label}_{dtype}``, each
    with its own max abs error here.  The bound counts the pairs a causal
    band leaves visible.  ``train_mask``: the mask requires grad; the dQ
    kernel also writes its gradient (the row ``flash_bwd_dq_dbias``), held
    to the plain version's and timed beside SDPA with an ``attn_mask``
    that requires grad."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_bwd_plain, flash_fwd_plain
    from paddle_tpu_torch.kernels.flash import (_bias_of, _heads_shape,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda, flash_delta,
                                                flash_fwd_cuda)

    b, h, sq, d = q.shape
    sk = k.shape[2]
    dt = {torch.float32: "fp32", torch.bfloat16: "bf16",
          torch.float16: "fp16"}[q.dtype]
    g = torch.Generator(device="cuda").manual_seed(7)
    base = None if mask is None else _bias_of(mask, q, "bnsd", k, causal)
    bias = None if base is None else base.expand(_heads_shape(q, "bnsd", k))
    scale = 1.0 / np.sqrt(d)
    opts = (causal, scale, None, "bnsd", bias)
    dqn = "flash_bwd_dq_dbias" if train_mask else "flash_bwd_dq"
    dbias = torch.zeros(base.shape, device="cuda") if train_mask else None
    what = (f"(bnsd, B={b} H={h} Sq={sq} Sk={sk} D={d}, "
            f"{'causal' if causal else 'not causal'}, {dt}, mask "
            f"{None if mask is None else tuple(mask.shape)})")
    out, lse = flash_fwd_cuda(q, k, v, *opts)
    ref, rlse = flash_fwd_plain(q, k, v, *opts)
    do = torch.randn(ref.shape, device="cuda", generator=g).to(q.dtype)
    delta = flash_delta(ref, do, "bnsd")
    parts = [("flash_fwd", "out", out, ref), ("flash_fwd", "lse", lse, rlse)]
    calls = {"flash_fwd": lambda: flash_fwd_cuda(q, k, v, *opts)}
    if backward:
        dq = flash_bwd_dq_cuda(q, k, v, ref, rlse, delta, do, *opts, dbias)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, rlse, delta, do, *opts)
        want = flash_bwd_plain(q, k, v, ref, rlse, do, *opts,
                               dbias_shape=None if dbias is None
                               else dbias.shape)
        parts += [(dqn, "dq", dq, want[0]),
                  ("flash_bwd_dkv", "dk", dk, want[1]),
                  ("flash_bwd_dkv", "dv", dv, want[2])]
        if train_mask:
            parts.append((dqn, "dbias", dbias, want[3]))
        calls[dqn] = lambda: flash_bwd_dq_cuda(
            q, k, v, ref, rlse, delta, do, *opts, dbias)
        calls["flash_bwd_dkv"] = lambda: flash_bwd_dkv_cuda(
            q, k, v, rlse, delta, do, *opts)
    err = {}
    for name, part, a, r in parts:
        e = _flash_close(f"{name} {part} {label} {what}", a, r,
                         *FLASH_TOL[dt][part])
        err[name] = max(err.get(name, 0.0), e)
    del parts, out, lse
    ms = {name: time_ms(fn) for name, fn in calls.items()}
    plain = {"flash_fwd": time_ms(lambda: flash_fwd_plain(q, k, v, *opts),
                                  iters=3)}
    am = mask
    if causal:
        band = torch.triu(torch.full((sq, sk), float("-inf"), device="cuda"),
                          1 + sk - sq)
        am = band if am is None else am + band
    am = None if am is None else am.to(q.dtype)
    lib = {"flash_fwd": graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=am))}
    if backward:
        plain[dqn] = plain["flash_bwd_dkv"] = time_ms(
            lambda: flash_bwd_plain(q, k, v, ref, rlse, do, *opts,
                                    dbias_shape=None if dbias is None
                                    else dbias.shape), iters=3)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        lam = am
        if train_mask:
            lam = am.detach().requires_grad_()
            leaves.append(lam)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(*leaves[:3], attn_mask=lam)
            torch.autograd.grad(o, leaves, do)

        lib[dqn] = lib["flash_bwd_dkv"] = (
            graph_ms(sdpa_fwd_bwd) - lib["flash_fwd"])
        del leaves, lam
    elt = q.element_size()
    qe, ke = b * h * sq * d * elt, b * h * sk * d * elt   # one operand
    rows = b * h * sq * 4                                 # lse
    drows = rows * (2 if dt == "fp32" else 1)             # delta
    mbytes = 0 if mask is None else mask.numel() * 4      # the bias
    dbytes = 0 if dbias is None else dbias.numel() * 4    # its gradient
    pairs = b * h * _visible_pairs(sq, sk, causal)
    full = pairs * d
    work = {"flash_fwd": (2 * qe + 2 * ke + rows + mbytes, 4 * full),
            dqn: (3 * qe + 2 * ke + rows + drows + mbytes + dbytes,
                  6 * full),
            "flash_bwd_dkv": (2 * qe + 4 * ke + rows + drows + mbytes,
                              8 * full)}
    results = {}
    for name in calls:
        nbytes, ops = work[name]
        bms, by, peak = _flash_bound(dt, nbytes, ops)
        fwd = name == "flash_fwd"
        results[f"{name}_{label}_{dt}"] = dict(
            ms=ms[name], plain_ms=plain[name], bound_ms=bms, bound_by=by,
            library_ms=lib[name], max_abs_err=err[name])
        log(f"{name} {label} {what}: {ms[name]:.4f} ms "
            f"({ops / ms[name] / 1e9:.1f} TFLOP/s), plain "
            f"{plain[name]:.4f} ms (the whole "
            f"{'forward' if fwd else 'backward'}), sdpa "
            f"{'forward' if fwd else 'fwd+bwd - fwd'} by graph replay "
            f"{lib[name]:.4f} ms, bound {bms:.4f} ms "
            f"({by}; {ops:.4g} flop at {peak}, {nbytes} bytes; "
            f"{100 * bms / ms[name]:.1f}% of it)")
    del q, k, v, mask, bias, ref, rlse, do, delta, base, dbias
    _free(torch)
    return results


def vit_flops_per_image(c):
    """Training flops per image, bench.py's convention (6 x the forward's
    multiply-adds): per block and token 12 h^2 (the projections and the
    MLP) + 2 s h (attention's two products), the patch embedding and the
    head on the class token."""
    h, n = c["hidden"], (c["img"] // c["patch"]) ** 2
    s = n + 1
    return 6.0 * (c["layers"] * s * (12.0 * h * h + 2.0 * s * h)
                  + n * 3 * c["patch"] ** 2 * h + h * c["classes"])


class _BiasSpy:
    """Counts the flash launches that carry a score bias, by kernel, while
    it is entered (a wrapper of ``flash._launch``)."""

    def __enter__(self):
        from paddle_tpu_torch.kernels import flash

        self._mod, self._orig = flash, flash._launch
        self.counts = dict.fromkeys(FLASH, 0)

        def launch(name, *args, **kw):
            bias = args[7] if len(args) > 7 else kw.get("bias")
            if bias is not None:
                self.counts[name] += 1
            return self._orig(name, *args, **kw)

        flash._launch = launch
        return self

    def __exit__(self, *exc):
        self._mod._launch = self._orig


def _model_step(np, torch, card, label, model, loss, batch, tokens,
                flops):
    """A model through ``build_model_train_step`` (AdamW, bf16 compute) on
    a resident batch: STEP_WARM + STEP_TIMED steps on the host clock, a
    profiled one; asserts 12 launches of each flash kernel a step and
    returns the run's flash launches, biased launches and numbers."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models.step_builder import build_model_train_step

    step, params, bufs, opt = build_model_train_step(
        model, loss, optimizer="adamw", lr=1e-4, weight_decay=0.01,
        compute_dtype="bfloat16")
    arrays = tuple(torch.as_tensor(a, device="cuda") for a in batch)
    n = STEP_WARM + STEP_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with _BiasSpy() as spy:
        state, losses, times = _timed_steps(
            np, torch, step, (params, bufs, opt), iter([arrays] * n))
    total = {k: KERNELS[k] for k in FLASH}
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = _profile(torch, f"{label} generic step",
                    lambda: step(*state, *arrays))
    step_s = float(np.mean(times[STEP_WARM:]))
    mfu = flops / step_s / BF16_FLOPS
    log(f"{label} generic step (AdamW, bf16; {card}): "
        f"{1e3 * step_s:.1f} ms a step (timed "
        f"{[round(1e3 * t, 1) for t in times[STEP_WARM:]]}, warm-up "
        f"{[round(1e3 * t, 1) for t in times[:STEP_WARM]]}), "
        f"{tokens / step_s:.0f} {'images' if 'ViT' in label else 'tokens'}"
        f"/s, MFU {100 * mfu:.2f}% of 989 TFLOP/s; max_memory_allocated "
        f"{peak:.2f} GiB; device busy {100 * busy:.1f}% of one profiled "
        f"step; losses {[round(x, 4) for x in losses]}; flash launches a "
        f"step {json.dumps({k: v // n for k, v in total.items()})}, with a "
        f"score bias {json.dumps({k: v // n for k, v in spy.counts.items()})}")
    if total != {k: 12 * n for k in FLASH}:
        raise AssertionError(f"{label} launched {total}, expected 12 of "
                             f"each flash kernel a step")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}'s generic step: losses {losses}")
    del step, params, bufs, opt, state, arrays
    _free(torch)
    return total, spy.counts


def _vit_step(np, torch, card):
    """(a): ViT-base/16 at 224 px through the generic step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision import models

    c = VIT
    paddle.seed(0)
    model = getattr(models, c["arch"])(num_classes=c["classes"],
                                       img_size=c["img"])
    rng = np.random.RandomState(0)
    batch = (rng.rand(c["batch"], 3, c["img"], c["img"]).astype("float32"),
             rng.randint(0, c["classes"], (c["batch"], 1)))
    total, biased = _model_step(np, torch, card, "ViT-base/16", model,
                                _ce_loss, batch, c["batch"],
                                c["batch"] * vit_flops_per_image(c))
    if any(biased.values()):
        raise AssertionError(f"ViT-base launched biased kernels: {biased}")
    del model
    return total


def _ernie_batch(np, c, seed=0):
    """ids whose rows have a real length drawn from [seq / 2, seq] and pad
    id 0 after it, token types, masked positions among the real tokens,
    their labels and the sentence-order labels."""
    rng = np.random.RandomState(seed)
    b, s, m = c["batch"], c["seq"], c["masked"]
    lens = rng.randint(s // 2, s + 1, b)
    ids = rng.randint(1, c["vocab"], (b, s)).astype("int64")
    ids[np.arange(s)[None, :] >= lens[:, None]] = 0
    tt = (rng.rand(b, s) > 0.5).astype("int64")
    pos = np.stack([rng.choice(n, m, replace=False) + i * s
                    for i, n in enumerate(lens)]).astype("int64")
    mlm = ids.reshape(-1)[pos.reshape(-1)]
    sop = rng.randint(0, 2, (b, 1)).astype("int64")
    return (ids, tt, pos, mlm, sop), lens


def _ernie_loss(m, ids, token_type, pos, mlm_labels, sop_labels):
    from paddle_tpu_torch.models import ErniePretrainingCriterion

    mlm_logits, sop_logits = m(ids, token_type, masked_positions=pos)
    return ErniePretrainingCriterion()(
        mlm_logits, sop_logits, mlm_labels, sop_labels,
        masked_lm_scale=float(int(pos.shape[0]) * int(pos.shape[1])))


def _ernie_step(np, torch, card):
    """(b): ERNIE-3.0-base through the generic step; every flash launch
    carries the pad mask's bias."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_3_0_base

    c = ERNIE
    paddle.seed(0)
    model = ErnieForPretraining(ernie_3_0_base(
        vocab_size=c["vocab"], max_seq_len=c["seq"], dropout=0.0))
    batch, lens = _ernie_batch(np, c)
    log(f"ERNIE-3.0-base batch: real lengths {lens.tolist()} of "
        f"{c['seq']} ({100 * (1 - lens.sum() / lens.size / c['seq']):.1f}% "
        "pad tokens)")
    tokens = c["batch"] * c["seq"]
    fpt = bert_flops_per_token(c["hidden"], c["layers"], c["seq"],
                               c["vocab"], c["masked"] / c["seq"])
    total, biased = _model_step(np, torch, card, "ERNIE-3.0-base", model,
                                _ernie_loss, batch, tokens, tokens * fpt)
    if biased != total:
        raise AssertionError(f"ERNIE-3.0-base: {biased} of {total} flash "
                             "launches carried the pad mask's bias")
    del model
    return total


def _small_parity(np, torch):
    """(c): vit_tiny and ernie_3_0_micro (pad tails) through the generic
    step on the card and the CPU, fp32; returns ERNIE's flash launches on
    the card."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_3_0_micro
    from paddle_tpu_torch.vision.models import vit_tiny

    rng = np.random.RandomState(1)
    images = (rng.randn(4, 3, 32, 32).astype("float32"),
              rng.randint(0, 10, (4, 1)).astype("int64"))
    _step_parity(np, torch, "vit_tiny", vit_tiny, _ce_loss, images)
    c = dict(vocab=1000, batch=4, seq=64, masked=8)
    batch, _ = _ernie_batch(np, c, seed=1)
    reset_launch_counts()
    _step_parity(np, torch, "ernie_3_0_micro", lambda: ErnieForPretraining(
        ernie_3_0_micro(vocab_size=c["vocab"], max_seq_len=c["seq"])),
        _ernie_loss, batch)
    return {k: KERNELS[k] for k in FLASH}


def _ernie_example(np, torch):
    """(d): ``pretrain_bert.py --model ernie`` at a small size, 3 steps on
    the card and on the CPU from the same weights, fp32 (losses within
    1e-5 relative: the fp32 kernels with the pad mask's bias) and under
    ``amp.auto_cast()`` (bf16, within 2e-2); returns the card's flash
    launches by dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for amp, dt, tol in ((False, "fp32", 1e-5), (True, "bf16", 2e-2)):
        init, cpu, _, _, _ = _bert_run(np, torch, ERNIE_SMALL, 3, amp=amp,
                                       device="cpu")
        _, card, _, launches, _ = _bert_run(np, torch, ERNIE_SMALL, 3,
                                            amp=amp, state=init)
        _free(torch)
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        log(f"pretrain_bert --model ernie ({dt}), card vs cpu: losses card "
            f"{card} cpu {cpu}, rel err {rel:.3e} (tol {tol:g}); launches "
            f"{json.dumps(launches)}")
        if not rel <= tol:
            raise AssertionError(f"the ERNIE example ({dt}) on the card "
                                 "disagrees with the CPU")
        if launches != {k: 3 * 2 for k in FLASH}:
            raise AssertionError(f"the ERNIE example launched {launches}")
        out[dt] = launches
    return out


def phase_transformers(np, torch, card):
    """Phase 11: the biased flash kernels against their plain versions,
    timed at ViT-base's and ERNIE-3.0-base's attention; ViT-base and
    ERNIE-3.0-base at full width through ``build_model_train_step``;
    vit_tiny and ernie_3_0_micro card vs CPU; the ERNIE example card vs
    CPU.  Returns the kernels-line rows and each row's launches."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    _flash_biased(np, torch)
    rows = {}
    for label, b, s, kind in (("vit", VIT["batch"], 197, None),
                              ("ernie", ERNIE["batch"], ERNIE["seq"], "pad")):
        g = torch.Generator(device="cuda").manual_seed(7)
        q, k, v = _qkv_views(torch, g, "bnsd", b, 12, 12, s, 64,
                             torch.bfloat16)
        rows.update(_time_flash_model(np, torch, label, q, k, v,
                                      _mask(torch, g, kind, b, s)))
        del q, k, v
    vit = _vit_step(np, torch, card)
    ernie = _ernie_step(np, torch, card)
    small = _small_parity(np, torch)
    example = _ernie_example(np, torch)
    launches = {"vit": ("phase 11 (a) ViT-base/16 generic step bf16", vit,
                        {}),
                "ernie": ("phase 11 (b) ERNIE-3.0-base generic step bf16",
                          ernie, {
                              "phase 11 (c) ernie_3_0_micro fp32": small,
                              "phase 11 (d) pretrain_bert --model ernie "
                              "fp32": example["fp32"],
                              "phase 11 (d) pretrain_bert --model ernie "
                              "bf16": example["bf16"]})}
    log(card)
    return rows, launches


# -- phase 12 ----------------------------------------------------------------

# Transformer-base (Vaswani et al. 2017; nn.Transformer's defaults): d_model
# 512, 8 heads, 6 + 6 layers, FFN 2048, a shared 37000-token vocabulary
# with the output tied to the embedding, residual dropout 0.1 and no
# attention or activation dropout (tensor2tensor's transformer_base);
# batch 96 of 256 source and 200 target tokens, each row's real length
# drawn by the seed (source 128-256, target 100-200), pad id 0 after it;
# greedy decode of DECODE_TOKENS tokens at that batch over the memory
TRANSFORMER = dict(vocab=37000, d_model=512, heads=8, layers=6, ffn=2048,
                   batch=96, src=256, tgt=200, dropout=0.1)
DECODE_TOKENS = 32
TRANSFORMER_SMALL = dict(vocab=128, d_model=64, heads=4, layers=2, ffn=128,
                         batch=4, src=24, tgt=16, dropout=0.0)
# BASELINE config 4: DeepFM and wide&deep at RecConfig's widths (26 fields,
# 13 dense features, dim 16, tower 400-400-400) with 1,000,000 rows a
# field (a Criteo-sized table of 26M rows), batch 4096, Adam 1e-3
REC = dict(fields=26, vocab=1_000_000, batch=4096, lr=1e-3)
REC_SMALL = dict(fields=8, vocab=500, batch=256, lr=1e-3)
# the flash kernels with q and k of other lengths (D=64; bnsd head views
# as MultiHeadAttention hands them over, bsnd for GQA): label, layout, B,
# H, Hkv, Sq, Sk, causal, mask kind (``_mask``'s: "pad" the source padding,
# "neginf" the decoder's mask)
CROSS_CASES = (
    ("cross", "bnsd", 96, 8, 8, 200, 256, False, "pad"),
    ("causal_offset", "bnsd", 96, 8, 8, 64, 256, True, None),
    ("decode", "bnsd", 96, 8, 8, 1, 256, False, "pad"),
    ("gqa_cross", "bsnd", 8, 8, 2, 200, 256, False, "full"),
    ("decoder_self", "bnsd", 8, 8, 8, 200, 200, False, "neginf"),
    ("more_queries", "bnsd", 8, 8, 8, 256, 200, False, None),
)


def _cross_inputs(torch, g, layout, b, h, hkv, sq, sk, d, dtype):
    """q of Sq rows and k, v of Sk rows: head views of one query and one
    fused key-value projection output, as cross-attention's projections
    give them."""
    q = torch.randn(b, sq, h * d, device="cuda", generator=g).to(dtype)
    kv = torch.randn(b, sk, 2 * hkv * d, device="cuda", generator=g).to(dtype)
    k, v = torch.split(kv, [hkv * d, hkv * d], dim=-1)
    q, k, v = (q.reshape(b, sq, h, d), k.reshape(b, sk, hkv, d),
               v.reshape(b, sk, hkv, d))
    if layout == "bnsd":
        return tuple(t.transpose(1, 2) for t in (q, k, v))
    return q, k, v


def _flash_cross(np, torch):
    """(a): the forward, dQ and dK/dV kernels with q and k of other lengths
    against their plain versions on the card, each tensor within FLASH_TOL,
    bf16 and fp32 (the backward kernels from the plain forward's out and
    lse); nothing is NaN where whole key tiles score -inf.  Then causal
    attention with more queries than keys: ``sdpa`` launches the kernels
    for it as for the same shape not causal."""
    from paddle_tpu_torch.kernels import KERNELS, flash_bwd_plain, \
        flash_fwd_plain, reset_launch_counts, sdpa
    from paddle_tpu_torch.kernels.flash import (_bias_of, _heads_shape,
                                                flash_bwd, flash_fwd_cuda)

    d = 64
    for case, layout, b, h, hkv, sq, sk, causal, kind in CROSS_CASES:
        for dt in ("bf16", "fp32"):
            dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dt]
            g = torch.Generator(device="cuda").manual_seed(sq + sk + h)
            q, k, v = _cross_inputs(torch, g, layout, b, h, hkv, sq, sk, d,
                                    dtype)
            mask = _mask(torch, g, kind, b, sq, h, sk)
            bias = None if mask is None else _bias_of(
                mask, q, layout, k, causal).expand(_heads_shape(q, layout, k))
            scale = 1.0 / np.sqrt(d)
            opts = (causal, scale, None, layout, bias)
            out, lse = flash_fwd_cuda(q, k, v, *opts)
            ref, rlse = flash_fwd_plain(q, k, v, *opts)
            do = torch.randn(ref.shape, device="cuda", generator=g).to(dtype)
            got = flash_bwd(q, k, v, ref, rlse, do, *opts)
            want = flash_bwd_plain(q, k, v, ref, rlse, do, *opts)
            torch.cuda.synchronize()
            for name, part, a, r in (("flash_fwd", "out", out, ref),
                                     ("flash_fwd", "lse", lse, rlse),
                                     ("flash_bwd_dq", "dq", got[0], want[0]),
                                     ("flash_bwd_dkv", "dk", got[1], want[1]),
                                     ("flash_bwd_dkv", "dv", got[2],
                                      want[2])):
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{name} {part} {case} ({dt}) is "
                                         "not finite")
                _flash_close(
                    f"{name} {part} {case} ({layout}, B={b} H={h} Hkv={hkv} "
                    f"Sq={sq} Sk={sk} D={d}, "
                    f"{'causal' if causal else 'not causal'}, {dt}, mask "
                    f"{kind})", a, r, *FLASH_TOL[dt][part])
            del q, k, v, bias, out, lse, ref, rlse, do, got, want
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = _cross_inputs(torch, g, "bnsd", 2, 8, 8, 256, 200, d,
                            torch.bfloat16)
    reset_launch_counts()
    sdpa(q, k, v)
    out = sdpa(q, k, v, is_causal=True)
    log(f"causal Sq=256 over Sk=200: sdpa launched {KERNELS['flash_fwd']} "
        f"forward kernels (with the same shape not causal)")
    if KERNELS["flash_fwd"] != 2 or not torch.isfinite(out).all():
        raise AssertionError(f"sdpa at Sq > Sk launched {KERNELS}")
    torch.cuda.empty_cache()


def _sinusoid(np, n, d):
    pos = np.arange(n)[:, None] / np.power(10000.0, np.arange(0, d, 2) / d)
    table = np.zeros((n, d), "float32")
    table[:, 0::2], table[:, 1::2] = np.sin(pos), np.cos(pos)
    return table


def _seq2seq(np, c):
    """A Transformer translation model from the API's layers: token
    embedding times sqrt(d_model) plus sinusoidal positions,
    ``nn.Transformer`` (post-norm, ReLU), logits by the embedding's
    transpose (tied)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    d = c["d_model"]

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            # N(0, d^-1/2), tensor2tensor's, so that the tied logits
            # start near unit scale
            self.embedding = nn.Embedding(c["vocab"], d, weight_attr=(
                paddle.ParamAttr(initializer=nn.initializer.Normal(
                    0.0, d ** -0.5))))
            self.transformer = nn.Transformer(
                d, c["heads"], c["layers"], c["layers"], c["ffn"],
                dropout=c["dropout"], attn_dropout=0.0, act_dropout=0.0)
            self.dropout = nn.Dropout(c["dropout"])
            self._pos = _sinusoid(np, max(c["src"], c["tgt"]) + 64, d)

        def embed(self, ids, start=0):
            x = self.embedding(ids) * float(np.sqrt(d))
            pos = paddle.to_tensor(self._pos[start:start + ids.shape[1]])
            return self.dropout(x + paddle.cast(pos, x.dtype))

        def logits(self, h):
            return paddle.matmul(h, self.embedding.weight, transpose_y=True)

        def forward(self, src, tgt, src_mask, tgt_mask):
            h = self.transformer(self.embed(src), self.embed(tgt), src_mask,
                                 tgt_mask, src_mask)
            return self.logits(h)

    return Seq2Seq()


def _seq2seq_batch(np, c, seed=0):
    """Source and target ids with pad tails of the seed's lengths (pad id
    0, BOS 1), the decoder's input and labels, the source key-padding bias
    [B, 1, 1, Ss] and the decoder's mask [B, 1, St, St]
    (``generate_square_subsequent_mask`` plus the target padding)."""
    from paddle_tpu_torch import nn

    rng = np.random.RandomState(seed)
    b, ss, st = c["batch"], c["src"], c["tgt"]
    src = rng.randint(3, c["vocab"], (b, ss)).astype("int64")
    tgt = rng.randint(3, c["vocab"], (b, st + 1)).astype("int64")
    src_len = rng.randint(ss // 2, ss + 1, b)
    tgt_len = rng.randint(st // 2, st + 2, b)
    src[np.arange(ss)[None, :] >= src_len[:, None]] = 0
    tgt[np.arange(st + 1)[None, :] >= tgt_len[:, None]] = 0
    tgt[:, 0] = 1
    src_mask = np.where(src == 0, -1e9, 0.0).astype("float32")[:, None, None]
    causal = nn.Transformer.generate_square_subsequent_mask(None, st)
    pad = np.where(tgt[:, :-1] == 0, -1e9, 0.0).astype("float32")
    tgt_mask = (causal.numpy()[None, None] + pad[:, None, None]).astype(
        "float32")
    return (src, tgt[:, :-1], tgt[:, 1:], src_mask, tgt_mask), (src_len,
                                                                tgt_len)


def _seq2seq_loss(m, src, tgt_in, tgt_out, src_mask, tgt_mask):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F

    logits = m(src, tgt_in, src_mask, tgt_mask)
    v = logits.shape[-1]
    return F.cross_entropy(paddle.reshape(logits, [-1, v]),
                           paddle.reshape(tgt_out, [-1, 1]))


def transformer_flops_per_step(c):
    """Training flops of one step, 6 x the forward's multiply-adds: per
    encoder layer and source token 4 d^2 (the projections) + 2 d f (the
    FFN) + 2 Ss d (attention's two products); per decoder layer and target
    token 4 d^2 + 2 St d (self-attention) + 2 d^2 + 2 Ss d (cross: q and
    out; k and v per source token, 2 d^2) + 2 d f; the tied logits d V per
    target token."""
    d, f, n = c["d_model"], c["ffn"], c["layers"]
    b, ss, st = c["batch"], c["src"], c["tgt"]
    enc = n * ss * (4 * d * d + 2 * d * f + 2 * ss * d)
    dec = n * (st * (4 * d * d + 2 * st * d + 2 * d * d + 2 * ss * d
                     + 2 * d * f) + ss * 2 * d * d)
    return 6.0 * b * (enc + dec + st * d * c["vocab"])


class _CrossSpy(_BiasSpy):
    """:class:`_BiasSpy` that also counts the launches whose q and k have
    other lengths (cross-attention), by kernel."""

    def __enter__(self):
        super().__enter__()
        self.cross = dict.fromkeys(FLASH, 0)
        inner = self._mod._launch

        def launch(name, *args, **kw):
            dims = args[2]
            if dims[3] != dims[4]:
                self.cross[name] += 1
            return inner(name, *args, **kw)

        self._mod._launch = launch
        return self


def _transformer_step(np, torch, card):
    """(b): Transformer-base through ``build_model_train_step`` (AdamW,
    bf16 compute, fp32 masters) on a resident batch: STEP_WARM +
    STEP_TIMED steps, one profiled; asserts 18 launches of each flash
    kernel a step (6 encoder self-attention, 6 decoder self-attention, 6
    cross-attention at Sq=200, Sk=256), every one biased.  Returns the
    model (its weights as built), the batch's source ids and mask, and
    the launches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models.step_builder import build_model_train_step

    c = TRANSFORMER
    paddle.seed(0)
    model = _seq2seq(np, c)
    batch, (src_len, tgt_len) = _seq2seq_batch(np, c)
    n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
    log(f"Transformer-base: {n_params / 1e6:.1f}M parameters; source "
        f"lengths {int(src_len.min())}-{int(src_len.max())} of {c['src']} "
        f"({int(src_len.sum())} real tokens), target "
        f"{int(tgt_len.min())}-{int(tgt_len.max())} of {c['tgt'] + 1}")
    step, params, bufs, opt = build_model_train_step(
        model, _seq2seq_loss, optimizer="adamw", lr=1e-4, weight_decay=0.01,
        compute_dtype="bfloat16")
    arrays = tuple(torch.as_tensor(a, device="cuda") for a in batch)
    n = STEP_WARM + STEP_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with _CrossSpy() as spy:
        state, losses, times = _timed_steps(
            np, torch, step, (params, bufs, opt), iter([arrays] * n))
    total = {k: KERNELS[k] for k in FLASH}
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = _profile(torch, "Transformer-base generic step",
                    lambda: step(*state, *arrays))
    step_s = float(np.mean(times[STEP_WARM:]))
    src_tok, tgt_tok = c["batch"] * c["src"], c["batch"] * c["tgt"]
    flops = transformer_flops_per_step(c)
    log(f"Transformer-base generic step (AdamW, bf16, dropout "
        f"{c['dropout']}; {card}): {1e3 * step_s:.1f} ms a step (timed "
        f"{[round(1e3 * t, 1) for t in times[STEP_WARM:]]}, warm-up "
        f"{[round(1e3 * t, 1) for t in times[:STEP_WARM]]}), "
        f"{src_tok / step_s:.0f} source + {tgt_tok / step_s:.0f} target "
        f"tokens/s, MFU {100 * flops / step_s / BF16_FLOPS:.2f}% of 989 "
        f"TFLOP/s ({flops:.4g} flop a step); max_memory_allocated "
        f"{peak:.2f} GiB; device busy {100 * busy:.1f}% of one profiled "
        f"step; losses {[round(x, 4) for x in losses]}; flash launches a "
        f"step {json.dumps({k: v // n for k, v in total.items()})}, with a "
        f"score bias {json.dumps({k: v // n for k, v in spy.counts.items()})}"
        f", cross-attention {json.dumps({k: v // n for k, v in spy.cross.items()})}")
    want = {k: 18 * n for k in FLASH}
    if (total != want or spy.counts != want
            or spy.cross != {k: 6 * n for k in FLASH}):
        raise AssertionError(f"Transformer-base launched {total} (biased "
                             f"{spy.counts}, cross {spy.cross}); expected 18 "
                             "of each a step, all biased, 6 cross")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"Transformer-base's generic step: losses "
                             f"{losses}")
    del step, params, bufs, opt, state, arrays
    _free(torch)
    return model, batch[0], batch[3], total


def _greedy(np, paddle, model, src, src_mask, steps, keep_logits=False):
    """Greedy decoding from BOS through ``TransformerDecoder.gen_cache``,
    each step's token chosen on the model's device: the tokens (numpy,
    read back once) and, with ``keep_logits``, each step's logits."""
    m = paddle.to_tensor(src_mask)
    memory = model.transformer.encoder(model.embed(paddle.to_tensor(src)), m)
    cache = model.transformer.decoder.gen_cache(memory)
    tok = paddle.to_tensor(np.ones((src.shape[0], 1), "int64"))
    toks, logits = [], []
    for t in range(steps):
        h, cache = model.transformer.decoder(model.embed(tok, start=t),
                                             memory, None, m, cache)
        out = model.logits(h)
        tok = paddle.argmax(out, axis=-1)
        toks.append(tok)
        if keep_logits:
            logits.append(out)
    toks = paddle.concat(toks, axis=1).numpy()
    if keep_logits:
        return toks, paddle.concat(logits, axis=1).numpy()
    return toks


def _transformer_decode(np, torch, card, model, src, src_mask):
    """(c): greedy decode of DECODE_TOKENS tokens at batch 96 over the
    memory of (b)'s source batch, fp32, under ``no_grad`` (the ``Cache``
    grows in place): ms a token and 12 forward launches a token asserted
    (6 against the growing ``Cache``, 6 against the ``StaticCache`` with
    the source padding's bias); returns the run's launches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    model.eval()
    with paddle.no_grad():
        _greedy(np, paddle, model, src, src_mask, 2)          # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        with _CrossSpy() as spy:
            t0 = time.perf_counter()
            toks = _greedy(np, paddle, model, src, src_mask, DECODE_TOKENS)
            wall = time.perf_counter() - t0
        total = {k: KERNELS[k] for k in FLASH}
        busy = _profile(torch, "Transformer-base greedy decode, 4 tokens",
                        lambda: _greedy(np, paddle, model, src, src_mask, 4))
    log(f"Transformer-base greedy decode ({card}): {DECODE_TOKENS} tokens at "
        f"batch {src.shape[0]} over a memory of {src.shape[1]}: "
        f"{1e3 * wall / DECODE_TOKENS:.2f} ms a token (host clock, "
        f"encoder included), device busy {100 * busy:.1f}% (4 tokens "
        f"profiled); flash launches {json.dumps(total)} "
        f"({total.get('flash_fwd', 0) / DECODE_TOKENS:.1f} a token, biased "
        f"{spy.counts.get('flash_fwd')}, q and k of other lengths "
        f"{spy.cross.get('flash_fwd')}); first row's tokens "
        f"{toks[0, :12].tolist()}")
    # the encoder's 6 self-attention launches, then 12 a token
    want = {k: 6 + 12 * DECODE_TOKENS if k == "flash_fwd" else 0
            for k in FLASH}
    cross = {k: 12 * DECODE_TOKENS if k == "flash_fwd" else 0 for k in FLASH}
    if total != want or spy.cross != cross:
        raise AssertionError(f"greedy decode launched {total} (cross "
                             f"{spy.cross}); expected 6 + 12 a token")
    model.train()
    return total


def _transformer_small_parity(np, torch):
    """(d): a small Transformer (2 + 2 layers, d 64) through the generic
    step on the card and the CPU, 3 fp32 steps (losses within 1e-5), and
    greedy decoding card vs CPU from the same weights, token for token."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.weights import load_paddle_state_dict

    c = TRANSFORMER_SMALL
    batch, _ = _seq2seq_batch(np, c, seed=2)
    _step_parity(np, torch, "Transformer (2 + 2, d 64)",
                 lambda: _seq2seq(np, c), _seq2seq_loss, batch)
    models = {}
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        with unique_name.guard():
            paddle.seed(0)
            models[dev] = _seq2seq(np, c)
    load_paddle_state_dict(models["gpu"], {
        k: v.numpy() for k, v in models["cpu"].state_dict().items()})
    toks, logits = {}, {}
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        models[dev].eval()
        with paddle.no_grad():
            toks[dev], logits[dev] = _greedy(np, paddle, models[dev],
                                             batch[0], batch[3], 12, True)
    paddle.set_device("gpu")
    rel = float(np.abs(logits["gpu"] - logits["cpu"]).max()
                / np.abs(logits["cpu"]).max())
    log(f"small Transformer greedy decode, card vs cpu: "
        f"{toks['gpu'].tolist()} vs {toks['cpu'].tolist()}; each step's "
        f"logits within {rel:.3e} of the largest (tol 1e-5)")
    if not (np.array_equal(toks["gpu"], toks["cpu"]) and rel <= 1e-5):
        raise AssertionError("greedy decoding on the card disagrees with "
                             "the CPU")
    del models
    _free(torch)


def _rec_batches(np, cfg, n, batch):
    from paddle_tpu_torch.models import synthetic_click_batch

    return [synthetic_click_batch(cfg, batch, seed=i) for i in range(n)]


def _rec_loss(m, ids, dense, label):
    from paddle_tpu_torch.nn import functional as F

    return F.binary_cross_entropy_with_logits(m(ids, dense), label)


def _rec_runs(np, torch, card):
    """(e): DeepFM and wide&deep at 26 fields x 1,000,000 rows, batch 4096:
    eagerly (``loss.backward()``, ``Adam.step()``, as the example) and
    through ``build_model_train_step`` (AdamW without weight decay), with
    dense gradients and updates; the batches made before the timed window
    (each draws the table's hidden logits, 26M normals, on the host)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.models import DeepFM, RecConfig, WideDeep
    from paddle_tpu_torch.models.step_builder import build_model_train_step

    c = REC
    cfg = RecConfig(field_vocab_sizes=(c["vocab"],) * c["fields"])
    t0 = time.perf_counter()
    batches = _rec_batches(np, cfg, STEP_WARM + STEP_TIMED, c["batch"])
    log(f"rec batches: {len(batches)} of {c['batch']} in "
        f"{time.perf_counter() - t0:.1f} s on the host")
    cuda = [tuple(torch.as_tensor(a, device="cuda") for a in b)
            for b in batches]
    for name, cls in (("DeepFM", DeepFM), ("wide&deep", WideDeep)):
        paddle.seed(0)
        model = cls(cfg)
        n_params = sum(int(np.prod(p.shape)) for p in model.parameters())
        o = opt.Adam(c["lr"], parameters=model.parameters())

        def eager(ids, dense, label):
            loss = _rec_loss(model, paddle.to_tensor(ids),
                             paddle.to_tensor(dense), paddle.to_tensor(label))
            loss.backward()
            o.step()
            o.clear_grad()
            return loss

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for b in cuda:
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(eager(*b).numpy()))
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = _profile(torch, f"{name} eager step", lambda: eager(*cuda[0]))
        step_s = float(np.mean(times[STEP_WARM:]))
        log(f"{name} eager (Adam {c['lr']}, fp32, dense; {card}): "
            f"{n_params / 1e6:.1f}M parameters, {1e3 * step_s:.2f} ms a "
            f"step (timed {[round(1e3 * t, 2) for t in times[STEP_WARM:]]})"
            f", {c['batch'] / step_s:.0f} examples/s; max_memory_allocated "
            f"{peak:.2f} GiB; device busy {100 * busy:.1f}%; losses "
            f"{[round(x, 4) for x in losses]}")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{name} eager: losses {losses}")
        # the generic step from the same initial weights
        del o, eager, model
        _free(torch)
        paddle.seed(0)
        model = cls(cfg)
        step, params, bufs, ost = build_model_train_step(
            model, _rec_loss, optimizer="adamw", lr=c["lr"],
            weight_decay=0.0, compute_dtype=None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, losses, times = _timed_steps(np, torch, step,
                                            (params, bufs, ost), iter(cuda))
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = _profile(torch, f"{name} generic step",
                        lambda: step(*state, *cuda[0]))
        step_s = float(np.mean(times[STEP_WARM:]))
        log(f"{name} generic step (AdamW {c['lr']}, no decay, fp32; {card}):"
            f" {1e3 * step_s:.2f} ms a step (timed "
            f"{[round(1e3 * t, 2) for t in times[STEP_WARM:]]}), "
            f"{c['batch'] / step_s:.0f} examples/s; max_memory_allocated "
            f"{peak:.2f} GiB; device busy {100 * busy:.1f}%; losses "
            f"{[round(x, 4) for x in losses]}")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{name} generic step: losses {losses}")
        del step, params, bufs, ost, state, model
        _free(torch)
    del cuda, batches
    _free(torch)


def _rec_small_parity(np, torch):
    """(f): a small DeepFM, 10 fp32 Adam steps of the example's loop on the
    card and on the CPU from the same weights (losses within 1e-5
    relative) and its held-out AUC (within 1e-4)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.examples.train_deepfm import (held_out_auc,
                                                        train_step)
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import DeepFM, RecConfig
    from paddle_tpu_torch.weights import load_paddle_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    c = REC_SMALL
    cfg = RecConfig(field_vocab_sizes=(c["vocab"],) * c["fields"])
    batches = _rec_batches(np, cfg, 10, c["batch"])
    runs, state = {}, None
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        with unique_name.guard():
            paddle.seed(0)
            model = DeepFM(cfg)
        if state is None:
            state = {k: v.numpy() for k, v in model.state_dict().items()}
        else:
            load_paddle_state_dict(model, state)
        o = opt.Adam(c["lr"], parameters=model.parameters())
        losses = [float(train_step(model, o, b).numpy()) for b in batches]
        runs[dev] = (losses, held_out_auc(cfg, model, batch=4096))
    paddle.set_device("gpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["gpu"][0],
                                                  runs["cpu"][0]))
    auc = abs(runs["gpu"][1] - runs["cpu"][1])
    log(f"small DeepFM, card vs cpu over 10 Adam steps: losses "
        f"{[round(x, 6) for x in runs['gpu'][0]]} vs "
        f"{[round(x, 6) for x in runs['cpu'][0]]}, worst rel {rel:.3e} (tol "
        f"1e-5); held-out AUC {runs['gpu'][1]:.6f} vs {runs['cpu'][1]:.6f} "
        f"(|diff| {auc:.2e}, tol 1e-4)")
    if not (rel <= 1e-5 and auc <= 1e-4):
        raise AssertionError("the small DeepFM on the card disagrees with "
                             "the CPU")
    _free(torch)


def phase_seq2seq_rec(np, torch, card):
    """Phase 12: the flash kernels with q and k of other lengths against
    their plain versions, timed at the Transformer's cross-attention, a
    causal chunk over a longer cache and a decode step; Transformer-base
    through the generic step and greedy decode; the small Transformer
    card vs CPU; DeepFM and wide&deep at 26M rows, eager and through the
    generic step; the small DeepFM card vs CPU.  Returns the kernels-line
    rows and each row's launches."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    _flash_cross(np, torch)
    c = TRANSFORMER
    rows = {}
    for label, sq, causal, kind, dtype in (
            ("cross", c["tgt"], False, "pad", torch.bfloat16),
            ("causal_offset", 64, True, None, torch.bfloat16),
            ("decode", 1, False, "pad", torch.float32)):
        g = torch.Generator(device="cuda").manual_seed(sq)
        q, k, v = _cross_inputs(torch, g, "bnsd", c["batch"], c["heads"],
                                c["heads"], sq, c["src"], 64, dtype)
        rows.update(_time_flash_model(
            np, torch, label, q, k, v,
            _mask(torch, g, kind, c["batch"], sq, sk=c["src"]), causal,
            backward=label != "decode"))
        del q, k, v
    model, src, src_mask, trained = _transformer_step(np, torch, card)
    decoded = _transformer_decode(np, torch, card, model, src, src_mask)
    del model
    _free(torch)
    _transformer_small_parity(np, torch)
    _rec_runs(np, torch, card)
    _rec_small_parity(np, torch)
    launches = {"cross": ("phase 12 (b) Transformer-base generic step bf16",
                          trained),
                "causal_offset": ("phase 12 (b) Transformer-base generic "
                                  "step bf16 (a timing row: no run at this "
                                  "shape)", trained),
                "decode": ("phase 12 (c) Transformer-base greedy decode "
                           "fp32", decoded)}
    log(card)
    return rows, launches


# -- phase 13 ----------------------------------------------------------------

# graph mode: (a) BASELINE config 0, the fluid LeNet of
# paddle_tpu_torch/examples/fluid_mnist.py (30 steps, batch 64), on the card
# against the same script on the CPU from the CPU's initial weights; (b)
# BERT-base (BERT_STEP's shape, AdamW lr 1e-4, wd 0.01, dropout 0) as a
# static program on a resident batch, STEP_WARM + STEP_TIMED steps, held to
# the eager port's model on the same weights; (c) the same program under
# static.amp.decorate (bf16) against the eager model under auto_cast; (d)
# (b)'s trained program saved as an inference model, reloaded and run
# against the eager model's eval forward.  Tolerances: (a) losses 1e-4
# relative with exact fp32 convolutions, 1e-3 with cuDNN's (see
# _static_mnist); (b) losses 1e-5 relative and each sampled parameter's update
# within UPDATE_RTOL (phase 10's generic-step parity); (c) losses 2e-2
# relative and updates within 2e-2 (FLASH_TOL's bf16 rtol); (d) FLASH_TOL
# fp32 on the logits.
MNIST_ARGS = ["--steps", "30", "--batch", "64"]
STATIC_LR, STATIC_WD = 1e-4, 0.01
STATIC_TOL = {"fp32": (1e-5, UPDATE_RTOL), "bf16": (2e-2, 2e-2)}
# the parameters whose updates (b) and (c) compare: the tied embedding, a
# first- and a last-layer weight, a LayerNorm scale and the heads
STATIC_SAMPLE = ("bert.word_embeddings.weight", "bert.layers.0.attn.qkv.weight",
                 "bert.layers.11.fc2.weight", "bert.layers.5.ln2.weight",
                 "transform.weight", "nsp.weight")


def _static_mnist(np, torch):
    """(a) the fluid LeNet on the card from the CPU run's initial weights
    (TF32 off): the loss falls; the losses within 1e-4 relative of the
    CPU's with the card's convolutions in exact fp32 (cuDNN off: PyTorch's
    own im2col + SGEMM), and within 1e-3 with cuDNN's algorithms (whose
    weight gradients differ from the CPU's by more than fp32 rounding, a
    difference that 30 Adam steps amplify; logged)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.examples import fluid_mnist as ex

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    quiet = lambda msg: None  # noqa: E731
    cpu, _, state = ex.run(ex.parse_args(MNIST_ARGS + ["--device", "cpu"]),
                           log=quiet)
    gpu = ex.parse_args(MNIST_ARGS + ["--device", "gpu"])
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        exact, _, _ = ex.run(gpu, init_state=state, log=quiet)
    t0 = time.perf_counter()
    card, accs, _ = ex.run(gpu, init_state=state, log=quiet)
    secs = time.perf_counter() - t0
    paddle.set_device("gpu")

    def worst(got):
        return max(abs(a - b) / abs(b) for a, b in zip(got, cpu))

    rel_exact, rel = worst(exact), worst(card)
    log(f"fluid LeNet (BASELINE config 0), {len(card)} steps at "
        f"{' '.join(MNIST_ARGS)} on the card in {secs:.2f} s: loss "
        f"{card[0]:.4f} -> {card[-1]:.4f}, accuracy {accs[0]:.3f} -> "
        f"{accs[-1]:.3f}; card vs cpu worst rel {rel_exact:.3e} with exact "
        f"fp32 convolutions (tol 1e-4), {rel:.3e} with cuDNN's (tol 1e-3)")
    if not (np.all(np.isfinite(card)) and card[-1] < card[0]):
        raise AssertionError(f"the fluid LeNet did not train: {card}")
    if not (rel_exact <= 1e-4 and rel <= 1e-3):
        raise AssertionError("the fluid LeNet on the card disagrees with the "
                             "CPU")


def _static_batch(np, torch, c):
    """BERT_STEP's batch on the card (as phase 10 (c) draws it), the
    masked positions flat over the batch."""
    rng = np.random.RandomState(0)
    b, s, m = c["batch"], c["seq"], c["masked"]
    ids = rng.randint(0, c["vocab"], (b, s)).astype("int64")
    tt = (rng.rand(b, s) > 0.5).astype("int64")
    pos = np.stack([rng.choice(s, m, replace=False) + i * s
                    for i in range(b)]).astype("int64").reshape(-1)
    mlm = ids.reshape(-1)[pos].reshape(-1, 1)
    nsp = rng.randint(0, 2, (b, 1)).astype("int64")
    return {k: torch.as_tensor(v, device="cuda") for k, v in
            dict(ids=ids, tt=tt, pos=pos, mlm=mlm, nsp=nsp).items()}


def _bert_cfg(c):
    from paddle_tpu_torch.models import BertConfig

    return BertConfig(vocab_size=c["vocab"], hidden_size=c["hidden"],
                      num_layers=c["layers"], num_heads=c["heads"],
                      max_seq_len=c["seq"], dropout=0.0)


def _static_bert_program(c, amp):
    """BERT-base and its criterion built under a fresh program pair and
    fresh unique names, AdamW's minimize appended (through
    static.amp.decorate for bf16)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import (BertForPretraining,
                                         BertPretrainingCriterion)

    b, s, m = c["batch"], c["seq"], c["masked"]
    main, startup = static.Program(), static.Program()
    paddle.enable_static()
    try:
        with static.program_guard(main, startup), unique_name.guard():
            model = BertForPretraining(_bert_cfg(c))
            crit = BertPretrainingCriterion()
            ids = static.data("ids", [b, s], "int64")
            tt = static.data("tt", [b, s], "int64")
            pos = static.data("pos", [b * m], "int64")
            mlm = static.data("mlm", [b * m, 1], "int64")
            nsp = static.data("nsp", [b, 1], "int64")
            logits, nsp_logits = model(ids, tt, masked_positions=pos)
            loss = crit(logits, nsp_logits, mlm, nsp,
                        masked_lm_scale=float(b * m))
            opt = paddle.optimizer.AdamW(learning_rate=STATIC_LR,
                                         weight_decay=STATIC_WD)
            if amp:
                opt = static.amp.decorate(opt)
            opt.minimize(loss)
    finally:
        paddle.disable_static()
    return main, startup, loss, [ids, tt, pos], [logits, nsp_logits]


def _eager_bert(np, torch, c, state):
    """The eager port's BERT-base on the card, each parameter set from
    ``state`` by its unique name (the static program's names)."""
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import (BertForPretraining,
                                         BertPretrainingCriterion)

    with unique_name.guard():
        model = BertForPretraining(_bert_cfg(c))
    for _, p in model.named_parameters():
        p.set_value(state[p.name])
    return model, BertPretrainingCriterion()


def _eager_bert_steps(np, torch, c, model, crit, batch, steps, amp):
    import paddle_tpu_torch as paddle

    opt = paddle.optimizer.AdamW(learning_rate=STATIC_LR,
                                 parameters=model.parameters(),
                                 weight_decay=STATIC_WD)
    args = [paddle.Tensor(batch[k]) for k in ("ids", "tt", "pos", "mlm",
                                                "nsp")]
    scale = float(c["batch"] * c["masked"])
    losses = []
    for _ in range(steps):
        with paddle.amp.auto_cast(enable=amp, dtype="bfloat16"):
            logits, nsp_logits = model(args[0], args[1],
                                       masked_positions=args[2])
            loss = crit(logits, nsp_logits, args[3], args[4],
                        masked_lm_scale=scale)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses


def _static_bert(np, torch, card, dt, init=None):
    """(b) fp32 or (c) bf16: BERT-base as a static program against the
    eager model on the same weights.  Returns the flash launches a step,
    the initial weights (numpy, by name), the trained program's pieces
    and the eager model (for (d))."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework.scope import Scope, scope_guard
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.static.io import _host

    c = BERT_STEP
    amp = dt == "bf16"
    steps = STEP_WARM + STEP_TIMED
    paddle.set_device("gpu")
    t0 = time.perf_counter()
    main, startup, loss, feeds, fetches = _static_bert_program(c, amp)
    build_s = time.perf_counter() - t0
    scope = Scope()
    exe = static.Executor(paddle.CUDAPlace(0))
    with scope_guard(scope):
        exe.run(startup)
        if init is not None:
            static.set_program_state(main, init)
        params = [p.name for p in main.all_parameters()]
        start = {n: _host(scope.find_var(n)) for n in params}
        batch = _static_batch(np, torch, c)
        feed = {"ids": batch["ids"], "tt": batch["tt"], "pos": batch["pos"],
                "mlm": batch["mlm"], "nsp": batch["nsp"]}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, times = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
            times.append(time.perf_counter() - t1)
            losses.append(float(lv))
        total = {k: KERNELS[k] for k in FLASH}
        peak = torch.cuda.max_memory_allocated() / 2**30
        ops = exe.last_run_ops
        # the weights after the compared steps (the runs below move them)
        trained = {n: scope.find_var(n).clone() for n in params}
        # the host's cost: one run whose fetch stays on the card, timed
        # without a synchronisation (an upper bound where the launch queue
        # fills and the host waits for the card)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)
        host_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        busy = _profile(torch, f"static BERT-base {dt} step",
                        lambda: exe.run(main, feed=feed, fetch_list=[loss]))
    step_s = float(np.mean(times[STEP_WARM:]))
    b, s, m = c["batch"], c["seq"], c["masked"]
    fpt = bert_flops_per_token(c["hidden"], c["layers"], s, c["vocab"], m / s)
    mfu = b * s / step_s * fpt / BF16_FLOPS
    log(f"static BERT-base {dt} (AdamW, B={b} S={s} {m} masked; {card}): "
        f"program of {ops} ops built in {build_s:.2f} s; "
        f"{1e3 * step_s:.1f} ms a step (timed "
        f"{[round(1e3 * t, 1) for t in times[STEP_WARM:]]}, warm-up "
        f"{[round(1e3 * t, 1) for t in times[:STEP_WARM]]}), "
        f"{b * s / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of 989 "
        f"TFLOP/s; max_memory_allocated {peak:.2f} GiB; device busy "
        f"{100 * busy:.1f}% of one profiled step; {ops} ops a step, "
        f"{1e6 * host_s / ops:.1f} us host an op ({1e3 * host_s:.1f} ms to "
        f"enqueue a step); losses {[round(x, 4) for x in losses]}; flash "
        f"launches {json.dumps(total)}")
    want = {k: c["layers"] * steps for k in FLASH}
    if total != want:
        raise AssertionError(f"static BERT-base {dt} launched {total}, "
                             f"expected {want} (one forward a layer a step)")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"static BERT-base {dt}: losses {losses}")

    model, crit = _eager_bert(np, torch, c, start)
    eager = _eager_bert_steps(np, torch, c, model, crit, batch, steps, amp)
    tol_loss, tol_update = STATIC_TOL[dt]
    rel = max(abs(a - e) / abs(e) for a, e in zip(losses, eager))
    named = dict(model.named_parameters())
    ratios = {}
    for key in STATIC_SAMPLE:
        p = named[key]
        got = trained[p.name].float()
        want_t, init_t = p._t.detach().float(), torch.as_tensor(
            start[p.name], device="cuda").float()
        ratios[key] = ((got - want_t).norm() / (want_t - init_t).norm()).item()
    log(f"static BERT-base {dt} vs the eager model on the same weights over "
        f"{steps} steps: losses {[round(x, 6) for x in losses]} vs "
        f"{[round(x, 6) for x in eager]}, worst rel {rel:.3e} (tol "
        f"{tol_loss:g}); update ratios "
        + ", ".join(f"{k} {v:.3e}" for k, v in ratios.items())
        + f" (tol {tol_update:g})")
    if not (rel <= tol_loss and max(ratios.values()) <= tol_update):
        raise AssertionError(f"static BERT-base {dt} disagrees with the "
                             "eager model")
    per_step = {k: v // steps for k, v in total.items()}
    return per_step, start, (main, scope, feeds, fetches, batch), model


def _static_inference(np, torch, trained, model):
    """(d) (b)'s program saved by save_inference_model, reloaded and run
    once: 12 flash_fwd launches and no backward launch, the logits within
    FLASH_TOL fp32 of the eager model's eval forward on the trained
    weights."""
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework.scope import Scope, scope_guard
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    main, scope, feeds, fetches, batch = trained
    exe = static.Executor(paddle.CUDAPlace(0))
    with tempfile.TemporaryDirectory() as d, scope_guard(scope):
        prefix = os.path.join(d, "bert_base")
        static.save_inference_model(prefix, feeds, fetches, exe,
                                    program=main)
        for _, p in model.named_parameters():
            p.set_value(scope.find_var(p.name))
        with scope_guard(Scope()):
            prog, feed_names, fetch_names = static.load_inference_model(
                prefix, exe)
            reset_launch_counts()
            got = exe.run(prog, feed={n: batch[k] for n, k in
                                      zip(feed_names, ("ids", "tt", "pos"))},
                          fetch_list=fetch_names, return_numpy=False)
            torch.cuda.synchronize()
            launches = {k: KERNELS[k] for k in FLASH}
    model.eval()
    with paddle.no_grad():
        want = model(paddle.Tensor(batch["ids"]), paddle.Tensor(batch["tt"]),
                     masked_positions=paddle.Tensor(batch["pos"]))
    log(f"static BERT-base inference program ({len(prog.global_block().ops)} "
        f"ops after pruning) reloaded: launches {json.dumps(launches)}")
    for label, g, w in zip(("mlm logits", "nsp logits"), got, want):
        _flash_close(f"reloaded inference program vs eager eval, {label}",
                     g._t.float(), w._t.float(), *FLASH_TOL["fp32"]["out"])
    want = {k: BERT_STEP["layers"] if k == "flash_fwd" else 0 for k in FLASH}
    if launches != want:
        raise AssertionError(f"the inference program launched {launches}, "
                             f"expected {want}")


def phase_static(np, torch, card):
    """Phase 13: graph mode (see the comment above MNIST_ARGS).  Returns
    each flash kernel's launches a step of the static BERT-base program,
    by dtype."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    _static_mnist(np, torch)
    runs = {}
    runs["fp32"], init, trained, model = _static_bert(np, torch, card,
                                                      "fp32")
    _static_inference(np, torch, trained, model)
    del trained, model
    _free(torch)
    runs["bf16"], _, _, _ = _static_bert(np, torch, card, "bf16", init=init)
    _free(torch)
    log(card)
    return runs



# -- phase 14 ----------------------------------------------------------------

# BERT-base (BERT_STEP's widths) through to_static and the Predictor:
# batch x seq, the batch of the int8 card-vs-CPU check, the Predictor's
# timed runs.  The int8 card-vs-CPU check holds the two within twice the
# distance that int8 puts between the CPU's int8 and fp32 outputs: int8
# with per-tensor dynamic scales is discontinuous, and the card's fp32
# attention and LayerNorm round differently from the CPU's, which moves
# activations across quantization steps (op by op, on equal inputs, the
# two are bit for bit: tests/test_torch_cuda.py)
JIT_BATCH, JIT_PARITY_BATCH, PRED_REPEATS = 32, 2, 5
# BERT-base's projections, (K, N), at JIT_BATCH x 512 rows (part (c))
BERT_PROJ = {"qkv": (768, 2304), "proj": (768, 768), "fc1": (768, 3072),
             "fc2": (3072, 768)}
# int8 GPT-1.3B through to_static: batch x seq, timed forwards
GPT_INT8 = dict(batch=4, seq=1024, timed=3)


def bert_int8_matmuls(layers):
    """The quantized_matmul ops of an L-layer BertModel program under
    enable_int8()'s size gate: each layer's qkv, proj, fc1 and fc2, and
    the pooler (tests/test_torch_int8_inference.py finds it for L=2)."""
    return 4 * layers + 1


def _launches(names=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "w8a8_gemm", "w8a8_gemm_prequant")):
    from paddle_tpu_torch.kernels import KERNELS

    return {k: KERNELS[k] for k in names}


def _jit_bert(np, torch, card, tmp):
    """(a) BERT-base through to_static against its eager forward, then
    jit.save / jit.load.  Returns the saved prefix, the batch and the
    to_static outputs."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.kernels import reset_launch_counts
    from paddle_tpu_torch.models import BertModel

    c = BERT_STEP
    b, s = JIT_BATCH, c["seq"]
    paddle.set_device("gpu")
    paddle.seed(0)
    with unique_name.guard():
        model = BertModel(_bert_cfg(c))
    model.eval()
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.randint(0, c["vocab"], (b, s)), device="cuda")
    tt = torch.as_tensor((rng.rand(b, s) > 0.5).astype("int64"),
                         device="cuda")
    args = (paddle.Tensor(ids), paddle.Tensor(tt))
    with paddle.no_grad():
        want = model(*args)
    spec = [jit.InputSpec([None, s], "int64")] * 2
    jit.to_static(model, input_spec=spec)
    t0 = time.perf_counter()
    model(*args)  # traces, then runs
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    reset_launch_counts()
    got = model(*args)
    torch.cuda.synchronize()
    launches = _launches()
    prog = model.forward.concrete_program[0]
    times = []
    for _ in range(PRED_REPEATS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    ms = 1e3 * float(np.mean(times))
    same = all(torch.equal(g._t, w._t) for g, w in zip(got, want))
    log(f"(a) to_static BERT-base fp32 (B={b} S={s}; {card}): program of "
        f"{len(prog.global_block().ops)} ops, traced and run once in "
        f"{trace_s:.2f} s; {ms:.2f} ms a call ({b * s / ms * 1e3:.0f} "
        f"tokens/s); launches a call {json.dumps(launches)}; outputs vs the "
        f"eager forward bit for bit: {same}")
    for label, g, w in zip(("sequence output", "pooled output"), got, want):
        _flash_close(f"(a) to_static vs eager, {label}", g._t, w._t,
                     *FLASH_TOL["fp32"]["out"])
    expect = {"flash_fwd": c["layers"], "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0, "w8a8_gemm": 0, "w8a8_gemm_prequant": 0}
    if launches != expect:
        raise AssertionError(f"(a) to_static BERT-base launched {launches}, "
                             f"expected {expect}")
    prefix = os.path.join(tmp, "bert_base")
    t0 = time.perf_counter()
    jit.save(model, prefix, input_spec=spec)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = jit.load(prefix)
    load_s = time.perf_counter() - t0
    back = loaded(*args)
    same = all(torch.equal(g._t, w._t) for g, w in zip(back, got))
    log(f"(a) jit.save {save_s:.2f} s, jit.load {load_s:.2f} s; the loaded "
        f"layer vs to_static bit for bit: {same}")
    if not same:
        raise AssertionError("(a) the jit.load-ed BERT-base differs from its "
                             "to_static program")
    outs = [g._t for g in got]
    del model, loaded, back, got, want
    _free(torch)
    return prefix, (ids, tt), outs


def _predictor(prefix, precision, device="gpu"):
    from paddle_tpu_torch import inference

    cfg = inference.Config(prefix)
    if device == "cpu":
        cfg.disable_gpu()
    if precision == "bf16":
        cfg.enable_bf16()
    elif precision == "int8":
        cfg.enable_int8()
    return inference.create_predictor(cfg)


def _predictors(np, torch, card, prefix, batch, fp32_outs):
    """(b) the Predictor over (a)'s saved model in fp32, bf16 and int8;
    then the int8 run at JIT_PARITY_BATCH against the CPU's.  Returns the
    launches a run of each precision."""
    from paddle_tpu_torch.kernels import reset_launch_counts

    c = BERT_STEP
    layers = c["layers"]
    b, s = batch[0].shape
    expect = {
        "fp32": dict(flash_fwd=layers),
        "bf16": dict(flash_fwd=layers),
        "int8": dict(flash_fwd=layers,
                     w8a8_gemm_prequant=bert_int8_matmuls(layers))}
    runs, outs = {}, {}
    for precision in ("fp32", "bf16", "int8"):
        t0 = time.perf_counter()
        pred = _predictor(prefix, precision)
        load_s = time.perf_counter() - t0
        block = pred._program.global_block()
        ops = [op.type for op in block.ops]
        n_q = ops.count("quantized_matmul")
        attn = {block._var_recursive(op.input("Q")[0]).dtype
                for op in block.ops
                if op.type == "scaled_dot_product_attention"}
        got = pred.run_on_device(batch)  # the first run: prepares the program
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        got = pred.run_on_device(batch)
        torch.cuda.synchronize()
        launches = _launches()
        times = []
        for _ in range(PRED_REPEATS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pred.run_on_device(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_ops = pred._exe.last_run_ops
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred.run_on_device(batch)
        host_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        busy = _profile(torch, f"Predictor BERT-base {precision} run",
                        lambda: pred.run_on_device(batch))
        ms = 1e3 * float(np.mean(times))
        outs[precision] = [g._t.float() for g in got]
        log(f"(b) Predictor BERT-base {precision} (B={b} S={s}; {card}): "
            f"loaded in {load_s:.2f} s; {ms:.2f} ms a batch (timed "
            f"{[round(1e3 * t, 2) for t in times]}), {b / ms * 1e3:.1f} "
            f"sequences/s; max_memory_allocated {peak:.2f} GiB; device busy "
            f"{100 * busy:.1f}% of one profiled run; {n_ops} ops a run, "
            f"{1e6 * host_s / n_ops:.1f} us host an op; quantized_matmul ops "
            f"{n_q}; the attention ops' query dtype {sorted(attn)}; launches "
            f"a run {json.dumps(launches)}")
        want = {k: expect[precision].get(k, 0) for k in launches}
        if launches != want:
            raise AssertionError(f"(b) the {precision} Predictor launched "
                                 f"{launches}, expected {want}")
        if attn != {"bfloat16" if precision == "bf16" else "float32"}:
            raise AssertionError(f"(b) the {precision} program's attention "
                                 f"takes {attn} queries")
        if precision == "int8" and (n_q != bert_int8_matmuls(layers)
                                    or pred._n_int8 != n_q):
            raise AssertionError(f"(b) the int8 program has {n_q} "
                                 f"quantized_matmul ops ({pred._n_int8} "
                                 "rewritten)")
        runs[precision] = launches
        del pred, got
        _free(torch)
    same = all(torch.equal(a, w) for a, w in zip(outs["fp32"], fp32_outs))
    log(f"(b) the fp32 Predictor vs (a)'s to_static outputs bit for bit: "
        f"{same}")
    if not same:
        raise AssertionError("(b) the fp32 Predictor differs from (a)")
    for precision in ("bf16", "int8"):
        for label, g, w in zip(("sequence output", "pooled output"),
                               outs[precision], outs["fp32"]):
            err = (g - w).abs().max().item()
            rel = ((g - w).norm() / w.norm()).item()
            log(f"(b) {precision} vs fp32, {label}: max abs err {err:.3e}, "
                f"relative (norm) error {rel:.3e}")
            if not (np.isfinite(err) and rel < 0.1):
                raise AssertionError(f"(b) the {precision} Predictor is off")
    # the int8 Predictor on the card against its CPU run (the plain
    # versions) on the batch's first rows, held within twice the distance
    # int8 itself puts between the CPU's int8 and fp32 outputs
    small = [t[:JIT_PARITY_BATCH].cpu().numpy() for t in batch]
    card_out = _predictor(prefix, "int8").run(small)
    cpu_out = _predictor(prefix, "int8", device="cpu").run(small)
    cpu_fp32 = _predictor(prefix, "fp32", device="cpu").run(small)
    for label, g, w, f in zip(("sequence output", "pooled output"),
                              card_out, cpu_out, cpu_fp32):
        err = float(np.abs(g - w).max())
        rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        int8_rel = float(np.linalg.norm(w - f) / np.linalg.norm(f))
        log(f"(b) int8 Predictor card vs CPU at B={JIT_PARITY_BATCH}, "
            f"{label}: max abs err {err:.3e} ({err / np.abs(w).max():.3e} "
            f"of the largest |output|), relative (norm) error {rel:.3e}; "
            f"the CPU's int8 vs its fp32: {int8_rel:.3e} (the bound: twice "
            f"it)")
        if not rel <= 2 * int8_rel:
            raise AssertionError("(b) the int8 Predictor on the card "
                                 "disagrees with the CPU")
    _free(torch)
    return runs


def _prequant_gemm(np, torch, card):
    """(c) the pre-quantized GEMM at BERT-base's projections (M = JIT_BATCH
    x 512 rows): the int32 sums (unit scales) and the rescaled output bit
    for bit against the plain version; timed by CUDA events beside
    ``torch._int_mm`` on the same operands and the bound.  Returns the
    kernels-line row (the layer's four projections summed)."""
    from paddle_tpu_torch.kernels.int8_gemm import (w8a8_gemm_prequant,
                                                    w8a8_gemm_prequant_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    m = JIT_BATCH * BERT_STEP["seq"]
    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    for proj, (k, n) in BERT_PROJ.items():
        xq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                           dtype=torch.int8)
        sx = torch.rand(m, 1, device=dev, generator=g) * 1e-2 + 1e-4
        ws = torch.rand(n, device=dev, generator=g) * 1e-2 + 1e-4
        ones_m = torch.ones(m, 1, device=dev)
        ones_n = torch.ones(n, device=dev)
        acc = w8a8_gemm_prequant(xq, ones_m, wq, ones_n)
        _, want_acc = w8a8_gemm_prequant_plain(xq, ones_m, wq, ones_n,
                                               return_acc=True)
        top = want_acc.abs().max().item()
        exact_acc = top < 2 ** 24 and torch.equal(acc, want_acc.float())
        out = w8a8_gemm_prequant(xq, sx, wq, ws)
        want = w8a8_gemm_prequant_plain(xq, sx, wq, ws)
        err = (out - want).abs().max().item()
        ms = time_ms(lambda: w8a8_gemm_prequant(xq, sx, wq, ws), 10)
        plain_ms = time_ms(lambda: w8a8_gemm_prequant_plain(xq, sx, wq, ws),
                           3, 1)
        lib_ms = time_ms(lambda: torch._int_mm(xq, wq.t()), 10)
        nbytes = m * k + n * k + 4 * m + 4 * n + 4 * m * n
        bms, by = bound_ms(nbytes, 2 * m * n * k, INT8_OPS)
        log(f"(c) w8a8_gemm_prequant {proj} M={m} K={k} N={n} ({card}): "
            f"int32 sums bit for bit {exact_acc} (largest |sum| {top:.0f}); "
            f"output max abs err {err:.3e} (tol 0); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, _int_mm {lib_ms:.4f} ms "
            f"({ms / lib_ms:.2f}x), bound {bms:.4f} ms ({by}), "
            f"{2 * m * n * k / ms / 1e9:.1f} TOP/s")
        if not (exact_acc and err == 0.0):
            raise AssertionError(f"(c) w8a8_gemm_prequant {proj} is not exact")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bytes", nbytes),
                         ("ops", 2 * m * n * k)):
            row[key] += val
        del xq, wq, acc, want_acc, out, want
    bms, by = bound_ms(row["bytes"], row["ops"], INT8_OPS)
    log(f"(c) w8a8_gemm_prequant one BERT-base layer (qkv + proj + fc1 + "
        f"fc2, M={m}): {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"_int_mm {row['library_ms']:.4f} ms "
        f"({row['ms'] / row['library_ms']:.2f}x), bound {bms:.4f} ms ({by})")
    _free(torch)
    return dict(ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=bms,
                bound_by=by, library_ms=row["library_ms"], max_abs_err=0.0)


def _jit_gpt_int8(np, torch, card):
    """(d) int8 GPT-1.3B (the paddle layers, fp32 as phase 9's plain runs)
    through to_static against its eager forward.  Returns the launches a
    forward."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.kernels import reset_launch_counts
    from paddle_tpu_torch.models import gpt_1p3b
    from paddle_tpu_torch.models.gpt_layers import GPTForPretraining

    cfg = gpt_1p3b(int8=True, int8_lm_head=True)
    b, s = GPT_INT8["batch"], GPT_INT8["seq"]
    paddle.set_device("gpu")
    paddle.seed(0)
    t0 = time.perf_counter()
    with unique_name.guard():
        model = GPTForPretraining(cfg)
    model.eval()
    build_s = time.perf_counter() - t0
    ids = paddle.Tensor(torch.as_tensor(
        np.random.RandomState(1).randint(0, cfg.vocab_size, (b, s)),
        device="cuda"))
    reset_launch_counts()
    with paddle.no_grad():
        want = model(ids)
    torch.cuda.synchronize()
    eager = _launches()
    jit.to_static(model, input_spec=[jit.InputSpec([None, s], "int64")])
    t0 = time.perf_counter()
    model(ids)
    torch.cuda.synchronize()
    trace_s = time.perf_counter() - t0
    ops = [op.type for op in model.forward.concrete_program[0]
           .global_block().ops]
    n_w8 = ops.count("w8a8_matmul")
    one_off = sorted({t for t in ops if t.startswith("__")})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    got = model(ids)
    torch.cuda.synchronize()
    launches = _launches()
    times = []
    for _ in range(GPT_INT8["timed"]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = 1e3 * float(np.mean(times))
    same = torch.equal(got._t, want._t)
    err = (got._t.float() - want._t.float()).abs().max().item()
    log(f"(d) int8 GPT-1.3B through to_static (fp32, B={b} S={s}; {card}): "
        f"built in {build_s:.2f} s, traced and run once in {trace_s:.2f} s; "
        f"program of {len(ops)} ops, {n_w8} w8a8_matmul, one-off ops "
        f"{one_off}; {ms:.2f} ms a forward (timed "
        f"{[round(1e3 * t, 2) for t in times]}), {b * s / ms * 1e3:.0f} "
        f"tokens/s; max_memory_allocated {peak:.2f} GiB; launches a forward "
        f"{json.dumps(launches)} (eager {json.dumps(eager)}); logits vs the "
        f"eager forward bit for bit: {same} (max abs err {err:.3e})")
    n_proj = 4 * cfg.num_layers + 1
    expect = {"flash_fwd": cfg.num_layers, "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0, "w8a8_gemm": n_proj,
              "w8a8_gemm_prequant": 0}
    if n_w8 != n_proj or one_off or launches != expect or eager != expect:
        raise AssertionError(f"(d) int8 GPT-1.3B: {n_w8} w8a8_matmul ops, "
                             f"one-off {one_off}, launches {launches} / "
                             f"eager {eager}, expected {expect}")
    if not same:
        raise AssertionError("(d) the to_static int8 GPT-1.3B differs from "
                             "its eager forward")
    del model, got, want
    _free(torch)
    return launches


def _d2s_cases(P):
    """Tensor if / while / for / break cases of
    tests/test_torch_dy2static.py, with the values the CPU test asserts."""

    def if_assign(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y + 0.5

    def while_tensor(x):
        s = P.zeros([1])
        i = P.zeros([1])
        while s.sum() < x.sum():
            s = s + 1.0
            i = i + 2.0
        return s + i

    def for_tensor_bound(x):
        n = x.sum().astype("int64")
        acc = P.zeros([1])
        for i in range(n):
            acc = acc + 1.5
        return acc

    def break_tensor_bound(x):
        n = x.sum().astype("int64")
        acc = P.zeros([1])
        for i in range(n):
            if acc.sum() >= 5.0:
                break
            acc = acc + 1.0
        return acc

    def return_in_while(x):
        s = P.zeros([1])
        while s.sum() < 5.0:
            s = s + 1.0
            if s.sum() > 2.0:
                return s
        return s

    return [(if_assign, (2, 3), 1.0, 2.5), (if_assign, (2, 3), -1.0, -1.5),
            (while_tensor, (4,), 1.8, 24.0),
            (for_tensor_bound, (5,), 1.0, 7.5),
            (break_tensor_bound, (100,), 1.0, 5.0),
            (return_in_while, (1,), 0.0, 3.0)]


def _examples_on_card(np, torch):
    """(e) dy2static on the card against the CPU, and the two examples."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.examples import fluid_word2vec, infer_int8

    for fn, shape, value, first in _d2s_cases(paddle):
        x = np.full(shape, value, "float32")
        got = {}
        for device in ("cpu", "gpu"):
            paddle.set_device(device)
            got[device] = paddle.jit.to_static(fn)(paddle.to_tensor(x)).numpy()
        log(f"(e) dy2static {fn.__name__}({value:g}): card "
            f"{got['gpu'].reshape(-1)[:3].tolist()}, cpu "
            f"{got['cpu'].reshape(-1)[:3].tolist()}")
        if not (got["gpu"].reshape(-1)[0] == first
                and np.array_equal(got["gpu"], got["cpu"])):
            raise AssertionError(f"(e) dy2static {fn.__name__} on the card "
                                 f"gave {got['gpu']}, the CPU {got['cpu']}")
    quiet = lambda msg: None  # noqa: E731
    paddle.set_device("gpu")
    acc_fp32, acc_int8 = infer_int8.main(["--device", "gpu"])
    log(f"(e) infer_int8.py --device gpu: accuracy fp32 {acc_fp32:.3f}, "
        f"int8 {acc_int8:.3f}")
    args = ["--steps", "60"]
    cpu, state, _ = fluid_word2vec.run(
        fluid_word2vec.parse_args(args + ["--device", "cpu"]), log=quiet)
    card, _, shape = fluid_word2vec.run(
        fluid_word2vec.parse_args(args + ["--device", "gpu"]),
        init_state=state, log=quiet)
    fluid_word2vec.check(card, shape)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    log(f"(e) fluid_word2vec.py --device gpu --steps 60: loss {card[0]:.4f} "
        f"-> {card[-1]:.4f}; card vs cpu worst rel {rel:.3e} (tol 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError("(e) fluid_word2vec on the card disagrees with "
                             "the CPU")
    paddle.set_device("gpu")


def phase_jit(np, torch, card):
    """Phase 14: jit and deployment (see the comment above JIT_BATCH).
    Returns the kernels-line row of the pre-quantized GEMM and each run's
    launches."""
    import tempfile

    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        prefix, batch, outs = _jit_bert(np, torch, card, tmp)
        runs["bert"] = _predictors(np, torch, card, prefix, batch, outs)
    del outs, batch
    _free(torch)
    row = _prequant_gemm(np, torch, card)
    runs["gpt"] = _jit_gpt_int8(np, torch, card)
    _examples_on_card(np, torch)
    log(card)
    return {"w8a8_gemm_prequant": row}, runs


# -- phase 15 ----------------------------------------------------------------

# the rest of the eager API.  (a) Transformer-base (phase 12's TRANSFORMER,
# fp32, random seeded weights) translating through nn.BeamSearchDecoder +
# nn.dynamic_decode: beam 4 (Vaswani et al. 2017, section 6.1; no length
# penalty, as the reference has none), batch 32 of 256-token sources with
# their pad bias (_seq2seq_batch), at most 64 steps, BOS 1, EOS 2; the cell
# runs model.transformer.decoder over gen_cache's caches, carried as a flat
# list of states (the memory, the source bias, each layer's Cache and
# StaticCache keys and values).  (b) The PTB "medium" LSTM language model
# (Zaremba et al. 2014; PaddleNLP's rnnlm example): vocab 10000, nn.LSTM of
# 2 x 650, 35 steps, batch 20, SGD lr 1.0 with a global-norm clip of 5,
# dropout off, seeded synthetic tokens, the states carried (detached) from
# step to step.  (c) The first two blocks of C3D (Tran et al. 2015) at
# batch 8 of 3 x 16 x 112 x 112 clips (Conv3D 64 k3 p1, ReLU, MaxPool3D
# (1, 2, 2), Conv3D 128 k3 p1, ReLU, MaxPool3D 2), forward and backward;
# bilinear and nearest interpolate x 2 of an [8, 64, 128, 128] map.  (d)
# The newly registered ops and the new functions at small shapes.  Each
# card run is held against the same run on the CPU: (a) ids equal and
# scores within 1e-5 on TRANSFORMER_SMALL (and beam 1 equal to _greedy),
# (b) losses within 1e-4, (c) within 1e-4 of each tensor's largest value
# (nearest exactly), (d) within 1e-5 of each tensor's largest value,
# integers exactly; TF32 off throughout.
BEAM = dict(batch=32, beam=4, steps=64, end=2)
PTB = dict(vocab=10000, hidden=650, layers=2, steps=35, batch=20, lr=1.0,
           clip=5.0, train_steps=5)
C3D = dict(batch=8, frames=16, size=112)
INTERP = (8, 64, 128, 128)


def _beam_search(np, paddle, model, src, src_mask, beam, steps, end):
    """Beam search through ``model.transformer.decoder`` (ids and best
    scores, numpy): the cell rebuilds the caches from the flat states and
    takes the position from the self-attention cache's length (gen_cache
    starts it at the memory's)."""
    mha = paddle.nn.MultiHeadAttention
    m = paddle.to_tensor(src_mask)
    memory = model.transformer.encoder(model.embed(paddle.to_tensor(src)), m)
    caches = model.transformer.decoder.gen_cache(memory)
    n = len(caches)

    def flat(memory, m, caches):
        return [memory, m] + [t for inc, st in caches
                              for t in (inc.k, inc.v, st.k, st.v)]

    def cell(ids, states):
        memory, m = states[0], states[1]
        cache = [(mha.Cache(*states[2 + 4 * i:4 + 4 * i]),
                  mha.StaticCache(*states[4 + 4 * i:6 + 4 * i]))
                 for i in range(n)]
        start = states[2].shape[2] - memory.shape[1]
        h, new = model.transformer.decoder(model.embed(ids, start), memory,
                                           None, m, cache)
        return paddle.squeeze(h, [1]), flat(memory, m, new)

    dec = paddle.nn.BeamSearchDecoder(
        cell, start_token=1, end_token=end, beam_size=beam,
        embedding_fn=lambda tok: paddle.unsqueeze(tok, [-1]),
        output_fn=model.logits)
    ids, scores = paddle.nn.dynamic_decode(dec, inits=flat(memory, m, caches),
                                           max_step_num=steps)
    return ids.numpy(), scores.numpy()


class _DecodeRecorder:
    """Keeps, while it is entered, the inputs and the result of the last
    ``flash_fwd_cuda`` call at Sq = 1 with a score bias (cross-attention
    over the source) and of the last at Sq = 1 without one whose Sk is not
    a multiple of 64 (self-attention over the grown cache, its last key
    tile ragged), by reference: the decoder makes new tensors each step
    and writes none of these in place."""

    def __enter__(self):
        from paddle_tpu_torch.kernels import flash

        self._mod, self._orig = flash, flash.flash_fwd_cuda
        self.kept = {}

        def fwd(q, k, v, causal, scale, window, layout, bias=None):
            res = self._orig(q, k, v, causal, scale, window, layout, bias)
            seq = 2 if layout == "bnsd" else 1
            if q.shape[seq] == 1 and (bias is not None or k.shape[seq] % 64):
                self.kept["cross" if bias is not None else "self"] = (
                    (q, k, v, causal, scale, window, layout, bias), res)
            return res

        flash.flash_fwd_cuda = fwd
        return self

    def __exit__(self, *exc):
        self._mod.flash_fwd_cuda = self._orig

    def check(self, torch):
        """Each kept launch's out and lse against ``flash_fwd_plain`` on
        its own inputs, within FLASH_TOL; the worst max abs error."""
        from paddle_tpu_torch.kernels import flash_fwd_plain

        worst = 0.0
        for kind in ("self", "cross"):
            if kind not in self.kept:
                raise AssertionError(f"beam search made no Sq = 1 {kind}-"
                                     "attention launch to check")
            args, (out, lse) = self.kept[kind]
            q, k, layout, bias = args[0], args[1], args[6], args[7]
            seq = 2 if layout == "bnsd" else 1
            dt = "fp32" if q.dtype == torch.float32 else "bf16"
            ref, rlse = flash_fwd_plain(*args)
            label = (f"flash_fwd beam-search decode {kind} ({layout}, "
                     f"B={q.shape[0]} H={q.shape[3 - seq]} Sq=1 "
                     f"Sk={k.shape[seq]} D={q.shape[-1]}, {dt}, "
                     f"{'pad bias' if bias is not None else 'no bias'})")
            for part, a, r in (("out", out, ref), ("lse", lse, rlse)):
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{label} {part} is not finite")
                top = _flash_close(f"{label} {part}", a, r,
                                   *FLASH_TOL[dt][part])
                worst = max(worst, top)
        self.kept.clear()
        return worst


def _beam_base(np, torch, card):
    """(a) at Transformer-base: ms a step, the busy share and device time
    by kernel, and 6 + 12 a step flash_fwd launches asserted (6 + 6 a step
    biased, 12 a step with q and k of other lengths, no backward); the
    last cross-attention launch and the last self-attention launch over a
    ragged cache held against the plain forward on their own inputs;
    returns the run's launches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    c = TRANSFORMER
    with unique_name.guard():
        paddle.seed(0)
        model = _seq2seq(np, c)
    model.eval()
    (src, _, _, src_mask, _), _ = _seq2seq_batch(
        np, dict(c, batch=BEAM["batch"]), seed=3)
    args = (np, paddle, model, src, src_mask, BEAM["beam"])
    with paddle.no_grad():
        _beam_search(*args, 2, BEAM["end"])                     # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        with _CrossSpy() as spy, _DecodeRecorder() as rec:
            t0 = time.perf_counter()
            ids, scores = _beam_search(*args, BEAM["steps"], BEAM["end"])
            wall = time.perf_counter() - t0
        total = {k: KERNELS[k] for k in FLASH}
        rec.check(torch)
        busy = _profile(torch, "Transformer-base beam search, 4 steps",
                        lambda: _beam_search(*args, 4, BEAM["end"]))
    steps = ids.shape[1]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"Transformer-base beam search ({card}): beam {BEAM['beam']} at "
        f"batch {src.shape[0]} over sources of {src.shape[1]}, {steps} "
        f"steps: {1e3 * wall / steps:.2f} ms a step (host clock, encoder "
        f"included), device busy {100 * busy:.1f}% (4 steps profiled), "
        f"peak {peak:.2f} GiB; flash launches {json.dumps(total)} "
        f"({total.get('flash_fwd', 0) / steps:.2f} a step, biased "
        f"{spy.counts.get('flash_fwd')}, q and k of other lengths "
        f"{spy.cross.get('flash_fwd')}); the fp32 forward runs one live query "
        f"row in its 256-row block (ROADMAP B.33); best scores "
        f"{float(scores.min()):.3f}..{float(scores.max()):.3f}, first "
        f"row's ids {ids[0, :12].tolist()}")
    want = {k: 6 + 12 * steps if k == "flash_fwd" else 0 for k in FLASH}
    biased = {k: 6 + 6 * steps if k == "flash_fwd" else 0 for k in FLASH}
    cross = {k: 12 * steps if k == "flash_fwd" else 0 for k in FLASH}
    if (total != want or spy.counts != biased or spy.cross != cross
            or ids.shape[0] != src.shape[0]
            or not np.isfinite(scores).all()
            or ids.min() < 0 or ids.max() >= c["vocab"]):
        raise AssertionError(
            f"beam search launched {total} (biased {spy.counts}, cross "
            f"{spy.cross}) over {steps} steps; expected 6 + 12 a step")
    del model
    _free(torch)
    return total


def _beam_small_parity(np, torch):
    """(a) on TRANSFORMER_SMALL from the same weights: beam 4 card vs CPU
    (ids equal, scores within 1e-5), beam 1 on the card equal to phase
    12's ``_greedy`` (the end token repeated once a row has emitted it)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.weights import load_paddle_state_dict

    c = TRANSFORMER_SMALL
    (src, _, _, src_mask, _), _ = _seq2seq_batch(np, c, seed=2)
    models, ids, scores = {}, {}, {}
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        with unique_name.guard():
            paddle.seed(0)
            models[dev] = _seq2seq(np, c)
        models[dev].eval()
    load_paddle_state_dict(models["gpu"], {
        k: v.numpy() for k, v in models["cpu"].state_dict().items()})
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        with paddle.no_grad():
            ids[dev], scores[dev] = _beam_search(
                np, paddle, models[dev], src, src_mask, 4, 12, BEAM["end"])
    with paddle.no_grad():
        ids1, _ = _beam_search(np, paddle, models["gpu"], src, src_mask, 1,
                               12, BEAM["end"])
        greedy = _greedy(np, paddle, models["gpu"], src, src_mask,
                         ids1.shape[1])
    ended = np.cumsum(greedy == BEAM["end"], axis=1) > 0
    ended[:, 1:] = ended[:, :-1].copy()
    ended[:, 0] = False
    greedy = np.where(ended, BEAM["end"], greedy)
    rel = float(np.abs(scores["gpu"] - scores["cpu"]).max()
                / max(1.0, float(np.abs(scores["cpu"]).max())))
    log(f"small Transformer beam search, card vs cpu: ids "
        f"{ids['gpu'].tolist()} vs {ids['cpu'].tolist()}, scores within "
        f"{rel:.3e} (tol 1e-5); beam 1 vs greedy {ids1.tolist()} vs "
        f"{greedy.tolist()}")
    if not (np.array_equal(ids["gpu"], ids["cpu"]) and rel <= 1e-5
            and np.array_equal(ids1, greedy)):
        raise AssertionError("beam search on the card disagrees with the "
                             "CPU or with greedy decoding")
    del models
    _free(torch)


def _ptb_lm(c):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    class RNNLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(c["vocab"], c["hidden"])
            self.lstm = nn.LSTM(c["hidden"], c["hidden"], c["layers"])
            self.head = nn.Linear(c["hidden"], c["vocab"])

        def forward(self, ids, states):
            out, states = self.lstm(self.embedding(ids), states)
            return self.head(out), states

    return RNNLM()


def _ptb_batches(np, c):
    """Seeded synthetic tokens cut as PTB's reader cuts a stream: a [batch,
    steps] window and the window one token later, a step each."""
    rng = np.random.RandomState(7)
    n = c["steps"] * c["train_steps"] + 1
    data = rng.randint(0, c["vocab"], (c["batch"], n)).astype("int64")
    return [(data[:, i:i + c["steps"]], data[:, i + 1:i + 1 + c["steps"]])
            for i in range(0, n - 1, c["steps"])]


def _ptb_train(np, torch, model, batches, c, clock=None):
    """SGD with the global-norm clip over ``batches``, the LSTM states
    carried (detached) from step to step; each step's loss and host ms
    (synchronised).  ``clock`` (an _OpClock) wraps the second step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    opt = paddle.optimizer.SGD(learning_rate=c["lr"],
                               parameters=model.parameters(),
                               grad_clip=nn.ClipGradByGlobalNorm(c["clip"]))
    shape = [c["layers"], c["batch"], c["hidden"]]
    states = (paddle.zeros(shape), paddle.zeros(shape))
    losses, ms = [], []
    for i, (ids, labels) in enumerate(batches):
        if i == 1 and clock is not None:
            clock.__enter__()
        t0 = time.perf_counter()
        logits, (h, cs) = model(paddle.to_tensor(ids), states)
        loss = F.cross_entropy(paddle.reshape(logits, [-1, c["vocab"]]),
                               paddle.reshape(paddle.to_tensor(labels),
                                              [-1, 1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        states = (h.detach(), cs.detach())
        losses.append(float(loss.numpy()))
        ms.append(1e3 * (time.perf_counter() - t0))
        if i == 1 and clock is not None:
            clock.__exit__()
    return losses, ms


def _ptb(np, torch, card):
    """(b): five steps on the card against the same five on the CPU from
    the same weights, losses within 1e-4; step ms, ops a step, the busy
    share of one more step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.weights import load_paddle_state_dict

    c = PTB
    batches = _ptb_batches(np, c)
    models, runs = {}, {}
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        with unique_name.guard():
            paddle.seed(0)
            models[dev] = _ptb_lm(c)
    load_paddle_state_dict(models["gpu"], {
        k: v.numpy() for k, v in models["cpu"].state_dict().items()})
    clock = _OpClock()
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        runs[dev] = _ptb_train(np, torch, models[dev], batches, c,
                               clock if dev == "gpu" else None)
    (cpu, _), (gpu, ms) = runs["cpu"], runs["gpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gpu, cpu))
    busy = _profile(torch, "PTB medium LSTM LM, one step",
                    lambda: _ptb_train(np, torch, models["gpu"],
                                       batches[:1], c))
    tokens = c["batch"] * c["steps"]
    log(f"PTB medium LSTM LM ({card}): vocab {c['vocab']}, 2 x "
        f"{c['hidden']}, {c['steps']} steps x batch {c['batch']}, SGD "
        f"{c['lr']} clip {c['clip']}: losses card {[round(v, 6) for v in gpu]}"
        f" vs cpu {[round(v, 6) for v in cpu]} (worst {rel:.3e} relative, "
        f"tol 1e-4); step ms {[round(v, 2) for v in ms]} (the last four "
        f"{np.mean(ms[1:]):.2f}, {tokens / np.mean(ms[1:]) * 1e3:.0f} "
        f"tokens/s); {clock.ops} ops traced a step at "
        f"{1e6 * clock.seconds / max(clock.ops, 1):.1f} us host each, "
        f"{clock.updates} update ops; device busy {100 * busy:.1f}%")
    if not rel <= 1e-4 or not all(np.isfinite(gpu)):
        raise AssertionError("the LSTM LM's losses on the card disagree "
                             "with the CPU's")
    del models
    _free(torch)


def _rel_err(np, got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _c3d_layers(nn):
    return [nn.Conv3D(3, 64, 3, padding=1), nn.ReLU(),
            nn.MaxPool3D((1, 2, 2)), nn.Conv3D(64, 128, 3, padding=1),
            nn.ReLU(), nn.MaxPool3D(2)]


def _c3d_choices(torch, z, a, k):
    """The stack's non-smooth choices at one block, as its backward makes
    them: ReLU's sign of the conv output ``z`` and max-pool's argmax of
    each window of ``a`` (size = stride = ``k``; a flat index into each
    (n, c) plane, as ``max_pool3d`` returns it)."""
    _, route = torch.nn.functional.max_pool3d(a, k, k, return_indices=True)
    return z > 0, route


def _c3d_flips(torch, zc, ac, k, sign_g, route_g, z_err, a_err):
    """Where the card's choices (``sign_g``, ``route_g``) differ from the
    CPU's on the CPU's tensors ``zc``, ``ac``.  Asserts that each differing
    ReLU sign has |z| within ``z_err`` (the conv output's largest
    card-vs-CPU difference) and that each differing argmax of a live
    window picks a value within 2 ``a_err`` of the window's CPU maximum:
    both choices then fall inside the forward's own rounding.  Counts the
    elements and windows whose choice the rounding could flip at all
    (|z| <= z_err; a live window's two largest values within 2 a_err), and
    asserts they are at most 1e-4 of the whole."""
    sign_c, route_c = _c3d_choices(torch, zc, ac, k)
    relu = sign_c != sign_g.cpu()
    n, c = ac.shape[:2]
    flat = ac.reshape(n, c, -1)
    rg, rc = route_g.cpu().reshape(n, c, -1), route_c.reshape(n, c, -1)
    top = flat.gather(2, rc)
    at_g = flat.gather(2, rg)
    # windows whose maximum is a ReLU zero on both sides send no gradient
    live = (top > 0) | (at_g > 0)
    pool = (rg != rc) & live
    shape = (n, c) + tuple(route_c.shape[2:])
    wins = ac.reshape(n, c, shape[2], k[0], shape[3], k[1], shape[4], k[2])
    wins = wins.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(*shape, -1)
    two = wins.topk(2, dim=-1).values
    near_pool = int(((two[..., 0] - two[..., 1] <= 2 * a_err)
                     & (two[..., 0] > 0)).sum())
    near_relu = int((zc.abs() <= z_err).sum())
    worst = {"relu": float(zc[relu].abs().max()) if relu.any() else 0.0,
             "pool": float((top - at_g)[pool].max()) if pool.any() else 0.0}
    res = {"relu flips": int(relu.sum()), "relu near zero": near_relu,
           "elements": zc.numel(), "pool flips": int(pool.sum()),
           "pool near ties": near_pool, "windows": route_c.numel(),
           "worst |z| of a flip": worst["relu"],
           "worst gap of a flip": worst["pool"]}
    if not (worst["relu"] <= z_err and worst["pool"] <= 2 * a_err
            and near_relu <= 1e-4 * zc.numel()
            and near_pool <= 1e-4 * route_c.numel()):
        raise AssertionError(f"C3D's choices on the card differ from the "
                             f"CPU's beyond the forward's rounding: {res} "
                             f"(z_err {z_err:.3e}, a_err {a_err:.3e})")
    return res


def _c3d(np, torch, card):
    """(c): C3D's first two blocks, forward and backward, card vs CPU from
    the same weights, input and output gradient.  The stack's output
    within 1e-4 of its largest value.  Its gradients are held within 1e-4
    of each tensor's largest against the CPU run with the card's ReLU
    signs and max-pool argmaxes (the CPU's convolutions on the same
    weights, each pool taken as a gather at the card's argmax): where a
    window's two largest values, or a conv output and zero, lie within the
    convolution's fp32 rounding of each other, the two devices may choose
    differently and send an O(1) gradient to another element.
    :func:`_c3d_flips` asserts that every such difference lies within that
    rounding and counts them; the gradients of the CPU's own choices are
    logged beside.  Then the stack's forward + backward timed."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.weights import load_paddle_state_dict

    c = C3D
    rng = np.random.RandomState(5)
    x = rng.randn(c["batch"], 3, c["frames"], c["size"],
                  c["size"]).astype("float32")
    nets = {}
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        with unique_name.guard():
            paddle.seed(0)
            nets[dev] = nn.Sequential(*_c3d_layers(nn))
    load_paddle_state_dict(nets["gpu"], {
        k: v.numpy() for k, v in nets["cpu"].state_dict().items()})
    pools = {2: (1, 2, 2), 5: (2, 2, 2)}
    g = None

    def run(net, choices=None):
        """The stack forward and backward on the current device: the
        outputs of its layers (torch), and the output and the gradients of
        the input and the weights (numpy).  ``choices`` ({pool layer:
        (ReLU signs, argmaxes)}) puts, in place of the ReLU before each
        pool and of the pool, a product by the given signs and a gather at
        the given argmaxes."""
        nonlocal g
        t = paddle.to_tensor(x, stop_gradient=False)
        h, acts = t, []
        for i, layer in enumerate(net.children()):
            if choices and i + 1 in choices:            # the ReLU
                h = h * paddle.to_tensor(choices[i + 1][0].float())
            elif choices and i in choices:              # the pool
                idx = paddle.to_tensor(choices[i][1])
                h = paddle.reshape(paddle.take_along_axis(
                    paddle.flatten(h, 2), paddle.flatten(idx, 2), 2),
                    list(idx.shape))
            else:
                h = layer(h)
            acts.append(h._t.detach())
        if g is None:
            g = rng.randn(*h.shape).astype("float32")
        paddle.sum(h * paddle.to_tensor(g)).backward()
        res = {"out": h.numpy(), "x.grad": t.grad.numpy(),
               **{n: p.grad.numpy() for n, p in net.named_parameters()}}
        net.clear_gradients()
        return acts, res

    paddle.set_device("cpu")
    acts_c, own = run(nets["cpu"])
    paddle.set_device("gpu")
    acts_g, got = run(nets["gpu"])
    choices = {i: _c3d_choices(torch, acts_g[i - 2], acts_g[i - 1], k)
               for i, k in pools.items()}
    flips = {}
    for i, k in pools.items():
        z_err = float((acts_g[i - 2].cpu() - acts_c[i - 2]).abs().max())
        a_err = float((acts_g[i - 1].cpu() - acts_c[i - 1]).abs().max())
        flips[f"block {i // 3 + 1}"] = _c3d_flips(
            torch, acts_c[i - 2], acts_c[i - 1], k, *choices[i], z_err,
            a_err)
    del acts_c, acts_g
    paddle.set_device("cpu")
    _, want = run(nets["cpu"], {i: tuple(t.cpu() for t in ch)
                                for i, ch in choices.items()})
    paddle.set_device("gpu")
    errs = {k: _rel_err(np, got[k], v) for k, v in want.items()}
    errs["out (the CPU's own choices)"] = _rel_err(np, got["out"],
                                                   own["out"])
    own_errs = {k: _rel_err(np, got[k], v) for k, v in own.items()
                if k != "out"}
    del choices, got, want, own

    def timed():
        xt = paddle.to_tensor(x, stop_gradient=False)
        out = nets["gpu"](xt)
        paddle.sum(out * paddle.to_tensor(g)).backward()
        nets["gpu"].clear_gradients()

    timed()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        timed()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 3
    macs = c["batch"] * c["frames"] * c["size"] ** 2 * 64 * 81 + \
        c["batch"] * c["frames"] * (c["size"] // 2) ** 2 * 128 * 64 * 27
    log(f"C3D blocks 1-2 ({card}): batch {c['batch']} x 3 x {c['frames']} x "
        f"{c['size']} x {c['size']} fp32, forward + backward {ms:.2f} ms "
        f"(host clock, synchronised; {6 * macs / ms / 1e9:.1f} TFLOP/s over "
        f"{6 * macs / 1e9:.0f} GFLOP); card vs cpu with the card's choices "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} of "
        f"each tensor's largest (tol 1e-4); choices that differ "
        f"{json.dumps(flips)}; the gradients with the CPU's own choices "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in own_errs.items()})}")
    bad = {k: v for k, v in errs.items() if not v <= 1e-4}
    del nets
    _free(torch)
    if bad:
        raise AssertionError(f"C3D on the card disagrees with the CPU: {bad}")


def _interp(np, torch, card):
    """(c): interpolate x 2, bilinear and nearest, through the port's
    ``F.interpolate`` (the registered ``*_interp_v2`` ops), card vs CPU,
    and timed on the card beside the one library call that computes the
    same function."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import functional as F

    m = np.random.RandomState(6).randn(*INTERP).astype("float32")
    outs, times = {}, {}
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        t = paddle.to_tensor(m)
        outs[dev] = {mode: F.interpolate(t, scale_factor=2, mode=mode).numpy()
                     for mode in ("bilinear", "nearest")}
    for mode in ("bilinear", "nearest"):
        times[mode] = time_ms(lambda: F.interpolate(t, scale_factor=2,
                                                    mode=mode))
    mt = torch.as_tensor(m, device="cuda")
    lib = {}
    for mode, tm in (("bilinear", "bilinear"), ("nearest", "nearest-exact")):
        kw = dict(align_corners=False, antialias=True) if mode == "bilinear" \
            else {}
        lib[mode] = time_ms(lambda: torch.nn.functional.interpolate(
            mt, scale_factor=2, mode=tm, **kw))
    errs = {mode: _rel_err(np, outs["gpu"][mode], outs["cpu"][mode])
            for mode in ("bilinear", "nearest")}
    nbytes = m.nbytes * 5
    log(f"interpolate x 2 of {list(INTERP)} fp32 ({card}): the port's "
        f"F.interpolate bilinear {times['bilinear']:.4f} ms, nearest "
        f"{times['nearest']:.4f} ms; the library call "
        f"(torch.nn.functional.interpolate) {lib['bilinear']:.4f} / "
        f"{lib['nearest']:.4f} ms (bound {1e3 * nbytes / HBM_BYTES_PER_S:.4f}"
        f" ms, bytes); card vs cpu {errs['bilinear']:.3e} / "
        f"{errs['nearest']:.3e} of the largest (tol 1e-5 / 0)")
    if errs["bilinear"] > 1e-5 or errs["nearest"] != 0:
        raise AssertionError(f"interpolate on the card disagrees with the "
                             f"CPU: {errs}")


def _new_op_cases(np):
    """(op, inputs, attrs) of each op this slice registered, small."""
    r = np.random.RandomState(0)

    def f(*s):
        return r.randn(*s).astype("float32")

    lens = np.array([5, 0, 3])
    return [
        ("conv3d", {"Input": [f(2, 3, 5, 6, 4)], "Filter": [f(4, 3, 3, 2, 3)]},
         {"strides": [1, 2, 1], "paddings": [1, 0, 1, 1, 0, 2]}),
        ("conv3d_transpose", {"Input": [f(2, 3, 3, 4, 3)],
                              "Filter": [f(3, 2, 3, 3, 2)]},
         {"strides": [2, 1, 2], "paddings": [1, 1, 0],
          "output_padding": [1, 0, 1]}),
        ("pool3d", {"X": [f(2, 3, 5, 6, 4)]},
         {"pooling_type": "avg", "ksize": [3, 3, 2], "strides": [2, 2, 2],
          "paddings": [1, 1, 0]}),
        ("pool3d", {"X": [f(2, 3, 5, 6, 4)]},
         {"pooling_type": "max", "ksize": [3, 3, 2], "strides": [2, 2, 2],
          "paddings": [1, 1, 1, 0, 0, 1]}),
        ("nearest_interp_v2", {"X": [f(2, 3, 5, 4)]},
         {"out_h": 8, "out_w": 3}),
        ("bilinear_interp_v2", {"X": [f(2, 3, 5, 4)]},
         {"out_h": -1, "out_w": -1, "scale": [1.6, 0.75]}),
        *[("sequence_pool", {"X": [f(3, 5, 2)], "Length": [lens]},
           {"pooltype": pt}) for pt in ("SUM", "AVERAGE", "SQRT", "MAX",
                                        "FIRST", "LAST")],
        ("sequence_pad", {"X": [f(3, 5, 2)], "Length": [lens]},
         {"pad_value": -1.0, "maxlen": 7}),
        ("sequence_unpad", {"X": [f(3, 5, 2)], "Length": [lens]}, {}),
        ("sequence_mask", {"X": [np.array([3, 0, 5])]},
         {"maxlen": 6, "out_dtype": "int32"}),
        ("sequence_softmax", {"X": [f(3, 5)], "Length": [lens]}, {}),
        ("sequence_reverse", {"X": [f(3, 5, 2)], "Length": [lens]}, {}),
        ("sequence_slice", {"X": [f(3, 5, 2)],
                            "Offset": [np.array([1, 0, 2])],
                            "SliceLength": [np.array([3, 2, 1])]}, {}),
        ("sequence_reshape", {"X": [f(3, 4, 6)],
                              "Length": [np.array([4, 2, 3])]},
         {"new_dim": 3}),
        ("sequence_concat", {"X": [f(2, 3, 2), f(2, 4, 2)],
                             "Length": [np.array([3, 1]),
                                        np.array([2, 4])]}, {}),
        ("sequence_expand_as", {"X": [f(3, 2)],
                                "Length": [np.array([2, 0, 3])]},
         {"maxlen": 4}),
        ("sequence_enumerate", {"X": [r.randint(0, 9, (3, 5))],
                                "Length": [np.array([5, 3, 1])]},
         {"win_size": 3, "pad_value": 7}),
        ("sequence_scatter", {"X": [f(2, 6)],
                              "Ids": [r.randint(0, 6, (2, 3))],
                              "Updates": [f(2, 3)],
                              "Length": [np.array([3, 2])]}, {}),
        ("sequence_conv", {"X": [f(3, 5, 2)], "Filter": [f(6, 4)],
                           "Length": [lens]},
         {"contextLength": 3, "contextStart": -1}),
    ]


def _function_cases(np, paddle):
    """(label, a function of the device's tensors, its numpy inputs) of the
    slice's new functions and a BiRNN / GRU with lengths; the CPU's call
    comes first."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.weights import load_paddle_state_dict

    r = np.random.RandomState(1)

    def f(*s):
        return r.randn(*s).astype("float32")

    def rnn(kind):
        state = {}

        def run(x, lens):
            # the CPU's run draws the weights, the card's loads them
            net = (paddle.nn.GRU(4, 6, num_layers=2, direction="bidirect")
                   if kind == "gru" else paddle.nn.BiRNN(
                       paddle.nn.LSTMCell(4, 6), paddle.nn.GRUCell(4, 6)))
            if state:
                load_paddle_state_dict(net, state)
            else:
                state.update({k: v.numpy()
                              for k, v in net.state_dict().items()})
            out, _ = net(x, sequence_length=lens)
            paddle.sum(out * out).backward()
            return [out, x.grad] + [p.grad for p in net.parameters()]
        return run

    return [
        ("ctc_loss", lambda lg, lab, il, ll: [F.ctc_loss(
            lg, lab, il, ll, reduction="none")],
         [f(6, 3, 5), np.array([[1, 2, 2], [3, 4, 0], [1, 1, 1]]),
          np.array([6, 5, 3]), np.array([3, 2, 3])]),
        ("hsigmoid_loss", lambda x, lab, w, b: [F.hsigmoid_loss(
            x, lab, 8, w, b)],
         [f(4, 6), np.array([[7], [1], [5], [0]]), f(7, 6), f(7)]),
        ("gather_tree", lambda ids, par: [F.gather_tree(ids, par)],
         [r.randint(0, 9, (5, 2, 3)), r.randint(0, 3, (5, 2, 3))]),
        ("grid_sample", lambda x, g: [F.grid_sample(x, g)],
         [f(2, 3, 4, 5), r.uniform(-1.2, 1.2, (2, 3, 4, 2)).astype(
             "float32")]),
        ("temporal_shift", lambda x: [F.temporal_shift(x, 4, 0.25)],
         [f(8, 8, 2, 2)]),
        ("GRU with lengths", rnn("gru"), [f(3, 5, 4), np.array([5, 2, 3])]),
        ("BiRNN with lengths", rnn("birnn"), [f(3, 5, 4),
                                              np.array([5, 2, 3])]),
    ]


def _ops_on_card(np, torch):
    """(d): each new registered op and each new function on the card
    against the same call on the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import registry

    worst = {}
    for op, ins, attrs in _new_op_cases(np):
        outs = {}
        for dev in ("cpu", "cuda"):
            t = {s: [torch.as_tensor(np.asarray(a), device=dev) for a in v]
                 for s, v in ins.items()}
            with torch.no_grad():
                got = registry.run_kernel(registry.get_op_def(op), t,
                                          dict(attrs))
            outs[dev] = [a.cpu().numpy() for v in got.values() for a in v]
        for g, w in zip(outs["cuda"], outs["cpu"]):
            err = (_rel_err(np, g, w) if w.dtype.kind == "f" and w.size
                   else float(not np.array_equal(g, w)))
            worst[op] = max(worst.get(op, 0.0), err)
    for label, fn, arrays in _function_cases(np, paddle):
        outs = {}
        for dev in ("cpu", "gpu"):
            paddle.set_device(dev)
            ts = [paddle.to_tensor(a, stop_gradient=a.dtype.kind != "f")
                  for a in arrays]
            outs[dev] = [o.numpy() for o in fn(*ts)]
        paddle.set_device("gpu")
        worst[label] = max(
            _rel_err(np, g, w) if w.dtype.kind == "f"
            else float(not np.array_equal(g, w))
            for g, w in zip(outs["gpu"], outs["cpu"]))
    log(f"new ops and functions, card vs cpu (of each tensor's largest; "
        f"integers 0 when equal): "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}")
    bad = {k: v for k, v in worst.items() if not v <= 1e-5}
    if bad:
        raise AssertionError(f"new ops disagree card vs cpu: {bad}")


def phase_eager_rest(np, torch, card):
    """Phase 15: the rest of the eager API (see the comment above BEAM).
    Returns the beam search's flash launches."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    launches = _beam_base(np, torch, card)
    _beam_small_parity(np, torch)
    paddle.set_device("gpu")
    _ptb(np, torch, card)
    paddle.set_device("gpu")
    _c3d(np, torch, card)
    _interp(np, torch, card)
    paddle.set_device("gpu")
    _ops_on_card(np, torch)
    paddle.set_device("gpu")
    log(card)
    return launches


# -- phase 16 ----------------------------------------------------------------

# Process-level distributed training (BASELINE config 3).  (a) The port's
# launcher at nproc 1 runs examples/train_gpt.py at GPT-1.3B width (hidden
# 2048, 24 layers, 16 heads, vocab 50304; seq 512, batch 8, no remat, bf16
# with fp32 masters) on a one-rank NCCL group: the trainer's rc, its OK
# line and falling losses; then the same build / run in this process as a
# launched rank (the launcher's environment for rank 0 of 1), with 24
# launches of each flash kernel a step asserted, step ms, tokens/s, MFU,
# peak memory and one profiled step.  (b) The same with --int8
# --seq-major, 3 steps: 4 x 24 w8a8_gemm launches a step and the flash
# kernels on sbnd views.  (c) The sharded checkpoint: GPT-1.3B width at 2
# layers, saved after step 2 into a temporary directory, loaded into a
# fresh state of another seed; step 3's loss and every leaf, master and
# moment equal the uninterrupted step 3's bit for bit.  (d) A static
# program of every differentiable c_* op (c_embedding, c_identity,
# c_allreduce_sum, mp_allreduce_sum, c_broadcast, c_allgather,
# c_reducescatter, alltoall, c_concat, c_split,
# c_softmax_with_cross_entropy) and its grads through append_backward, the
# gradients' all-reduce between the stream-ordering ops and a barrier, and
# the loss's all-reduce max / min / prod, run on the one-rank NCCL group,
# held bit for bit to the same program without them (lookup_table_v2 and
# softmax_with_cross_entropy for the two vocabulary-split ops) over
# P16_STATIC steps of SGD.  (e) examples/train_multiprocess_dp.py through
# the launcher at nproc 1: rc 0 and its final check.  Before (a), every
# kernel of (a) and (b) is held to its plain version at the shapes they
# give it: the flash kernels on the 1.3B attention's bsnd (a) and sbnd (b)
# head views (B=8 H=16 S=512 D=128 causal bf16) within FLASH_TOL, and
# w8a8_gemm on the four 1.3B projections at (b)'s P16_ROWS bf16 rows bit
# for bit.  The bsnd attention is timed by graph replay (as SDPA is)
# before (a) and again after (e), in the same call; rows
# flash_*_gpt1p3b_bf16 of the kernels line stand on the later reading.
P16_GPT = ["--config", "1p3b", "--batch", "8", "--steps", "10", "--device",
           "gpu"]
P16_GPT_INT8 = ["--config", "1p3b", "--batch", "8", "--steps", "3", "--int8",
                "--seq-major", "--device", "gpu"]
P16_DP = ["--device", "gpu"]
P16_ROWS = 8 * 512              # (b)'s projection rows: batch x seq
CKPT_CFG = dict(vocab_size=50304, hidden_size=2048, num_layers=2,
                num_heads=16, max_seq_len=2048)
CKPT_BATCH = (8, 512)
P16_STATIC = dict(batch=64, hidden=256, vocab=1024, steps=3)
GPT1P3B_FLASH = ("gpt1p3b", "bsnd", 8, 16, 16, 512, True, None, "bf16")
GPT1P3B_FLASH_SBND = ("gpt1p3b_sbnd", "sbnd", 8, 16, 16, 512, True, None,
                      "bf16")
LAUNCH_TIMEOUT = 600


def _root():
    return os.path.dirname(os.path.abspath(__file__))


def _launch(script, argv, log_dir, label):
    """``script`` through the port's launcher at nproc 1; returns the
    trainer's log.  A non-zero rc raises with the log's tail."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "1", "--log_dir", log_dir,
           os.path.join("paddle_tpu_torch", "examples", script), *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=_root(), capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT)
    path = os.path.join(log_dir, "workerlog.0")
    text = open(path).read() if os.path.exists(path) else ""
    log(f"({label}) {' '.join(cmd[2:])}: rc {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in text.splitlines()[-8:]:
        log(f"  trainer: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"({label}) the launched trainer failed, rc "
                             f"{proc.returncode}: {proc.stderr[-2000:]} "
                             f"{text[-2000:]}")
    return text


@contextlib.contextmanager
def _as_launched_rank():
    """This process as the launcher's rank 0 of 1 (its environment),
    restored after."""
    from paddle_tpu_torch.distributed.launch_utils import (Cluster,
                                                           find_free_port,
                                                           rank_env)

    cluster = Cluster(ips=["127.0.0.1"], nproc_per_node=1,
                      master="127.0.0.1", master_port=find_free_port())
    env = rank_env(cluster, 0)
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _expect(label, launches, want):
    if launches != want:
        raise AssertionError(f"({label}) launched {launches}, expected "
                             f"{want}")


def _gpt_in_process(np, torch, argv, per_step, label):
    """train_gpt's build / run in this process as a launched rank: its
    losses, launches asserted per step, step ms, tokens/s, MFU (the
    example's own: 6 N flops a token over its --peak-flops, 989 TFLOP/s),
    peak memory and a profiled step; returns the launches."""
    import torch.distributed as dist

    from paddle_tpu_torch.examples import train_gpt
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    with _as_launched_rank():
        job = train_gpt.build(argv)
        try:
            reset_launch_counts()
            losses = train_gpt.run(job)
            launches = {k: n for k, n in KERNELS.items() if n}
            _expect(label, launches, {k: n * job.args.steps
                                      for k, n in per_step.items()})
            timed = job.step_ms[1:]
            log(f"({label}) in process on a one-rank "
                f"{dist.get_backend()} group: losses "
                f"{[round(x, 4) for x in losses]}; step "
                f"{float(np.mean(timed)):.1f} ms (timed "
                f"{[round(t, 1) for t in timed]}, first "
                f"{job.step_ms[0]:.1f}), {job.tokens_per_s:.0f} tokens/s, "
                f"MFU {100 * job.mfu:.2f}% of "
                f"{job.args.peak_flops / 1e12:.0f} TFLOP/s, "
                f"max_memory_allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                f"launches {json.dumps(launches)}")
            _profile(torch, f"({label}) one more step", job.step_once)
        except BaseException:
            train_gpt.close(job, barrier=False)
            raise
        train_gpt.close(job)
    if dist.is_initialized():
        raise AssertionError(f"({label}) left a process group up")
    del job
    _free(torch)
    return launches


def _ckpt_run(np, torch, seed, ids, labels, save_at=None, load=None,
              steps=3):
    """GPT-1.3B width at 2 layers: ``steps`` steps, saving after step
    ``save_at`` to the directory ``save_at[1]``, or loading ``load``
    first; returns (the losses, the state after the last step)."""
    from paddle_tpu_torch.models import GPTConfig, GPTParams
    from paddle_tpu_torch.models.gpt import (build_functional_train_step,
                                             load_train_state,
                                             save_train_state,
                                             train_state_dict)

    model = GPTParams(GPTConfig(**CKPT_CFG), device=ids.device, seed=seed)
    step, params, opt = build_functional_train_step(
        model, lr=1e-4, remat=False, ce_chunk_rows=2048)
    if load is not None:
        load_train_state(step, params, opt, load)
    losses = []
    for i in range(opt["t"], steps):
        params, opt, loss = step(params, opt, ids, labels)
        losses.append(float(loss))
        if save_at is not None and i + 1 == save_at[0]:
            t0 = time.perf_counter()
            save_train_state(step, params, opt, save_at[1])
            size = sum(os.path.getsize(os.path.join(save_at[1], f))
                       for f in os.listdir(save_at[1]))
            log(f"(c) saved after step {i + 1}: {size / 2**30:.2f} GiB in "
                f"{time.perf_counter() - t0:.1f} s")
    state = {k: v.clone()
             for k, v in train_state_dict(step, params, opt).items()}
    del model, step, params, opt
    return losses, state


def _checkpoint_on_card(np, torch):
    """(c): the uninterrupted run against save-after-2, load into a fresh
    state, step 3; bit for bit."""
    import shutil
    import tempfile

    rng = np.random.RandomState(3)
    b, s = CKPT_BATCH
    v = CKPT_CFG["vocab_size"]
    dev = torch.device("cuda")
    ids = torch.as_tensor(rng.randint(0, v, (b, s)).astype("int32"),
                          device=dev)
    labels = torch.as_tensor(rng.randint(0, v, (b, s)).astype("int64"),
                             device=dev)
    tmp = tempfile.mkdtemp(prefix="ckpt16_")
    try:
        full, want = _ckpt_run(np, torch, 0, ids, labels, save_at=(2, tmp))
        t0 = time.perf_counter()
        resumed, got = _ckpt_run(np, torch, 1, ids, labels, load=tmp)
        log(f"(c) loaded and stepped in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = [k for k in want if torch.equal(want[k], got[k])]
    log(f"(c) uninterrupted losses {full}, resumed step 3 {resumed}; "
        f"{len(same)} of {len(want)} entries (leaves, masters, moments, t) "
        f"bit for bit")
    if resumed != full[2:] or len(same) != len(want):
        raise AssertionError(f"(c) the resumed step differs: "
                             f"{sorted(set(want) - set(same))[:8]}")
    del want, got
    _free(torch)


def _static_collectives(np, torch, with_ops):
    """(d)'s program, with the c_* ops or without them, run
    ``P16_STATIC["steps"]`` SGD steps from one seed's weights; returns
    (the op types, the fetched losses and final weights)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.ops.dispatch import dispatch_static

    c = P16_STATIC
    main, startup = static.Program(), static.Program()
    paddle.enable_static()
    try:
        with static.program_guard(main, startup), unique_name.guard():
            ids = static.data("ids", [c["batch"]], "int64")
            label = static.data("label", [c["batch"], 1], "int64")
            emb = paddle.create_parameter([c["vocab"], c["hidden"]],
                                          "float32", name="emb")
            w = paddle.create_parameter([c["hidden"], c["vocab"]],
                                        "float32", name="w")

            def op(t, x, **attrs):
                return dispatch_static(t, {"X": [x]},
                                       {"ring_id": 0, **attrs})["Out"][0]

            if with_ops:
                h = dispatch_static("c_embedding", {"W": [emb], "Ids": [ids]},
                                    {"ring_id": 0, "start_index": 0})
                h = op("c_identity", h["Out"][0])
                h = op("c_broadcast", h, root=0)
                h = op("c_allgather", h, nranks=1)
                h = op("c_reducescatter", h, nranks=1)
                h = op("alltoall", h)
                logits = paddle.matmul(h, w)
                logits = D.all_reduce(logits)
                logits = op("mp_allreduce_sum", logits)
                logits = op("c_split", logits, nranks=1)
                logits = op("c_concat", logits, nranks=1)
                loss = dispatch_static(
                    "c_softmax_with_cross_entropy",
                    {"Logits": [logits], "Label": [label]},
                    {"ring_id": 0})["Loss"][0]
            else:
                h = dispatch_static("lookup_table_v2",
                                    {"W": [emb], "Ids": [ids]}, {})["Out"][0]
                logits = paddle.matmul(h, w)
                loss = dispatch_static(
                    "softmax_with_cross_entropy",
                    {"Logits": [logits], "Label": [label]}, {})["Loss"][0]
            avg = paddle.mean(loss)
            static.append_backward(avg)
            lr = static.create_global_var([1], 0.5, "float32",
                                          persistable=True, name="lr")
            fetch = [avg]
            for p in ("emb", "w"):
                g = f"{p}@GRAD"
                if with_ops:
                    # the ops without gradients on the update's side, as
                    # a data-parallel rewrite places them
                    g = op("c_sync_calc_stream", g)
                    g = op("c_allreduce_sum", g)
                    g = op("c_sync_comm_stream", g)
                    g = op("c_wait_compute", g)
                    g = op("barrier", g)
                dispatch_static("sgd", {"Param": [p], "Grad": [g],
                                        "LearningRate": [lr]}, {},
                                outputs={"ParamOut": [p]})
            if with_ops:
                fetch += [op(t, avg) for t in ("c_allreduce_max",
                                               "c_allreduce_min",
                                               "c_allreduce_prod")]
    finally:
        paddle.disable_static()
    exe = static.Executor(paddle.CUDAPlace(0))
    scope = static.global_scope()
    exe.run(startup)
    rng = np.random.RandomState(16)
    dev = torch.device("cuda")
    scope.set("emb", torch.as_tensor(
        rng.randn(c["vocab"], c["hidden"]).astype("float32") * 0.1, device=dev))
    scope.set("w", torch.as_tensor(
        rng.randn(c["hidden"], c["vocab"]).astype("float32") * 0.1, device=dev))
    feed = {"ids": rng.randint(0, c["vocab"], (c["batch"],)).astype("int64"),
            "label": rng.randint(0, c["vocab"],
                                 (c["batch"], 1)).astype("int64")}
    losses = []
    for _ in range(c["steps"]):
        got = exe.run(main, feed=feed, fetch_list=fetch)
        if any(float(x) != float(got[0]) for x in got[1:]):
            raise AssertionError(f"(d) one-rank max / min / prod of the "
                                 f"loss differ from it: {got}")
        losses.append(float(got[0]))
    out = [scope.find_var(n).cpu().clone() for n in ("emb", "w")]
    return [o.type for o in main.global_block().ops], losses, out


def _static_on_card(np, torch):
    """(d): the c_* program against the plain one on a one-rank NCCL
    group."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env

    with _as_launched_rank():
        init_parallel_env()
        try:
            ops, la, wa = _static_collectives(np, torch, True)
            _, lb, wb = _static_collectives(np, torch, False)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    colls = sorted({t for t in ops if t.startswith(("c_", "mp_", "all",
                                                    "barrier"))})
    same = [torch.equal(a, b) for a, b in zip(wa, wb)]
    log(f"(d) static program on a one-rank {backend} group, {len(ops)} ops, "
        f"collective ops and grads {colls}; losses {la} against {lb} "
        f"without them; weights bit for bit {same}")
    if la != lb or not all(same):
        raise AssertionError("(d) the c_* program differs from the plain one")


def _dp_example(tmp):
    """(e): examples/train_multiprocess_dp.py through the launcher."""
    text = _launch("train_multiprocess_dp.py", P16_DP,
                   os.path.join(tmp, "dp"), "e")
    if "params identical across 1 processes OK" not in text:
        raise AssertionError("(e) no final check in the trainer's log")


def phase_dist_training(np, torch, card):
    """Phase 16 (see the comment above P16_GPT).  Returns the
    1.3B attention's kernels-line rows and the launches of (a) and (b)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    if dist.is_initialized():
        raise AssertionError("phase 16 found a process group up")
    errs = _gpt1p3b_kernels(np, torch)
    before = _time_flash(np, torch, GPT1P3B_FLASH, errs, timer=graph_ms)
    before["eager"] = _fwd_eager_ms(np, torch)
    log(f"(timed before (a)) {_clocks()}")
    tmp = tempfile.mkdtemp(prefix="phase16_")
    try:
        text = _launch("train_gpt.py", P16_GPT, os.path.join(tmp, "a"), "a")
        ok = [ln for ln in text.splitlines() if ln.startswith("OK:")]
        if not ok:
            raise AssertionError("(a) no OK line in the trainer's log")
        first, last = (float(x) for x in
                       ok[0].split("loss ")[1].split(",")[0].split(" -> "))
        if not last < first:
            raise AssertionError(f"(a) the loss did not fall: {ok[0]}")
        a = _gpt_in_process(np, torch, P16_GPT, dict.fromkeys(FLASH, 24),
                            "a")
        b = _gpt_in_process(np, torch, P16_GPT_INT8,
                            {**dict.fromkeys(FLASH, 24), "w8a8_gemm": 96},
                            "b")
        _checkpoint_on_card(np, torch)
        _static_on_card(np, torch)
        _dp_example(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = _gpt1p3b_rows(np, torch, errs, before)
    log(card)
    return rows, {"a": a, "b": b}


def _gpt1p3b_kernels(np, torch):
    """Every kernel that (a) and (b) launch, at the shapes they give it,
    against its plain version on the same inputs: the flash forward, dQ
    and dK/dV on (a)'s bsnd and (b)'s sbnd head views within FLASH_TOL,
    and w8a8_gemm on (b)'s four projections at P16_ROWS bf16 rows, bit
    for bit (the output, the quantized rows and their scales).  Returns
    the worst flash error of each kernel over both layouts."""
    from paddle_tpu_torch.kernels import w8a8_gemm, w8a8_gemm_plain

    errs = _flash_case(np, torch, GPT1P3B_FLASH)
    for name, err in _flash_case(np, torch, GPT1P3B_FLASH_SBND).items():
        errs[name] = max(errs[name], err)
    g = torch.Generator(device="cuda").manual_seed(16)
    for proj, (wq, ws, k, n) in _gemm_weights(torch, g, PROJ).items():
        x = torch.randn(P16_ROWS, k, device="cuda", generator=g).bfloat16()
        got = w8a8_gemm(x, wq, ws, return_quantized=True)
        want = w8a8_gemm_plain(x, wq, ws, return_quantized=True)
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"w8a8_gemm GPT-1.3B training {proj} M={P16_ROWS} K={k} N={n}, "
            f"bf16: bit-exact {exact} (max_abs_err "
            f"{(got[0] - want[0]).abs().max().item():.3e})")
        if not exact:
            raise AssertionError(f"w8a8_gemm GPT-1.3B {proj} M={P16_ROWS} "
                                 "is not exact")
        del x, got, want
    _free(torch)
    return errs


def _clocks():
    """The card's SM clock (and its maximum), temperature and power draw
    now, for reading two timings of one call side by side."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,"
         "power.draw", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60)
    return "card now: " + (smi.stdout.strip() or smi.stderr.strip())


def _fwd_eager_ms(np, torch):
    """The 1.3B bsnd forward by CUDA events around eager calls, beside
    its graph-replay reading: the difference is the host's enqueue (the
    wrapper's allocations and launch) where it outlasts the kernel."""
    from paddle_tpu_torch.kernels.flash import flash_fwd_cuda

    _, layout, b, h, hkv, s, causal, window, dt = GPT1P3B_FLASH
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = _qkv_views(torch, g, layout, b, h, hkv, s, 128,
                         torch.bfloat16)
    ms = time_ms(lambda: flash_fwd_cuda(q, k, v, causal, 1.0 / np.sqrt(128),
                                        window, layout))
    del q, k, v
    _free(torch)
    return ms


def _gpt1p3b_rows(np, torch, errs, before):
    """The 1.3B attention timed again after (e) by graph replay, as SDPA
    is, beside ``before`` (the reading before (a), same call and inputs);
    the kernels-line rows, which stand on this later reading."""
    after = _time_flash(np, torch, GPT1P3B_FLASH, errs, timer=graph_ms)
    eager = _fwd_eager_ms(np, torch)
    log(f"(timed after (e)) {_clocks()}")
    log(f"flash_fwd GPT-1.3B bsnd by CUDA events around eager calls, "
        f"before (a) / after (e): {before.pop('eager'):.4f} / {eager:.4f} "
        f"ms")
    for name, row in after.items():
        b = before[name]
        log(f"{name} GPT-1.3B bsnd, before (a) / after (e): kernel "
            f"{b['ms']:.4f} / {row['ms']:.4f} ms, SDPA "
            f"{b['library_ms']:.4f} / {row['library_ms']:.4f} ms, kernel / "
            f"SDPA {b['ms'] / b['library_ms']:.2f}x / "
            f"{row['ms'] / row['library_ms']:.2f}x")
    _free(torch)
    return {f"{name}_gpt1p3b_bf16": row for name, row in after.items()}


# -- phase 17 ----------------------------------------------------------------

# ViT-base/16 (Dosovitskiy et al. 2021) through paddle.Model: 224 px, patch
# 16, width 768, 12 layers of 12 heads (D=64, S=197), 1000 classes, fp32 as
# the reference's Model runs (its prepare takes amp_configs and ignores
# them); the data a DatasetFolder of seeded 256 x 256 x 3 uint8 .npy images
# in 10 class folders of 32, center-cropped to 224, normalised and made
# CHW by vision.transforms; batch 32
HAPI = dict(arch="vit_b_16", img=224, patch=16, classes=1000, hidden=768,
            layers=12, folders=10, per_folder=32, side=256, batch=32,
            static_steps=3, parity_images=4)
# the detection ops at published shapes: YOLOv3 at 608 px, 80 classes, its
# three heads at strides 32 / 16 / 8 with the COCO anchors, and the NMS
# settings of PaddleDetection's yolov3_darknet53 (score 0.01, top 1000 a
# class, keep 100, IoU 0.45, no background class); roi_align and the
# RPN's proposals on a ResNet C4 map (stride 16) of an 800 x 1088 image,
# 512 RoIs at 14 x 14 and 15 anchors a cell (5 sizes x 3 ratios), 6000
# proposals into NMS at 0.7 and 1000 out; DCNv2 (a mask) 3 x 3 at
# [8, 512, 28, 28]
YOLO = dict(batch=2, img=608, classes=80, grids=(19, 38, 76),
            strides=(32, 16, 8),
            anchors=((116, 90, 156, 198, 373, 326), (30, 61, 62, 45, 59, 119),
                     (10, 13, 16, 30, 33, 23)),
            conf=0.005, score=0.01, nms_top_k=1000, keep_top_k=100, nms=0.45)
ROI = dict(c=1024, h=50, w=68, rois=512, out=14, stride=16)
RPN = dict(batch=1, h=50, w=68, stride=16, sizes=(32, 64, 128, 256, 512),
           ratios=(0.5, 1.0, 2.0), pre=6000, post=1000, nms=0.7)
DCN = dict(batch=8, c=512, size=28, k=3)
DET_RTOL = 1e-5     # |card - cpu| <= DET_RTOL * max |cpu|, per output
TP_STATIC = dict(rows=512, hidden=768, ffn=3072, vocab=50304, ids=(4, 128))


def _npy_folder(np, root, c, seed=0):
    """``folders`` class folders of ``per_folder`` seeded uint8 HWC .npy
    images under ``root``; returns the bytes written."""
    rng = np.random.RandomState(seed)
    total = 0
    for k in range(c["folders"]):
        d = os.path.join(root, f"class_{k:02d}")
        os.makedirs(d)
        for i in range(c["per_folder"]):
            img = rng.randint(0, 256, (c["side"], c["side"], 3)).astype(
                "uint8")
            np.save(os.path.join(d, f"{i:03d}.npy"), img)
            total += img.nbytes
    return total


class _LaunchProbe:
    """A hapi callback asserting each batch's flash launches: ``per_train``
    of every kernel a train batch, ``per_eval`` forwards and no backward
    an eval batch; it keeps the train batches' host-clock times."""

    def __init__(self, callbacks, per_train, per_eval):
        from paddle_tpu_torch.kernels import KERNELS

        self._k = KERNELS
        base = callbacks.Callback
        probe = self

        class Probe(base):
            def on_train_batch_begin(self, step, logs=None):
                probe._begin()

            def on_train_batch_end(self, step, logs=None):
                probe._end("train", step, per_train)

            def on_eval_batch_begin(self, step, logs=None):
                probe._begin()

            def on_eval_batch_end(self, step, logs=None):
                probe._end("eval", step, per_eval)

        self.callback = Probe()
        self.times, self.batches = [], {"train": 0, "eval": 0}

    def _begin(self):
        self._before = {k: self._k[k] for k in FLASH}
        self._t0 = time.perf_counter()

    def _end(self, kind, step, want):
        # fit and evaluate read the loss back before this hook: the batch
        # is done on the card
        if kind == "train":
            self.times.append(time.perf_counter() - self._t0)
        got = {k: self._k[k] - self._before[k] for k in FLASH}
        if got != want:
            raise AssertionError(f"(a) {kind} batch {step} launched {got}, "
                                 f"expected {want}")
        self.batches[kind] += 1


def _vit_model(paddle, c, state=None):
    from paddle_tpu_torch.vision import models

    net = getattr(models, c["arch"])(num_classes=c["classes"],
                                     img_size=c["img"])
    if state is not None:
        net.set_state_dict(state)
    return net


def _prepared(paddle, net, c, steps, spec=False):
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.static import InputSpec

    kw = {}
    if spec:
        # the batch is given: ViT's class token expands to the batch, and
        # with a None batch (-1) expand keeps its 1 in both packages, so
        # neither's static ViT builds
        kw = dict(inputs=[InputSpec([c["batch"], 3, c["img"], c["img"]],
                                    "float32", "image")],
                  labels=[InputSpec([c["batch"], 1], "int64", "label")])
    model = paddle.Model(net, **kw)
    sched = paddle.optimizer.lr.CosineAnnealingDecay(1e-4, T_max=2 * steps)
    model.prepare(paddle.optimizer.AdamW(sched, parameters=net.parameters(),
                                         weight_decay=0.01),
                  paddle.nn.CrossEntropyLoss(), Accuracy(topk=(1, 5)))
    return model


def _vit_pipeline(paddle, c):
    T = paddle.vision.transforms
    return T.Compose([T.CenterCrop(c["img"]),
                      T.Normalize([127.5] * 3, [127.5] * 3, "HWC"),
                      T.Transpose()])


def _hapi_fit(np, torch, card, tmp):
    """(a): ViT-base/16 through ``paddle.Model`` in dygraph mode, fp32."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    c = HAPI
    root = os.path.join(tmp, "images")
    nbytes = _npy_folder(np, root, c)
    ds = paddle.vision.datasets.DatasetFolder(root,
                                              transform=_vit_pipeline(paddle,
                                                                      c))
    steps = len(ds) // c["batch"]
    log(f"(a) DatasetFolder: {len(ds)} .npy images in {len(ds.classes)} "
        f"classes, {nbytes / 2**20:.1f} MiB, a sample {ds[0][0].shape} "
        f"{ds[0][0].dtype}")
    paddle.seed(0)
    net = _vit_model(paddle, c)
    init = {k: v.numpy() for k, v in net.state_dict().items()}
    # the first forward on the card against the CPU's, from the same weights
    x0 = np.stack([ds[i][0] for i in range(c["parity_images"])])
    net.eval()
    with paddle.no_grad():
        got = net(paddle.to_tensor(x0)).numpy()
    paddle.set_device("cpu")
    try:
        with paddle.no_grad():
            want = _vit_model(paddle, c, init)(paddle.to_tensor(x0)).numpy()
    finally:
        paddle.set_device("gpu")
    err = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"(a) the first forward ({c['parity_images']} images, fp32 logits), "
        f"card vs cpu: max |diff| / max |cpu| {err:.3e} (bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("(a) ViT-base's forward on the card disagrees "
                             "with the CPU's")
    model = _prepared(paddle, net, c, steps)
    fwd_only = {k: c["layers"] if k == "flash_fwd" else 0 for k in FLASH}
    probe = _LaunchProbe(paddle.callbacks, dict.fromkeys(FLASH, c["layers"]),
                         fwd_only)
    ckpt = os.path.join(tmp, "ckpt")
    cbs = [probe.callback, paddle.callbacks.ModelCheckpoint(save_dir=ckpt),
           paddle.callbacks.LRScheduler(by_step=True),
           paddle.callbacks.EarlyStopping(monitor="loss", patience=1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(ds, ds, batch_size=c["batch"], epochs=1, verbose=1,
              callbacks=cbs)
    fit_s = time.perf_counter() - t0
    fit_launches = {k: KERNELS[k] for k in FLASH}
    peak = torch.cuda.max_memory_allocated() / 2**30
    lr = model._optimizer.get_lr()
    files = sorted(os.listdir(ckpt))
    logs = model.evaluate(ds, batch_size=c["batch"], verbose=0)
    t1 = time.perf_counter()
    preds = model.predict(ds, batch_size=c["batch"], stack_outputs=True)[0]
    pred_s = time.perf_counter() - t1
    want_launches = {k: (2 if k == "flash_fwd" else 1) * c["layers"] * steps
                     for k in FLASH}
    if fit_launches != want_launches or probe.batches != {"train": steps,
                                                          "eval": steps}:
        raise AssertionError(f"(a) fit launched {fit_launches} over "
                             f"{probe.batches}, expected {want_launches}")
    if files != ["0.pdopt", "0.pdparams", "final.pdopt", "final.pdparams"]:
        raise AssertionError(f"(a) ModelCheckpoint wrote {files}")
    if not (np.isfinite(preds).all() and preds.shape == (len(ds),
                                                         c["classes"])):
        raise AssertionError(f"(a) predictions {preds.shape}")
    path = os.path.join(tmp, "vit")
    model.save(path)
    again = _prepared(paddle, _vit_model(paddle, c), c, steps)
    again.load(path)
    preds2 = again.predict(ds, batch_size=c["batch"], stack_outputs=True)[0]
    if not np.array_equal(preds, preds2):
        raise AssertionError("(a) the loaded Model predicts otherwise: max "
                             f"|diff| {np.abs(preds - preds2).max()}")
    step_s = float(np.median(probe.times[2:] or probe.times))
    flops = c["batch"] * vit_flops_per_image(c)
    x, y = next(iter(paddle.io.DataLoader(ds, batch_size=c["batch"])))
    busy = _profile(torch, "ViT-base/16 Model.train_batch fp32",
                    lambda: model.train_batch([x], [y]))
    log(f"(a) ViT-base/16 Model.fit fp32 ({card}): {steps} train + {steps} "
        f"eval batches of {c['batch']} in {fit_s:.2f} s (checkpoints "
        f"included); a train batch {1e3 * step_s:.1f} ms (median after 2 "
        f"warm-up; all {[round(1e3 * t, 1) for t in probe.times]}), "
        f"{c['batch'] / step_s:.1f} images/s, MFU "
        f"{100 * flops / step_s / BF16_FLOPS:.2f}% of 989 TFLOP/s (the bf16 "
        f"peak, as the other phases' fp32 runs) and "
        f"{100 * flops / step_s / FP32_FLOPS:.2f}% of 67 TFLOP/s (fp32 "
        f"FMAs); predict {len(ds) / pred_s:.1f} images/s; "
        f"max_memory_allocated {peak:.2f} GiB; device busy {100 * busy:.1f}% "
        f"of one profiled train batch; lr after the scheduler's steps "
        f"{lr:.3e}; eval {json.dumps(logs)}; launches {json.dumps(fit_launches)}"
        f" ({c['layers']} of each a train batch, {c['layers']} forwards an "
        f"eval batch); checkpoint files {files}; the reloaded Model's "
        f"predictions bit for bit")
    del model, again, net
    _free(torch)
    return init, ds, fit_launches


def _hapi_static(np, torch, init, ds):
    """(b): the same network through the static adapter, 3 train_batch
    calls from (a)'s initial weights, against an eager Model's 3."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts

    c = HAPI
    n = c["static_steps"]
    loader = iter(paddle.io.DataLoader(ds, batch_size=c["batch"]))
    batches = []
    for _ in range(n):
        x, y = next(loader)
        batches.append((x.numpy(), y.numpy().reshape(-1, 1).astype("int64")))
    losses, launches, times = {}, {}, {}
    for mode in ("eager", "static"):
        model = _prepared(paddle, _vit_model(paddle, c, init), c, n,
                          spec=True)
        if mode == "static":
            paddle.enable_static()
        try:
            reset_launch_counts()
            got, ts = [], []
            for x, y in batches:
                t0 = time.perf_counter()
                got.append(float(np.asarray(
                    model.train_batch([x], [y]).numpy()).reshape(-1)[0]))
                ts.append(time.perf_counter() - t0)
            launches[mode] = {k: KERNELS[k] for k in FLASH}
        finally:
            if mode == "static":
                paddle.disable_static()
        losses[mode], times[mode] = got, ts
        del model
        _free(torch)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["static"],
                                                  losses["eager"]))
    log(f"(b) ViT-base/16 through the static adapter, {n} train_batch "
        f"calls: losses {losses['static']} against the eager Model's "
        f"{losses['eager']} (max rel {rel:.3e}, bound 1e-5); ms a batch "
        f"static {[round(1e3 * t, 1) for t in times['static']]}, eager "
        f"{[round(1e3 * t, 1) for t in times['eager']]}; launches static "
        f"{json.dumps(launches['static'])}, eager "
        f"{json.dumps(launches['eager'])}")
    want = dict.fromkeys(FLASH, c["layers"] * n)
    if launches["static"] != want or launches["eager"] != want:
        raise AssertionError(f"(b) launched {launches}, expected {want}")
    if not rel <= 1e-5:
        raise AssertionError("(b) the static adapter's losses differ from "
                             "the eager Model's")
    return launches["static"]


def _det_inputs(np):
    """The seeded inputs of (c), as numpy."""
    rng = np.random.RandomState(17)
    y, r, p, d = YOLO, ROI, RPN, DCN
    heads = [rng.randn(y["batch"], 3 * (5 + y["classes"]), g, g).astype(
        "float32") for g in y["grids"]]
    img = np.full((y["batch"], 2), y["img"], "int32")
    feat = rng.randn(1, r["c"], r["h"], r["w"]).astype("float32")
    hi, wi = r["h"] * r["stride"], r["w"] * r["stride"]
    xy = rng.rand(r["rois"], 2) * [wi - 64, hi - 64]
    wh = rng.rand(r["rois"], 2) * [wi / 2, hi / 2] + 16
    rois = np.concatenate([xy, np.minimum(xy + wh, [wi - 1, hi - 1])],
                          1).astype("float32")
    a = len(p["sizes"]) * len(p["ratios"])
    scores = rng.rand(p["batch"], a, p["h"], p["w"]).astype("float32")
    deltas = (rng.randn(p["batch"], 4 * a, p["h"], p["w"]) * 0.2).astype(
        "float32")
    base = []
    for s in p["sizes"]:
        for ratio in p["ratios"]:
            w_ = s / np.sqrt(ratio)
            h_ = s * np.sqrt(ratio)
            base.append([-w_ / 2, -h_ / 2, w_ / 2, h_ / 2])
    cy, cx = np.meshgrid(np.arange(p["h"]) * p["stride"] + 8,
                         np.arange(p["w"]) * p["stride"] + 8, indexing="ij")
    ctr = np.stack([cx, cy, cx, cy], -1)[:, :, None, :]
    anchors = (ctr + np.asarray(base)[None, None]).astype("float32")
    variances = np.ones_like(anchors)
    im_info = np.array([[p["h"] * p["stride"], p["w"] * p["stride"]]] *
                       p["batch"], "float32")
    k = d["k"]
    dcn = dict(x=rng.randn(d["batch"], d["c"], d["size"], d["size"]).astype(
                   "float32"),
               off=(rng.randn(d["batch"], 2 * k * k, d["size"], d["size"])
                    * 2.0).astype("float32"),
               mask=rng.rand(d["batch"], k * k, d["size"], d["size"]).astype(
                   "float32"),
               w=(rng.randn(d["c"], d["c"], k, k) * 0.02).astype("float32"),
               b=rng.randn(d["c"]).astype("float32"),
               g=rng.randn(d["batch"], d["c"], d["size"], d["size"]).astype(
                   "float32"))
    return dict(heads=heads, img=img, feat=feat, rois=rois, scores=scores,
                deltas=deltas, anchors=anchors, variances=variances,
                im_info=im_info, dcn=dcn)


def _det_run(np, paddle, inp, nms_in=None):
    """The detection ops of (c) on the current place; returns their
    outputs as numpy, the NMS inputs (the concatenated boxes and scores)
    and a callable per op for timing.  ``nms_in``: the NMS inputs to use
    (the card's, so that both devices sort the same scores)."""
    from paddle_tpu_torch.vision import ops

    t = paddle.to_tensor
    y = YOLO
    out, calls = {}, {}
    boxes, scores = [], []
    for h, (x, stride, anchors) in enumerate(zip(inp["heads"], y["strides"],
                                                 y["anchors"])):
        xt, it = t(x), t(inp["img"])

        def yb(xt=xt, it=it, stride=stride, anchors=anchors):
            return ops.yolo_box(xt, it, list(anchors), y["classes"],
                                y["conf"], stride, clip_bbox=True)

        b, s = yb()
        calls[f"yolo_box head {h}"] = yb
        out[f"yolo_box{h}_boxes"], out[f"yolo_box{h}_scores"] = (
            b.numpy(), s.numpy())
        boxes.append(b.numpy())
        scores.append(s.numpy())
    if nms_in is None:
        nms_in = (np.concatenate(boxes, 1),
                  np.ascontiguousarray(np.concatenate(scores, 1).transpose(
                      0, 2, 1)))
    bt, st = t(nms_in[0]), t(nms_in[1])

    def nms():
        return ops.multiclass_nms(bt, st, y["score"], y["nms_top_k"],
                                  y["keep_top_k"], nms_threshold=y["nms"],
                                  normalized=False, background_label=-1,
                                  return_index=True)

    o, n, i = nms()
    calls["multiclass_nms"] = nms
    out["nms_out"], out["nms_num"], out["nms_index"] = (o.numpy(), n.numpy(),
                                                        i.numpy())
    ft, rt = t(inp["feat"]), t(inp["rois"])
    nt = t(np.array([len(inp["rois"])], "int32"))

    def roi():
        return ops.roi_align(ft, rt, boxes_num=nt, output_size=ROI["out"],
                             spatial_scale=1.0 / ROI["stride"])

    out["roi_align"] = roi().numpy()
    calls["roi_align"] = roi
    gi = [t(inp[k]) for k in ("scores", "deltas", "im_info", "anchors",
                              "variances")]

    def gp():
        return ops.generate_proposals(*gi, pre_nms_top_n=RPN["pre"],
                                      post_nms_top_n=RPN["post"],
                                      nms_thresh=RPN["nms"], min_size=0.0,
                                      return_rois_num=True)

    r, rs, rn = gp()
    calls["generate_proposals"] = gp
    out["rpn_rois"], out["rpn_scores"], out["rpn_num"] = (r.numpy(),
                                                          rs.numpy(),
                                                          rn.numpy())
    d = inp["dcn"]
    leaves = [t(d[k], stop_gradient=False) for k in ("x", "off", "w", "b",
                                                      "mask")]
    gt = t(d["g"])

    def dcn():
        o = ops.deform_conv2d(leaves[0], leaves[1], leaves[2], leaves[3],
                              padding=1, mask=leaves[4])
        paddle.sum(o * gt).backward()
        return o

    o = dcn()
    out["dcn_out"] = o.numpy()
    for name, leaf in zip(("x", "offset", "weight", "bias", "mask"), leaves):
        out[f"dcn_grad_{name}"] = leaf.grad.numpy()
        leaf.clear_grad()

    def dcn_timed():
        o = dcn()
        for leaf in leaves:
            leaf.clear_grad()
        return o

    calls["deform_conv2d forward + backward"] = dcn_timed
    return out, nms_in, calls


def _hapi_detection(np, torch, card):
    """(c): the detection ops on the card against the port on the CPU."""
    import paddle_tpu_torch as paddle

    inp = _det_inputs(np)
    got, nms_in, calls = _det_run(np, paddle, inp)
    paddle.set_device("cpu")
    try:
        want, _, _ = _det_run(np, paddle, inp, nms_in)
    finally:
        paddle.set_device("gpu")
    exact = ("nms_num", "nms_index", "rpn_num")
    worst = {}
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"(c) {k}: card {g.shape} {g.dtype}, cpu "
                                 f"{w.shape} {w.dtype}")
        if k in exact:
            if not np.array_equal(g, w):
                bad = np.argwhere(g != w)[:5].tolist()
                raise AssertionError(f"(c) {k} differs at {bad}")
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        worst[k] = float(np.abs(g.astype("float64") - w).max()) / scale
        if not worst[k] <= DET_RTOL:
            i = np.unravel_index(np.argmax(np.abs(g - w)), w.shape)
            raise AssertionError(f"(c) {k}: max |card - cpu| / max |cpu| "
                                 f"{worst[k]:.3e} at {i}: card {g[i]} cpu "
                                 f"{w[i]}")
    # the NMS rows pick the same candidates in the same order: the class
    # column and the kept scores are the card's own inputs
    if not np.array_equal(got["nms_out"][..., :2], want["nms_out"][..., :2]):
        raise AssertionError("(c) multiclass_nms kept other rows")
    ms = {name: time_ms(fn, iters=3, warmup=1) for name, fn in calls.items()}
    log(f"(c) detection ops, card vs the port on the CPU ({card}): counts "
        f"and indices equal (NMS kept {got['nms_num'].tolist()} of "
        f"{YOLO['keep_top_k']}, the RPN {got['rpn_num'].tolist()} of "
        f"{RPN['post']}); values within {DET_RTOL:g} of each output's "
        f"largest magnitude, worst {json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}; "
        f"ms on the card {json.dumps({k: round(v, 3) for k, v in ms.items()})}")
    _free(torch)


def _hapi_flops(np, torch):
    """(d): paddle.flops and paddle.summary of ViT-base/16 on the card and
    on the CPU."""
    import paddle_tpu_torch as paddle

    counts = {}
    for dev in ("gpu", "cpu"):
        paddle.set_device(dev)
        try:
            net = _vit_model(paddle, HAPI)
            with contextlib.redirect_stdout(open(os.devnull, "w")):
                counts[dev] = (paddle.flops(net, [1, 3, HAPI["img"],
                                                  HAPI["img"]]),
                               paddle.summary(net)["total_params"])
        finally:
            paddle.set_device("gpu")
        del net
    log(f"(d) paddle.flops / paddle.summary of ViT-base/16 at 224 px: card "
        f"{counts['gpu']}, cpu {counts['cpu']}")
    if counts["gpu"] != counts["cpu"]:
        raise AssertionError("(d) the counts differ between the devices")
    _free(torch)


def _hapi_tp_static(np, torch):
    """(e): the three tensor-parallel layers as a static program on a
    one-rank NCCL group, against the eager layers, bit for bit."""
    import torch.distributed as dist

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed import fleet, init_parallel_env
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpp
    from paddle_tpu_torch.framework import unique_name

    c = TP_STATIC
    rng = np.random.RandomState(5)
    x = rng.randn(c["rows"], c["hidden"]).astype("float32")
    ids = rng.permutation(c["vocab"])[:int(np.prod(c["ids"]))].reshape(
        c["ids"]).astype("int64")
    gy = rng.randn(c["rows"], c["hidden"]).astype("float32")
    ge = rng.randn(*c["ids"], c["hidden"]).astype("float32")

    def build():
        return [mpp.ColumnParallelLinear(c["hidden"], c["ffn"],
                                         gather_output=False),
                mpp.RowParallelLinear(c["ffn"], c["hidden"],
                                      input_is_parallel=True),
                mpp.VocabParallelEmbedding(c["vocab"], c["hidden"])]

    def forward(layers, xv, iv, gyv, gev):
        col, row, emb = layers
        y, e = row(col(xv)), emb(iv)
        return [y, e], paddle.sum(y * gyv) + paddle.sum(e * gev)

    with _as_launched_rank():
        init_parallel_env()
        try:
            s = fleet.DistributedStrategy()
            s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                                "pp_degree": 1, "sharding_degree": 1}
            fleet.init(is_collective=True, strategy=s)
            backend = dist.get_backend()
            with unique_name.guard():
                eager = build()
            outs, loss = forward(eager, *[paddle.to_tensor(a)
                                          for a in (x, ids, gy, ge)])
            loss.backward()
            params = [p for m in eager for p in (m.weight, m.bias)
                      if p is not None]
            want = [o._t for o in outs] + [p.grad._t for p in params]
            main, startup = static.Program(), static.Program()
            paddle.enable_static()
            try:
                with static.program_guard(main, startup), unique_name.guard():
                    vs = [static.data(n, list(a.shape), str(a.dtype))
                          for n, a in zip(("x", "ids", "gy", "ge"),
                                          (x, ids, gy, ge))]
                    layers = build()
                    souts, sloss = forward(layers, *vs)
                    static.append_backward(sloss)
            finally:
                paddle.disable_static()
            exe = static.Executor()
            scope = static.Scope()
            exe.run(startup, scope=scope)
            sparams = [p for m in layers for p in (m.weight, m.bias)
                       if p is not None]
            for sp, p in zip(sparams, params):
                scope.set(sp.name, p._t.detach().clone())
            got = exe.run(main, feed={"x": x, "ids": ids, "gy": gy,
                                      "ge": ge},
                          fetch_list=souts + [p.name + "@GRAD"
                                              for p in sparams],
                          scope=scope, return_numpy=False)
        finally:
            dist.destroy_process_group()
            mesh_mod.set_mesh(None)
    if len(got) != len(want):
        raise AssertionError(f"(e) fetched {len(got)} of {len(want)}")
    same = [torch.equal(g._t, w) for g, w in zip(got, want)]
    if not all(same):
        log("(e) max |static - eager|: " + str(
            [float((g._t.float() - w.float()).abs().max()) if
             g._t.shape == w.shape else (tuple(g._t.shape), tuple(w.shape))
             for g, w in zip(got, want)]))
    ops = [o.type for o in main.global_block().ops if not o.type.endswith(
        "_grad")]
    log(f"(e) ColumnParallelLinear -> RowParallelLinear and "
        f"VocabParallelEmbedding at mp 1 on a one-rank {backend} group: the "
        f"static program's forward ops {ops}; outputs and the 5 parameters' "
        f"gradients bit for bit the eager layers' {same}")
    if not all(same):
        raise AssertionError("(e) the static program differs from the eager "
                             "layers")


def phase_hapi(np, torch, card):
    """Phase 17 (see the comment above HAPI): (a) ViT-base/16 through
    ``paddle.Model`` in dygraph mode, (b) through the static adapter, (c)
    the detection ops card vs CPU, (d) ``paddle.flops`` / ``summary``, (e)
    the tensor-parallel layers in a static program.  Returns the ViT
    attention's kernels-line rows and the launches of (a) and (b)."""
    import shutil
    import tempfile

    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    g = torch.Generator(device="cuda").manual_seed(7)
    n_tok = (HAPI["img"] // HAPI["patch"]) ** 2 + 1
    q, k, v = _qkv_views(torch, g, "bnsd", HAPI["batch"], 12, 12, n_tok,
                         HAPI["hidden"] // 12, torch.float32)
    rows = _time_flash_model(np, torch, "vitfit", q, k, v, None)
    del q, k, v
    tmp = tempfile.mkdtemp(prefix="phase17_")
    try:
        init, ds, fit_launches = _hapi_fit(np, torch, card, tmp)
        static_launches = _hapi_static(np, torch, init, ds)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del init, ds
    _free(torch)
    _hapi_detection(np, torch, card)
    _hapi_flops(np, torch)
    _hapi_tp_static(np, torch)
    log(card)
    return rows, {"vitfit": (
        "phase 17 (a) ViT-base/16 Model.fit fp32 (train + eval)",
        fit_launches,
        {"phase 17 (b) ViT-base/16 static adapter fp32, 3 train_batch":
         static_launches})}


# -- phase 18 ----------------------------------------------------------------

# (a) BERT-base (models/bert.py's config: vocab 30522) pretrained under 2:4
# ASP and gradient merge, bf16 auto_cast, batch 32 x 512 with phase 8's
# seeded batches (76 masked a sequence): GradientMergeOptimizer(
# asp.decorate(AdamW(1e-4, weight_decay=0.01)), k_steps=4) and an EMA
# (decay 0.999) updated after each real update; 8 micro-steps, 2 updates.
# The narrow BERT of the card-vs-CPU check runs the same wrappers in fp32.
ASP_BERT = dict(vocab=30522, hidden=768, layers=12, heads=12, seq=512,
                batch=32, masked=76, k=4, micro=8, lr=1e-4)
ASP_SMALL = dict(vocab=1024, hidden=128, layers=2, heads=4, seq=128,
                 batch=8, masked=20, k=4, micro=8, lr=1e-4)
ASP_RTOL = 1e-5          # small BERT card vs CPU: losses, EMA shadows
# (b) ResNet-50 under LookAhead(Momentum) and ModelAverage, then ONNX
R50_LA = dict(batch=64, image=224, classes=1000, steps=10, lr=0.1, k=5)
ONNX_RTOL = 1e-4         # |runner - card| <= ONNX_RTOL * max |card logits|
# (c) the fused softmax masks at GPT-1.3B's causal scores and ERNIE-3.0-
# base's padded ones; the distributions at GPT's vocabulary
SOFTMAX_CASES = (("GPT-1.3B causal", (8, 16, 512, 512), True, "fp32"),
                 ("GPT-1.3B causal", (8, 16, 512, 512), True, "bf16"),
                 ("ERNIE-3.0-base padded", (32, 12, 512, 512), False,
                  "fp32"))
# |card - cpu| <= tol * max |cpu|, per output: the smoke's fp32 tolerance
# (DET_RTOL) and its bf16 one (FLASH_TOL's rtol); the flash kernels'
# per-row bound has no room for a row that cancels (the first causal
# query's dx is g - g)
SOFTMAX_RTOL = {"fp32": DET_RTOL, "bf16": FLASH_TOL["bf16"]["out"][0]}
CATEGORICAL = dict(rows=4096, vocab=50304, draws=64)
SHARE_Z = 7.0            # |share - mean p| <= SHARE_Z * sqrt(mean p / N)
DIST_SHAPE = (4096, 1024)
DIST_RTOL = 1e-5         # card vs CPU, of each output's largest magnitude
CUSTOM_RELU = (4096, 4096)
RELU_CC = r'''
#include "paddle_tpu_ext.h"

extern "C" {
PT_EXPORT_OPS("relu_p18")

int pt_relu_p18_num_outputs(void) { return 1; }

int pt_relu_p18_infer_shape(const int64_t* in_dims, const int32_t* in_ndims,
                            const int32_t* in_dtypes, int n_in,
                            int64_t* out_dims, int32_t* out_ndims,
                            int32_t* out_dtypes) {
  if (n_in != 1 || in_dtypes[0] != PT_FLOAT32) return 1;
  out_ndims[0] = in_ndims[0];
  out_dtypes[0] = in_dtypes[0];
  for (int i = 0; i < in_ndims[0]; ++i) out_dims[i] = in_dims[i];
  return 0;
}

int pt_relu_p18_forward(const PT_Tensor* ins, int n_in, PT_Tensor* outs,
                        int n_out) {
  const float* x = (const float*)ins[0].data;
  float* y = (float*)outs[0].data;
  const int64_t n = pt_numel(&ins[0]);
  for (int64_t i = 0; i < n; ++i) y[i] = x[i] > 0.f ? x[i] : 0.f;
  return 0;
}

int pt_relu_p18_backward(const PT_Tensor* ins, int n_in, PT_Tensor* outs,
                         int n_out) {
  const float* x = (const float*)ins[0].data;
  const float* g = (const float*)ins[1].data;
  float* dx = (float*)outs[0].data;
  const int64_t n = pt_numel(&ins[0]);
  for (int64_t i = 0; i < n; ++i) dx[i] = x[i] > 0.f ? g[i] : 0.f;
  return 0;
}
}
'''


def _asp_bert(np, torch, c, device, amp, state=None, keep=False,
              card=None):
    """BERT of config ``c`` on ``device`` under ASP 2:4, GradientMerge(
    decorate(AdamW), k) and an EMA, ``c["micro"]`` micro-steps.  After
    each real update: ``check_sparsity`` and density 0.5 on every pruned
    weight, zeros where its mask says, the EMA's apply / restore bit for
    bit.  Returns the run's record (``keep``: the masks and the EMA
    shadows as numpy; ``card``: the timings, memory and profiles)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import incubate, optimizer as opt
    from paddle_tpu_torch.examples import pretrain_bert as ex
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         BertPretrainingCriterion)
    from paddle_tpu_torch.weights import (load_paddle_state_dict,
                                          state_dict_to_numpy)

    paddle.set_device(device)
    on_card = device != "cpu"
    old = unique_name.switch()
    try:
        paddle.seed(0)
        cfg = BertConfig(vocab_size=c["vocab"], hidden_size=c["hidden"],
                         num_layers=c["layers"], num_heads=c["heads"],
                         max_seq_len=c["seq"], dropout=0.0)
        model = BertForPretraining(cfg)
        crit = BertPretrainingCriterion()
        if state is not None:
            load_paddle_state_dict(model, state)
        init = state_dict_to_numpy(model) if keep and state is None else None
        asp._helper.reset()
        t0 = time.perf_counter()
        helper = asp.prune_model(model, 2, 4)
        prune_s = time.perf_counter() - t0
        pruned = sorted(p.name for p in helper._params.values())
        gm = incubate.GradientMergeOptimizer(asp.decorate(opt.AdamW(
            learning_rate=c["lr"], parameters=model.parameters(),
            weight_decay=0.01)), k_steps=c["k"])
        ema = incubate.ExponentialMovingAverage(model.parameters(),
                                                decay=0.999)
        batches = [ex.make_batch(cfg, c["batch"], c["seq"], c["masked"],
                                 seed) for seed in range(c["micro"])]

        def micro(i):
            ids, tt, pos, mlm, nsp = batches[i % len(batches)]
            ctx = paddle.amp.auto_cast() if amp else contextlib.nullcontext()
            with ctx:
                mlm_logits, nsp_logits = model(
                    paddle.to_tensor(ids), paddle.to_tensor(tt),
                    masked_positions=paddle.to_tensor(pos))
                loss = crit(mlm_logits, nsp_logits, paddle.to_tensor(mlm),
                            paddle.to_tensor(nsp),
                            masked_lm_scale=float(pos.size))
            loss.backward()
            gm.step()
            update = (i + 1) % c["k"] == 0
            if update:
                ema.update()
            return loss, update

        def checks(i):
            for k, p in helper._params.items():
                mask = helper._masks[k]
                if not (asp.check_sparsity(p, 2, 4)
                        and asp.calculate_density(p) == 0.5
                        and not bool(((p._t != 0) & (mask == 0)).any())):
                    raise AssertionError(
                        f"ASP ({device}): {p.name} lost its 2:4 mask after "
                        f"micro-step {i} (density "
                        f"{asp.calculate_density(p)})")
            before = [p._t.clone() for p in model.parameters()]
            with ema.apply():
                pass
            if not all(torch.equal(a, p._t)
                       for a, p in zip(before, model.parameters())):
                raise AssertionError("EMA apply / restore changed a weight")

        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, times = [], []
        for i in range(c["micro"]):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, update = micro(i)
            losses.append(float(loss.numpy()))       # synchronises
            times.append(time.perf_counter() - t0)
            if update:
                checks(i)
        launches = {k: KERNELS[k] for k in FLASH}
        run = {"losses": losses, "times": times, "launches": launches,
               "pruned": pruned, "init": init, "prune_s": prune_s,
               "cfg": cfg, "n_pruned": sum(p.size for p in
                                           helper._params.values()),
               "n_params": sum(p.size for p in model.parameters())}
        if keep:
            run["masks"] = {helper._params[k].name: m.cpu().numpy()
                            for k, m in helper._masks.items()}
            names = {id(p): p.name for p in model.parameters()}
            run["ema"] = {names[k]: s.cpu().numpy()
                          for k, s in ema._shadow.items()}
        if card is not None:
            run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

            def window():
                for i in range(c["k"]):
                    micro(i)
                torch.cuda.synchronize()

            run["busy"] = _profile(torch, "one merge window (4 micro-steps, "
                                   "the last the update)", window)
            run["update"] = _update_breakdown(torch, gm, helper, ema, micro,
                                              c["k"])
        del gm, ema, helper, model
        asp._helper.reset()
        return run
    finally:
        unique_name.switch(old)
        paddle.set_device("gpu")


def _update_breakdown(torch, gm, helper, ema, micro, k):
    """The device time of the update micro-step by part, from one profile
    of it (CPU and CUDA activity) with each part in a ``record_function``
    range: the gradient accumulation and the mean's cast (GradientMerge's
    own step outside the inner step), AdamW, the masks, the EMA; the
    forward and backward are the rest.  Returns ``{part: ms}``, or None
    where the profiler ties no kernel to a host op."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dec = gm.inner_optimizer
    adamw = dec._inner

    def ranged(label, fn):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run

    saved = (adamw.step, helper.apply_masks, ema.update, gm.step)
    adamw.step = ranged("p18.adamw", saved[0])
    helper.apply_masks = ranged("p18.masks", saved[1])
    ema.update = ranged("p18.ema", saved[2])
    gm.step = ranged("p18.merge", saved[3])
    try:
        for i in range(k - 1):
            micro(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            micro(k - 1)
            torch.cuda.synchronize()
    finally:
        del adamw.step, helper.apply_masks, ema.update, gm.step
    events = prof.events()
    # each kernel to the innermost range around the host op that
    # launched it (the ranges nest: AdamW and the masks inside the
    # merge's step)
    ranges = [(e.time_range.start, e.time_range.end, e.name[4:])
              for e in events if e.name.startswith("p18.")]
    parts = dict.fromkeys(("forward and backward", "accumulation", "adamw",
                           "masks", "ema"), 0.0)
    for e in events:
        kernels = getattr(e, "kernels", None) or []
        if not kernels or e.name.startswith("p18."):
            continue
        t = e.time_range.start
        hit = [label for s, end, label in ranges if s <= t <= end]
        label = next((h for h in hit if h in ("adamw", "masks", "ema")),
                     "accumulation" if "merge" in hit
                     else "forward and backward")
        parts[label] += sum(k.duration for k in kernels) / 1e3
    total = sum(parts.values())
    if not total:
        log("  update micro-step: the profiler tied no kernel to a host op "
            "(device time by part: not measured)")
        return None
    log(f"  update micro-step: device {total:.2f} ms, by part (each kernel "
        "to the range of the host op that launched it): " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts.items()))
    return dict(parts, total=total)


def _asp_parity(np, torch):
    """(a) 2: the narrow BERT in fp32 with the same wrappers, 8 micro-steps
    on the card and in the port on the CPU from the same weights: losses
    and the EMA shadows (all together) within ASP_RTOL, masks equal bit
    for bit, 2 layers' flash launches a micro-step on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = _asp_bert(np, torch, ASP_SMALL, "cpu", False, keep=True)
    card = _asp_bert(np, torch, ASP_SMALL, "gpu", False, state=cpu["init"],
                     keep=True)
    _free(torch)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                  cpu["losses"]))
    # all shadows together: a zero-initialised bias's shadow is 1e-3 of
    # its AdamW updates, which amplify rounding where a gradient is tiny
    # (tests/torch_step_parity.py), so each shadow alone is logged
    diff = sum(float(np.square(card["ema"][n] - w).sum())
               for n, w in cpu["ema"].items())
    ema = (diff / sum(float(np.square(w).sum())
                      for w in cpu["ema"].values())) ** 0.5
    worst = max(((float(np.linalg.norm(card["ema"][n] - w)
                        / max(np.linalg.norm(w), 1e-30)), n)
                 for n, w in cpu["ema"].items()))
    same = (card["masks"].keys() == cpu["masks"].keys()
            and all(np.array_equal(card["masks"][n], m)
                    for n, m in cpu["masks"].items()))
    log(f"ASP + gradient merge + EMA, small BERT card vs cpu (fp32, "
        f"{ASP_SMALL['micro']} micro-steps): losses card "
        f"{[round(v, 6) for v in card['losses']]} cpu "
        f"{[round(v, 6) for v in cpu['losses']]}, rel err {rel:.3e}; EMA "
        f"shadows together rel err {ema:.3e} (tol {ASP_RTOL:g}; the worst "
        f"alone {worst[0]:.3e}, {worst[1]}); "
        f"{len(cpu['masks'])} masks equal: {same}; launches "
        f"{json.dumps(card['launches'])}")
    if not (rel <= ASP_RTOL and ema <= ASP_RTOL and same):
        raise AssertionError("ASP training on the card disagrees with the "
                             "CPU")
    want = {k: ASP_SMALL["micro"] * ASP_SMALL["layers"] for k in FLASH}
    if card["launches"] != want:
        raise AssertionError(f"small ASP BERT launched {card['launches']}")


def _asp_bert_base(np, torch, card):
    """(a) 1: BERT-base at full width under ASP and gradient merge, bf16;
    returns its flash launches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    c = ASP_BERT
    run = _asp_bert(np, torch, c, "gpu", True, card=card)
    _free(torch)
    # the pruned set, against the port's selection for the same model on
    # the CPU
    paddle.set_device("cpu")
    old = unique_name.switch()
    try:
        paddle.seed(0)
        cpu_model = BertForPretraining(BertConfig(
            vocab_size=c["vocab"], hidden_size=c["hidden"],
            num_layers=c["layers"], num_heads=c["heads"],
            max_seq_len=c["seq"], dropout=0.0))
        cpu_set = sorted(p.name for p in cpu_model.parameters()
                         if asp._prunable(p))
    finally:
        unique_name.switch(old)
        paddle.set_device("gpu")
    del cpu_model
    if run["pruned"] != cpu_set:
        raise AssertionError("the pruned set differs from the CPU's: "
                             f"{run['pruned']} vs {cpu_set}")
    want = {k: 12 * c["micro"] for k in FLASH}
    if run["launches"] != want:
        raise AssertionError(f"ASP BERT-base launched {run['launches']}, "
                             f"expected {want}")
    losses = run["losses"]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"ASP BERT-base: losses {losses}")
    times = run["times"]
    k = c["k"]
    plain = [t for i, t in enumerate(times) if (i + 1) % k and i >= k]
    upd = [t for i, t in enumerate(times) if not (i + 1) % k and i >= k]
    window = sum(times[k:2 * k])
    tokens = c["batch"] * c["seq"] * k
    cfg = run["cfg"]
    fpt = bert_flops_per_token(cfg.hidden_size, cfg.num_layers, c["seq"],
                               cfg.vocab_size, c["masked"] / c["seq"])
    mfu = tokens / window * fpt / BF16_FLOPS
    log(f"ASP 2:4 + gradient merge (k={k}) + EMA, BERT-base bf16 auto_cast "
        f"(B={c['batch']} S={c['seq']} {c['masked']} masked, vocab "
        f"{c['vocab']}, {card}): {len(run['pruned'])} weights pruned "
        f"({run['n_pruned'] / 1e6:.1f}M of {run['n_params'] / 1e6:.1f}M "
        f"parameters, masks picked on the host in {run['prune_s']:.2f} s), "
        f"the set equal to the CPU's; losses "
        f"{[round(v, 4) for v in losses]}; micro-step "
        f"{1e3 * float(np.mean(plain)):.1f} ms, the update micro-step "
        f"{1e3 * float(np.mean(upd)):.1f} ms (all "
        f"{[round(1e3 * t, 1) for t in times]}); the second merge window "
        f"{1e3 * window:.1f} ms, {tokens / window:.0f} tokens/s, MFU "
        f"{100 * mfu:.2f}% of 989 TFLOP/s; max_memory_allocated "
        f"{run['peak_gib']:.2f} GiB; device busy {100 * run['busy']:.1f}% "
        f"of one profiled merge window; launches "
        f"{json.dumps(run['launches'])}; sparsity, density 0.5 and the "
        f"EMA's apply / restore held after each update")
    return run["launches"]


def _resnet_lookahead_onnx(np, torch, card, tmp):
    """(b) ResNet-50 fp32, batch 64 at 224 px: 10 steps of LookAhead(
    Momentum) with ModelAverage; then under ModelAverage.apply() the eval
    forward on the card, ``paddle.onnx.export`` on the card, the file run
    by the port's numpy runner on the host (within ONNX_RTOL of the
    card's logits), and the same Layer moved to the CPU (``Layer.to``)
    and exported there: the same bytes."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import incubate, optimizer as opt
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.onnx import runner
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision import models

    c = R50_LA
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.set_device("gpu")
    with unique_name.guard():
        paddle.seed(0)
        model = models.resnet50(num_classes=c["classes"])
    la = incubate.LookAhead(opt.Momentum(
        learning_rate=c["lr"], momentum=0.9, parameters=model.parameters()),
        alpha=0.5, k=c["k"])
    ma = incubate.ModelAverage(0.15, model.parameters(),
                               min_average_window=2, max_average_window=10)
    g = torch.Generator(device="cuda").manual_seed(18)
    images = torch.randn(c["batch"], 3, c["image"], c["image"],
                         device="cuda", generator=g)
    labels = torch.randint(0, c["classes"], (c["batch"], 1), device="cuda",
                           generator=g)
    losses, times = [], []
    for step in range(c["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = F.cross_entropy(model(paddle.Tensor(images)),
                               paddle.Tensor(labels))
        loss.backward()
        la.step()
        la.clear_grad()
        ma.step()
        losses.append(float(loss.numpy()))
        times.append(time.perf_counter() - t0)
        if (step + 1) % c["k"] == 0 and not all(
                torch.equal(p._t, la._slow[id(p)])
                for p in model.parameters()):
            raise AssertionError("LookAhead: fast weights are not the slow "
                                 f"ones after step {step + 1}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"ResNet-50 LookAhead: losses {losses}")
    spec = [InputSpec([1, 3, c["image"], c["image"]], "float32", "image")]
    x = images[:1].contiguous()
    with ma.apply():
        model.eval()
        want = model(paddle.Tensor(x)).numpy()
        t0 = time.perf_counter()
        path = paddle.onnx.export(model, os.path.join(tmp, "r50_card"),
                                  input_spec=spec)
        export_s = time.perf_counter() - t0
        # the same Layer, its weights moved to the CPU, exported there
        model.to("cpu")
        paddle.set_device("cpu")
        try:
            cpu_path = paddle.onnx.export(
                model, os.path.join(tmp, "r50_cpu"), input_spec=spec)
        finally:
            paddle.set_device("gpu")
            model.to("gpu")
        model.train()
    graph = runner.load(path)
    t0 = time.perf_counter()
    (got,) = runner.run(graph, {graph.input_names[0]: x.cpu().numpy()})
    run_s = time.perf_counter() - t0
    err = float(np.abs(got - want).max() / np.abs(want).max())
    same = open(path, "rb").read() == open(cpu_path, "rb").read()
    del model, la, ma, images, labels
    _free(torch)
    log(f"ResNet-50 fp32 (batch {c['batch']} at {c['image']} px, {card}): "
        f"{c['steps']} steps of LookAhead(Momentum(0.1, 0.9), alpha 0.5, "
        f"k {c['k']}) with ModelAverage(0.15, 2..10): losses "
        f"{[round(v, 4) for v in losses]}, step "
        f"{1e3 * float(np.mean(times[1:])):.1f} ms; ONNX under "
        f"ModelAverage.apply(): {os.path.getsize(path)} bytes, "
        f"{len(graph.nodes)} nodes, export {export_s:.2f} s on the card, "
        f"the numpy runner {run_s:.2f} s; runner vs the card's eval forward "
        f"{err:.3e} of the largest logit {np.abs(want).max():.4g} (tol "
        f"{ONNX_RTOL:g}); the CPU's export of the same weights byte for "
        f"byte the same: {same}")
    if not err <= ONNX_RTOL:
        raise AssertionError("the ONNX runner disagrees with the card")
    if not same:
        raise AssertionError("the card's and the CPU's ONNX files differ")


def _softmax_masks(np, torch):
    """(c) 1: the fused softmax masks forward and backward on the card
    against the port on the CPU, within SOFTMAX_RTOL of each output's
    largest magnitude; ms a call."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import incubate

    g = torch.Generator(device="cuda").manual_seed(19)
    for label, shape, causal, dt in SOFTMAX_CASES:
        dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dt]
        x = (4 * torch.randn(shape, device="cuda", generator=g)).to(dtype)
        gy = torch.randn(shape, device="cuda", generator=g).to(dtype)
        mask = None
        if not causal:
            lens = torch.randint(shape[-1] // 4, shape[-1] + 1,
                                 (shape[0],), device="cuda", generator=g)
            keep = torch.arange(shape[-1], device="cuda")[None] < lens[:, None]
            mask = torch.where(keep, 0.0, -1e4).to(dtype)[:, None, None, :]

        def fn(t, m):
            if causal:
                return incubate.softmax_mask_fuse_upper_triangle(t)
            return incubate.softmax_mask_fuse(t, m)

        outs = {}
        for dev, place in (("cuda", "gpu"), ("cpu", "cpu")):
            paddle.set_device(place)
            t = paddle.Tensor(x.to(dev), stop_gradient=False)
            m = None if mask is None else paddle.Tensor(mask.to(dev))
            y = fn(t, m)
            y.backward(paddle.Tensor(gy.to(dev)))
            outs[dev] = (y._t, t.grad._t)
        paddle.set_device("gpu")
        if (outs["cpu"][0].device.type != "cpu"
                or outs["cuda"][0].device != x.device):
            raise AssertionError("the softmax masks ran on the wrong device")
        what = f"softmax_mask_fuse{'_upper_triangle' if causal else ''} " \
            f"{label} {list(shape)} {dt}"
        for part, (got, want) in zip(("out", "dx"), zip(outs["cuda"],
                                                         outs["cpu"])):
            want = want.to(got.device).float()
            err = (got.float() - want).abs().max().item()
            top = want.abs().max().item()
            log(f"{what} {part}, card vs cpu: max_abs_err {err:.3e}, "
                f"{err / top:.3e} of the largest {top:.3e} (tol "
                f"{SOFTMAX_RTOL[dt]:g})")
            if not err <= SOFTMAX_RTOL[dt] * top:
                raise AssertionError(f"{what} {part}: the card disagrees "
                                     "with the CPU")
        t = paddle.Tensor(x)
        m = None if mask is None else paddle.Tensor(mask)
        fwd = time_ms(lambda: fn(t, m), iters=10)
        tg = paddle.Tensor(x, stop_gradient=False)

        def fwd_bwd():
            fn(tg, m).backward(paddle.Tensor(gy))
            tg.clear_grad()

        both = time_ms(fwd_bwd, iters=5)
        log(f"{what}: forward {fwd:.3f} ms, forward + backward {both:.3f} "
            "ms a call")
        del outs, x, gy, mask, t, tg
        _free(torch)


def _rel_max(np, got, want):
    """max |got - want| over max |want| where ``want`` is finite; inf
    unless both are non-finite at the same places with the same values
    (a uniform draw at its low end has log_prob -inf on both devices)."""
    got, want = np.asarray(got, "float64"), np.asarray(want, "float64")
    fin = np.isfinite(want)
    if not (np.array_equal(fin, np.isfinite(got))
            and np.array_equal(got[~fin], want[~fin])):
        return float("inf")
    return float(np.abs(got[fin] - want[fin]).max()
                 / np.abs(want[fin]).max())


def _distributions(np, torch):
    """(c) 2: ``Categorical`` over [4096, 50304] weights (GPT's vocabulary)
    and ``Normal`` / ``Uniform`` over [4096, 1024] on the card: equal draws
    for one seed, the draws' statistics, and ``log_prob`` / ``entropy`` /
    ``kl_divergence`` against the port on the CPU within DIST_RTOL of each
    output's largest magnitude."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distribution as D

    c = CATEGORICAL
    g = torch.Generator(device="cuda").manual_seed(20)
    w = torch.exp(0.5 * torch.randn(c["rows"], c["vocab"], device="cuda",
                                    generator=g))
    w2 = torch.exp(0.5 * torch.randn(c["rows"], c["vocab"], device="cuda",
                                     generator=g))
    cat = D.Categorical(paddle.Tensor(w))
    paddle.seed(11)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s1 = cat.sample([c["draws"]])
    torch.cuda.synchronize()
    draw_ms = 1e3 * (time.perf_counter() - t0)
    paddle.seed(11)
    s2 = cat.sample([c["draws"]])
    paddle.seed(12)
    s3 = cat.sample([c["draws"]])
    n = c["rows"] * c["draws"]
    counts = torch.bincount(s1._t.reshape(-1), minlength=c["vocab"])
    pbar = (w / w.sum(-1, keepdim=True)).double().mean(0)
    z = ((counts.double() / n - pbar).abs() / (pbar / n).sqrt()).max().item()
    value = s1._t.t().contiguous()                # [rows, draws]
    card = {"entropy": cat.entropy().numpy(),
            "kl": cat.kl_divergence(D.Categorical(paddle.Tensor(w2))).numpy(),
            "log_prob": cat.log_prob(paddle.Tensor(value)).numpy()}
    paddle.set_device("cpu")
    try:
        cpu_cat = D.Categorical(paddle.Tensor(w.cpu()))
        cpu = {"entropy": cpu_cat.entropy().numpy(),
               "kl": cpu_cat.kl_divergence(
                   D.Categorical(paddle.Tensor(w2.cpu()))).numpy(),
               "log_prob": cpu_cat.log_prob(
                   paddle.Tensor(value.cpu())).numpy()}
        on_cpu = cpu_cat.logits._t.device.type == "cpu"
    finally:
        paddle.set_device("gpu")
    if not (on_cpu and cat.logits._t.device == w.device):
        raise AssertionError("Categorical ran on the wrong device")
    errs = {k: _rel_max(np, card[k], cpu[k]) for k in card}
    log(f"Categorical [{c['rows']}, {c['vocab']}]: {c['draws']} draws a row "
        f"in {draw_ms:.1f} ms; the same seed draws the same: "
        f"{torch.equal(s1._t, s2._t)}, another seed differs: "
        f"{not torch.equal(s1._t, s3._t)}; pooled shares vs the mean "
        f"probabilities, worst z {z:.2f} (bound {SHARE_Z:g}); card vs cpu "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
        f"(tol {DIST_RTOL:g})")
    if not (torch.equal(s1._t, s2._t) and not torch.equal(s1._t, s3._t)
            and z <= SHARE_Z and max(errs.values()) <= DIST_RTOL):
        raise AssertionError("Categorical on the card failed its checks")
    del w, w2, cat, cpu_cat, s1, s2, s3, counts, pbar, value, card, cpu
    _free(torch)

    shape = DIST_SHAPE
    loc = torch.randn(shape, device="cuda", generator=g)
    scale = torch.rand(shape, device="cuda", generator=g) + 0.5
    low = torch.randn(shape, device="cuda", generator=g)
    high = low + torch.rand(shape, device="cuda", generator=g) + 0.1
    loc2 = torch.randn(shape, device="cuda", generator=g)
    scale2 = torch.rand(shape, device="cuda", generator=g) + 0.5
    for name, args, kl in (("Normal", (loc, scale), (loc2, scale2)),
                           ("Uniform", (low, high), None)):
        cls = getattr(D, name)
        dist = cls(*[paddle.Tensor(a) for a in args])
        s = dist.sample([4], seed=3)._t
        same = torch.equal(s, dist.sample([4], seed=3)._t)
        other = not torch.equal(s, dist.sample([4], seed=4)._t)
        n = s.numel()
        if name == "Normal":
            u = (s - loc) / scale
            stats = (u.mean().item(), u.std().item())
            ok = abs(stats[0]) <= 5 / n ** 0.5 and \
                abs(stats[1] - 1) <= 5 * (2 / n) ** 0.5
        else:
            u = (s - low) / (high - low)
            stats = (u.mean().item(), u.min().item(), u.max().item())
            # in [low, high]: low + u (high - low) can round to high
            ok = abs(stats[0] - 0.5) <= 5 * (1 / 12 / n) ** 0.5 and \
                stats[1] >= 0 and stats[2] <= 1
        value = s[0]
        card = {"log_prob": dist.log_prob(paddle.Tensor(value)).numpy(),
                "entropy": dist.entropy().numpy()}
        if kl is not None:
            card["kl"] = dist.kl_divergence(
                cls(*[paddle.Tensor(a) for a in kl])).numpy()
        paddle.set_device("cpu")
        try:
            cpu_dist = cls(*[paddle.Tensor(a.cpu()) for a in args])
            cpu = {"log_prob": cpu_dist.log_prob(
                       paddle.Tensor(value.cpu())).numpy(),
                   "entropy": cpu_dist.entropy().numpy()}
            if kl is not None:
                cpu["kl"] = cpu_dist.kl_divergence(
                    cls(*[paddle.Tensor(a.cpu()) for a in kl])).numpy()
            on_cpu = (s.device == loc.device and
                      cpu_dist.entropy()._t.device.type == "cpu")
        finally:
            paddle.set_device("gpu")
        if not on_cpu:
            raise AssertionError(f"{name} ran on the wrong device")
        errs = {k: _rel_max(np, card[k], cpu[k]) for k in card}
        log(f"{name} {list(shape)}: 4 seeded draws, same seed equal: {same}, "
            f"another differs: {other}; standardised draws {stats}; card vs "
            f"cpu {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}"
            f" (tol {DIST_RTOL:g})")
        if not (same and other and ok and max(errs.values()) <= DIST_RTOL):
            raise AssertionError(f"{name} on the card failed its checks")
    _free(torch)


def _utilities(np, torch, tmp):
    """(d) ``utils.run_check()`` on the card, and a custom C++ ReLU from
    ``cpp_extension.load`` (g++) on a CUDA tensor: forward and gradient
    bit for bit ``F.relu``'s; ms a call, the host round trip included."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.utils import cpp_extension

    paddle.utils.run_check()
    src = os.path.join(tmp, "relu_p18.cc")
    with open(src, "w") as f:
        f.write(RELU_CC)
    t0 = time.perf_counter()
    ext = cpp_extension.load("relu_p18", [src], build_directory=tmp)
    build_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(CUSTOM_RELU, device="cuda", generator=g)
    gy = torch.randn(CUSTOM_RELU, device="cuda", generator=g)
    tx = paddle.Tensor(x, stop_gradient=False)
    out = ext.relu_p18(tx)
    out.backward(paddle.Tensor(gy))
    xr = x.clone().requires_grad_(True)
    ref = torch.nn.functional.relu(xr)
    ref.backward(gy)
    same = (out._t.device == x.device == tx.grad._t.device
            and torch.equal(out._t, ref) and torch.equal(tx.grad._t, xr.grad))
    tn = paddle.Tensor(x)
    ms = time_ms(lambda: ext.relu_p18(tn), iters=5, warmup=1)
    lib = time_ms(lambda: torch.nn.functional.relu(x))
    log(f"custom op relu_p18 (g++ {build_s:.2f} s) on a CUDA tensor "
        f"{list(CUSTOM_RELU)}: forward and gradient bit for bit F.relu's: "
        f"{same}; {ms:.2f} ms a call with the host round trip (F.relu on "
        f"the card {lib:.4f} ms)")
    if not same:
        raise AssertionError("the custom op disagrees with F.relu")


def phase_breadth(np, torch, card):
    """Phase 18: (a) BERT-base under ASP 2:4, gradient merge and an EMA
    in bf16, and the narrow BERT card vs CPU; (b) ResNet-50 under
    LookAhead and ModelAverage, exported to ONNX; (c) the fused softmax
    masks and the distributions at published shapes; (d) ``run_check``
    and a custom C++ op.  Returns the BERT-base bf16 flash rows timed
    again here and (a)'s launches."""
    import shutil
    import tempfile

    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    rows = _time_flash_bert(np, torch, "bf16")
    _asp_parity(np, torch)
    launches = _asp_bert_base(np, torch, card)
    tmp = tempfile.mkdtemp(prefix="phase18_")
    try:
        _resnet_lookahead_onnx(np, torch, card, tmp)
        _softmax_masks(np, torch)
        _distributions(np, torch)
        _utilities(np, torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(card)
    return rows, launches


# -- phase 19 ----------------------------------------------------------------

# the reference's inputs on the card: BERT-base (phase 8's shape) under
# fp16 O1 with a dynamic GradScaler, then O2 under decorate(float16), and
# runs with a trainable [H, S, S] attention bias and a trainable [B, 1, 1,
# S] pad mask (the dBias path, both of emit_dbias's reductions); causal
# cross-attention with more queries than keys trained in fp16 (the rows
# with no key); the small BERT card vs CPU in fp16 with a forced overflow
# at init_loss_scaling 2^24
P19_O1_STEPS = 6                # 1 warm-up and 5 timed
P19_O2_STEPS = 2
P19_BIAS_STEPS = 2
P19_NOKEY_STEPS = 3
P19_SMALL_STEPS = 4
# the small BERT's fp16 losses card vs CPU, relative: measured 5.9e-5 on
# an H100 80GB HBM3 at 700 W, a third of one step's loss change (3e-3)
P19_SMALL_TOL = 1e-3
# each step's loss change card vs CPU, as a share of the largest change
# on the CPU: measured 1.8% on the same card; a wrong or missing update
# moves it by a whole step
P19_SMALL_STEP_TOL = 0.1
# the causal Sq > Sk run's first fp16 output against the same weights'
# fp32 output on the CPU (sdpa_plain), as a share of the largest |output|:
# O1 runs the attention in fp16 (the Linears stay fp32, as the
# reference's do), which rounds q, k, v, P and its output to 4.9e-4 of a
# value each; measured 5.1e-4 on an H100 80GB HBM3 at 700 W
P19_NOKEY_TOL = 5e-3
# the small run's GradScaler: 2^24 overflows its first step, decr_ratio
# 2^-8 drops the scale to 2^16, where none of its steps overflows on the
# CPU (2^17 does, now and then): one skipped step, then updates
P19_SMALL_SCALE = (2.0 ** 24, 2.0 ** -8)
# the new kernel cases of (b): label, B, H, Sq, Sk, D, causal, dtype,
# mask kind (``_mask``'s; "hss" a learned [H, Sq, Sk] bias), trainable
P19_CASES = (
    ("bertbase", 32, 12, 512, 512, 64, False, "fp16", None, False),
    ("dbias_pad", 32, 12, 512, 512, 64, False, "fp16", "pad", True),
    ("dbias_hss", 32, 12, 512, 512, 64, False, "fp16", "hss", True),
    ("nokey", 96, 8, 256, 200, 64, True, "fp16", None, False),
)
# the run of (a) whose launches each case's rows report: the run that
# takes that case's variant on the main path
P19_ROW_RUNS = {"bertbase": "O1",
                "dbias_pad": "O1 trainable [B, 1, 1, S] pad mask",
                "dbias_hss": "O1 trainable [H, S, S] bias",
                "nokey": "causal Sq > Sk"}


def _bert_amp_run(np, torch, argv, steps, dtype, level="O1", scale=2.0 ** 16,
                  device="gpu", state=None, train_mask=None, profile=False,
                  decr_ratio=0.5):
    """The pretrain_bert example's loop under ``auto_cast(level, dtype)``
    with a dynamic GradScaler (``scale`` its initial loss scaling,
    ``decr_ratio`` its factor on an overflow), O2
    after ``amp.decorate(level="O2", dtype=dtype)``; ``train_mask``: the
    attention takes a trainable float mask (a parameter the optimizer
    updates), "hss" an [H, S, S] bias, "pad" a [B, 1, 1, S] pad mask.  Returns the initial state, the losses, the scale after each
    step, the step seconds, the flash launches (dBias's included), the
    bias's change and, with ``profile``, the peak memory and the busy
    share of one more step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.examples import pretrain_bert as ex
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.weights import (load_paddle_state_dict,
                                          state_dict_to_numpy)

    paddle.set_device(device)
    args = ex.parse(argv + ["--steps", str(steps), "--device", device])
    old = unique_name.switch()
    try:
        cfg, model, crit, sched, opt = ex.build(args)
        if state is not None:
            load_paddle_state_dict(model, state)
        init = state_dict_to_numpy(model) if state is None else state
        bias = None
        if train_mask is not None:
            shape = ([cfg.num_heads, args.seq, args.seq]
                     if train_mask == "hss" else [args.batch, 1, 1, args.seq])
            bias = paddle.create_parameter(
                shape, "float32",
                default_initializer=paddle.nn.initializer.Constant(0.0))
            opt = popt.AdamW(learning_rate=sched,
                             parameters=model.parameters() + [bias],
                             weight_decay=0.01,
                             grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
            forward = model.forward

            def biased(ids, token_type_ids=None, attn_mask=None, **kw):
                return forward(ids, token_type_ids, attn_mask=bias, **kw)

            model.forward = biased
        if level == "O2":
            model, opt = paddle.amp.decorate(models=model, optimizers=opt,
                                             level="O2", dtype=dtype)
        scaler = paddle.amp.GradScaler(init_loss_scaling=scale,
                                       decr_ratio=decr_ratio)
        batch = ex.make_batch(cfg, args.batch, args.seq, args.masked,
                              args.seed)
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, scales, times = [], [], []
        for _ in range(steps):
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = ex.train_step(model, crit, opt, sched, batch, amp=dtype,
                                 scaler=scaler, level=level)
            losses.append(float(loss.numpy()))          # synchronises
            times.append(time.perf_counter() - t0)
            scales.append(scaler.get_loss_scaling())
        launches = {k: KERNELS[k] for k in FLASH + ("flash_bwd_dq_dbias",)}
        moved = (None if bias is None
                 else float(bias.numpy().astype("float64").std()))
        extra = None
        if profile:
            peak = torch.cuda.max_memory_allocated() / 2**30
            busy = _profile(torch, f"one more {level} {dtype} step",
                            lambda: ex.train_step(model, crit, opt, sched,
                                                  batch, amp=dtype,
                                                  scaler=scaler,
                                                  level=level))
            extra = {"peak_gib": peak, "busy": busy, "cfg": cfg,
                     "args": args}
        return init, losses, scales, times, launches, moved, extra
    finally:
        unique_name.switch(old)
        paddle.set_device("gpu")


def _fp16_parity(np, torch):
    """(a1) The small BERT for P19_SMALL_STEPS steps of the fp16 O1 loop
    with a GradScaler at P19_SMALL_SCALE (its first step overflows:
    skipped, the scale cut) on the card and on the CPU from the same
    weights: the scale sequences equal, the losses within P19_SMALL_TOL
    (fp16 products on two devices), each step's loss change within
    P19_SMALL_STEP_TOL of the CPU's largest (a wrong gradient moves it),
    2 layers' flash launches a step."""
    scale, decr = P19_SMALL_SCALE
    init, cpu, cpu_scales, _, _, _, _ = _bert_amp_run(
        np, torch, BERT_SMALL, P19_SMALL_STEPS, "float16", scale=scale,
        device="cpu", decr_ratio=decr)
    _, card, scales, _, launches, _, _ = _bert_amp_run(
        np, torch, BERT_SMALL, P19_SMALL_STEPS, "float16", scale=scale,
        state=init, decr_ratio=decr)
    _free(torch)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    moves = [np.diff(x) for x in (card, cpu)]
    step = float(np.abs(moves[0] - moves[1]).max()
                 / np.abs(moves[1]).max())
    log(f"eager BERT small fp16 O1 + GradScaler({scale:g}, decr_ratio "
        f"{decr:g}), card vs cpu: losses "
        f"card {card} cpu {cpu}, rel err {rel:.3e} (tol {P19_SMALL_TOL:g}); "
        f"loss changes card {moves[0].tolist()} cpu {moves[1].tolist()}, "
        f"apart by {step:.3e} of the largest (tol {P19_SMALL_STEP_TOL:g}); "
        f"scales card {scales} cpu {cpu_scales}; launches "
        f"{json.dumps(launches)}")
    if (not rel <= P19_SMALL_TOL or not step <= P19_SMALL_STEP_TOL
            or scales != cpu_scales):
        raise AssertionError("the fp16 BERT step on the card disagrees with "
                             "the CPU")
    if scales[0] != scale * decr or card[-1] == card[0]:
        raise AssertionError(f"no skipped first step, or no update after "
                             f"it: scales {scales}, losses {card}")
    want = {k: P19_SMALL_STEPS * 2 for k in FLASH}
    if {k: launches[k] for k in FLASH} != want:
        raise AssertionError(f"small fp16 BERT launched {launches}")


def _bert_fp16(np, torch, card):
    """(a2) BERT-base under fp16 O1 + GradScaler (P19_O1_STEPS steps, the
    first a warm-up), O2 under decorate(float16) (P19_O2_STEPS) and O1
    with a trainable [H, S, S] attention bias and with a trainable [B, 1,
    1, S] pad mask (P19_BIAS_STEPS each, the dBias path): finite losses,
    the scale each step, 12 launches of each flash kernel a step (dQ with
    dBias in the biased runs) and the mask moved; step ms, tokens/s, MFU
    over the fp16 dense peak, peak memory and the busy share of one more
    O1 step.  Returns each run's launches."""
    runs = {}
    for label, level, steps, train_mask in (
            ("O1", "O1", P19_O1_STEPS, None),
            ("O2", "O2", P19_O2_STEPS, None),
            ("O1 trainable [H, S, S] bias", "O1", P19_BIAS_STEPS, "hss"),
            ("O1 trainable [B, 1, 1, S] pad mask", "O1", P19_BIAS_STEPS,
             "pad")):
        _, losses, scales, times, launches, moved, x = _bert_amp_run(
            np, torch, BERT_BASE, steps, "float16", level=level,
            train_mask=train_mask, profile=label == "O1")
        _free(torch)
        dq = "flash_bwd_dq_dbias" if train_mask else "flash_bwd_dq"
        want = {k: 0 for k in FLASH + ("flash_bwd_dq_dbias",)}
        want.update({k: 12 * steps for k in ("flash_fwd", dq,
                                               "flash_bwd_dkv")})
        log(f"eager BERT-base fp16 {label} + GradScaler ({card}): losses "
            f"{[round(v, 4) for v in losses]}; loss scale after each step "
            f"{scales}; step times "
            f"{[round(1e3 * t, 1) for t in times]} ms; launches "
            f"{json.dumps(launches)}"
            + ("" if moved is None else f"; the mask's std after "
               f"{steps} steps {moved:.3e}"))
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"BERT-base fp16 {label}: losses {losses}")
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"BERT-base fp16 {label} launched "
                                 f"{launches}, expected {want}")
        if train_mask and not moved > 0:
            raise AssertionError(f"the trainable attention mask of {label} "
                                 "did not move")
        runs[label] = launches
        if x is None:
            continue
        cfg, args = x["cfg"], x["args"]
        step_s = float(np.mean(times[1:]))
        tokens = args.batch * args.seq
        fpt = bert_flops_per_token(cfg.hidden_size, cfg.num_layers, args.seq,
                                   cfg.vocab_size, args.masked / args.seq)
        mfu = tokens / step_s * fpt / BF16_FLOPS
        log(f"eager BERT-base fp16 O1 (B={args.batch} S={args.seq} "
            f"{args.masked} masked): step {1e3 * step_s:.1f} ms (mean of "
            f"the {len(times) - 1} after the warm-up), "
            f"{tokens / step_s:.0f} tokens/s, MFU {100 * mfu:.2f}% of the "
            f"fp16 dense peak 989 TFLOP/s; max_memory_allocated "
            f"{x['peak_gib']:.2f} GiB; device busy {100 * x['busy']:.1f}% "
            f"of one profiled step")
    return runs


def _nokey_model(paddle, b, h, sq, sk, d):
    """Causal cross-attention with more queries than keys: the queries of
    an [B, Sq, H * D] sequence over an [B, Sk, H * D] memory through
    ``paddle.nn.functional.scaled_dot_product_attention`` (bsnd, K and V
    read in place from one fused projection), the band aligned at the
    bottom right, so the first Sq - Sk queries see no key."""
    import paddle_tpu_torch.nn.functional as F

    w = h * d

    class Cross(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.q = paddle.nn.Linear(w, w)
            self.kv = paddle.nn.Linear(w, 2 * w)
            self.out = paddle.nn.Linear(w, w)

        def forward(self, x, memory):
            q = paddle.reshape(self.q(x), [b, sq, h, d])
            kv = paddle.reshape(self.kv(memory), [b, sk, 2, h, d])
            o = F.scaled_dot_product_attention(q, kv[:, :, 0], kv[:, :, 1],
                                               is_causal=True, layout="bsnd")
            self.attn_dtype = o.dtype
            return self.out(paddle.reshape(o, [b, sq, w]))

    return Cross()


def _nokey_train(np, torch, card):
    """(a3) The causal Sq > Sk model (:func:`_nokey_model`) at the nokey
    row's shape, trained P19_NOKEY_STEPS steps under fp16 O1 + a dynamic
    GradScaler with Adam toward a seeded target: the first step's output
    within P19_NOKEY_TOL of the same weights' fp32 output on the CPU
    (sdpa_plain, the reference's attention; the rows with no key too),
    finite losses that fall, one launch of each flash kernel a step.
    Returns the run's launches."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts
    from paddle_tpu_torch.weights import (load_paddle_state_dict,
                                          state_dict_to_numpy)

    _, b, h, sq, sk, d = next(c for c in P19_CASES if c[0] == "nokey")[:6]
    rng = np.random.RandomState(19)
    x, memory, target = (rng.randn(b, n, h * d).astype("float32")
                         for n in (sq, sk, sq))
    paddle.seed(19)
    paddle.set_device("cpu")
    try:
        ref = _nokey_model(paddle, b, h, sq, sk, d)
        state = state_dict_to_numpy(ref)
        want = ref(paddle.to_tensor(x), paddle.to_tensor(memory)).numpy()
    finally:
        paddle.set_device("gpu")
    model = _nokey_model(paddle, b, h, sq, sk, d)
    load_paddle_state_dict(model, state)
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=model.parameters())
    scaler = paddle.amp.GradScaler()
    x, memory, target = (paddle.to_tensor(a) for a in (x, memory, target))
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, scales, first = [], [], None
    for _ in range(P19_NOKEY_STEPS):
        with paddle.amp.auto_cast(dtype="float16"):
            y = model(x, memory)
            loss = F.mse_loss(y, target)
        if first is None:
            first = y.numpy().astype("float32")
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
        scales.append(scaler.get_loss_scaling())
    launches = {k: KERNELS[k] for k in FLASH + ("flash_bwd_dq_dbias",)}
    rel = float(np.abs(first - want).max() / np.abs(want).max())
    nokey = float(np.abs(first - want)[:, :sq - sk].max()
                  / np.abs(want).max())
    log(f"causal cross-attention Sq > Sk (bsnd, B={b} H={h} Sq={sq} "
        f"Sk={sk} D={d}) fp16 O1 + GradScaler, Adam ({card}): losses "
        f"{losses}; attention in {model.attn_dtype}; the first output vs "
        f"the CPU's fp32: max abs err {rel:.3e} of its largest |value| "
        f"{float(np.abs(want).max()):.4f} (tol {P19_NOKEY_TOL:g}; "
        f"{nokey:.3e} in the {sq - sk} rows with no key); scales {scales}; "
        f"launches {json.dumps(launches)}")
    _free(torch)
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"causal Sq > Sk training: losses {losses}")
    if not rel <= P19_NOKEY_TOL:
        raise AssertionError("causal Sq > Sk: the card's first output is "
                             "off the CPU's")
    want = {k: P19_NOKEY_STEPS for k in FLASH}
    want["flash_bwd_dq_dbias"] = 0
    if launches != want or "float16" not in str(model.attn_dtype):
        raise AssertionError(f"causal Sq > Sk training launched {launches} "
                             f"in {model.attn_dtype}, expected {want} in "
                             f"fp16")
    return launches


def _sdpa_inputs_on_card(np, torch):
    """(b1) ``sdpa`` on the card against ``sdpa_plain`` (the reference's
    attention) on the card, fp32, forward and gradients of q, k, v and a
    float mask, for each input the card refused before: fp16 (bf16 and
    fp16 within 2e-2 of the fp32 plain), a trainable mask of [B, 1, 1,
    Sk], [H, Sq, Sk] and full shape, causal Sq > Sk with and without one,
    head dims 8, 12, 20 and v's 40 against q's 24, bnsd GQA, 2-D q; then
    a head dim of 264 raises NotImplementedError and launches nothing."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launch_counts, sdpa
    from paddle_tpu_torch.kernels.attention import sdpa_plain

    g = torch.Generator(device="cuda").manual_seed(19)
    cases = (  # label, q, k, v shapes, mask shape, causal, dtype
        ("fp16", (4, 8, 128, 64), (4, 8, 128, 64), (4, 8, 128, 64), None,
         False, "fp16"),
        ("bf16 pad mask", (4, 8, 128, 64), (4, 8, 96, 64), (4, 8, 96, 64),
         (4, 1, 1, 96), False, "bf16"),
        ("trainable pad", (4, 8, 128, 64), (4, 8, 128, 64), (4, 8, 128, 64),
         (4, 1, 1, 128), False, "fp32"),
        ("trainable hss", (4, 8, 128, 64), (4, 8, 128, 64), (4, 8, 128, 64),
         (8, 128, 128), True, "fp32"),
        ("trainable full", (2, 8, 100, 64), (2, 8, 90, 64), (2, 8, 90, 64),
         (2, 8, 100, 90), False, "fp32"),
        ("causal Sq > Sk", (4, 8, 200, 64), (4, 8, 120, 64),
         (4, 8, 120, 64), None, True, "fp32"),
        ("causal Sq > Sk masked", (4, 8, 200, 64), (4, 8, 120, 64),
         (4, 8, 120, 64), (4, 1, 1, 120), True, "fp32"),
        ("D=8", (2, 4, 64, 8), (2, 4, 64, 8), (2, 4, 64, 8), None, True,
         "fp32"),
        ("D=12", (2, 4, 64, 12), (2, 4, 64, 12), (2, 4, 64, 12), None,
         False, "fp32"),
        ("D=20", (2, 4, 64, 20), (2, 4, 64, 20), (2, 4, 64, 20), None,
         False, "fp32"),
        ("Dv=40", (2, 4, 64, 24), (2, 4, 64, 24), (2, 4, 64, 40), None,
         False, "fp32"),
        ("bnsd GQA", (2, 12, 128, 64), (2, 4, 128, 64), (2, 4, 128, 64),
         (2, 1, 1, 1, 128), True, "fp32"),
        ("2-D q", (96, 64), (80, 64), (80, 64), None, False, "fp32"),
    )
    for label, qs, ks, vs, ms, causal, dt in cases:
        dtype = getattr(torch, DTYPES[dt])
        q, k, v = (torch.randn(s, device="cuda", generator=g).to(dtype)
                   .requires_grad_() for s in (qs, ks, vs))
        mask = (None if ms is None else torch.randn(
            ms, device="cuda", generator=g).requires_grad_())
        reset_launch_counts()
        out = sdpa(q, k, v, mask=mask, is_causal=causal)
        do = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
        leaves = [t for t in (q, k, v, mask) if t is not None]
        got = torch.autograd.grad(out, leaves, do)
        if KERNELS["flash_fwd"] != 1:
            raise AssertionError(f"sdpa {label}: launched {KERNELS}")
        ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
        rq, rk, rv = ref_leaves[:3]
        ref = sdpa_plain(rq, rk, rv, mask=ref_leaves[3] if mask is not None
                         else None, is_causal=causal)
        want = torch.autograd.grad(ref, ref_leaves, do.float())
        tol = 2e-2 if dt != "fp32" else 2e-4
        errs = []
        for name, a, r in zip(("out", "dq", "dk", "dv", "dmask"),
                              (out,) + got, (ref,) + want):
            err = (a.float() - r).abs().max().item()
            scale = r.abs().max().item()
            errs.append(f"{name} {err:.2e}")
            if not err <= tol * max(scale, 1.0):
                raise AssertionError(f"sdpa {label} on the card: {name} "
                                     f"off the reference's by {err}")
        log(f"sdpa on the card, {label} ({dt}; q {qs} k {ks} v {vs} mask "
            f"{ms}{' causal' if causal else ''}) vs sdpa_plain fp32: "
            f"{', '.join(errs)} (tol {tol:g} x max(|ref|, 1)); launches "
            f"{json.dumps({k: n for k, n in KERNELS.items() if n})}")
    q = torch.randn(2, 4, 64, 264, device="cuda", generator=g)
    reset_launch_counts()
    try:
        sdpa(q, q, q)
    except NotImplementedError as e:
        log(f"sdpa at head_dim 264 raises: {e}")
    else:
        raise AssertionError("sdpa took head_dim 264")
    if any(KERNELS.values()):
        raise AssertionError(f"a refused sdpa launched {KERNELS}")
    _free(torch)


def _cross_new_inputs(np, torch):
    """(c) dBias and causal Sq > Sk at CROSS_CASES's shapes, plus bnsd GQA:
    every case with a float mask with the mask trainable (the dQ kernel's
    dBias), every case causal where Sq > Sk, in bf16, fp16 and fp32,
    against the plain versions on the card within FLASH_TOL."""
    from paddle_tpu_torch.kernels import flash_bwd_plain, flash_fwd_plain
    from paddle_tpu_torch.kernels.flash import (_bias_of, flash_bwd,
                                                flash_fwd_cuda)

    d = 64
    cases = [c for c in CROSS_CASES if c[-1] in ("pad", "full", "neginf")]
    cases += [(c[0] + "_causal",) + c[1:7] + (True, c[8])
              for c in CROSS_CASES if c[5] > c[6]]
    cases.append(("gqa_bnsd", "bnsd", 8, 8, 2, 200, 256, False, "pad"))
    for case, layout, b, h, hkv, sq, sk, causal, kind in cases:
        for dt in ("bf16", "fp16", "fp32"):
            dtype = getattr(torch, DTYPES[dt])
            g = torch.Generator(device="cuda").manual_seed(sq + sk + h)
            q, k, v = _cross_inputs(torch, g, layout, b, h, hkv, sq, sk, d,
                                    dtype)
            mask = _mask(torch, g, kind, b, sq, h, sk)
            base = None if mask is None else _bias_of(mask, q, layout, k,
                                                      causal)
            bias = None if base is None else base.expand(
                b, h, sq, sk)
            shape = None if base is None else base.shape
            opts = (causal, 1.0 / np.sqrt(d), None, layout, bias)
            out, lse = flash_fwd_cuda(q, k, v, *opts)
            ref, rlse = flash_fwd_plain(q, k, v, *opts)
            do = torch.randn(ref.shape, device="cuda", generator=g).to(dtype)
            got = flash_bwd(q, k, v, ref, rlse, do, *opts, dbias_shape=shape)
            want = flash_bwd_plain(q, k, v, ref, rlse, do, *opts,
                                   dbias_shape=shape)
            torch.cuda.synchronize()
            parts = [("flash_fwd", "out", out, ref),
                     ("flash_fwd", "lse", lse, rlse),
                     ("flash_bwd_dq", "dq", got[0], want[0]),
                     ("flash_bwd_dkv", "dk", got[1], want[1]),
                     ("flash_bwd_dkv", "dv", got[2], want[2])]
            if shape is not None:
                parts.append(("flash_bwd_dq_dbias", "dbias", got[3],
                              want[3]))
            for name, part, a, r in parts:
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{name} {part} {case} ({dt}) is "
                                         "not finite")
                _flash_close(
                    f"{name} {part} {case} ({layout}, B={b} H={h} Hkv={hkv} "
                    f"Sq={sq} Sk={sk} D={d}, "
                    f"{'causal' if causal else 'not causal'}, {dt}, mask "
                    f"{kind}{' trainable' if shape is not None else ''})",
                    a, r, *FLASH_TOL[dt][part])
            del q, k, v, mask, base, bias, out, lse, ref, rlse, do, got, want
    _free(torch)


def phase_sdpa_inputs(np, torch, card):
    """Phase 19, the reference's inputs on the card: (a) BERT-base under
    fp16 O1 + GradScaler, O2 and with a trainable [H, S, S] bias and [B,
    1, 1, S] pad mask, causal cross-attention with Sq > Sk trained in
    fp16, and the small BERT card vs CPU in fp16; (b) ``sdpa`` on the card on each input
    the card refused before, and the new kernel cases timed (fp16 at
    BERT-base's attention, dBias with a [B, 1, 1, S] and an [H, S, S]
    trainable bias, causal Sq > Sk); (c) dBias and causal Sq > Sk at the
    cross-attention shapes.  Returns (b)'s kernels-line rows and (a)'s
    launches by run."""
    import paddle_tpu_torch as paddle

    paddle.set_device("gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _sdpa_inputs_on_card(np, torch)
    rows = {}
    for label, b, h, sq, sk, d, causal, dt, kind, train in P19_CASES:
        g = torch.Generator(device="cuda").manual_seed(sq * 3 + sk)
        dtype = getattr(torch, DTYPES[dt])
        q, k, v = _cross_inputs(torch, g, "bnsd", b, h, h, sq, sk, d, dtype)
        mask = (torch.randn(h, sq, sk, device="cuda", generator=g)
                if kind == "hss" else _mask(torch, g, kind, b, sq, h, sk))
        rows.update(_time_flash_model(np, torch, label, q, k, v, mask,
                                      causal, train_mask=train))
        del q, k, v, mask
    _cross_new_inputs(np, torch)
    _fp16_parity(np, torch)
    runs = _bert_fp16(np, torch, card)
    runs["causal Sq > Sk"] = _nokey_train(np, torch, card)
    log(card)
    return rows, runs


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
    if sys.argv[1:] == ["--phase", "7"]:
        # phase 7 alone, for work on the distributed layer: no result line
        phase_distributed(np, torch, card)
        done("7 distributed")
        return 0
    if sys.argv[1:] == ["--phase", "8"]:
        # phase 8 alone, for work on the eager API: no result line
        phase_bert(np, torch, card)
        done("8 eager BERT")
        return 0
    if sys.argv[1:] == ["--phase", "9"]:
        # phase 9 alone, for work on fleet: no result line
        phase_fleet(np, torch, card)
        done("9 fleet")
        return 0
    if sys.argv[1:] == ["--phase", "10"]:
        # phase 10 alone, for work on data and the generic step: no result
        # line
        phase_data(np, torch, card)
        done("10 data and the generic step")
        return 0
    if sys.argv[1:] == ["--phase", "11"]:
        # phase 11 alone, for work on the transformer encoders and the
        # biased flash kernels: no result line
        phase_transformers(np, torch, card)
        done("11 the transformer encoders")
        return 0
    if sys.argv[1:] == ["--phase", "13"]:
        # phase 13 alone, for work on graph mode: no result line
        phase_static(np, torch, card)
        done("13 graph mode")
        return 0
    if sys.argv[1:] == ["--phase", "14"]:
        # phase 14 alone, for work on jit and deployment: no result line
        phase_jit(np, torch, card)
        done("14 jit and deployment")
        return 0
    if sys.argv[1:] == ["--phase", "15"]:
        # phase 15 alone, for work on the rest of the eager API: no result
        # line
        phase_eager_rest(np, torch, card)
        done("15 the rest of the eager API")
        return 0
    if sys.argv[1:] == ["--phase", "16"]:
        # phase 16 alone, for work on process-level distributed training:
        # no result line
        phase_dist_training(np, torch, card)
        done("16 process-level distributed training")
        return 0
    if sys.argv[1:] == ["--phase", "17"]:
        # phase 17 alone, for work on hapi and vision: no result line
        phase_hapi(np, torch, card)
        done("17 hapi and vision")
        return 0
    if sys.argv[1:] == ["--phase", "18"]:
        # phase 18 alone, for work on the rest of the breadth: no result
        # line
        phase_breadth(np, torch, card)
        done("18 the rest of the breadth")
        return 0
    if sys.argv[1:] == ["--phase", "19"]:
        # phase 19 alone, for work on the reference's inputs on the card
        # (fp16, dBias, causal Sq > Sk, head dims, GQA): no result line
        phase_sdpa_inputs(np, torch, card)
        done("19 the reference's inputs on the card")
        return 0
    if sys.argv[1:] == ["--phase", "12"]:
        # phase 12 alone, for work on the encoder-decoder, the flash
        # kernels at other lengths and the rec models: no result line
        phase_seq2seq_rec(np, torch, card)
        done("12 the encoder-decoder and the rec models")
        return 0
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
    phase_distributed(np, torch, card)
    done("7 distributed")
    bert_kernels, bert_runs = phase_bert(np, torch, card)
    done("8 eager BERT")
    fleet_runs = phase_fleet(np, torch, card)
    done("9 fleet")
    step_launches = phase_data(np, torch, card)
    done("10 data and the generic step")
    encoder_kernels, encoder_runs = phase_transformers(np, torch, card)
    done("11 the transformer encoders")
    seq_kernels, seq_runs = phase_seq2seq_rec(np, torch, card)
    done("12 the encoder-decoder and the rec models")
    static_runs = phase_static(np, torch, card)
    done("13 graph mode")
    jit_kernels, jit_runs = phase_jit(np, torch, card)
    done("14 jit and deployment")
    beam_launches = phase_eager_rest(np, torch, card)
    done("15 the rest of the eager API")
    gpt_rows, gpt_runs = phase_dist_training(np, torch, card)
    done("16 process-level distributed training")
    hapi_rows, hapi_runs = phase_hapi(np, torch, card)
    done("17 hapi and vision")
    breadth_rows, asp_launches = phase_breadth(np, torch, card)
    done("18 the rest of the breadth")
    p19_rows, p19_runs = phase_sdpa_inputs(np, torch, card)
    done("19 the reference's inputs on the card")
    kernels.update(gpt_rows)
    kernels.update(hapi_rows)
    kernels.update(jit_kernels)
    kernels.update(bert_kernels)
    # BERT-base's bf16 attention timed again in phase 18: the later reading
    kernels.update(breadth_rows)
    kernels.update(encoder_kernels)
    kernels.update(seq_kernels)
    kernels.update(p19_rows)
    line = []
    for name, k in kernels.items():
        src = name.split("_int")[0]
        entry = {"paged_attention": 213, "paged_attention_mq": 372}
        replaces = {"paged_prefill": "paddle_tpu/kernels/paged_prefill.py:166",
                    "w8a8_gemm": "paddle_tpu/kernels/int8_gemm.py:85",
                    "w8a8_gemm_prequant":
                        "paddle_tpu/kernels/int8_gemm.py:85",
                    "flash_fwd": "paddle_tpu/kernels/flash.py:74",
                    "flash_bwd_dq": "paddle_tpu/kernels/flash.py:177",
                    "flash_bwd_dkv": "paddle_tpu/kernels/flash.py:224"}.get(
            src, f"paddle_tpu/kernels/paged_attention.py:{entry.get(src)}")
        more = {run: c[name] for run, c in cluster.items() if name in c}
        model = next((m for m in encoder_runs if f"_{m}_" in name), None)
        shape = next((m for m in seq_runs if f"_{m}_" in name), None)
        hapi = next((m for m in hapi_runs if f"_{m}_" in name), None)
        if name in p19_rows:
            # phase 19's rows: launches on the run of (a) that takes the
            # case's variant (P19_ROW_RUNS), the other runs beside
            base = next(b for b in ("flash_fwd", "flash_bwd_dq_dbias",
                                    "flash_bwd_dq", "flash_bwd_dkv")
                        if name.startswith(b + "_"))
            run = next(r for c, r in P19_ROW_RUNS.items()
                       if name == f"{base}_{c}_fp16")
            n = p19_runs[run][base]
            more = {f"phase 19 (a) {r}": c[base]
                    for r, c in p19_runs.items() if r != run}
            src = "flash_fwd" if base == "flash_fwd" else "flash_bwd"
            replaces = {"flash_fwd": "paddle_tpu/kernels/flash.py:74",
                        "flash_bwd_dq": "paddle_tpu/kernels/flash.py:177",
                        "flash_bwd_dq_dbias":
                            "paddle_tpu/kernels/flash.py:177",
                        "flash_bwd_dkv": "paddle_tpu/kernels/flash.py:224"
                        }[base]
            log(f"{name}: {n} launches on phase 19 (a)'s {run} run")
        elif hapi is not None:
            base = name.split(f"_{hapi}_")[0]
            run, counts, others = hapi_runs[hapi]
            n = counts[base]
            more = {r: c[base] for r, c in others.items()}
            src = "flash_fwd" if base == "flash_fwd" else "flash_bwd"
            replaces = {"flash_fwd": "paddle_tpu/kernels/flash.py:74",
                        "flash_bwd_dq": "paddle_tpu/kernels/flash.py:177",
                        "flash_bwd_dkv": "paddle_tpu/kernels/flash.py:224"
                        }[base]
            log(f"{name}: {n} launches on the {run} run")
        elif "_gpt1p3b_" in name:
            base = name.split("_gpt1p3b_")[0]
            n = gpt_runs["a"][base]
            more = {"phase 16 (b) GPT-1.3B --int8 --seq-major (sbnd)":
                    gpt_runs["b"][base]}
            src = "flash_fwd" if base == "flash_fwd" else "flash_bwd"
            replaces = {"flash_fwd": "paddle_tpu/kernels/flash.py:74",
                        "flash_bwd_dq": "paddle_tpu/kernels/flash.py:177",
                        "flash_bwd_dkv": "paddle_tpu/kernels/flash.py:224"
                        }[base]
            log(f"{name}: {n} launches on phase 16 (a)'s in-process run")
        elif shape is not None:
            base = name.split(f"_{shape}_")[0]
            run, counts = seq_runs[shape]
            n = counts[base]
            src = "flash_fwd" if base == "flash_fwd" else "flash_bwd"
            replaces = {"flash_fwd": "paddle_tpu/kernels/flash.py:74",
                        "flash_bwd_dq": "paddle_tpu/kernels/flash.py:177",
                        "flash_bwd_dkv": "paddle_tpu/kernels/flash.py:224"
                        }[base]
            log(f"{name}: {n} launches on the {run} run")
        elif model is not None:
            base = name.split(f"_{model}_")[0]
            run, counts, others = encoder_runs[model]
            n = counts[base]
            more = {r: c[base] for r, c in others.items()}
            src = "flash_fwd" if base == "flash_fwd" else "flash_bwd"
            replaces = {"flash_fwd": "paddle_tpu/kernels/flash.py:74",
                        "flash_bwd_dq": "paddle_tpu/kernels/flash.py:177",
                        "flash_bwd_dkv": "paddle_tpu/kernels/flash.py:224"
                        }[base]
            log(f"{name}: {n} launches on the {run} run")
        elif "_bert_" in name or "_gpt760m_" in name:
            base, dt = name.split("_bert_" if "_bert_" in name
                                  else "_gpt760m_")
            if "_bert_" in name:
                n, run = bert_runs[dt][base], f"eager BERT-base {dt}"
                more = {f"phase 13 static BERT-base {dt} (a step)":
                        static_runs[dt][base],
                        f"phase 14 BERT-base Predictor {dt} (a run)":
                        jit_runs["bert"][dt][base]}
                if dt == "fp32":
                    more["phase 14 BERT-base int8 Predictor (a run)"] = \
                        jit_runs["bert"]["int8"][base]
                if dt == "bf16":
                    more["phase 10 BERT-base generic step bf16"] = \
                        step_launches[base]
                    more["phase 18 (a) BERT-base ASP 2:4 + gradient merge "
                         "bf16 (8 micro-steps)"] = asp_launches[base]
            else:
                (run, c), *rest = fleet_runs[dt].items()
                n = c[base]
                more = {r: other[base] for r, other in rest}
            src = "flash_fwd" if base == "flash_fwd" else "flash_bwd"
            replaces = {"flash_fwd": "paddle_tpu/kernels/flash.py:74",
                        "flash_bwd_dq": "paddle_tpu/kernels/flash.py:177",
                        "flash_bwd_dkv": "paddle_tpu/kernels/flash.py:224"
                        }[base]
            log(f"{name}: {n} launches on the {run} run")
        elif name == "w8a8_gemm_prequant":
            n = jit_runs["bert"]["int8"][name]
            src = "w8a8_gemm"
            log(f"{name}: {n} launches on phase 14's int8 BERT-base "
                "Predictor run")
        elif name in FLASH:
            n, run = trained[name]
            src = "flash_fwd" if name == "flash_fwd" else "flash_bwd"
            log(f"{name}: {n} launches on training run ({run})")
            if beam_launches.get(name):
                more["phase 15 (a) Transformer-base beam search fp32"] = \
                    beam_launches[name]
        else:
            n, run = first[name]
            log(f"{name}: {n} launches on serving run ({run})")
            if name == "w8a8_gemm":
                more["phase 14 int8 GPT-1.3B to_static (a forward)"] = \
                    jit_runs["gpt"][name]
                more["phase 16 (b) GPT-1.3B --int8 --seq-major training"] = \
                    gpt_runs["b"][name]
        entry = {"name": name, "route": "cuda",
                 "source": f"paddle_tpu_torch/csrc/{src}.cu",
                 "replaces": replaces, "launches": n,
                 "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                 "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                 "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        if more:
            # its launches in phase 5's runs (g) and (h), or in phase 9's
            # other runs of its dtype
            entry["launches_in"] = more
            log(f"{name}: {json.dumps(more)} launches in other runs")
        line.append(entry)
    log(card)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Continuous-batching GPT serving demo on the PyTorch port (counterpart
of ``examples/serve_gpt.py``, with the same flags and one more,
``--device``).

Builds a GPT with random weights from a fixed seed, queues a mixed-length
request load, and drives the ``paddle_tpu_torch.serving.ServingEngine``
host loop step by step, printing admissions and completions as slots free
up and are refilled.  With ``--http PORT`` it serves the streaming HTTP
front end instead (``ServingFrontend``: SSE ``/v1/completions``,
``/metrics``, ``/healthz``, ``/debug`` with ``--debug``).

Runs on the CUDA card unless ``--device`` names another device; without a
card and without ``--device cpu`` it stops with an error (there is no
quiet fallback).  A tiny configuration by default; flags scale it up::

    python -m paddle_tpu_torch.examples.serve_gpt --device cpu
    python -m paddle_tpu_torch.examples.serve_gpt --int8
    python -m paddle_tpu_torch.examples.serve_gpt --slots 8 --page-size 32
    python -m paddle_tpu_torch.examples.serve_gpt --shared-prefix 32 \\
            --chunk-tokens 16
    python -m paddle_tpu_torch.examples.serve_gpt --deadline-ms 500 \\
            --max-queue 4
    python -m paddle_tpu_torch.examples.serve_gpt --inject-faults 7
    python -m paddle_tpu_torch.examples.serve_gpt --metrics-dir DIR
        # TensorBoard scalars, metrics.prom and a Perfetto trace.json
        # (host RecordEvent spans on the same timeline) land in DIR
    python -m paddle_tpu_torch.examples.serve_gpt --speculate 4
    python -m paddle_tpu_torch.examples.serve_gpt --kv-heads 2 \\
            --window 64 --kv-bits 4
    python -m paddle_tpu_torch.examples.serve_gpt --http 8000 \\
            --tenants a:3,b:1
        #   curl -N localhost:8000/v1/completions \\
        #        -d '{"prompt": [1,2,3], "max_tokens": 8, "tenant": "a"}'
    python -m paddle_tpu_torch.examples.serve_gpt --replicas 2 --disaggregate
    python -m paddle_tpu_torch.examples.serve_gpt --double-buffer
    python -m paddle_tpu_torch.examples.serve_gpt --http 8000 --debug
"""

import argparse
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.examples.serve_gpt")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--decode-block", type=int, default=1)
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decoding: n-gram self-draft up to K "
                         "tokens/slot, verify in one multi-query dispatch "
                         "(requires greedy, excludes --decode-block)")
    ap.add_argument("--chunk-tokens", type=int, default=64,
                    help="chunked-prefill program width / per-step budget")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable KV page reuse across shared prefixes")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common N-token system prompt to every "
                         "request (shows the prefix cache working)")
    ap.add_argument("--int8", action="store_true",
                    help="serve W8A8 projections + int8 KV pages")
    ap.add_argument("--kv-heads", type=int, default=None, metavar="N",
                    help="grouped-query attention: store only N KV heads "
                         "(must divide --heads); decode output stays "
                         "token-identical to full MHA weights")
    ap.add_argument("--window", type=int, default=None, metavar="W",
                    help="sliding-window attention: each position attends "
                         "to the last W keys and the engine RECYCLES "
                         "pages behind the window mid-request")
    ap.add_argument("--kv-bits", type=int, default=None, choices=[4, 8],
                    help="quantize KV pages to 4 (nibble-packed) or 8 "
                         "bits with per-position fp32 scales; 4-bit "
                         "pages hold ~8x the tokens of fp32")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="< 1.0 switches greedy off and nucleus-samples")
    ap.add_argument("--eos", type=int, default=None,
                    help="eos token id: finished slots free their pages")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline: requests overstaying this "
                         "many ms (queued or resident) expire")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the waiting queue; overflow is rejected "
                         "with an explicit terminal (backpressure)")
    ap.add_argument("--inject-faults", type=int, default=None, metavar="SEED",
                    help="run under a seeded FaultPlan: scripted alloc "
                         "failures, step exceptions and virtual latency")
    ap.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="observe the run: TensorBoard scalars per step "
                         "(tensorboard --logdir DIR), a Prometheus "
                         "metrics.prom text dump, and a Chrome trace.json "
                         "(open at https://ui.perfetto.dev) land in DIR")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve the streaming HTTP front end instead of "
                         "the scripted demo load: SSE /v1/completions "
                         "over token ids, /metrics Prometheus scrape, "
                         "/healthz")
    ap.add_argument("--tenants", default=None, metavar="SPEC",
                    help="comma-separated name:weight pairs (e.g. "
                         "'a:3,b:1') enabling weighted-fair multi-tenant "
                         "scheduling; requests pick their tenant via the "
                         "HTTP body's \"tenant\" field")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="serve through a Router over N engine replicas "
                         "(cache-affinity + load routing, cluster-wide "
                         "WFQ fairness) instead of one engine")
    ap.add_argument("--disaggregate", action="store_true",
                    help="with --replicas >= 2: split the fleet into "
                         "prefill and decode replicas; prefilled KV "
                         "pages cross the boundary via the page-payload "
                         "handoff")
    ap.add_argument("--double-buffer", action="store_true",
                    help="overlap host scheduling of step N+1 with the "
                         "device running step N (sync one step late; "
                         "excludes --speculate)")
    ap.add_argument("--device", default=None,
                    help="where the model and the engine run: the CUDA "
                         "card by default; 'cpu' runs the plain versions "
                         "of the kernels on the CPU")
    ap.add_argument("--debug", action="store_true",
                    help="with --http: expose the read-only /debug "
                         "surface (state + invariant verdicts, flight-"
                         "recorder rings, merged Chrome trace)")
    args = ap.parse_args(argv)
    cluster = args.replicas > 1
    if cluster and (args.inject_faults is not None or args.speculate):
        ap.error("--replicas > 1 demos routing/handoff; run "
                 "--inject-faults / --speculate on the single-engine "
                 "demo (chaos per replica is exercised in "
                 "tests/test_torch_disagg.py)")

    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import FaultPlan, ServingEngine

    cfg = GPTConfig(vocab_size=args.vocab, hidden_size=args.hidden,
                    num_layers=args.layers, num_heads=args.heads,
                    max_seq_len=args.max_seq, dropout=0.0,
                    num_kv_heads=args.kv_heads, attn_window=args.window)
    model = GPTForPretraining(cfg, device=args.device, seed=0)
    model.eval()

    faults = (FaultPlan.random(args.inject_faults, n_steps=50)
              if args.inject_faults is not None else None)
    tenants = None
    if args.tenants:
        tenants = {}
        for part in args.tenants.split(","):
            name, _, weight = part.partition(":")
            tenants[name.strip()] = float(weight) if weight else 1.0
    if cluster:
        from paddle_tpu_torch.serving import make_cluster

        eng = make_cluster(model, args.replicas, device=model.device,
                           disaggregate=args.disaggregate,
                           tenants=tenants,
                           router_max_queue=args.max_queue,
                           max_slots=args.slots,
                           page_size=args.page_size,
                           decode_block=args.decode_block,
                           chunk_tokens=args.chunk_tokens,
                           prefix_cache=not args.no_prefix_cache,
                           greedy=args.top_p >= 1.0, top_p=args.top_p,
                           eos_token_id=args.eos, int8=args.int8,
                           kv_bits=args.kv_bits,
                           double_buffer=args.double_buffer)
    else:
        eng = ServingEngine(model, device=model.device, max_slots=args.slots,
                            page_size=args.page_size,
                            decode_block=args.decode_block,
                            chunk_tokens=args.chunk_tokens,
                            prefix_cache=not args.no_prefix_cache,
                            greedy=args.top_p >= 1.0, top_p=args.top_p,
                            eos_token_id=args.eos, int8=args.int8,
                            max_queue=args.max_queue, faults=faults,
                            tenants=tenants, spec_k=args.speculate,
                            kv_bits=args.kv_bits,
                            double_buffer=args.double_buffer,
                            metrics=args.metrics_dir is not None,
                            trace=args.metrics_dir is not None)
    replicas = eng.replicas if cluster else [eng]
    if cluster and args.metrics_dir is not None:
        # fleet-wide observability: per-replica registries +
        # shared-clock tracers + flight recorders; artifacts (cluster.prom,
        # merged trace.json, flight_r{i}.json) land in --metrics-dir at exit
        eng.attach_metrics()
        eng.attach_tracers()
        eng.attach_flight()
        os.makedirs(args.metrics_dir, exist_ok=True)
        for i, rep in enumerate(replicas):
            rep._crash_dump_dir = args.metrics_dir
            rep._crash_dump_name = f"flight_crash_r{i}.json"
    if args.debug:
        # /debug/flight and /debug/trace 404 unless something is attached
        if cluster:
            if eng.tracer is None:
                eng.attach_tracers()
            eng.attach_flight()
        else:
            if eng.tracer is None:
                eng.attach_tracer()
            if eng.flight is None:
                eng.attach_flight()
    if args.http is not None:
        from paddle_tpu_torch.serving.frontend import serve

        # warm the step functions (and build the kernels on the card)
        # before accepting traffic, then hand the host loop to the
        # asyncio driver until Ctrl-C
        eng.add_request(np.arange(4, dtype=np.int32), 2)
        eng.run()
        print(f"engine warm: slots={args.slots} policy="
              f"{replicas[0].scheduler.policy.name} "
              f"tenants={tenants or '-'}"
              + (f" replicas={[e.role for e in replicas]}"
                 if cluster else ""))
        try:
            serve(eng, port=args.http, debug=args.debug)
        finally:
            if args.metrics_dir is not None and cluster:
                eng._dump_artifacts(args.metrics_dir)
                print(f"cluster artifacts (metrics_r*.prom, cluster.prom, "
                      f"trace.json, flight_r*.json) -> {args.metrics_dir}")
            elif args.metrics_dir is not None:
                # the demo-load exporter path below never runs in HTTP
                # mode — dump the artifacts the flag promised at exit
                from paddle_tpu_torch.serving import MetricsFileExporter

                os.makedirs(args.metrics_dir, exist_ok=True)
                with MetricsFileExporter(eng.metrics,
                                         args.metrics_dir) as ex:
                    ex.flush(eng._step_idx)
                trace = eng.tracer.save(
                    os.path.join(args.metrics_dir, "trace.json"))
                print(f"metrics -> {ex.prom_path}, trace -> {trace}")
        return
    exporter = None
    if args.metrics_dir is not None and not cluster:
        from paddle_tpu_torch.serving import (MetricsFileExporter,
                                              attach_profiler)

        os.makedirs(args.metrics_dir, exist_ok=True)
        exporter = MetricsFileExporter(eng.metrics, args.metrics_dir)
        attach_profiler(eng.tracer)   # host RecordEvent spans join the trace
    e0 = replicas[0]
    if cluster:
        print(f"cluster: {args.replicas} replicas "
              f"{[e.role for e in replicas]} — cache-affinity + load "
              f"routing, {'page-payload handoff, ' if args.disaggregate else ''}"
              f"{'cluster-wide WFQ' if tenants else 'FCFS'}")
    print(f"engine: slots={args.slots}/replica page_size={args.page_size} "
          f"pool={e0.pool.num_pages} pages "
          f"({e0.pool.hbm_bytes() / 1e6:.1f} MB) int8={args.int8} "
          f"double_buffer={args.double_buffer}")
    print(f"kv layout: {e0.pool.num_kv_heads}/{args.heads} kv heads, "
          f"kv_bits={e0.kv_bits or '-'} window={e0.window or '-'} -> "
          f"{e0.pool.bytes_per_token()} KV bytes/token")

    rng = np.random.RandomState(0)
    system = rng.randint(0, args.vocab, (args.shared_prefix,))
    rids = {}
    for i in range(args.requests):
        plen = int(rng.randint(4, args.max_seq // 4))
        new = int(rng.randint(4, args.max_seq // 2))
        prompt = np.concatenate(
            [system, rng.randint(0, args.vocab, (plen,))])
        rid = eng.add_request(
            prompt, new,
            deadline_s=(args.deadline_ms / 1e3
                        if args.deadline_ms is not None else None))
        rids[rid] = (len(prompt), new)
        print(f"  queued rid={rid} prompt_len={len(prompt)} max_new={new}")

    t0 = time.perf_counter()
    n_done, step = 0, 0
    while eng.has_work:
        step += 1
        occupancy = sum(e.scheduler.n_active for e in replicas)
        for fin in eng.step():
            n_done += 1
            plen, new = rids[fin.rid]
            print(f"  step {step:4d} | done rid={fin.rid} "
                  f"({fin.finish_reason}, {len(fin.tokens)}/{new} tokens, "
                  f"resident {fin.n_steps} steps) | "
                  f"pool util "
                  f"{max(e.pool.utilization() for e in replicas):.0%} | "
                  f"slots busy {occupancy}/{args.slots * len(replicas)}")
        if exporter is not None:
            exporter.flush(step)
    dt = time.perf_counter() - t0

    s = {k: sum(e.stats[k] for e in replicas)
         for k, v in replicas[0].stats.items()
         if isinstance(v, (int, float))}
    print(f"\n{n_done} requests, {s['tokens_generated']} tokens in {dt:.2f}s "
          f"({s['tokens_generated'] / dt:.1f} tok/s)")
    print(f"step shapes: {s['prefill_traces']} prefill shape(s) "
          f"({s['prefill_calls']} chunk calls), {s['decode_traces']} decode "
          f"shape(s) ({s['decode_calls']} calls)")
    print(f"prefix cache: {s['prefix_hit_tokens']}/{s['prompt_tokens']} "
          f"prompt tokens served from cached pages "
          f"({s['prefix_hit_tokens'] / max(s['prompt_tokens'], 1):.0%} "
          f"hit rate), {sum(e.pool.num_cached for e in replicas)} pages "
          f"cached for future requests")
    if cluster:
        rs = eng.stats
        print(f"router: routed {rs['routed']} per prefill target "
              f"({rs['prefix_routed']} prefix-affine, "
              f"{rs['prefix_match_tokens']} matched tokens), "
              f"{rs['handoffs']} handoff(s) "
              f"({rs['handoff_bytes'] / 1e6:.2f} MB page payloads, "
              f"{rs['degraded_handoffs']} degraded), "
              f"{rs['rejected']} rejected at the router")
    if args.double_buffer:
        print(f"double buffering: {s['decode_sync_s'] * 1e3:.1f}ms host "
              f"time blocked on device syncs across "
              f"{s['decode_calls']} decode dispatches")
    if args.speculate:
        acc = s["spec_accepted"] / max(s["spec_drafted"], 1)
        print(f"speculation (k={args.speculate}): {s['spec_drafted']} "
              f"drafted, {s['spec_accepted']} accepted, "
              f"{s['spec_rejected']} rejected "
              f"({acc:.0%} acceptance) in {s['decode_calls']} verify "
              f"dispatches")
    print(f"lifecycle: {s['preemptions']} preemption(s) "
          f"({s['recompute_tokens']} tokens recomputed), "
          f"{s['rejected']} rejected, {s['expired']} expired, "
          f"{s['cancelled']} cancelled, {s['step_faults']} step fault(s) "
          f"absorbed")
    if faults is not None:
        print(f"fault plan (seed {args.inject_faults}): "
              f"{faults.injected['alloc_fail']} alloc failure(s), "
              f"{faults.injected['raise']} injected exception(s), "
              f"{faults.injected['latency_s'] * 1e3:.1f}ms virtual latency "
              f"— pool drained leak-free: {eng.pool.pages_in_use == 0}")
    if exporter is not None:
        exporter.close()
        trace_path = eng.tracer.save(
            os.path.join(args.metrics_dir, "trace.json"))
        sc = eng.metrics.scalars()
        print(f"observability: TTFT p50/p99 "
              f"{sc['serving_ttft_s_p50'] * 1e3:.1f}/"
              f"{sc['serving_ttft_s_p99'] * 1e3:.1f}ms, "
              f"TBT p50 {sc['serving_tbt_s_p50'] * 1e3:.1f}ms, "
              f"queue wait p99 "
              f"{sc['serving_queue_wait_s_p99'] * 1e3:.1f}ms")
        print(f"  {len(sc)} scalar series -> tensorboard --logdir "
              f"{args.metrics_dir}")
        print(f"  Prometheus text dump -> {exporter.prom_path}")
        print(f"  request/phase timeline -> {trace_path} "
              f"(open at https://ui.perfetto.dev)")
    if cluster and args.metrics_dir is not None:
        eng._dump_artifacts(args.metrics_dir)
        sc = eng.scalars()
        print(f"observability: CLUSTER TTFT p50/p99 "
              f"{sc['serving_ttft_s_p50'] * 1e3:.1f}/"
              f"{sc['serving_ttft_s_p99'] * 1e3:.1f}ms — true fleet "
              f"quantiles (histogram buckets merged across replicas)")
        print(f"  artifacts -> {args.metrics_dir}: metrics_r*.prom, "
              f"cluster.prom (one scrape page), flight_r*.json black "
              f"boxes, MERGED trace.json (open at https://ui.perfetto.dev "
              f"to see handoff arrows cross replica lanes)")
    eng.check_invariants()


if __name__ == "__main__":
    main()

"""The port's paged serving stack: unit tests of the pool, the prefix index
and the scheduler (mirroring tests/test_serving.py), and end-to-end token
parity on the reference's test configuration:

    port ServingEngine == port dense decoder == JAX ServingEngine

token for token (greedy, fp32 on the CPU, same weights), through chunked
prefill, a shared prefix with a copy-on-write tail, preemption under a
small pool, sliding-window page recycling, GQA and ``decode_block=4``.
Every port engine step is followed by ``check_invariants()``, and every run
must drain clean.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu_torch.serving import (FCFSScheduler, KVPool, PrefixIndex,
                                      Request, ServingEngine)
from torch_parity import (assert_all_equal, dense, drain, pair, prompts_of,
                          serve_both)


# ---------------------------------------------------------------------------
# pool, prefix index, scheduler
# ---------------------------------------------------------------------------


def test_kv_pool_alloc_free_invariants():
    pool = KVPool(2, 2, 16, num_pages=8, page_size=4, device="cpu")
    assert pool.num_free == 7  # page 0 reserved
    a = pool.alloc(3)
    b = pool.alloc(4)
    assert pool.alloc(1) is None  # exhausted
    assert 0 not in a + b  # null page never handed out
    assert len(set(a + b)) == 7
    pool.free(a)
    assert pool.num_free == 3
    with pytest.raises(ValueError):
        pool.free(a)  # double free
    with pytest.raises(ValueError):
        pool.free([0])  # null page
    assert pool.pages_for(1) == 1 and pool.pages_for(4) == 1
    assert pool.pages_for(5) == 2
    c = pool.alloc(3)
    assert sorted(c) == sorted(a)  # freed pages recycle
    assert tuple(pool.buffers["k"].shape) == (2, 8, 2, 4, 16)
    assert pool.buffers["k"].device.type == "cpu"


def test_kv_pool_gqa_layout_and_bytes():
    pool = KVPool(3, 8, 16, num_pages=4, page_size=4, num_kv_heads=2,
                  dtype=torch.bfloat16, device="cpu")
    assert tuple(pool.buffers["v"].shape) == (3, 4, 2, 4, 16)
    assert pool.bytes_per_token() == 2 * 3 * 2 * 16 * 2
    with pytest.raises(ValueError):
        KVPool(1, 3, 16, num_pages=4, page_size=4, num_kv_heads=2,
               device="cpu")
    with pytest.raises(ValueError):
        KVPool(1, 2, 16, num_pages=1, page_size=4, device="cpu")


def test_kv_pool_refcount_sharing_and_reclaim():
    pool = KVPool(1, 1, 8, num_pages=6, page_size=4, prefix_cache=True,
                  device="cpu")
    pages = pool.alloc(2)
    pool.prefix.insert(np.arange(8, dtype=np.int32), pages)
    pool.retain(pages)
    pool.free(pages)
    assert pool.num_free == 3 and pool.pages_in_use == 2
    pool.free(pages)                          # rc 0: cached -> reclaimable
    assert pool.num_free == 3
    assert pool.num_reclaimable == 2 and pool.pages_in_use == 0
    with pytest.raises(ValueError):
        pool.free(pages)
    got = pool.alloc(5)                       # needs the cached pages back
    assert got is not None and len(got) == 5
    assert pool.num_cached == 0 and len(pool.prefix) == 0
    pool.check()
    pool.free(got)
    assert pool.num_free == 5


def test_kv_pool_alloc_free_stress():
    rng = np.random.RandomState(0)
    pool = KVPool(1, 1, 8, num_pages=64, page_size=4, prefix_cache=True,
                  device="cpu")
    live = []
    for i in range(2000):
        r = rng.rand()
        if live and (r < 0.45 or pool.num_free < 4):
            pool.free(live.pop(rng.randint(len(live))))
        elif live and r < 0.55:
            lease = live[rng.randint(len(live))]
            pool.retain(lease)
            pool.free(lease)
        else:
            got = pool.alloc(int(rng.randint(1, 5)))
            if got is not None:
                live.append(got)
        if i % 500 == 0:
            pool.check()
    for pages in live:
        pool.free(pages)
    pool.check()
    assert pool.pages_in_use == 0 and pool.num_free == 63


def test_prefix_index_match_insert_lru():
    idx = PrefixIndex(4)
    t = np.arange(16, dtype=np.int32)
    assert idx.match(t) == ([], None)
    assert idx.insert(t, [5, 6, 7, 8]) == [5, 6, 7, 8]
    assert idx.match(t) == ([5, 6, 7, 8], None)
    q = np.concatenate([t[:6], [99, 99]]).astype(np.int32)
    assert idx.match(q) == ([5], (6, 2))      # full page + COW partial
    assert idx.insert(t[:8], [50, 51]) == []  # duplicates keep their page
    idx2 = PrefixIndex(4)
    idx2.insert(np.arange(8, dtype=np.int32), [1, 2])
    idx2.insert(np.array([0, 1, 2, 3, 9, 9, 9, 9], np.int32), [1, 3])
    idx2.match(np.arange(8, dtype=np.int32))
    rc = [0] * 10
    assert idx2.evict(1, rc) == [3]           # LRU leaf first
    assert idx2.evict(5, rc) == [2, 1]        # then the freed parent
    idx3 = PrefixIndex(4)
    idx3.insert(np.arange(8, dtype=np.int32), [1, 2])
    assert idx3.evict(2, [0, 0, 1] + [0] * 7) == []   # pinned leaf blocks


def test_scheduler_fcfs_pages_gate_admission():
    pool = KVPool(1, 1, 8, num_pages=9, page_size=4, device="cpu")
    sched = FCFSScheduler(n_slots=4, pool=pool, token_budget=10)
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(0, 9, (n,)), max_new_tokens=4)
            for n in (14, 14, 14)]
    for r in reqs:
        sched.add(r)
    adm = sched.schedule_step()
    assert [a.request.rid for a in adm] == [reqs[0].rid, reqs[1].rid]
    assert all(len(a.pages) == 4 for a in adm)
    assert sched.schedule_step() == []
    sched.release(adm[0].slot, adm[0].pages)
    assert [a.request.rid for a in sched.schedule_step()] == [reqs[2].rid]


def test_scheduler_admission_ignores_max_new_tokens():
    pool = KVPool(1, 1, 8, num_pages=9, page_size=4, device="cpu")
    sched = FCFSScheduler(n_slots=2, pool=pool)
    sched.add(Request(prompt=np.arange(3), max_new_tokens=29))
    adm = sched.schedule_step()
    assert len(adm) == 1 and len(adm[0].pages) == 1


def test_scheduler_chunk_budget():
    pool = KVPool(1, 1, 8, num_pages=20, page_size=4, device="cpu")
    sched = FCFSScheduler(n_slots=8, pool=pool, token_budget=16)
    assert sched.prefill_budget(0, chunk_tokens=64) == 16
    assert sched.prefill_budget(4, chunk_tokens=64) == 12
    assert sched.prefill_budget(4, chunk_tokens=8) == 8
    assert sched.prefill_budget(99, chunk_tokens=8) == 1


def test_scheduler_rejects_oversized_request():
    pool = KVPool(1, 1, 8, num_pages=4, page_size=4, device="cpu")
    sched = FCFSScheduler(n_slots=2, pool=pool)
    with pytest.raises(ValueError):
        sched.add(Request(prompt=np.arange(20), max_new_tokens=4))
    with pytest.raises(ValueError):
        FCFSScheduler(n_slots=2, pool=pool, policy="lottery")
    with pytest.raises(ValueError):     # tenants need the wfq policy
        FCFSScheduler(n_slots=2, pool=pool, policy="fcfs", tenants={"a": 1})


# ---------------------------------------------------------------------------
# engine parity: port engine == port dense decoder == JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("over,kw", [
    ({}, {}),
    ({}, {"chunk_tokens": 8}),
    ({}, {"decode_block": 4}),
    ({"num_heads": 4, "num_kv_heads": 2}, {"chunk_tokens": 8}),
], ids=["plain", "chunked8", "decode_block4", "gqa_chunked8"])
def test_engine_matches_dense_and_reference(over, kw):
    jm, tm = pair(**over)
    prompts = prompts_of(np.random.RandomState(3), (5, 11, 23, 7))
    port, ref, eng, _ = serve_both(jm, tm, prompts, 12, **kw)
    assert_all_equal(port, dense(tm, prompts, 12), ref)
    if "chunk_tokens" in kw:
        assert eng.stats["prefill_calls"] > len(prompts)


def test_engine_shared_prefix_and_cow_tail():
    """Full-page prefix hits shared across a wave of requests, then a
    copy-on-write partial tail: B shares A's first page and half of its
    second, C repeats A (all but its last token from cache)."""
    jm, tm = pair(seed=4)
    rng = np.random.RandomState(21)
    shared = rng.randint(0, 512, (16,)).astype(np.int32)
    wave = [np.concatenate([shared, t]) for t in prompts_of(rng, (5, 3, 7, 4))]
    port, ref, eng, jeng = serve_both(jm, tm, wave, 6, chunk_tokens=16)
    assert_all_equal(port, dense(tm, wave, 6), ref)
    assert eng.stats["prefix_hit_tokens"] >= 2 * 16
    assert eng.stats["prefix_hit_tokens"] == jeng.stats["prefix_hit_tokens"]

    A = rng.randint(0, 512, (16,)).astype(np.int32)
    B = np.concatenate([A[:12], rng.randint(0, 512, (6,)).astype(np.int32)])
    eng = ServingEngine(tm, device="cpu", max_slots=1, page_size=8,
                        chunk_tokens=16)
    jeng = JEngine(jm, max_slots=1, page_size=8, chunk_tokens=16,
                   use_paged_kernel=False)
    hits = []
    for p in (A, B, A.copy()):
        rid, jrid = eng.add_request(p, 6), jeng.add_request(p, 6)
        tok = drain(eng)[rid].tokens
        assert_all_equal([tok], dense(tm, [p], 6), [jeng.run()[jrid].tokens])
        hits.append(eng.stats["prefix_hit_tokens"])
    assert hits == [0, 12, 12 + 15]           # B: 8 + 4 via COW; C: 8 + 7


def test_engine_preemption_under_a_small_pool():
    """Six usable pages cannot hold both residents' growth: the younger is
    preempted, requeued and recomputed, and every token stays exact."""
    jm, tm = pair()
    rng = np.random.RandomState(51)
    A = rng.randint(0, 512, (8,)).astype(np.int32)
    B = rng.randint(0, 512, (16,)).astype(np.int32)
    eng = ServingEngine(tm, device="cpu", max_slots=2, page_size=8,
                        num_pages=7, chunk_tokens=16)
    ra, rb = eng.add_request(A, 24), eng.add_request(B, 16)
    out = drain(eng)
    jeng = JEngine(jm, max_slots=2, page_size=8, num_pages=7,
                   chunk_tokens=16, use_paged_kernel=False)
    ja, jb = jeng.add_request(A, 24), jeng.add_request(B, 16)
    jout = jeng.run()
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["recompute_tokens"] > 0
    assert eng.stats["preemptions"] == jeng.stats["preemptions"]
    assert_all_equal([out[ra].tokens], dense(tm, [A], 24),
                      [jout[ja].tokens])
    assert_all_equal([out[rb].tokens], dense(tm, [B], 16),
                      [jout[jb].tokens])


def test_engine_window_recycles_pages():
    """GQA + a 16-token window over a 40-token generation: the live pages
    stay a bounded ring while the high-water page count keeps growing,
    recycled pages go back to the pool, and tokens stay exact."""
    over = dict(num_heads=4, num_kv_heads=2, attn_window=16)
    jm, tm = pair(seed=6, **over)
    prompts = prompts_of(np.random.RandomState(11), (5, 13))
    seen = {"live": 0, "hw": 0}

    def trace(eng):
        for st in eng._slots:
            if st is not None:
                seen["live"] = max(seen["live"], len(st.pages))
                seen["hw"] = max(seen["hw"], st.hw_pages)

    port, ref, eng, _ = serve_both(jm, tm, prompts, 40, trace=trace,
                                    prefix_cache=False)
    assert_all_equal(port, dense(tm, prompts, 40), ref)
    cap = eng.pool.pages_for(16 + 1) + 1
    assert seen["live"] <= cap < seen["hw"]
    assert eng.pool.num_free == eng.pool.num_pages - 1


def test_engine_lifecycle_cancel_expire_reject():
    """cancel() in every state, deadlines and the bounded queue: every
    request ends in exactly one terminal state and the pool drains."""
    _, tm = pair()
    now = {"t": 0.0}
    eng = ServingEngine(tm, device="cpu", max_slots=1, page_size=8,
                        chunk_tokens=4, max_queue=2, clock=lambda: now["t"])
    rng = np.random.RandomState(54)
    r1 = eng.add_request(rng.randint(0, 512, (12,)), 6)
    r2 = eng.add_request(rng.randint(0, 512, (5,)), 6, deadline_s=1.0)
    r3 = eng.add_request(rng.randint(0, 512, (5,)), 6)      # queue full
    out = {f.rid: f for f in eng.step()}                    # r1 mid-prefill
    assert eng.cancel(r1) and not eng.cancel(r1)
    now["t"] = 5.0                                          # r2 overdue
    r4 = eng.add_request(rng.randint(0, 512, (5,)), 3)
    out.update(drain(eng))
    assert {r: out[r].reason for r in (r1, r2, r3, r4)} == {
        r1: "cancelled", r2: "expired", r3: "rejected", r4: "length"}
    with pytest.raises(ValueError):
        eng.add_request(np.arange(90) % 512, 10)            # > max_seq_len

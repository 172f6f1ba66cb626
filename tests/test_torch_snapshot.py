"""Snapshots of the port (``paddle_tpu_torch/serving/snapshot.py``), held
against the reference (``paddle_tpu/serving/snapshot.py``):

* a snapshot taken mid-run (slots decoding and mid-prefill, requests
  queued), restored into a fresh engine and drained, gives the tokens of
  the uninterrupted run, exactly: float, int8 and int4 pages, ``spec_k``,
  WFQ, ``double_buffer`` (the decode in flight is retired first) and a
  sampled engine (the generator's stream continues); also a prefill
  replica's outbox and a decode replica's inbox;
* the port's snapshot dict at a given step equals the reference's section
  by section.  The exceptions, named: the RNG key (the reference's is a
  JAX PRNG key, the port's its generator's state), the config echo's
  ``use_paged_kernel`` (the port has none), the port-only stats key
  ``decode_tokens``, the stats' wall-clock seconds, and the pool's page
  bytes, which agree to 1e-5 (two fp32 implementations of the model)
  rather than bit for bit.
"""

import numpy as np
import pytest

from paddle_tpu.serving import FaultPlan as JFaultPlan
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving import snapshot_engine as jsnapshot
from paddle_tpu_torch.serving import (FaultPlan, ServingEngine,
                                      restore_engine, snapshot_engine)
from paddle_tpu_torch.serving import scheduler as tsched
from torch_parity import pair, prompts_of


def _drain(eng, done):
    while eng.has_work:
        for f in eng.step():
            assert f.rid not in done
            done[f.rid] = f
        eng.check_invariants()
    return done


@pytest.mark.parametrize("over", [
    {},
    {"kv_bits": 8},
    {"int8": True, "kv_bits": 4},
    {"spec_k": 3},
    {"tenants": {"a": 1.0, "b": 2.0}},
    {"double_buffer": True, "num_pages": 10},
    {"greedy": False, "temperature": 0.8, "top_k": 20, "seed": 5},
])
def test_snapshot_restore_mid_run_is_exact(over):
    jm, tm = pair(num_layers=1)
    kw = dict(max_slots=2, page_size=8, chunk_tokens=4, token_budget=6,
              metrics=True, **over)
    rng = np.random.RandomState(57)
    prompts = prompts_of(rng, (5, 19, 7, 11))
    prompts[3] = np.tile(prompts[3][:3], 4)        # drafts propose here
    tenants = ["a", "b", "a", "b"] if "tenants" in over else [None] * 4
    eng = ServingEngine(tm, device="cpu", **kw)
    rids = [eng.add_request(p, 10, tenant=t)
            for p, t in zip(prompts, tenants)]
    done = {}
    for _ in range(4):
        for f in eng.step():
            done[f.rid] = f
    assert eng.scheduler.n_waiting or any(
        s is not None and not s.started for s in eng._slots)
    snap = snapshot_engine(eng)
    assert eng._inflight is None
    want = _drain(eng, dict(done))
    eng2 = restore_engine(tm, snap)
    got = _drain(eng2, dict(done))
    assert set(got) == set(rids)
    for rid in rids:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
    assert eng2.stats["tokens_generated"] == eng.stats["tokens_generated"]
    assert eng2.metrics.scalars()["serving_tokens_generated"] == \
        eng.stats["tokens_generated"]
    if over.get("greedy", True):
        jeng = JEngine(jm, use_paged_kernel=False,
                       **{k: v for k, v in kw.items() if k != "metrics"})
        jr = [jeng.add_request(p, 10, tenant=t)
              for p, t in zip(prompts, tenants)]
        jdone = jeng.run()
        for rid, j in zip(rids, jr):
            np.testing.assert_array_equal(got[rid].tokens, jdone[j].tokens)
    with pytest.raises(ValueError, match="layout"):
        restore_engine(tm, snap, kv_bits=4 if over.get("kv_bits") != 4
                       else 8)


def test_snapshot_restores_outbox_and_inbox():
    """A prefill replica snapshotted with records in its outbox, and a
    decode replica snapshotted with an un-admitted inbox record, both
    resume to the monolithic engine's tokens."""
    _, tm = pair(num_layers=1)
    kw = dict(max_slots=2, page_size=8, num_pages=32)
    prompts = prompts_of(np.random.RandomState(11), [13, 6])
    mono = ServingEngine(tm, device="cpu", **kw)
    mr = [mono.add_request(p, 8) for p in prompts]
    want = mono.run()
    pre = ServingEngine(tm, device="cpu", role="prefill", **kw)
    rids = [pre.add_request(p, 8) for p in prompts]
    while len(pre._handoff_out) < 2:
        pre.step()
    pre2 = restore_engine(tm, snapshot_engine(pre))
    assert len(pre2._handoff_out) == 2 and not pre2.has_work
    dec = ServingEngine(tm, device="cpu", role="decode", **kw)
    for h in pre2.drain_handoffs():
        dec.ingest_handoff(h)
    assert len(dec._handoff_in) == 2
    dec2 = restore_engine(tm, snapshot_engine(dec))
    assert len(dec2._handoff_in) == 2
    got = _drain(dec2, {})
    for rid, m in zip(rids, mr):
        np.testing.assert_array_equal(got[rid].tokens, want[m].tokens)


def _same(a, b, path="snap"):
    """Recursive equality of two snapshot sections (numpy arrays by value);
    the pool's page buffers within 1e-5."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if ".pool.buffers." in path and a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("over", [
    {"num_pages": 7},                   # a preemption and a prefix hit
    {"kv_bits": 8, "tenants": {"a": 1.0, "b": 3.0}},
])
def test_snapshot_dict_equals_the_references(over):
    jm, tm = pair(num_layers=1)
    kw = dict(max_slots=2, page_size=8, chunk_tokens=8, **over)
    rng = np.random.RandomState(21)
    prompts = prompts_of(rng, (9, 17, 4, 12))
    prompts[2] = np.concatenate([prompts[1][:16], prompts[2]])  # a hit
    tenants = ["a", "b", "b", "a"] if "tenants" in over else [None] * 4
    # both packages mint the same rids from here
    base = max(tsched._next_rid.n, jsched._next_rid.n)
    tsched._next_rid.n = jsched._next_rid.n = base
    snaps = []
    for eng in (ServingEngine(tm, device="cpu", faults=FaultPlan(), **kw),
                JEngine(jm, use_paged_kernel=False, faults=JFaultPlan(),
                        **kw)):
        for p, t in zip(prompts, tenants):
            eng.add_request(p, 12, tenant=t)
        for _ in range(14):
            eng.step()
        snaps.append(eng)
    ours, theirs = snapshot_engine(snaps[0]), jsnapshot(snaps[1])
    assert snaps[0].scheduler.n_active and snaps[0].has_work
    if "num_pages" in over:
        assert snaps[0].stats["preemptions"] == 1
        assert snaps[0].stats["prefix_hit_tokens"] == 32
    assert set(ours) == set(theirs)
    ref_config = dict(theirs["config"])
    assert ref_config.pop("use_paged_kernel") is False
    _same(ours["config"], ref_config, "snap.config")
    es, ej = dict(ours["engine"]), dict(theirs["engine"])
    assert es.pop("key").dtype == np.uint8
    ej.pop("key")
    ss, sj = es.pop("stats"), ej.pop("stats")
    assert set(ss) == set(sj) | {"decode_tokens"}
    for k, v in sj.items():
        if not k.endswith("_s"):
            assert ss[k] == v, k
    _same(es, ej, "snap.engine")
    for section in ("version", "kv_layout", "scheduler", "pool", "slots",
                    "rid_next", "metrics"):
        _same(ours[section], theirs[section], f"snap.{section}")

"""Continuous-batching serving engine over the paged KV pool.

Counterpart of ``paddle_tpu/serving/engine.py``.  Every host-loop
iteration (:meth:`ServingEngine.step`)
expires deadlines, admits waiting requests into freed slots, spends the
step's chunk budget on prompt prefill, grows decode pages (preempting the
youngest slot under pressure) and runs one decode step over every started
slot:

* **chunk prefill**: up to ``chunk_tokens`` of ONE request's prompt per
  call — embeddings, ``_block_qkv``, the chunk's K/V scattered into the
  slot's pool pages, then paged attention of the chunk against everything
  already written (cached prefix pages, earlier chunks, itself) through
  the block table (:func:`~paddle_tpu_torch.kernels.paged_prefill`).
  Chunk widths pad to power-of-two buckets capped at ``chunk_tokens``.
* **decode**: one token for every started slot — per-slot K/V write at
  each slot's own position, paged attention through the block table
  (:func:`~paddle_tpu_torch.kernels.paged_attention`), sampling.
  ``decode_block=k`` runs k such steps before the host looks at the
  tokens.
* **speculative verify** (``spec_k > 0``): an n-gram drafter proposes up
  to ``spec_k`` tokens per slot from its own history, one step scores
  ``[carry, drafts]`` for every slot through the multi-query kernel
  (:func:`~paddle_tpu_torch.kernels.paged_attention_mq`), and the greedy
  rejection rule keeps the longest agreeing prefix plus one corrected
  token: the output is token for token that of plain greedy decoding.

``int8`` serves W8A8 projections (the ``w8a8_gemm`` kernel) over int8 KV
pages; ``kv_bits`` 8 or 4 picks int8 or nibble-packed int4 pages, which
the scatter quantizes per position and every attention kernel
dequantizes right after its page loads.

Prefix caching shares full prompt pages across requests through the pool's
radix index, with a copy-on-write clone for a partial tail page.
Sliding-window attention recycles the pages that fell behind the window.

The reference jits these programs and donates the pool buffers to them;
here the step functions run eagerly and update the pool tensors IN PLACE,
which is what donation buys there: one copy of the pool, never two.

Features of the reference engine that are not ported yet — disaggregated
handoff, double-buffered dispatch, weighted fair queueing, metrics,
tracing, the flight recorder, fault injection and snapshots — are not
accepted here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels import paged_attention, paged_attention_mq, paged_prefill
from ..models.generation import (_block_finish, _block_qkv, _decoder_setup,
                                 _lm_head, _make_sampler, _resolve_int8,
                                 _resolve_kv_bits, spec_accept_greedy)
from ..ops.quant_ops import quantize_int4_per_token, quantize_per_token
from .drafter import NGramDrafter
from .kv_pool import KVPool
from .scheduler import FCFSScheduler, Request


@dataclasses.dataclass
class FinishedRequest:
    """One terminal request: the continuation produced (prompt excluded).
    ``finish_reason`` is ``eos`` or ``length`` for a completed request,
    else ``rejected``, ``expired`` or ``cancelled``; then ``tokens`` holds
    whatever was generated before the request left (possibly nothing)."""

    rid: int
    prompt: np.ndarray
    tokens: np.ndarray            # generated continuation, EOS included
    finish_reason: str
    n_steps: int                  # engine steps it was resident

    @property
    def reason(self) -> str:
        return self.finish_reason


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class _Slot:
    """Host-side state of one occupied engine slot."""

    def __init__(self, request: Request, pages: List[int], prefilled: int,
                 seq: int, base_len: int, born_step: int):
        self.request = request
        self.pages = pages            # table order: shared prefix + owned
        # generated tokens live ON THE REQUEST so they survive preemption
        self.tokens: List[int] = request.generated
        self.born_step = born_step
        self.seq = seq                # admission order, kept across
        #                               preemption (oldest never a victim)
        self.base_len = base_len      # work-prompt length at admission
        self.prefilled = prefilled    # work positions with K/V in pages
        # high-water LOGICAL page count: windowed recycling frees dead
        # leading pages (their table entries become the null page), so
        # len(pages) shrinks while hw_pages marks where growth appends
        self.hw_pages = len(pages)
        self.started = False          # first token sampled; decoding
        # speculative draft of this step: host-only, rebuilt from the
        # request's history by every speculative step
        self.draft: List[int] = []


class ServingEngine:
    """Continuous-batching generation over a paged KV cache.

    ``device`` is where the engine runs: the CUDA card unless the caller
    passes another (the model must live there too).  ``max_slots`` bounds
    the decode batch; ``page_size`` the pool granularity; ``num_pages``
    the pool size (default: every slot at ``max_seq_len``, +1 null page);
    ``token_budget`` the per-step token budget (decode tokens + prefill);
    ``chunk_tokens`` the widest prefill chunk; ``prefix_cache`` reuses KV
    pages across requests sharing a page-aligned prefix.  Sampling knobs
    mirror :func:`~paddle_tpu_torch.models.generation.build_generate_fn`;
    ``seed`` seeds the sampling generator.  ``max_queue`` bounds the
    waiting queue (overflow becomes a ``rejected`` terminal); ``clock``
    (zero-argument callable, seconds) drives deadlines, default
    ``time.monotonic``; ``attn_window`` overrides ``cfg.attn_window``.

    ``int8`` (default ``cfg.int8``) serves W8A8 projections and, unless
    ``kv_bits`` says otherwise, int8 KV pages; ``kv_bits`` (default
    ``cfg.kv_bits``) picks 8 (int8) or 4 (nibble-packed int4) pages with
    fp32 per-position scales.  ``spec_k`` > 0 drafts up to that many
    tokens per slot and step (an :class:`~.drafter.NGramDrafter` matching
    n-grams up to ``spec_ngram`` long, or any ``drafter`` with
    ``draft(history, max_tokens)``) and verifies them in one step; it
    needs greedy sampling and replaces ``decode_block``.  Its acceptance
    is counted in ``stats["spec_drafted"/"spec_accepted"/"spec_rejected"]``.
    """

    def __init__(self, model, *, device: DeviceLike = None,
                 max_slots: int = 8, page_size: int = 32,
                 max_seq_len: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 decode_block: int = 1, chunk_tokens: int = 128,
                 prefix_cache: bool = True,
                 max_queue: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 attn_window: Optional[int] = None,
                 int8: Optional[bool] = None, kv_bits: Optional[int] = None,
                 spec_k: int = 0, spec_ngram: int = 3, drafter=None):
        cfg = model.cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"runs on {self.device}")
        self.decode_block = max(1, int(decode_block))
        self.spec_k = max(0, int(spec_k))
        if self.spec_k:
            if not greedy:
                raise ValueError(
                    "speculative decoding (spec_k > 0) requires greedy "
                    "sampling: the longest-agreeing-prefix rule is the "
                    "greedy case of rejection sampling")
            if self.decode_block > 1:
                raise ValueError(
                    "spec_k > 0 replaces decode_block fusion: the verify "
                    "step already scores spec_k + 1 positions")
        self._drafter = drafter if drafter is not None else (
            NGramDrafter(self.spec_k, max_ngram=spec_ngram)
            if self.spec_k else None)
        self.int8 = _resolve_int8(cfg, int8)
        self.kv_bits = _resolve_kv_bits(cfg, self.int8, kv_bits)
        self.params, _ = _decoder_setup(model, int8=self.int8)
        self.n_heads = cfg.num_heads
        self.n_kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.head_dim
        self.eps = cfg.layer_norm_eps
        win = attn_window if attn_window is not None else cfg.attn_window
        if win is not None and int(win) < 1:
            raise ValueError(f"attn_window must be >= 1, got {win}")
        self.window = None if win is None else int(win)
        self.max_slots = max_slots
        self.page_size = page_size
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        if self.max_seq_len > cfg.max_seq_len:
            raise ValueError("max_seq_len exceeds the model's position table")
        self.max_pages = -(-self.max_seq_len // page_size)
        self.eos_token_id = eos_token_id
        self.chunk_tokens = max(1, min(int(chunk_tokens), self.max_seq_len))
        self.max_queue = max_queue
        self._clock = clock if clock is not None else time.monotonic
        n_pages = num_pages or (1 + max_slots * self.max_pages)
        self.pool = KVPool(cfg.num_layers, cfg.num_heads, self.head_dim,
                           n_pages, page_size, dtype=model.dtype,
                           device=self.device, prefix_cache=prefix_cache,
                           num_kv_heads=self.n_kv_heads, kv_bits=self.kv_bits)
        self.scheduler = FCFSScheduler(max_slots, self.pool,
                                       token_budget=token_budget)
        self._sample = _make_sampler(greedy, temperature, top_k, top_p)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

        # host mirrors of the decode step's device operands
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        self._tok = np.zeros((max_slots,), np.int32)
        self._len = np.zeros((max_slots,), np.int32)
        self._table = np.zeros((max_slots, self.max_pages), np.int32)
        self._step_idx = 0
        self._admit_seq = 0
        # terminals produced OUTSIDE step() (reject at enqueue, cancel)
        # park here and are delivered by the next step()
        self._pending: List[FinishedRequest] = []
        self.stats = {"prefill_calls": 0, "decode_calls": 0,
                      "tokens_generated": 0, "decode_tokens": 0,
                      "prefix_hit_tokens": 0, "prompt_tokens": 0,
                      "pages_in_use": 0, "queue_depth": 0,
                      "step_wall_s": 0.0, "last_step_s": 0.0,
                      "prefill_s": 0.0, "decode_s": 0.0,
                      "preemptions": 0, "recompute_tokens": 0,
                      "rejected": 0, "expired": 0, "cancelled": 0,
                      # speculative decoding: drafted = proposals scored
                      # by verify = accepted + rejected; the bonus or
                      # correction token is ordinary decode output
                      "spec_drafted": 0, "spec_accepted": 0,
                      "spec_rejected": 0}

    # -- device work ------------------------------------------------------

    def _scatter_kv(self, li, rows, offs, k1, v1):
        """Write per-token K/V rows (..., Hkv, D) into layer ``li`` of the
        pool at (page ``rows``, offset ``offs``), in place — quantized to
        int8 (or packed int4) values plus fp32 per-position scales when the
        pool is quantized.  The one scatter of the decode, verify and
        prefill steps.  Padded and inactive rows all target the null page
        0: a scatter with duplicate indices lands in no defined order,
        which is harmless only because page 0 is never read unmasked."""
        bufs = self.pool.buffers
        if self.kv_bits is None:
            bufs["k"][li][rows, :, offs] = k1
            bufs["v"][li][rows, :, offs] = v1
            return
        quant = (quantize_int4_per_token if self.kv_bits == 4
                 else quantize_per_token)
        for side, blk in (("k", k1), ("v", v1)):
            vals, scales = quant(blk)
            bufs[side][li][rows, :, offs] = vals
            bufs[side + "s"][li][rows, :, offs] = scales

    def _pages(self, li):
        """Layer ``li``'s pages and, for a quantized pool, their scales, as
        the paged kernels take them."""
        bufs = self.pool.buffers
        kw = {}
        if self.kv_bits is not None:
            kw = dict(k_scales=bufs["ks"][li], v_scales=bufs["vs"][li])
        return bufs["k"][li], bufs["v"][li], kw

    def _decode_once(self, toks, lengths, active, table):
        """One decode step for every slot lane: returns the sampled tokens
        (S,) int32.  Inactive lanes compute into the null page and their
        tokens are ignored."""
        p, ps, eps = self.params, self.page_size, self.eps
        s = toks.shape[0]
        # an out-of-range gather raises here where JAX clamps silently; an
        # inactive lane's length is not a real position, so clamp its read
        pe = p["wpe"][lengths.clamp(max=p["wpe"].shape[0] - 1)]
        x = (p["wte"][toks] + pe)[:, None, :]                  # (S, 1, h)
        page_idx = (lengths // ps).clamp(max=self.max_pages - 1)
        lanes = torch.arange(s, device=self.device)
        rows = torch.where(active, table[lanes, page_idx], 0)
        offs = lengths % ps
        for li, bp in enumerate(p["blocks"]):
            q, kb, vb = _block_qkv(bp, x, self.n_heads, eps,
                                   n_kv_heads=self.n_kv_heads)
            self._scatter_kv(li, rows, offs, kb[:, :, 0], vb[:, :, 0])
            kp, vp, kw = self._pages(li)
            out = paged_attention(q[:, :, 0].contiguous(), kp, vp, table,
                                  lengths + 1, window=self.window, **kw)
            x = _block_finish(bp, x, out.reshape(s, 1, -1).to(x.dtype), eps)
        logits = _lm_head(p, x[:, 0], eps)                     # (S, V)
        return self._sample(logits, self._generator).to(torch.int32)

    @torch.no_grad()
    def _decode_call(self, remaining: np.ndarray) -> np.ndarray:
        """``decode_block`` decode steps over every lane; lanes whose
        ``remaining`` budget runs out stop advancing.  Returns the sampled
        tokens (decode_block, S) on the host — the one sync of the call."""
        dev = self.device
        toks = torch.from_numpy(self._tok).to(dev)
        lengths = torch.from_numpy(self._len).to(dev)
        table = torch.from_numpy(self._table).to(dev)
        rem = torch.from_numpy(remaining).to(dev)
        steps = []
        for _ in range(self.decode_block):
            active = rem > 0
            nxt = self._decode_once(toks, lengths, active, table)
            toks = torch.where(active, nxt, toks)
            lengths = torch.where(active, lengths + 1, lengths)
            rem = (rem - 1).clamp(min=0)
            steps.append(nxt)
        return torch.stack(steps).cpu().numpy()

    @torch.no_grad()
    def _verify_call(self, draft: np.ndarray, n_draft: np.ndarray
                     ) -> np.ndarray:
        """The speculative verify step: every slot lane embeds its
        ``[carry, draft_0 .. draft_{k-1}]`` block at positions ``len ..
        len + k``, scatters the rows' K/V into its pages, attends each row
        to the history and the block's earlier rows (multi-query kernel),
        and predicts greedily after every row.  Rows past the lane's
        ``n_draft`` and every row of a lane not decoding this step
        (``n_draft == -1``) write to the null page.  Returns the
        predictions (S, k + 1) on the host — the one sync of the step.

        Rejected rows leave stale K/V past the accepted prefix; the next
        step's scatter rewrites those positions before any row attends to
        them, and no row attends past its own position."""
        p, ps, eps, dev = self.params, self.page_size, self.eps, self.device
        t = self.spec_k + 1
        toks = torch.from_numpy(self._tok).to(dev)
        lengths = torch.from_numpy(self._len).to(dev)
        table = torch.from_numpy(self._table).to(dev)
        n_d = torch.from_numpy(n_draft).to(dev)
        block = torch.cat([toks[:, None], torch.from_numpy(draft).to(dev)],
                          dim=1)                                 # (S, T)
        s = block.shape[0]
        pos = lengths[:, None] + torch.arange(t, device=dev,
                                              dtype=torch.int32)[None, :]
        # rows of short drafts can run past the position table: clamp
        # their embedding gather (their outputs are unused)
        pe = p["wpe"][pos.clamp(max=p["wpe"].shape[0] - 1)]
        x = p["wte"][block] + pe                                 # (S, T, h)
        row_ok = torch.arange(t, device=dev)[None, :] <= n_d[:, None]
        page_idx = (pos // ps).clamp(max=self.max_pages - 1).long()
        rows = torch.where(row_ok, torch.gather(table, 1, page_idx), 0)
        offs = pos % ps
        for li, bp in enumerate(p["blocks"]):
            q, kb, vb = _block_qkv(bp, x, self.n_heads, eps,
                                   n_kv_heads=self.n_kv_heads)  # (S,H,T,D)
            self._scatter_kv(li, rows, offs, kb.transpose(1, 2),
                             vb.transpose(1, 2))
            kp, vp, kw = self._pages(li)
            out = paged_attention_mq(q.transpose(1, 2).contiguous(), kp, vp,
                                     table, lengths, window=self.window, **kw)
            x = _block_finish(bp, x, out.reshape(s, t, -1).to(x.dtype), eps)
        logits = _lm_head(p, x, eps)                             # (S, T, V)
        pred = self._sample(logits.reshape(s * t, -1), self._generator)
        return pred.reshape(s, t).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def _prefill_chunk(self, toks: np.ndarray, start: int, n_valid: int,
                       table_row: np.ndarray, sample_row: Optional[int]):
        """One chunk of one prompt: rows ``[start, start + n_valid)`` of the
        sequence (the rest of ``toks`` is padding).  Writes the chunk's K/V
        into the slot's pages, then attends the chunk against every
        written position through the block table.  With ``sample_row``
        (the chunk row of the LAST prompt token) returns the sampled next
        token as a device scalar, else None."""
        p, ps, eps, dev = self.params, self.page_size, self.eps, self.device
        c = toks.size
        toks_d = torch.from_numpy(toks).to(dev)
        row = torch.from_numpy(table_row).to(dev)
        pos = start + torch.arange(c, device=dev, dtype=torch.int32)
        # the padded rows of a prompt's last chunk run past the position
        # table: clamp their gather (JAX clamps silently, torch raises);
        # their K/V land on the null page and their outputs are dropped
        pe = p["wpe"][pos.clamp(max=p["wpe"].shape[0] - 1)]
        x = (p["wte"][toks_d] + pe)[None]                       # (1, C, h)
        valid = torch.arange(c, device=dev) < n_valid
        page_idx = (pos // ps).clamp(max=self.max_pages - 1)
        rows = torch.where(valid, row[page_idx], 0)
        offs = pos % ps
        for li, bp in enumerate(p["blocks"]):
            q, kb, vb = _block_qkv(bp, x, self.n_heads, eps,
                                   n_kv_heads=self.n_kv_heads)
            # (1, H, C, D) -> (C, H, D): the page-scatter layout
            self._scatter_kv(li, rows, offs, kb[0].transpose(0, 1),
                             vb[0].transpose(0, 1))
            kp, vp, kw = self._pages(li)
            out = paged_prefill(q[0].transpose(0, 1).contiguous(), kp, vp,
                                row, start, window=self.window, **kw)
            x = _block_finish(bp, x, out.reshape(1, c, -1).to(x.dtype), eps)
        if sample_row is None:
            return None
        # LN and the head are row-wise: project only the sampled row
        last = _lm_head(p, x[0, sample_row][None], eps)          # (1, V)
        return self._sample(last, self._generator)[0]

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write clone of one pool page across all layers."""
        for buf in self.pool.buffers.values():
            buf[:, dst] = buf[:, src]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- public API -------------------------------------------------------

    def add_request(self, prompt, max_new_tokens: int,
                    deadline_s: Optional[float] = None) -> int:
        """Queue one request; returns its rid.  The prompt + continuation
        must fit ``max_seq_len``.  ``deadline_s`` expires the request that
        many engine-clock seconds after enqueue, whatever state it is in."""
        return self._enqueue(
            Request(prompt=np.asarray(prompt, np.int32).reshape(-1),
                    max_new_tokens=max_new_tokens, deadline_s=deadline_s))

    def _enqueue(self, req: Request) -> int:
        """Single admission gate: every request must fit the model's
        position table; a full waiting queue REJECTS it (backpressure) —
        it still gets a rid and a ``rejected`` terminal from the next
        step()."""
        if req.total_len > self.max_seq_len:
            raise ValueError(
                f"request needs {req.total_len} positions; engine "
                f"max_seq_len is {self.max_seq_len}")
        req.t_enqueue = self._clock()
        if (self.max_queue is not None
                and self.scheduler.n_waiting >= self.max_queue):
            self.stats["rejected"] += 1
            self._pending.append(self._terminal(req, "rejected"))
            return req.rid
        return self.scheduler.add(req)

    def cancel(self, rid: int) -> bool:
        """Cancel a request in ANY live state — waiting, mid-prefill or
        decoding.  Pages are released at once; the ``cancelled`` terminal
        arrives with the next step().  False when the rid is unknown or
        already terminal."""
        req = self.scheduler.remove_waiting(rid)
        if req is not None:
            self.stats["cancelled"] += 1
            self._pending.append(self._terminal(req, "cancelled"))
            return True
        for idx, st in enumerate(self._slots):
            if st is not None and st.request.rid == rid:
                self.stats["cancelled"] += 1
                self._pending.append(self._finish(idx, "cancelled"))
                return True
        return False

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work or bool(self._pending)

    # -- internals --------------------------------------------------------

    def _terminal(self, req: Request, reason: str) -> FinishedRequest:
        """Terminal record for a request that is NOT in a slot."""
        return FinishedRequest(
            rid=req.rid, prompt=req.prompt,
            tokens=np.asarray(req.generated, np.int32),
            finish_reason=reason, n_steps=0)

    def _vacate(self, idx: int) -> _Slot:
        st = self._slots[idx]
        self._slots[idx] = None
        self._table[idx] = 0
        self._tok[idx] = 0
        self._len[idx] = 0
        self.scheduler.release(idx, st.pages)
        return st

    def _finish(self, idx: int, reason: str) -> FinishedRequest:
        st = self._vacate(idx)
        return FinishedRequest(
            rid=st.request.rid, prompt=st.request.prompt,
            tokens=np.asarray(st.tokens, np.int32), finish_reason=reason,
            n_steps=self._step_idx - st.born_step + 1)

    def _preempt(self, idx: int) -> None:
        """Evict slot ``idx`` to recompute later: pages freed (cached
        prompt pages park reclaimable — the cheap part of the recompute),
        generated tokens kept on the request, request requeued at the
        HEAD of the waiting queue."""
        st = self._vacate(idx)
        st.request.n_preempted += 1
        self.scheduler.requeue(st.request)
        self.stats["preemptions"] += 1

    def _pick_victim(self) -> Optional[int]:
        """The youngest occupied slot — unless it is the only one: the
        oldest request is never preempted (no livelock)."""
        occ = [(st.seq, i) for i, st in enumerate(self._slots)
               if st is not None]
        if len(occ) <= 1:
            return None
        return max(occ)[1]

    def _expire(self, finished: List[FinishedRequest]) -> None:
        """Deadlines, both sides: overdue WAITING requests drop before
        this step's admissions, overdue SLOTS release their pages."""
        now = self._clock()
        for req in self.scheduler.pop_expired(now):
            self.stats["expired"] += 1
            finished.append(self._terminal(req, "expired"))
        for idx, st in enumerate(self._slots):
            if st is not None and st.request.expired(now):
                self.stats["expired"] += 1
                finished.append(self._finish(idx, "expired"))

    def _admit(self, adm) -> None:
        """Apply one scheduling decision: the slot's block table from
        shared-prefix + owned pages, the COW tail clone, and how much of
        the prompt needs no recompute."""
        req, idx = adm.request, adm.slot
        pages = list(adm.cached) + list(adm.pages)
        if adm.cow is not None:
            # the first owned page inherits the partial tail's K/V; the
            # source drops the reference the scheduler pinned for us
            self._copy_page(adm.cow[0], adm.pages[0])
            self.pool.release([adm.cow[0]])
        if req.seq is None:
            self._admit_seq += 1
            req.seq = self._admit_seq
        self._slots[idx] = _Slot(req, pages, prefilled=adm.matched,
                                 seq=req.seq, base_len=req.work_len,
                                 born_step=self._step_idx)
        self._table[idx] = 0
        self._table[idx, :len(pages)] = pages
        self.stats["prefix_hit_tokens"] += adm.matched
        self.stats["prompt_tokens"] += req.work_len
        if req.n_preempted > 0:
            self.stats["recompute_tokens"] += req.work_len - adm.matched

    def _prefill_chunks(self, finished: List[FinishedRequest]) -> None:
        """Spend the step's chunk budget over partially-prefilled slots in
        admission order, one chunk of one slot per call.  A slot whose
        prompt completes samples its next token and joins this step's
        decode."""
        n_decoding = sum(1 for s in self._slots
                         if s is not None and s.started)
        budget = self.scheduler.prefill_budget(
            n_decoding, self.chunk_tokens, decode_cost=1 + self.spec_k)
        partial = sorted((i for i, s in enumerate(self._slots)
                          if s is not None and not s.started),
                         key=lambda i: self._slots[i].seq)
        for idx in partial:
            st = self._slots[idx]
            req = st.request
            work = req.work_prompt()
            while budget > 0 and not st.started:
                n = min(st.base_len - st.prefilled, budget,
                        self.chunk_tokens)
                c_pad = min(_next_pow2(max(n, 8)),
                            max(self.chunk_tokens, n))
                toks = np.zeros((c_pad,), np.int32)
                toks[:n] = work[st.prefilled:st.prefilled + n]
                completes = st.prefilled + n == st.base_len
                tok = self._prefill_chunk(toks, st.prefilled, n,
                                          self._table[idx],
                                          n - 1 if completes else None)
                self.stats["prefill_calls"] += 1
                st.prefilled += n
                budget -= n
                if not completes:
                    continue
                # prompt complete: its full pages become matchable
                st.started = True
                if self.pool.prefix is not None:
                    if (self.window is not None
                            and st.base_len > self.window):
                        # the leading pages are about to be recycled:
                        # indexing would pin dead pages, so refuse
                        self.pool.prefix.window_refusals += 1
                    else:
                        nfull = st.base_len // self.page_size
                        self.pool.prefix.insert(work, st.pages[:nfull])
                tok = int(tok)
                st.tokens.append(tok)
                self.stats["tokens_generated"] += 1
                self._tok[idx] = tok
                self._len[idx] = st.base_len
                if (self.eos_token_id is not None
                        and tok == self.eos_token_id):
                    finished.append(self._finish(idx, "eos"))
                elif len(st.tokens) >= req.max_new_tokens:
                    finished.append(self._finish(idx, "length"))
            if budget <= 0:
                break

    def _grow_pages(self, idx: int, consumed: int) -> bool:
        """Ensure slot ``idx`` owns every page its next ``consumed`` decode
        writes need.  On allocation failure, preempt the youngest occupied
        slot and retry; never the oldest.  True when the slot can decode
        this step."""
        st = self._slots[idx]
        # grow from the HIGH-WATER page count: logical page i always lives
        # at table column i, whatever windowed recycling freed
        need = self.pool.pages_for(int(self._len[idx]) + consumed) \
            - st.hw_pages
        while need > 0:
            got = self.pool.alloc(need)
            if got is not None:
                self._table[idx, st.hw_pages:st.hw_pages + len(got)] = got
                st.pages.extend(got)
                st.hw_pages += len(got)
                return True
            victim = self._pick_victim()
            if victim is None:
                return False          # stalled; the pool can't shrink
            self._preempt(victim)
            if victim == idx:
                return False          # the grower was the youngest itself
        return True

    def _recycle_window_pages(self, idx: int) -> None:
        """Sliding-window page recycling: leading logical page j is dead
        once ``(j+1) * page_size <= len + 1 - window`` (the next query at
        position ``len`` sees none of it); it goes back to the pool and
        its table entry becomes the null page, which the window mask
        already excludes.  A slot's live pages form a ring of about
        ceil(window / page_size) + 1."""
        st = self._slots[idx]
        if st is None or self.window is None or not st.started:
            return
        dead = (int(self._len[idx]) + 1 - self.window) // self.page_size
        done = st.hw_pages - len(st.pages)    # leading pages already freed
        if dead <= done:
            return
        victims = st.pages[:dead - done]
        del st.pages[:dead - done]
        self._table[idx, done:dead] = 0
        self.pool.free(victims)

    def _decode_step(self, finished: List[FinishedRequest]) -> None:
        if self.spec_k:
            return self._spec_decode_step(finished)
        # page growth oldest first, so preemption victims are always
        # younger than the grower
        order = sorted((i for i, s in enumerate(self._slots)
                        if s is not None and s.started),
                       key=lambda i: self._slots[i].seq)
        run: List[int] = []
        for idx in order:
            st = self._slots[idx]
            if st is None:                    # preempted by an earlier grow
                continue
            consumed = min(self.decode_block, st.request.remaining_new)
            if self._grow_pages(idx, consumed):
                run.append(idx)
        if not run:
            return
        remaining = np.zeros((self.max_slots,), np.int32)
        for idx in run:
            remaining[idx] = self._slots[idx].request.remaining_new
        toks_all = self._decode_call(remaining)
        self.stats["decode_calls"] += 1
        for idx in run:
            st = self._slots[idx]
            consumed = int(min(self.decode_block, remaining[idx]))
            reason = None
            for i in range(consumed):
                tok = int(toks_all[i, idx])
                st.tokens.append(tok)
                self.stats["tokens_generated"] += 1
                self.stats["decode_tokens"] += 1
                if (self.eos_token_id is not None
                        and tok == self.eos_token_id):
                    reason = "eos"
                    break
            if reason is None and len(st.tokens) >= st.request.max_new_tokens:
                reason = "length"
            if reason is not None:
                finished.append(self._finish(idx, reason))
            else:
                # mirror the device state: it advanced `consumed` steps and
                # its carry token is the last one sampled
                self._tok[idx] = int(toks_all[consumed - 1, idx])
                self._len[idx] += consumed
                self._recycle_window_pages(idx)

    def _spec_decode_step(self, finished: List[FinishedRequest]) -> None:
        """One speculative iteration over the started slots: draft from each
        request's history, grow pages for the whole verify block (carry +
        drafts, the same on-demand growth and preemption as decode), one
        verify step, then the greedy rejection rule advances each slot by
        ``accepted + 1`` tokens.  The draft is capped at ``remaining_new -
        1``, so even full acceptance plus the bonus token lands exactly on
        ``max_new_tokens``."""
        k = self.spec_k
        order = sorted((i for i, s in enumerate(self._slots)
                        if s is not None and s.started),
                       key=lambda i: self._slots[i].seq)
        # -1 marks a lane not decoding this step (empty, mid-prefill or
        # stalled): the verify step parks all its rows on the null page
        n_draft = np.full((self.max_slots,), -1, np.int32)
        draft = np.zeros((self.max_slots, k), np.int32)
        run: List[int] = []
        for idx in order:
            st = self._slots[idx]
            if st is None:                    # preempted by an earlier grow
                continue
            cap = min(k, st.request.remaining_new - 1)
            st.draft = []
            if cap > 0:
                prop = np.asarray(
                    self._drafter.draft(st.request.work_prompt(), cap),
                    np.int32).reshape(-1)
                st.draft = [int(v) for v in prop[:cap]]
            if self._grow_pages(idx, len(st.draft) + 1):
                run.append(idx)
                n_draft[idx] = len(st.draft)
                draft[idx, :len(st.draft)] = st.draft
        if not run:
            return
        pred = self._verify_call(draft, n_draft)
        self.stats["decode_calls"] += 1
        for idx in run:
            st = self._slots[idx]
            req = st.request
            nd = len(st.draft)
            n_acc, emitted = spec_accept_greedy(pred[idx], st.draft)
            st.draft = []
            self.stats["spec_drafted"] += nd
            self.stats["spec_accepted"] += n_acc
            self.stats["spec_rejected"] += nd - n_acc
            reason = None
            n_new = 0
            for tok in emitted:
                st.tokens.append(tok)
                n_new += 1
                self.stats["tokens_generated"] += 1
                self.stats["decode_tokens"] += 1
                if (self.eos_token_id is not None
                        and tok == self.eos_token_id):
                    reason = "eos"
                    break
            if reason is None and len(st.tokens) >= req.max_new_tokens:
                reason = "length"
            if reason is not None:
                finished.append(self._finish(idx, reason))
            else:
                # positions len .. len + n_new - 1 now hold the K/V of the
                # carry and the accepted drafts; the new carry is the
                # bonus or correction token, whose K/V the next step writes
                self._tok[idx] = emitted[n_new - 1]
                self._len[idx] += n_new
                self._recycle_window_pages(idx)

    def step(self) -> List[FinishedRequest]:
        """One engine iteration: expire deadlines, admit into freed slots,
        advance partial prefills by the chunk budget, grow decode pages
        (preempting under pressure), then decode every started slot.
        Returns every request that reached a terminal state this step
        (including rejects and cancels recorded since the last step)."""
        t0 = time.perf_counter()
        self._step_idx += 1
        finished: List[FinishedRequest] = list(self._pending)
        self._pending.clear()
        self._expire(finished)
        for adm in self.scheduler.schedule_step():
            self._admit(adm)
        t_p = time.perf_counter()
        calls = self.stats["prefill_calls"]
        self._prefill_chunks(finished)
        if self.stats["prefill_calls"] > calls:
            # settle the chunks' device work so the phase clock measures
            # it rather than its enqueue (decode syncs on its tokens)
            self._sync()
        t_d = time.perf_counter()
        self._decode_step(finished)
        t1 = time.perf_counter()
        self.stats["prefill_s"] += t_d - t_p
        self.stats["decode_s"] += t1 - t_d
        self.stats["pages_in_use"] = self.pool.pages_in_use
        self.stats["queue_depth"] = self.scheduler.n_waiting
        self.stats["step_wall_s"] += t1 - t0
        self.stats["last_step_s"] = t1 - t0
        return finished

    def check_invariants(self) -> None:
        """Page-leak / refcount / scheduler-consistency audit: the pool's
        bookkeeping balances, the refcount total equals the page
        references live slots hold (so waiting and preempted requests hold
        none), no rid is waiting and resident at once, slot occupancy
        agrees with the scheduler, windowed slots keep a bounded ring of
        live pages, and a speculative draft stays within ``spec_k`` and the
        request's remaining budget, on a decoding slot."""
        self.pool.check()
        refs = sum(len(s.pages) for s in self._slots if s is not None)
        held = sum(self.pool.refcount)
        if held != refs:
            raise AssertionError(
                f"refcount sum {held} != {refs} page references held by "
                "live slots — a page reference leaked or double-freed")
        waiting_rids = [r.rid for r in self.scheduler.waiting]
        if len(waiting_rids) != len(set(waiting_rids)):
            raise AssertionError("duplicate rid in the waiting queue")
        slot_rids = {s.request.rid for s in self._slots if s is not None}
        both = set(waiting_rids) & slot_rids
        if both:
            raise AssertionError(
                f"rid(s) {sorted(both)} simultaneously waiting and "
                "resident in a slot")
        free = set(self.scheduler._free_slots)
        for i, s in enumerate(self._slots):
            if (i in free) == (s is not None):
                raise AssertionError(
                    f"slot {i} occupancy disagrees with the scheduler's "
                    "free-slot list")
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if s.hw_pages < len(s.pages):
                raise AssertionError(
                    f"slot {i} high-water {s.hw_pages} below live page "
                    f"count {len(s.pages)}")
            if self.window is None:
                if s.hw_pages != len(s.pages):
                    raise AssertionError(
                        f"slot {i} recycled pages without a window "
                        f"(hw {s.hw_pages}, live {len(s.pages)})")
            elif s.started:
                length = int(self._len[i])
                k = max(self.decode_block, self.spec_k + 1)
                cap = self.pool.pages_for(min(length + k,
                                              self.window + k)) + 1
                if len(s.pages) > cap:
                    raise AssertionError(
                        f"slot {i} holds {len(s.pages)} pages at len "
                        f"{length} under window {self.window}; ring cap "
                        f"is {cap}")
            if s.draft and (len(s.draft) > self.spec_k or not s.started
                            or len(s.draft) >= s.request.remaining_new):
                raise AssertionError(
                    f"slot {i} holds a draft of {len(s.draft)} tokens "
                    f"(spec_k {self.spec_k}, started {s.started}, "
                    f"remaining {s.request.remaining_new})")

    def run(self, requests: Optional[Sequence] = None
            ) -> Dict[int, FinishedRequest]:
        """Drive the host loop until every queued (and given) request is
        terminal; returns {rid: FinishedRequest}.  ``requests`` holds
        :class:`Request` objects or ``(prompt, max_new_tokens)`` pairs.
        Raises when a page is still referenced after the drain."""
        for r in requests or ():
            if isinstance(r, Request):
                self._enqueue(r)
            else:
                prompt, max_new = r
                self.add_request(prompt, max_new)
        done: Dict[int, FinishedRequest] = {}
        while self.has_work:
            for fin in self.step():
                done[fin.rid] = fin
        if self.scheduler.n_active or self.pool.pages_in_use:
            raise AssertionError(
                f"page leak after drain: {self.scheduler.n_active} slots "
                f"active, {self.pool.pages_in_use} pages still referenced")
        return done

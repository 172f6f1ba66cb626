"""Autoregressive GPT decoding with a dense KV cache.

Counterpart of ``paddle_tpu/models/generation.py``.  The block halves
(:func:`_block_qkv`, :func:`_block_finish`), the LM head and the sampler
are shared with the paged serving engine (``serving/engine.py``), so the
two decode substrates cannot fork numerically; the dense decoder
(:func:`build_generate_fn`) is the engine's oracle.

With ``int8`` the projections run W8A8 (:func:`_block_params` quantizes
each weight once, :func:`_mm` applies it through the ``w8a8_gemm``
kernel), and with ``kv_bits`` 8 or 4 the cache holds int8 values or int4
nibbles with one fp32 scale per position, quantized at the write and
dequantized inside attention.

The reference runs the whole generation as one jitted ``lax.scan``; here
PyTorch runs eagerly, so the decode loop is a Python loop and the cache is
updated in place.  Sampling draws from an explicit ``torch.Generator``.
:func:`build_beam_search_fn` is the reference's beam search, decision for
decision, over the same cache.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.quant_ops import (quantize_int4_per_token, quantize_per_channel,
                             quantize_per_token, unpack_int4, w8a8_apply)

_NEG_INF = -1e30
_PROJECTIONS = ("qkv", "proj", "fc1", "fc2")


def _block_params(blk, int8=False):
    """One block's parameter dict, keyed as in the reference.  Float: the
    block's own parameters, detached (the same storage, not copies, and no
    autograd graph).  With ``int8`` each projection
    weight is quantized once, here, per output channel: ``<name>_wq`` is
    (N, K) int8 — the reference's (K, N) ``_wq`` transposed, K contiguous,
    as the W8A8 kernel reads it — and ``<name>_ws`` (N,) fp32; the float
    ``<name>_w`` is left out, so decoding never reads it."""
    p = {k: v.detach() for k, v in blk.named_parameters()}
    if int8:
        for name in _PROJECTIONS:
            wq, ws = quantize_per_channel(p.pop(name + "_w"), axis=1)
            p[name + "_wq"] = wq.t().contiguous()
            p[name + "_ws"] = ws
    return p


def _mm(p, name, x):
    """``x @ weight``: W8A8 through the int8 GEMM when the block carries
    quantized weights, a float matmul otherwise."""
    wq = p.get(name + "_wq")
    if wq is not None:
        return w8a8_apply(x, wq, p[name + "_ws"], out_dtype=x.dtype)
    return x @ p[name + "_w"]


def _kv_dequant(vals, scale, hd):
    """One quantized cache side back to fp32: int4 caches (packed last dim
    ``hd // 2``) unpack first, int8 caches multiply straight through."""
    if vals.shape[-1] != hd:
        return unpack_int4(vals).float() * scale
    return vals.float() * scale


def _ln(x, g, b, eps):
    """LayerNorm with the population variance, as the reference computes it."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def _block_qkv(p, x, n_heads, eps, n_kv_heads=None):
    """The block's pre-attention half: LN1, the fused QKV projection and
    the head split.  ``x`` is (B, T, h); returns ``q`` (B, H, T, D) and
    ``k``/``v`` (B, Hkv, T, D) — under GQA the projection is
    (H + 2*Hkv)*D wide and the split uneven."""
    b, t, h = x.shape
    hd = h // n_heads
    nkv = n_kv_heads or n_heads
    hx = _ln(x, p["ln1_g"], p["ln1_b"], eps)
    qkv = _mm(p, "qkv", hx) + p["qkv_b"]
    q, k, v = torch.split(qkv, [n_heads * hd, nkv * hd, nkv * hd], dim=-1)

    def heads(z, n):  # (B, T, n*hd) -> (B, n, T, hd)
        return z.reshape(b, t, n, hd).transpose(1, 2)

    return heads(q, n_heads), heads(k, nkv), heads(v, nkv)


def _lm_head(p, x, eps):
    """Final LN and the tied-embedding projection; fp32 logits over the
    last axis of ``x``."""
    h = _ln(x, p["lnf_g"], p["lnf_b"], eps)
    return (h @ p["wte"].t()).float()


def _block_finish(p, x, out, eps):
    """The block's post-attention half: output projection residual and the
    MLP residual (exact-erf GELU).  ``out`` is the attention output merged
    back to the layout of ``x``."""
    x = x + _mm(p, "proj", out) + p["proj_b"]
    hx = _ln(x, p["ln2_g"], p["ln2_b"], eps)
    hid = F.gelu(_mm(p, "fc1", hx) + p["fc1_b"], approximate="none")
    return x + _mm(p, "fc2", hid) + p["fc2_b"]


def _block_fwd(p, x, k_cache, v_cache, pos, n_heads, eps, n_kv_heads=None,
               window=None):
    """One decoder block over ``x`` (B, T, h) with its K/V written into the
    dense cache at ``pos``.

    ``k_cache``/``v_cache`` are (B, Hkv, S, D) float tensors, or, for a
    quantized cache, ``(values, scales)`` pairs: int8 values (B, Hkv, S, D)
    or packed int4 (B, Hkv, S, D // 2, told apart by the shape) with fp32
    scales (B, Hkv, S, 1).  The block's K/V are quantized at the write and
    the cache dequantizes for the attention product.  Caches are updated
    IN PLACE (the reference returns new arrays); they are returned for the
    reference's signature.  Query heads group over the shared K/V head by
    a reshape, never by repeating the cache.  ``window`` masks keys more
    than ``window - 1`` positions behind each query.  Works for prefill
    (T = prompt length, pos = 0) and decode (T = 1, pos = length)."""
    b, t, h = x.shape
    hd = h // n_heads
    nkv = n_kv_heads or n_heads
    q, k_blk, v_blk = _block_qkv(p, x, n_heads, eps, n_kv_heads=n_kv_heads)
    if isinstance(k_cache, tuple):
        # the pool's rules: the dense cache and the pages quantize alike
        quant = (quantize_int4_per_token if k_cache[0].shape[-1] != hd
                 else quantize_per_token)
        for (vals, scales), blk in ((k_cache, k_blk), (v_cache, v_blk)):
            bq, bs = quant(blk)
            vals[:, :, pos:pos + t] = bq
            scales[:, :, pos:pos + t] = bs
        k_eff = _kv_dequant(*k_cache, hd)
        v_eff = _kv_dequant(*v_cache, hd)
    else:
        k_cache[:, :, pos:pos + t] = k_blk
        v_cache[:, :, pos:pos + t] = v_blk
        k_eff, v_eff = k_cache, v_cache
    s_max = k_eff.shape[2]
    g = n_heads // nkv
    qg = q.reshape(b, nkv, g, t, hd)
    scores = torch.einsum("bngtd,bnsd->bngts", qg.float(), k_eff.float())
    scores = scores / np.float32(np.sqrt(hd))
    q_pos = pos + torch.arange(t, device=x.device)[:, None]
    kv_pos = torch.arange(s_max, device=x.device)[None, :]
    mask = kv_pos <= q_pos
    if window is not None:
        mask = mask & (kv_pos > q_pos - window)
    scores = torch.where(mask, scores, _NEG_INF)
    att = torch.softmax(scores, dim=-1).to(v_eff.dtype)
    out = torch.einsum("bngts,bnsd->bngtd", att, v_eff)
    out = out.reshape(b, n_heads, t, hd).transpose(1, 2).reshape(b, t, h)
    return _block_finish(p, x, out.to(x.dtype), eps), k_cache, v_cache


def _resolve_int8(cfg, int8=None) -> bool:
    """The effective W8A8 flag: an explicit ``int8`` wins, else
    ``cfg.int8``."""
    return bool(cfg.int8) if int8 is None else bool(int8)


def _resolve_kv_bits(cfg, int8, kv_bits=None):
    """Effective KV-cache quantization width: an explicit ``kv_bits`` wins,
    then ``cfg.kv_bits``, then ``int8`` (W8A8 weights) selecting an int8
    cache.  Returns None, 8 or 4."""
    if kv_bits is None:
        kv_bits = cfg.kv_bits
    if kv_bits is None and int8:
        kv_bits = 8
    if kv_bits not in (None, 4, 8):
        raise ValueError(f"kv_bits must be None, 4 or 8, got {kv_bits!r}")
    return kv_bits


def _layer(cache, li):
    """Layer ``li`` of a stacked cache side: a tensor, or for a quantized
    cache the ``(values, scales)`` pair of that layer."""
    if isinstance(cache, tuple):
        return cache[0][li], cache[1][li]
    return cache[li]


def _decoder_setup(model, int8=None, attn_window=None):
    """Shared decode substrate: returns ``(params, make_run)`` — the flat
    parameter dict (the same keys as the reference's tree; float tensors
    are the model's own parameters, detached, not copies; with ``int8``,
    default ``cfg.int8``, the projections carry quantized weights instead,
    see :func:`_block_params`) and ``make_run(p)`` producing the cached forward
    ``run(tokens, pos, kc, vc) -> (logits, kc, vc)``."""
    cfg = model.cfg
    eps = cfg.layer_norm_eps
    window = attn_window if attn_window is not None else cfg.attn_window
    int8 = _resolve_int8(cfg, int8)
    params = {
        "wte": model.wte.detach(), "wpe": model.wpe.detach(),
        "lnf_g": model.lnf_g.detach(), "lnf_b": model.lnf_b.detach(),
        "blocks": [_block_params(blk, int8=int8) for blk in model.blocks],
    }

    def make_run(p):
        def run(tokens, pos, kc, vc):
            t = tokens.shape[1]
            pe = p["wpe"][pos + torch.arange(t, device=tokens.device)]
            x = p["wte"][tokens] + pe
            for li, bp in enumerate(p["blocks"]):
                x, _, _ = _block_fwd(bp, x, _layer(kc, li), _layer(vc, li),
                                     pos, cfg.num_heads, eps,
                                     n_kv_heads=cfg.num_kv_heads,
                                     window=window)
            return _lm_head(p, x, eps), kc, vc

        return run

    return params, make_run


def _empty_cache(cfg, b, s_max, dtype, device, int8=False, kv_bits=None):
    """Zeroed K and V caches, (L, B, Hkv, S, D) each, in ``dtype``; with a
    quantized width (``kv_bits``, or ``int8``'s int8 default) each side is
    an ``(values, scales)`` pair: int8 (L, B, Hkv, S, D) — or (…, D // 2)
    packed int4 — and fp32 (L, B, Hkv, S, 1)."""
    shape = (cfg.num_layers, b, cfg.num_kv_heads, s_max, cfg.head_dim)
    kv_bits = _resolve_kv_bits(cfg, int8, kv_bits)
    if kv_bits is not None:
        vd = cfg.head_dim // 2 if kv_bits == 4 else cfg.head_dim

        def side():
            return (torch.zeros(shape[:-1] + (vd,), dtype=torch.int8,
                                device=device),
                    torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                device=device))

        return side(), side()
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _top_p_mask(logits, top_p):
    """Nucleus filter: keep the smallest prefix of descending-probability
    tokens whose cumulative probability reaches ``top_p`` (the boundary
    token stays in, and the top-1 token always does); everything else is
    masked to -1e30."""
    sl = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sl, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < np.float32(top_p)
    cutoff = torch.where(keep, sl, torch.inf).min(dim=-1, keepdim=True).values
    return torch.where(logits < cutoff, _NEG_INF, logits)


def _make_sampler(greedy: bool, temperature: float, top_k: int,
                  top_p: float = 1.0):
    """The token sampler shared by the dense decoder and the serving
    engine: greedy argmax, or temperature -> top-k -> top-p -> categorical
    draw from the caller's ``torch.Generator``."""
    def sample(logits, generator):
        if greedy:
            return torch.argmax(logits, dim=-1)
        logits = logits.float() / np.float32(max(temperature, 1e-6))
        if top_k > 0:
            kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
            logits = torch.where(logits < kth, _NEG_INF, logits)
        if top_p is not None and top_p < 1.0:
            logits = _top_p_mask(logits, top_p)
        probs = torch.softmax(logits, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        draw = torch.multinomial(flat, 1, generator=generator)
        return draw.reshape(probs.shape[:-1])

    return sample


def spec_accept_greedy(pred, draft):
    """The greedy rejection rule of speculative decoding, shared by the
    serving engine's verify step and its tests.

    The verify block holds ``[carry, draft[0], .., draft[n-1]]`` at
    positions ``L .. L+n``; ``pred[i]`` is the target model's greedy token
    AFTER block row ``i``, so ``draft[i]`` is right iff ``pred[i] ==
    draft[i]``.  Accept the longest agreeing prefix, then emit the
    target's own token at the first disagreement (or the bonus token after
    a fully accepted draft): every emitted token is what sequential greedy
    decoding would have produced.  Returns ``(n_accepted, emitted)``, with
    ``emitted = draft[:n_accepted] + [pred[n_accepted]]``."""
    n = 0
    for d in draft:
        if int(pred[n]) != int(d):
            break
        n += 1
    return n, [int(t) for t in draft[:n]] + [int(pred[n])]


def build_generate_fn(model, max_new_tokens: int, temperature: float = 1.0,
                      top_k: int = 0, greedy: bool = True,
                      top_p: float = 1.0,
                      eos_token_id: Optional[int] = None,
                      int8: Optional[bool] = None,
                      kv_bits: Optional[int] = None,
                      attn_window: Optional[int] = None):
    """``gen(ids, seed=0)``: (B, T0) token ids in, (B, T0 + max_new_tokens)
    out on the model's device, the continuation appended.

    ``top_p`` < 1 enables nucleus sampling after temperature and top-k.
    With ``eos_token_id`` set, a row that emits EOS is finished and every
    later position of it is EOS.  ``int8`` (default ``cfg.int8``) runs the
    projections W8A8 with an int8 KV cache; ``kv_bits`` (default
    ``cfg.kv_bits``; 8 or 4) quantizes the KV cache alone.
    ``attn_window`` (default ``cfg.attn_window``) applies sliding-window
    attention.  ``seed`` seeds the sampling generator."""
    cfg = model.cfg
    int8 = _resolve_int8(cfg, int8)
    params, make_run = _decoder_setup(model, int8=int8,
                                      attn_window=attn_window)
    sample = _make_sampler(greedy, temperature, top_k, top_p)
    run = make_run(params)
    device = model.device

    @torch.no_grad()
    def gen(ids, seed: int = 0):
        ids = torch.as_tensor(ids).to(device=device, dtype=torch.long)
        b, t0 = ids.shape
        if t0 + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"{t0} prompt + {max_new_tokens} new tokens exceed the "
                f"model's max_seq_len {cfg.max_seq_len}")
        kc, vc = _empty_cache(cfg, b, t0 + max_new_tokens,
                              params["wte"].dtype, device, int8=int8,
                              kv_bits=kv_bits)
        generator = torch.Generator(device=device).manual_seed(seed)
        logits, kc, vc = run(ids, 0, kc, vc)
        tok = sample(logits[:, -1], generator)
        finished = (torch.zeros_like(tok, dtype=torch.bool)
                    if eos_token_id is None else tok == eos_token_id)
        out = [tok]
        for i in range(max_new_tokens - 1):
            # the carry token sits at position t0 + i: its K/V fill that
            # cache slot and the next token is sampled from its logits
            logits, kc, vc = run(tok[:, None], t0 + i, kc, vc)
            nxt = sample(logits[:, -1], generator)
            if eos_token_id is not None:
                nxt = torch.where(finished, eos_token_id, nxt)
                finished = finished | (nxt == eos_token_id)
            out.append(nxt)
            tok = nxt
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)

    return gen


def generate(model, ids, max_new_tokens: int = 32, temperature: float = 1.0,
             top_k: int = 0, greedy: bool = True, seed: int = 0,
             top_p: float = 1.0, eos_token_id: Optional[int] = None,
             int8: Optional[bool] = None, kv_bits: Optional[int] = None,
             attn_window: Optional[int] = None):
    """One-shot :func:`build_generate_fn` call.  Runs where the model
    lives: a model built without ``device=`` is on the CUDA card."""
    fn = build_generate_fn(model, max_new_tokens, temperature, top_k, greedy,
                           top_p=top_p, eos_token_id=eos_token_id, int8=int8,
                           kv_bits=kv_bits, attn_window=attn_window)
    return fn(ids, seed)


def _log_softmax(x):
    """``jax.nn.log_softmax`` over the last axis, in its order: the
    max-shifted values minus the log of their exponentials' sum."""
    shifted = x - x.max(dim=-1, keepdim=True).values
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _top_k(x, k):
    """``lax.top_k`` over the last axis: the ``k`` largest values and their
    indices, descending, equal values in index order (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _cache_rows(cache, rows):
    """A cache side with its batch rows (axis 1) taken in ``rows`` order:
    a new tensor, or a new ``(values, scales)`` pair."""
    if isinstance(cache, tuple):
        return tuple(c.index_select(1, rows) for c in cache)
    return cache.index_select(1, rows)


def build_beam_search_fn(model, max_new_tokens: int, beam_size: int = 4,
                         length_penalty: float = 0.0,
                         eos_token_id: Optional[int] = None,
                         int8: Optional[bool] = None):
    """Beam-search decoding: ``gen(ids)`` takes (B, T0) token ids and
    returns (B, T0 + max_new_tokens) on the model's device.

    Counterpart of the reference's ``build_beam_search_fn``: the B x K
    beams are flattened into the batch rows (row ``b * K + k``); the
    prompts prefill once, and the ``top_k`` of the last position's
    log-softmax seeds the K beams, whose caches are the prompt's repeated;
    each step is one (B*K)-row decode against the shared dense cache,
    then the top K of each batch row's K*V candidates (score plus
    log-prob) pick the parent beams and tokens, and the cache's rows are
    reordered to the parents.  Scores are sums of token log-probs.  With
    ``eos_token_id`` set a beam that emitted EOS is frozen: only its EOS
    continuation survives, at an unchanged score, and its length stops
    growing.  The sequences are read back through the parent pointers,
    and each batch row takes the beam of the best ``score / ((5 + len) /
    6) ** length_penalty`` (GNMT; 1 when ``length_penalty`` is 0) over
    the beam's actual length.  ``int8`` (default ``cfg.int8``) runs W8A8
    projections over ``(values, scales)`` caches, which reorder together.

    Ties break as ``lax.top_k`` breaks them, the lower index first (a
    stable descending sort): frozen beams make exact ties routine.  The
    cache is written in place by each step's forward, so the reorder
    takes the rows into new tensors after the write (``index_select``):
    no step reads a row that the next step overwrites."""
    cfg = model.cfg
    K = beam_size
    int8 = _resolve_int8(cfg, int8)
    params, make_run = _decoder_setup(model, int8=int8)
    run = make_run(params)
    device = model.device

    @torch.no_grad()
    def gen(ids):
        ids = torch.as_tensor(ids).to(device=device, dtype=torch.long)
        b, t0 = ids.shape
        if t0 + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"{t0} prompt + {max_new_tokens} new tokens exceed the "
                f"model's max_seq_len {cfg.max_seq_len}")
        V = params["wte"].shape[0]
        kc, vc = _empty_cache(cfg, b, t0 + max_new_tokens,
                              params["wte"].dtype, device, int8=int8)
        logits, kc, vc = run(ids, 0, kc, vc)
        scores0, tok0 = _top_k(_log_softmax(logits[:, -1]), K)   # (B, K)
        rep = torch.arange(b, device=device).repeat_interleave(K)
        kc, vc = _cache_rows(kc, rep), _cache_rows(vc, rep)      # b*K + k
        tokens = tok0.reshape(b * K)
        scores = scores0.reshape(b * K)
        finished = (torch.zeros(b * K, dtype=torch.bool, device=device)
                    if eos_token_id is None else tokens == eos_token_id)
        lengths = torch.ones(b * K, dtype=torch.float32, device=device)
        if eos_token_id is not None:
            frozen = torch.full((V,), -torch.inf, device=device)
            frozen[eos_token_id] = 0.0
        base = torch.arange(b, device=device)[:, None] * K
        toks, parents = [], []
        for i in range(max_new_tokens - 1):
            logits, kc, vc = run(tokens[:, None], t0 + i, kc, vc)
            lp = _log_softmax(logits[:, -1])                      # (B*K, V)
            if eos_token_id is not None:
                # frozen beams: only the EOS continuation survives, at an
                # unchanged score
                lp = torch.where(finished[:, None], frozen[None, :], lp)
            cand = (scores[:, None] + lp).reshape(b, K * V)
            new_scores, flat = _top_k(cand, K)                    # (B, K)
            parent = flat // V
            new_tok = flat % V
            rows = (base + parent).reshape(b * K)
            kc, vc = _cache_rows(kc, rows), _cache_rows(vc, rows)
            tokens = new_tok.reshape(b * K)
            scores = new_scores.reshape(b * K)
            finished = finished[rows]
            # live beams grew by one token; frozen beams keep the length
            # they had at their EOS (it feeds the length penalty)
            lengths = lengths[rows] + (~finished).float()
            if eos_token_id is not None:
                finished = finished | (tokens == eos_token_id)
            toks.append(tokens)
            parents.append(rows)

        # backtrack through the parent pointers
        rows = torch.arange(b * K, device=device)
        seq = []
        for step_toks, step_parents in zip(reversed(toks), reversed(parents)):
            seq.append(step_toks[rows])
            rows = step_parents[rows]
        first = tok0.reshape(b * K)[rows]
        beams = torch.stack([first] + seq[::-1])                  # (new, B*K)
        if length_penalty:
            norm = torch.pow((5.0 + lengths) / 6.0,
                             torch.tensor(length_penalty, dtype=torch.float32))
        else:
            norm = torch.ones_like(lengths)
        best = torch.argmax((scores / norm).reshape(b, K), dim=1)  # (B,)
        pick = torch.arange(b, device=device) * K + best
        out = beams[:, pick].t()                                   # (B, new)
        return torch.cat([ids, out.to(ids.dtype)], dim=1)

    return gen

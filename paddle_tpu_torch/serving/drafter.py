"""Host-side n-gram self-drafting for speculative decoding.

Own copy of ``paddle_tpu/serving/drafter.py``.  Prompt-lookup decoding: the
draft "model" is the request's own token history.  The history's trailing
n-gram is matched against its earlier occurrences, and the tokens that
followed the most recent match are proposed.

The drafter is host-only and stateless: numpy over the request's
``work_prompt()`` (prompt + generated), so draft buffers can always be
rebuilt from the request, and deterministic, so speculative greedy
decoding stays token-for-token identical to plain greedy decoding (the
verify pass, not the drafter, decides what is emitted).  The engine takes
any object with ``draft(history, max_tokens) -> np.ndarray``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class NGramDrafter:
    """Propose up to ``spec_k`` tokens by prompt lookup.

    Matches the history's trailing n-gram for ``n`` from ``max_ngram``
    down to ``min_ngram`` (a longer match wins); within one ``n`` the most
    recent earlier occurrence wins.  The proposal is the ``spec_k`` tokens
    that followed the match, possibly overlapping the suffix itself (right
    for periodic continuations).  No match proposes nothing: the verify
    step then runs as a plain one-token decode."""

    def __init__(self, spec_k: int, max_ngram: int = 3, min_ngram: int = 1):
        if spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.spec_k = int(spec_k)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def draft(self, history, max_tokens: Optional[int] = None) -> np.ndarray:
        """Up to ``min(spec_k, max_tokens)`` proposed continuation tokens of
        ``history`` (1-D int tokens), possibly none."""
        h = np.asarray(history, np.int32).reshape(-1)
        k = self.spec_k if max_tokens is None else min(self.spec_k,
                                                       int(max_tokens))
        if k < 1 or h.size < self.min_ngram + 1:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_ngram, h.size - 1),
                       self.min_ngram - 1, -1):
            suffix = h[h.size - n:]
            # windows that start before the trailing suffix itself
            wins = np.lib.stride_tricks.sliding_window_view(
                h, n)[: h.size - n]
            hits = np.flatnonzero((wins == suffix).all(axis=1))
            if hits.size:
                j = int(hits[-1]) + n
                return h[j:j + k].copy()
        return np.zeros((0,), np.int32)

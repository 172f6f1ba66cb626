"""Page-aligned prefix index for KV page reuse (RadixAttention, SGLang).

Requests to a real service overwhelmingly share prompt PREFIXES — the
system prompt, few-shot examples, the conversation so far — and a paged
KV cache makes sharing free at the kernel level: a page is just a row of
the pool, and two slots whose block tables point at the same row read the
same K/V.  What's missing is the host-side index that says "these tokens
are already in that page".

This module is that index: a radix tree over PAGE-SIZED token chunks.
Each node covers exactly ``page_size`` tokens and names the pool page
holding their K/V; a path from the root spells out a cached prefix.
Children are keyed by the raw chunk bytes (the dict's own hashing is the
token-chunk hash), with the chunk stored on the node so partial-tail
matches — the copy-on-write candidates — can be found by prefix
comparison.

Counterpart of ``paddle_tpu/serving/prefix_cache.py`` (host numpy only).

Lifecycle contract with :class:`~paddle_tpu_torch.serving.kv_pool.KVPool`:

  * the index holds NO refcount of its own — ``refcount[page]`` counts
    only live requests.  A cached page with refcount 0 is *reclaimable*:
    it stays out of the free list (its K/V remain valid for future
    matches) until :meth:`evict` hands it back under memory pressure —
    LRU eviction of refcount-0 leaves instead of eager free;
  * only IMMUTABLE pages may be inserted: full prompt pages a request
    will never write again.  The partially-filled tail page is never
    cached — a new request wanting it gets a copy-on-write clone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class _Node:
    __slots__ = ("chunk", "page", "children", "parent", "tick")

    def __init__(self, chunk: Optional[np.ndarray], page: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk            # the page_size tokens this node covers
        self.page = page              # pool page holding their K/V
        self.children: Dict[bytes, _Node] = {}
        self.parent = parent
        self.tick = 0                 # LRU clock (match/insert refresh it)


class PrefixIndex:
    """Radix tree mapping page-aligned token prefixes to pool pages."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _Node(None, -1, None)
        self._by_page: Dict[int, _Node] = {}
        self._tick = 0
        # lifetime eviction count: cache-churn observable the
        # engine mirrors into its metrics registry — rising evictions at
        # a flat hit rate means the working set outgrew the pool
        self.evictions = 0
        # prompts NOT indexed because sliding-window attention would
        # recycle their pages past the window boundary — the clean-refusal
        # counter the engine increments instead of inserting
        self.window_refusals = 0

    def __len__(self) -> int:
        return len(self._by_page)

    def __contains__(self, page: int) -> bool:
        return page in self._by_page

    def _touch(self, node: _Node) -> None:
        """Refresh the LRU tick on ``node`` and its whole prefix chain (a
        parent can never be older than a just-used child)."""
        self._tick += 1
        while node is not None and node.page >= 0:
            node.tick = self._tick
            node = node.parent

    @staticmethod
    def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
        n = min(a.size, b.size)
        neq = a[:n] != b[:n]
        return int(np.argmax(neq)) if neq.any() else n

    # -- lookup -----------------------------------------------------------

    def match(self, tokens) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest cached page-aligned prefix of ``tokens``.

        Returns ``(pages, partial)``: ``pages`` cover the first
        ``len(pages) * page_size`` tokens exactly (shareable as-is), and
        ``partial`` is an optional ``(page, m)`` whose first ``m`` (>= 1)
        positions hold K/V for the next ``m`` tokens — usable only via a
        copy-on-write clone, since the request must write later positions
        of that page.  Matched nodes' LRU ticks are refreshed; the caller
        must ``retain`` the returned pages before anything that can evict
        (they may sit at refcount 0).
        """
        toks = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        node, pages, i = self.root, [], 0
        while i + ps <= toks.size:
            child = node.children.get(toks[i:i + ps].tobytes())
            if child is None:
                break
            node = child
            pages.append(child.page)
            i += ps
        partial = None
        rest = toks[i:]
        if rest.size:
            best, best_m = None, 0
            for child in node.children.values():
                m = self._common_prefix(rest, child.chunk)
                if m > best_m:
                    best, best_m = child, m
            if best is not None:
                partial = (best.page, best_m)
                self._touch(best)
        if pages:
            self._touch(node)
        return pages, partial

    def probe_len(self, tokens) -> int:
        """Longest cached prefix of ``tokens`` in TOKENS, read-only: the
        same walk as :meth:`match` (full page-aligned chain plus the best
        partial tail) but touching neither the LRU ticks nor refcounts —
        this is how a replica exposes its prefix-index keys to the
        multi-replica router, which probes EVERY replica per
        request and must not distort the caches it merely inspected."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        node, i = self.root, 0
        while i + ps <= toks.size:
            child = node.children.get(toks[i:i + ps].tobytes())
            if child is None:
                break
            node = child
            i += ps
        rest = toks[i:]
        best_m = 0
        if rest.size:
            for child in node.children.values():
                best_m = max(best_m, self._common_prefix(rest, child.chunk))
        return i + best_m

    # -- insertion --------------------------------------------------------

    def insert(self, tokens, pages: Sequence[int]) -> List[int]:
        """Record ``pages[i]`` as holding the K/V of ``tokens``' i-th full
        chunk (only ``len(tokens) // page_size`` full chunks insert — the
        tail stays uncached).  A chunk already present keeps its EXISTING
        page; the duplicate is NOT absorbed and stays owned by its
        request alone.  Returns the pages newly adopted by the index
        (reclaimable through :meth:`evict` once their refcount hits 0).
        """
        toks = np.asarray(tokens, np.int32).reshape(-1)
        ps = self.page_size
        node, new = self.root, []
        for j in range(toks.size // ps):
            chunk = toks[j * ps:(j + 1) * ps]
            key = chunk.tobytes()
            child = node.children.get(key)
            if child is None:
                page = int(pages[j])
                if page in self._by_page:
                    raise ValueError(f"page {page} already indexed")
                child = _Node(chunk.copy(), page, node)
                node.children[key] = child
                self._by_page[page] = child
                new.append(page)
            node = child
        if node is not self.root:
            self._touch(node)
        return new

    # -- snapshot (serving/snapshot.py) -----------------------------------

    def to_state(self) -> dict:
        """Plain-python capture of the whole tree: nodes in parent-first
        (DFS) order as ``(parent_page, page, chunk, tick)``, with the
        root named by page -1.  Everything numpy/int — picklable and
        device-free."""
        nodes = []

        def walk(node: _Node) -> None:
            for child in node.children.values():
                nodes.append((node.page, child.page,
                              np.asarray(child.chunk, np.int32).copy(),
                              child.tick))
                walk(child)

        walk(self.root)
        return {"page_size": self.page_size, "tick": self._tick,
                "nodes": nodes, "evictions": self.evictions,
                "window_refusals": self.window_refusals}

    @classmethod
    def from_state(cls, state: dict) -> "PrefixIndex":
        """Rebuild an index from :meth:`to_state`.  Parent-first node
        order means every parent exists before its children link in."""
        idx = cls(state["page_size"])
        by_page: Dict[int, _Node] = {-1: idx.root}
        for parent_page, page, chunk, tick in state["nodes"]:
            parent = by_page[int(parent_page)]
            node = _Node(np.asarray(chunk, np.int32), int(page), parent)
            node.tick = int(tick)
            parent.children[node.chunk.tobytes()] = node
            idx._by_page[node.page] = node
            by_page[node.page] = node
        idx._tick = int(state["tick"])
        idx.evictions = int(state.get("evictions", 0))
        idx.window_refusals = int(state.get("window_refusals", 0))
        return idx

    # -- eviction ---------------------------------------------------------

    def evict(self, n_pages: int, refcount: Sequence[int]) -> List[int]:
        """Reclaim up to ``n_pages`` cached pages, LRU-first, considering
        only LEAVES with ``refcount == 0`` (an interior node becomes
        evictable once its children go).  Returns the evicted pages —
        the pool pushes them back on its free list."""
        out: List[int] = []
        while len(out) < n_pages:
            # one sweep collects every currently-evictable leaf; evicting
            # down the sorted list may expose parents, so sweep again only
            # if the quota isn't met — O(n + k log n) typical instead of a
            # full scan per evicted page
            victims = sorted(
                (node for node in self._by_page.values()
                 if not node.children and refcount[node.page] == 0),
                key=lambda n: n.tick)
            if not victims:
                break
            for node in victims:
                if len(out) >= n_pages:
                    break
                del node.parent.children[node.chunk.tobytes()]
                del self._by_page[node.page]
                out.append(node.page)
        self.evictions += len(out)
        return out

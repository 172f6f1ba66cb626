"""Page-pool KV cache allocator (PagedAttention / vLLM, SOSP '23).

Counterpart of ``paddle_tpu/serving/kv_pool.py``.  The KV cache is a pool
of fixed-size pages shared by all slots; each sequence owns just enough
pages for its current length, recorded in a per-slot block table.

Device layout: one tensor per side, all layers stacked,
``(L, P, Hkv, page_size, D)`` in the model dtype.  With ``kv_bits=8`` the
pages hold int8 values, with ``kv_bits=4`` two int4 values per byte
(``(…, D // 2)``, split halves), and both add fp32 per-position scale
buffers ``ks``/``vs`` of shape ``(L, P, Hkv, page_size, 1)``.  The
engine's step functions write these tensors in place.

Page 0 is RESERVED as the null page: the allocator never hands it out,
block-table padding points at it, and masked/inactive lanes write their
garbage there — so no gather can index out of the pool and no active page
can be corrupted by an inactive lane.

Sharing: every page carries a REFCOUNT of live requests holding it.
``alloc`` leases fresh pages at refcount 1; a request matching a cached
prefix ``retain``\\ s the shared pages; ``free`` drops one reference per
page and only a page at refcount 0 leaves circulation — back to the free
list, unless the pool's :class:`~.prefix_cache.PrefixIndex` still names it,
in which case it parks as *reclaimable* until LRU eviction hands it back.

Page payloads (the disaggregated prefill -> decode handoff and snapshots)
travel as host numpy in the snapshot-v5 wire format: one array per buffer
(``k``, ``v`` and, for quantized pages, ``ks``/``vs``) in block-table
order, with the pool's :meth:`KVPool.layout` beside them.  numpy has no
bf16, so a bf16 buffer ships as its raw 16-bit patterns in a ``uint16``
array: a reader tells the two apart by the layout's ``page_dtype``
(``"bfloat16"``), and no other page dtype ships as ``uint16``.  An array
of ``ml_dtypes``' bfloat16 (what the reference exports) is taken the same
way.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, resolve_dtype
from .prefix_cache import PrefixIndex


class KVPool:
    """Fixed-size page pool + refcounted free-list allocator.  The pool
    lives on ``device`` (the CUDA card unless the caller passes one; see
    :mod:`paddle_tpu_torch.device`) in ``dtype`` (default: the device's,
    fp32 on the CPU and bf16 on the card).  The arguments are the
    reference's, in its order (``int8=True`` means ``kv_bits=8``), and
    ``device``, keyword-only."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 num_pages: int, page_size: int,
                 dtype: Optional[torch.dtype] = None,
                 int8: bool = False, prefix_cache: bool = False,
                 num_kv_heads: Optional[int] = None,
                 kv_bits: Optional[int] = None,
                 window: Optional[int] = None, *,
                 device: DeviceLike = None):
        if num_pages < 2:
            raise ValueError("KVPool needs >= 2 pages (page 0 is the "
                             "reserved null page)")
        if kv_bits is None and int8:
            kv_bits = 8
        if kv_bits not in (None, 4, 8):
            raise ValueError(f"kv_bits must be None, 4 or 8, got {kv_bits}")
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads != 0:
            raise ValueError(f"num_heads={num_heads} not divisible by "
                             f"num_kv_heads={kv_heads}")
        if kv_bits == 4 and head_dim % 2 != 0:
            raise ValueError("kv_bits=4 needs an even head_dim "
                             "(two nibbles per byte)")
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = kv_heads
        self.head_dim = head_dim
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_bits = kv_bits
        self.window = window
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        store_d = head_dim // 2 if kv_bits == 4 else head_dim
        shape = (num_layers, num_pages, kv_heads, page_size, store_d)
        if kv_bits is None:
            self.buffers: Dict[str, torch.Tensor] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
        else:
            scales = shape[:-1] + (1,)
            self.buffers = {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(scales, dtype=torch.float32, device=device),
                "vs": torch.zeros(scales, dtype=torch.float32, device=device)}
        # LIFO free list over pages 1..P-1 (page 0 stays the null page),
        # mirrored by a set for O(1) membership
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self.refcount: List[int] = [0] * num_pages
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(page_size) if prefix_cache else None)
        # optional fault-injection plan (serving/faults.py): a scripted
        # step makes every alloc fail, the observable a real exhausted
        # pool produces
        self.faults = None
        # allocator traffic, mirrored into the engine's metrics registry
        self.alloc_calls = 0
        self.alloc_failures = 0

    # -- allocation -------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached(self) -> int:
        """Pages parked in the prefix index (reclaimable + shared)."""
        return len(self.prefix) if self.prefix is not None else 0

    @property
    def num_reclaimable(self) -> int:
        """Cached pages with no live reference — evictable on demand."""
        if self.prefix is None:
            return 0
        return sum(1 for p in self.prefix._by_page if self.refcount[p] == 0)

    @property
    def pages_in_use(self) -> int:
        """Pages referenced by at least one live request."""
        return sum(1 for r in self.refcount if r > 0)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` positions."""
        return max(1, math.ceil(n_tokens / self.page_size))

    def _check_page(self, p: int) -> None:
        if p <= 0 or p >= self.num_pages:
            raise ValueError(f"invalid page id {p}")

    def _push_free(self, p: int) -> None:
        self._free.append(p)
        self._free_set.add(p)

    def alloc(self, n_pages: int) -> Optional[List[int]]:
        """Lease ``n_pages`` fresh pages at refcount 1, or None when even
        LRU-evicting reclaimable cached pages can't satisfy the request
        (caller keeps the request queued — FCFS)."""
        if n_pages == 0:
            return []
        self.alloc_calls += 1
        if self.faults is not None and self.faults.fail_alloc():
            self.alloc_failures += 1
            return None
        if n_pages > len(self._free) and self.prefix is not None:
            for p in self.prefix.evict(n_pages - len(self._free),
                                       self.refcount):
                self._push_free(p)
        if n_pages > len(self._free):
            self.alloc_failures += 1
            return None
        got = []
        for _ in range(n_pages):
            p = self._free.pop()
            self._free_set.discard(p)
            self.refcount[p] = 1
            got.append(p)
        return got

    def retain(self, pages: List[int]) -> None:
        """Add one reference per page — a request adopting cached prefix
        pages (a reclaimable page at refcount 0 becomes live again)."""
        for p in pages:
            self._check_page(p)
            if p in self._free_set:
                raise ValueError(f"retain of free page {p}")
            self.refcount[p] += 1

    def free(self, pages: List[int]) -> None:
        """Drop one reference per page.  A page reaching refcount 0 goes
        back to the free list unless the prefix index still names it (it
        parks as reclaimable instead).  Over-freeing — more drops than
        references, including duplicates within one call — raises BEFORE
        any mutation."""
        for p, n in Counter(pages).items():
            self._check_page(p)
            if self.refcount[p] < n:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self.refcount[p] -= 1
            if self.refcount[p] == 0 and not (
                    self.prefix is not None and p in self.prefix):
                self._push_free(p)

    # retain/free bracket one REFERENCE; `release` reads better at call
    # sites that drop a whole lease
    release = free

    # -- page payload transfer --------------------------------------------

    def export_pages(self, pages: List[int]) -> Dict[str, object]:
        """The K/V bytes of ``pages`` (in the given block-table order) as
        host numpy — the handoff payload, one array ``(L, n, Hkv, ps, d)``
        per buffer, so quantized pages travel with their scale planes.
        On the card: one device gather and one device-to-host copy per
        buffer.  The payload embeds :meth:`layout`; :meth:`ingest_pages`
        on the receiving pool refuses a mismatch."""
        idx = [int(p) for p in pages]
        for p in idx:
            self._check_page(p)
        rows = torch.tensor(idx, dtype=torch.long)
        out = {}
        for name, buf in self.buffers.items():
            got = buf.index_select(1, rows.to(buf.device))
            out[name] = to_wire(got)
        return {"layout": self.layout(), "buffers": out}

    @staticmethod
    def payload_nbytes(payload: Dict[str, object]) -> int:
        """Wire size of an :meth:`export_pages` payload (page bytes and
        scale planes; the layout dict is negligible)."""
        return sum(int(a.nbytes) for a in payload["buffers"].values())

    def check_layout(self, want: Dict[str, object],
                     what: str = "page payload") -> None:
        """Refuse a foreign KV layout loudly, with the per-key diff: mixed
        layouts would reinterpret page bytes silently."""
        have = self.layout()
        if have != want:
            diff = {k: (want.get(k), have.get(k))
                    for k in set(want) | set(have)
                    if have.get(k) != want.get(k)}
            raise ValueError(
                f"{what} KV layout does not match this pool — sender vs "
                f"receiver: {diff}; pages are byte-compatible only between "
                "pools that share kv heads, page dtype, kv_bits, window "
                "and page geometry")

    def ingest_pages(self, payload: Dict[str, object],
                     pages: List[int]) -> None:
        """Adopt an :meth:`export_pages` payload into freshly leased
        ``pages`` (same order).  Layout-guarded; on the card one
        host-to-device copy and one ``index_copy_`` per buffer, so the
        round trip export -> host -> ingest is bit-exact for float, int8
        and int4 pages and their scales."""
        self.check_layout(payload["layout"])
        bufs = payload["buffers"]
        if set(bufs) != set(self.buffers):
            raise ValueError(
                f"payload buffers {sorted(bufs)} != pool buffers "
                f"{sorted(self.buffers)}")
        idx = [int(p) for p in pages]
        for p in idx:
            self._check_page(p)
        n = len(idx)
        for name, arr in bufs.items():
            if arr.shape[1] != n:
                raise ValueError(
                    f"payload buffer {name!r} carries {arr.shape[1]} "
                    f"pages for a {n}-page lease")
        rows = torch.tensor(idx, dtype=torch.long)
        for name, arr in bufs.items():
            buf = self.buffers[name]
            src = from_wire(arr, buf.dtype, buf.device)
            buf.index_copy_(1, rows.to(buf.device), src)

    # -- invariants -------------------------------------------------------

    def check(self) -> None:
        """Refcount / free-list / prefix-index consistency — every page is
        exactly one of: free, live (refcount > 0), or cached-reclaimable."""
        if len(self._free) != len(self._free_set) or \
                set(self._free) != self._free_set:
            raise AssertionError("free list and free set diverged")
        if 0 in self._free_set or self.refcount[0] != 0:
            raise AssertionError("null page entered circulation")
        cached = set(self.prefix._by_page) if self.prefix is not None else set()
        for p in range(1, self.num_pages):
            free = p in self._free_set
            rc = self.refcount[p]
            if rc < 0:
                raise AssertionError(f"negative refcount on page {p}")
            if free and (rc != 0 or p in cached):
                raise AssertionError(f"page {p} free while referenced/cached")
            if not free and rc == 0 and p not in cached:
                raise AssertionError(f"leaked page {p}: unreferenced, "
                                     "uncached, not free")

    # -- stats ------------------------------------------------------------

    def utilization(self) -> float:
        """Fraction of usable pages out of the free list (live + cached)."""
        usable = self.num_pages - 1
        return 1.0 - len(self._free) / max(usable, 1)

    def hbm_bytes(self) -> int:
        return sum(b.numel() * b.element_size()
                   for b in self.buffers.values())

    def bytes_per_token(self) -> int:
        """Device bytes one token position costs across all layers and both
        sides, scales included (GQA divides it by the group factor, int8 by
        about 2 against bf16, int4 by about 4)."""
        return self.num_layers * self.num_kv_heads * sum(
            b.element_size() * b.shape[-1] for b in self.buffers.values())

    def layout(self) -> Dict[str, object]:
        """The pool's KV storage layout — everything that must MATCH for
        another pool's pages to be byte-compatible with this one (what
        snapshot v5 records and restore refuses to mix).  ``page_dtype``
        takes numpy's spelling (``"float32"``, ``"bfloat16"``,
        ``"int8"``), as the reference's pools give it."""
        return {
            "kv_heads": self.num_kv_heads,
            "page_dtype": dtype_name(self.buffers["k"].dtype),
            "kv_bits": self.kv_bits,
            "window": self.window,
            "page_size": self.page_size,
            "head_dim": self.head_dim,
        }


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype: ``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).replace("torch.", "")


def to_wire(t: torch.Tensor) -> np.ndarray:
    """A tensor as host numpy in the wire format: bf16 as its raw bit
    patterns in ``uint16`` (numpy has no bf16), every other dtype as is."""
    # a copy either way: the wire never aliases a live CPU buffer
    host = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def from_wire(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """The inverse of :func:`to_wire` onto ``device`` in ``dtype``: a
    ``uint16`` array (or one of ``ml_dtypes``' bfloat16) meant for a bf16
    buffer is viewed back bit for bit."""
    arr = np.ascontiguousarray(arr)
    if dtype == torch.bfloat16:
        if arr.dtype != np.uint16:
            if arr.dtype.name != "bfloat16":
                raise ValueError(f"a bf16 buffer takes uint16 bit patterns, "
                                 f"got {arr.dtype}")
            arr = arr.view(np.uint16)
        return torch.from_numpy(arr.view(np.int16)).to(device).view(dtype)
    if dtype_name(dtype) != arr.dtype.name:
        raise ValueError(f"a {dtype_name(dtype)} buffer cannot take a "
                         f"{arr.dtype} array")
    return torch.from_numpy(arr).to(device)

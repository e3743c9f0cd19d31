"""Paged KV pool: the serving engine's physical cache allocator.

A port of the JAX package's ``serving/kv_pool.py`` allocator:

* one device tensor of fixed-size pages shared by every sequence,
  ``(n_layers, num_pages + 1, page_size, 2*Kv, hd)`` in the fused
  head-interleaved ``[K0,V0,K1,V1,..]`` layout, the extra page being the
  trash page that padded rows write to;
* a per-sequence page table mapping logical page ``j`` to a physical page;
* a LIFO free list with reuse, and per-page refcounts so a page may sit in
  several tables (``reserve(shared_pages=...)``; a partially shared
  ``boundary_page`` is copy-on-written into a fresh page);
* reservation-based admission: ``reserve()`` sets aside a request's
  worst-case page count up front, so an admitted sequence never runs out of
  pages mid-decode, and the table grows lazily from it (``ensure``);
* exact internal-fragmentation accounting (the tail of each sequence's last
  page); there is no padding waste;
* a host spill tier (``enable_spill``): ref-free cached pages move to a
  host arena under pool pressure and come back on re-match.  On a CUDA
  pool the arena is one pinned tensor, and each spill or restore is one
  copy of a page at every layer on the current stream.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import stats
from ..device import resolve_device
from ..kernels.paged_attention import interleave_kv
from ..obs.tracing import span


class OutOfPagesError(RuntimeError):
    """Raised when a reservation asks for more pages than the pool holds.

    Carries the sizing facts (``need``/``free``/``in_use``/``num_pages``),
    and the message names the remedies.
    """

    def __init__(self, what: str, *, need: int, free: int,
                 in_use: int, num_pages: int):
        self.need = need
        self.free = free
        self.in_use = in_use
        self.num_pages = num_pages
        super().__init__(
            f"{what}: need {need} page(s) but only {free} free"
            f" ({in_use} of {num_pages} in use);"
            " retry after sequences retire, or raise --num-pages"
        )


@dataclass
class _SeqAlloc:
    reserved: List[int] = field(default_factory=list)  # physical, not in table
    table: List[int] = field(default_factory=list)     # physical, in use
    tokens: int = 0                                    # KV tokens written


class KVPool:
    """Page allocator + the paged KV device tensor for one model.

    The tensor holds all layers, so one page id covers a token's KV at every
    layer: a single page table per sequence.
    """

    def __init__(self, *, n_layers: int, n_kv_heads: int, head_dim: int,
                 num_pages: int, page_size: int, dtype=torch.float32,
                 device="cuda"):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be positive")
        self.n_layers = n_layers
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.num_pages = num_pages
        self.page_size = page_size
        self.dtype = dtype
        self.device = resolve_device(device)
        # physical page ``num_pages`` is the trash page: padded rows of an
        # engine step write their KV there, so no write is predicated.  It is
        # never allocated and not part of the accounted capacity.
        self.pages = torch.zeros(
            (n_layers, num_pages + 1, page_size, 2 * n_kv_heads, head_dim),
            dtype=dtype, device=self.device)
        # LIFO free list: most-recently-freed pages are reused first
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._seqs: Dict[int, _SeqAlloc] = {}
        # every page outside the free list and outside a private reservation
        # has a refcount: 1 for its sequence, +1 per extra holder
        self._ref: Dict[int, int] = {}
        self.peak_pages_in_use = 0
        self.alloc_events = 0
        self.free_events = 0
        self.cow_events = 0
        # the host spill tier (enable_spill): a (capacity, n_layers,
        # page_size, 2*Kv, hd) arena, pinned on a CUDA pool, and its free slots
        self._host: Optional[torch.Tensor] = None
        self._host_free: List[int] = []
        self.spill_events = 0
        self.restore_events = 0

    @property
    def trash_page(self) -> int:
        """Physical index of the scratch page padded writes are aimed at."""
        return self.num_pages

    # -- capacity ------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def can_reserve(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= len(self._free)

    # -- refcounts ------------------------------------------------------
    def refcount(self, page: int) -> int:
        """Current holder count of a physical page (0 = free or reserved)."""
        return self._ref.get(page, 0)

    def incref(self, page: int) -> None:
        """Register one more holder of an already-allocated page."""
        if page not in self._ref:
            raise ValueError(f"page {page} is not allocated (cannot incref)")
        self._ref[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one holder; the last ref returns the page to the free list.

        Returns True when the page actually went back to the free list.
        """
        n = self._ref.get(page)
        if not n:
            raise ValueError(f"page {page} is not allocated (cannot decref)")
        if n > 1:
            self._ref[page] = n - 1
            return False
        del self._ref[page]
        self._free.append(page)
        self.free_events += 1
        stats.bump("pages_freed")
        return True

    # -- allocation ----------------------------------------------------
    def reserve(self, seq_id: int, n_tokens: int, *,
                shared_pages: Sequence[int] = (), shared_tokens: int = 0,
                boundary_page: Optional[int] = None) -> None:
        """Set aside pages for ``n_tokens`` worth of KV (admission step).

        ``shared_pages`` are full, already-populated pages that seed the
        sequence's table; each gains one ref and is not drawn from the free
        list.  ``boundary_page`` is a partially matched page: its contents
        are copied on the device into one of the newly reserved pages, so a
        shared page is never written.

        Raises :class:`OutOfPagesError` without side effects if the free
        list cannot cover the request.
        """
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already allocated")
        if shared_tokens > n_tokens:
            raise ValueError("shared_tokens exceeds the reservation")
        need = self.pages_for(n_tokens) - len(shared_pages)
        if need < (1 if boundary_page is not None else 0):
            raise ValueError("shared pages exceed the reservation size")
        if need > len(self._free):
            raise OutOfPagesError(
                f"sequence {seq_id}: reserving {n_tokens} tokens",
                need=need, free=len(self._free),
                in_use=self.pages_in_use, num_pages=self.num_pages,
            )
        table = []
        for p in shared_pages:
            self.incref(p)
            table.append(p)
        reserved = [self._free.pop() for _ in range(need)]
        if boundary_page is not None:
            dst = reserved.pop()
            self._ref[dst] = 1
            self.pages[:, dst].copy_(self.pages[:, boundary_page])
            table.append(dst)
            self.cow_events += 1
            stats.bump("cow_copies")
        self._seqs[seq_id] = _SeqAlloc(reserved=reserved, table=table,
                                       tokens=shared_tokens)
        self.alloc_events += need
        stats.bump("pages_allocated", need)
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)

    def ensure(self, seq_id: int, n_tokens: int) -> None:
        """Grow the sequence's page table to cover ``n_tokens`` tokens.

        Pages are promoted from the sequence's own reservation first; a
        shortfall draws from the free list and may raise
        :class:`OutOfPagesError`.
        """
        alloc = self._seqs[seq_id]
        need = self.pages_for(n_tokens) - len(alloc.table)
        for _ in range(max(need, 0)):
            if alloc.reserved:
                page = alloc.reserved.pop()
            elif self._free:
                page = self._free.pop()
                self.alloc_events += 1
                stats.bump("pages_allocated")
            else:
                raise OutOfPagesError(
                    f"sequence {seq_id}: table growth to {n_tokens} tokens"
                    " exhausted both its reservation and the free list",
                    need=max(need, 0), free=0,
                    in_use=self.pages_in_use, num_pages=self.num_pages,
                )
            self._ref[page] = 1
            alloc.table.append(page)
        alloc.tokens = max(alloc.tokens, n_tokens)
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)

    def free(self, seq_id: int) -> int:
        """Release every page the sequence holds; returns how many pages
        actually re-entered the free list."""
        alloc = self._seqs.pop(seq_id)
        returned = 0
        for p in alloc.table:
            if self.decref(p):
                returned += 1
        self._free.extend(reversed(alloc.reserved))
        self.free_events += len(alloc.reserved)
        stats.bump("pages_freed", len(alloc.reserved))
        return returned + len(alloc.reserved)

    # -- host spill tier -----------------------------------------------
    def enable_spill(self, capacity: int) -> None:
        """Allocate the host spill arena of ``capacity`` pages.

        On a CUDA pool the arena is pinned, so a spill or restore is one
        DMA; a failed pinned allocation raises."""
        if capacity < 1:
            raise ValueError("spill capacity must be positive")
        self._host = torch.zeros(
            (capacity, self.n_layers, self.page_size, 2 * self.n_kv_heads, self.head_dim),
            dtype=self.dtype, pin_memory=self.device.type == "cuda")
        self._host_free = list(range(capacity - 1, -1, -1))

    @property
    def spill_enabled(self) -> bool:
        return self._host is not None

    @property
    def host_capacity(self) -> int:
        return 0 if self._host is None else self._host.shape[0]

    @property
    def spilled_pages(self) -> int:
        return self.host_capacity - len(self._host_free)

    def spill_page(self, page: int) -> int:
        """Move a sole-holder device page to the host arena; returns the
        host slot.  The device page returns to the free list (its single
        ref, the caller's, is consumed)."""
        if self._host is None:
            raise RuntimeError("spill tier not enabled (enable_spill)")
        if self._ref.get(page) != 1:
            raise ValueError(f"page {page} has refcount {self.refcount(page)};"
                             " only sole-holder pages may spill")
        if not self._host_free:
            raise RuntimeError("host spill arena is full")
        slot = self._host_free.pop()
        # pages[:, page] strides over the layers: the copy gathers the page
        # at every layer into the slot's contiguous block
        with span("serve.spill", page=page, slot=slot):
            self._host[slot].copy_(self.pages[:, page])
        self.decref(page)
        self.spill_events += 1
        stats.bump("pages_spilled")
        return slot

    def restore_page(self, slot: int) -> int:
        """Bring a spilled page back to the device; returns the physical
        page id (refcount 1, owned by the caller).  Raises
        :class:`OutOfPagesError` when the free list is empty: the caller
        decides whether to spill something else first."""
        if self._host is None:
            raise RuntimeError("spill tier not enabled (enable_spill)")
        if slot in self._host_free or not (0 <= slot < self.host_capacity):
            raise ValueError(f"host slot {slot} holds no spilled page")
        if not self._free:
            raise OutOfPagesError(f"restoring spilled host slot {slot}", need=1, free=0,
                                  in_use=self.pages_in_use, num_pages=self.num_pages)
        page = self._free.pop()
        with span("serve.restore", page=page, slot=slot):
            self.pages[:, page].copy_(self._host[slot])
        self._ref[page] = 1
        self._host_free.append(slot)
        self.alloc_events += 1
        stats.bump("pages_allocated")
        self.restore_events += 1
        stats.bump("pages_restored")
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return page

    def drop_spilled(self, slot: int) -> None:
        """Discard a spilled page (host-arena eviction, no device effect)."""
        if slot in self._host_free or not (0 <= slot < self.host_capacity):
            raise ValueError(f"host slot {slot} holds no spilled page")
        self._host_free.append(slot)

    # -- invariants ----------------------------------------------------
    def check_invariants(self) -> None:
        """Assert the allocator's conservation laws (test/debug hook).

        Every physical page is in exactly one of: the free list, a
        sequence's private reservation, or the refcounted set (tables and
        external holders such as the prefix cache); a page may appear in
        several tables only while its refcount covers each one.
        """
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages in free list"
        reserved: List[int] = []
        table_counts: Dict[int, int] = {}
        for a in self._seqs.values():
            reserved.extend(a.reserved)
            for p in a.table:
                table_counts[p] = table_counts.get(p, 0) + 1
        assert len(set(reserved)) == len(reserved), "reserved page aliased"
        refd = set(self._ref)
        for group in (reserved, refd):
            assert not free & set(group), "page both free and allocated"
        assert not refd & set(reserved), "page both reserved and refcounted"
        assert len(free) + len(refd) + len(reserved) == self.num_pages, \
            "page conservation violated"
        for p, n in table_counts.items():
            assert self._ref.get(p, 0) >= n, (
                f"page {p} in {n} tables with refcount {self._ref.get(p, 0)}")
        for p, r in self._ref.items():
            assert r > 0, f"page {p} held with nonpositive refcount"
        assert self.spilled_pages >= 0

    # -- views for the kernel ------------------------------------------
    def table(self, seq_id: int) -> List[int]:
        return list(self._seqs[seq_id].table)

    def tokens(self, seq_id: int) -> int:
        return self._seqs[seq_id].tokens

    def table_array(self, seq_ids: List[Optional[int]], max_pages: int) -> torch.Tensor:
        """Dense (len(seq_ids), max_pages) int32 page table on the pool's
        device.  ``None`` rows and unused tail entries are 0; the kernel
        never reads them."""
        out = np.zeros((len(seq_ids), max_pages), np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is None:
                continue
            t = self._seqs[sid].table
            out[i, :len(t)] = t
        return torch.from_numpy(out).to(self.device)

    # -- device writes -------------------------------------------------
    def write(self, layer: int, slots: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """Write new KV rows into layer ``layer`` of the pool, in place.

        ``slots``: (T,) flat slot ids (``page_id * page_size + offset``);
        ``k``/``v``: (T, Kv, hd).  The JAX pool rebuilds its array
        functionally for every layer; writing in place saves one pool copy
        per layer per step.  Duplicate slots (padded rows aimed at the trash
        page) leave that page with any one of their rows.
        """
        flat = self.pages[layer].view(-1, 2 * self.n_kv_heads, self.head_dim)
        flat.index_copy_(0, slots, interleave_kv(k, v).to(self.dtype))

    # -- accounting ----------------------------------------------------
    def token_bytes(self) -> int:
        """KV bytes of ONE token across all layers (the waste unit)."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return self.n_layers * 2 * self.n_kv_heads * self.head_dim * itemsize

    def frag_token_slots(self) -> int:
        """Internal fragmentation: reserved-but-unwritten token slots."""
        slack = 0
        for a in self._seqs.values():
            slack += len(a.table) * self.page_size - a.tokens
            slack += len(a.reserved) * self.page_size
        return slack

    def frag_bytes(self) -> int:
        return self.frag_token_slots() * self.token_bytes()

    def stats(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pages_in_use": self.pages_in_use,
            "peak_pages_in_use": self.peak_pages_in_use,
            "free_pages": self.free_pages,
            "pages_allocated": self.alloc_events,
            "pages_freed": self.free_events,
            "frag_token_slots": self.frag_token_slots(),
            "frag_bytes": self.frag_bytes(),
            "cow_copies": self.cow_events,
            "spilled_pages": self.spilled_pages,
            "host_capacity_pages": self.host_capacity,
            "pages_spilled": self.spill_events,
            "pages_restored": self.restore_events,
            # paged KV has no padding by construction
            "padded_kv_waste_bytes": 0,
        }

    @classmethod
    def for_config(cls, cfg, *, num_pages: int, page_size: int, device="cuda"):
        """Build a pool sized for ``cfg``'s attention stack."""
        if cfg.family not in ("dense", "vlm", "moe") or cfg.mla:
            raise ValueError(
                f"KVPool supports standard GQA attention caches, not"
                f" family={cfg.family!r} mla={cfg.mla}"
            )
        return cls(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.hd, num_pages=num_pages, page_size=page_size,
                   dtype=cfg.torch_dtype, device=device)

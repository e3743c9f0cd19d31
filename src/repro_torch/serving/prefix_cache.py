"""Prefix-sharing radix cache over the paged KV pool.

A port of the JAX package's ``serving/prefix_cache.py``.  Requests that
share prompt structure (one system prompt, one few-shot preamble) share the
pool pages holding its KV instead of storing and prefilling it again:

* a **radix tree keyed on token-id page blocks**: each node covers one pool
  page worth of prompt tokens (the last node of an inserted prompt may be
  partial) and points at the physical :class:`~repro_torch.serving.kv_pool.KVPool`
  page holding that block's KV at every layer.  Children are scanned for
  the longest common token prefix, so lookups match *into* a block, not
  just at block boundaries;
* **ref-counted sharing**: a matched admission seeds its page table with
  the cached physical pages (one ``incref`` per page; the paged attention
  kernel needs no change, shared pages are repeated physical ids across
  tables) and skips prefill for every matched token; prefill chunks start
  at the divergence point;
* **copy-on-write at the boundary**: only a *partially* matched page is
  ever written by the matcher, so exactly that page is copied
  (``KVPool.reserve(boundary_page=...)``) and every fully matched page
  stays immutable however many tables reference it;
* a **host spill tier**: under pool pressure, ref-free cached pages (held
  only by this cache) are evicted LRU into the pool's host arena
  (``spill_page``) instead of dropped, and restored on re-match
  (``restore_page``), so an ``OutOfPagesError`` at admission becomes a
  retry after spill instead of a refusal.

Correctness notes.  KV for a token depends only on the token ids before it
and the (fixed) parameters, so matching is exact token-id equality.  A
cached page may physically hold stale rows beyond its node's token count
(the inserting sequence kept decoding into its last prompt page); those
rows are either overwritten by the matcher's own prefill (positions at or
past the match point) or masked by the kernel's ragged causal mask.
Matches are capped at ``len(prompt) - 1`` tokens: the engine still needs
one forward position to produce the first output token.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from .kv_pool import KVPool, OutOfPagesError


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


@dataclass
class _Node:
    """One page-block of cached prompt: a radix-tree edge + its KV page."""

    tokens: Tuple[int, ...]
    page: Optional[int] = None        # physical pool page when resident
    host_slot: Optional[int] = None   # pool host-arena slot when spilled
    parent: Optional["_Node"] = None
    children: List["_Node"] = field(default_factory=list)
    last_access: int = 0

    @property
    def resident(self) -> bool:
        return self.page is not None

    @property
    def spilled(self) -> bool:
        return self.host_slot is not None


@dataclass
class PrefixMatch:
    """Result of a prefix lookup: what admission may share.

    ``full_pages`` are fully-matched immutable pages (shared by incref);
    ``boundary_page`` is a partially-matched page the matcher must COW.
    ``matched_tokens`` counts both parts.
    """

    matched_tokens: int = 0
    full_pages: List[int] = field(default_factory=list)
    boundary_page: Optional[int] = None

    @property
    def pages(self) -> FrozenSet[int]:
        extra = () if self.boundary_page is None else (self.boundary_page,)
        return frozenset(list(self.full_pages) + list(extra))


class PrefixCache:
    """Radix tree of cached prompt prefixes backed by ref-counted pool pages.

    The cache sits between the allocator and the scheduler: admission calls
    :meth:`lock_prefix`, reserves with the returned shared pages, and on
    :class:`OutOfPagesError` calls :meth:`release_pages` for the shortfall
    and retries.  Prefill completion calls :meth:`insert` so the *next*
    request can match.
    """

    def __init__(self, pool: KVPool, *, spill_pages: int = 0):
        self.pool = pool
        if spill_pages > 0 and not pool.spill_enabled:
            pool.enable_spill(spill_pages)
        self.root = _Node(tokens=())
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.tokens_reused = 0
        self.inserted_nodes = 0
        self.dropped_nodes = 0

    # -- internals -----------------------------------------------------
    def _bump(self, node: _Node) -> None:
        self._clock += 1
        node.last_access = self._clock

    def _iter_nodes(self) -> Iterator[_Node]:
        stack = list(self.root.children)
        while stack:
            n = stack.pop()
            stack.extend(n.children)
            yield n

    def _ensure_resident(self, node: _Node, protect: Set[int]) -> bool:
        """Restore a spilled node's page, spilling others if needed."""
        if node.resident:
            return True
        try:
            page = self.pool.restore_page(node.host_slot)
        except OutOfPagesError:
            if self.release_pages(1, protect=protect) < 1:
                return False
            try:
                page = self.pool.restore_page(node.host_slot)
            except OutOfPagesError:
                return False
        node.page = page
        node.host_slot = None
        return True

    def _drop(self, node: _Node) -> None:
        """Remove a node from the tree, releasing whatever it holds."""
        if node.resident:
            self.pool.decref(node.page)
        elif node.spilled:
            self.pool.drop_spilled(node.host_slot)
        node.page = None
        node.host_slot = None
        if node.parent is not None:
            node.parent.children.remove(node)
        node.parent = None
        self.dropped_nodes += 1

    # -- lookup --------------------------------------------------------
    def lock_prefix(self, prompt: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of ``prompt``, made device-resident.

        Walks the tree block by block, restoring spilled pages along the
        matched path (path pages are protected from being spill victims of
        each other's restores).  Residency is best-effort: if a restore
        cannot get a device page even after spilling, the match simply
        stops before that node — a shorter prefix is still a valid prefix.
        The returned pages are NOT ref'd for the caller; passing them to
        ``KVPool.reserve(shared_pages=..., boundary_page=...)`` takes the
        references atomically with admission.
        """
        self.lookups += 1
        m = PrefixMatch()
        cap = len(prompt) - 1
        if cap <= 0:
            return m
        ps = self.pool.page_size
        node = self.root
        protect: Set[int] = set()
        consumed = 0
        while consumed < cap:
            want = tuple(prompt[consumed: consumed + ps])
            best, best_cp = None, 0
            for child in node.children:
                cp = _common_prefix(child.tokens, want)
                if cp > best_cp:
                    best, best_cp = child, cp
            if best is None or best_cp == 0:
                break
            if not self._ensure_resident(best, protect):
                break
            self._bump(best)
            protect.add(best.page)
            take = min(best_cp, cap - consumed)
            if take == ps and len(best.tokens) == ps:
                m.full_pages.append(best.page)
                consumed += ps
                node = best
                continue
            # partial coverage — either a mid-block divergence, a cached
            # partial tail, or the len-1 cap: the boundary page, COWed by
            # the admission so the shared original stays immutable
            m.boundary_page = best.page
            consumed += take
            break
        m.matched_tokens = consumed
        if consumed > 0:
            self.hits += 1
            self.tokens_reused += consumed
        return m

    # -- insertion -----------------------------------------------------
    def insert(self, prompt: Sequence[int], pages: Sequence[int]) -> int:
        """Cache a completed prompt's KV pages; returns new nodes created.

        ``pages`` must cover exactly ``ceil(len(prompt)/page_size)`` table
        pages of the sequence that just finished prefill.  Existing nodes
        are reused (no incref of the caller's duplicate page); a cached
        partial block that this prompt extends is upgraded in place to the
        caller's fuller page.  Divergent blocks become siblings — the tree
        is a trie over page blocks with longest-common-prefix matching, so
        no node splitting is required.
        """
        ps = self.pool.page_size
        blocks = [
            tuple(prompt[i: i + ps]) for i in range(0, len(prompt), ps)
        ]
        if len(pages) != len(blocks):
            raise ValueError(
                f"{len(pages)} pages for {len(blocks)} prompt blocks"
            )
        node = self.root
        created = 0
        for block, page in zip(blocks, pages):
            found = None
            for child in node.children:
                cp = _common_prefix(child.tokens, block)
                if cp == len(child.tokens) == len(block):
                    # exact block already cached; if it sits spilled, adopt
                    # the caller's freshly written resident page instead of
                    # paying a restore on the next match
                    if child.spilled:
                        self.pool.incref(page)
                        self.pool.drop_spilled(child.host_slot)
                        child.host_slot = None
                        child.page = page
                    found = child
                    break
                if cp == len(child.tokens) and cp < len(block):
                    # cached partial tail is a strict prefix of our fuller
                    # block: upgrade the node to the fuller page
                    self.pool.incref(page)
                    if child.resident:
                        self.pool.decref(child.page)
                    elif child.spilled:
                        self.pool.drop_spilled(child.host_slot)
                        child.host_slot = None
                    child.page = page
                    child.tokens = block
                    found = child
                    break
                if cp == len(block) and cp < len(child.tokens):
                    # a fuller version of our (partial, final) block is
                    # already cached — ours adds nothing
                    found = child
                    break
            if found is None:
                found = _Node(tokens=block, page=page, parent=node)
                self.pool.incref(page)
                node.children.append(found)
                self.inserted_nodes += 1
                created += 1
            self._bump(found)
            node = found
        return created

    # -- eviction / spill ----------------------------------------------
    def _evictable(self, protect: Set[int]) -> List[_Node]:
        """Resident nodes held only by this cache, LRU-first."""
        cands = [
            n for n in self._iter_nodes()
            if n.resident and n.page not in protect
            and self.pool.refcount(n.page) == 1
        ]
        cands.sort(key=lambda n: n.last_access)
        return cands

    def release_pages(
        self, n: int, *, protect: FrozenSet[int] = frozenset()
    ) -> int:
        """Free at least ``n`` device pages from the cache, LRU-first.

        Spills when the host arena has room (interior nodes may spill —
        the match path restores them); otherwise drops leaves (dropping an
        interior node would orphan its subtree).  Pages in ``protect`` and
        pages any sequence still references are never victims.  Returns
        the number of device pages actually freed; the caller retries its
        reservation and treats a short count as a genuine refusal.
        """
        protect = set(protect)
        freed = 0
        while freed < n:
            cands = self._evictable(protect)
            if not cands:
                break
            if self.pool.spill_enabled and self.pool.host_capacity > self.pool.spilled_pages:
                victim = cands[0]
                victim.host_slot = self.pool.spill_page(victim.page)
                victim.page = None
            else:
                leaves = [c for c in cands if not c.children]
                if not leaves:
                    break
                self._drop(leaves[0])
            freed += 1
        return freed

    def flush(self) -> int:
        """Drop every cached node (device refs and host slots released)."""
        dropped = 0
        # post-order: children before parents so _drop always sees leaves
        def _post(node: _Node) -> None:
            nonlocal dropped
            for child in list(node.children):
                _post(child)
            if node is not self.root:
                self._drop(node)
                dropped += 1
        _post(self.root)
        return dropped

    # -- introspection -------------------------------------------------
    def check_invariants(self) -> None:
        """Structural health assertions (test/debug hook)."""
        seen_pages: Set[int] = set()
        seen_slots: Set[int] = set()
        for n in self._iter_nodes():
            assert n.tokens, "node with empty token block"
            assert len(n.tokens) <= self.pool.page_size
            assert n.resident != n.spilled, (
                "node must be exactly one of resident/spilled"
            )
            if n.resident:
                assert self.pool.refcount(n.page) >= 1
                assert n.page not in seen_pages, "page cached twice"
                seen_pages.add(n.page)
            else:
                assert n.host_slot not in seen_slots, "host slot aliased"
                seen_slots.add(n.host_slot)
        assert len(seen_slots) <= self.pool.host_capacity

    def stats(self) -> dict:
        nodes = list(self._iter_nodes())
        resident = [n for n in nodes if n.resident]
        return {
            "nodes": len(nodes),
            "cached_tokens": sum(len(n.tokens) for n in nodes),
            "resident_pages": len(resident),
            "spilled_nodes": len(nodes) - len(resident),
            "evictable_pages": len(self._evictable(set())),
            "lookups": self.lookups,
            "hits": self.hits,
            "tokens_reused": self.tokens_reused,
            "inserted_nodes": self.inserted_nodes,
            "dropped_nodes": self.dropped_nodes,
        }

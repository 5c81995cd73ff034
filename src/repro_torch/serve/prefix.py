"""Host-side page allocator + radix-tree prefix cache for paged serving.

The device keeps one page pool per cache leaf (see
``repro_torch/models/cache_utils.py``); everything that DECIDES which page
holds what lives here, in plain Python and numpy, where it is cheap and
unit-testable. It is the JAX package's ``serve/prefix.py``, kept as the
port's own copy (the port imports nothing of that package):

* :class:`PagePool` — refcounted physical pages. Page 0 is the reserved
  TRASH page (never allocated): freed slots zero their block-table rows so
  stale device writes/reads land there harmlessly.
* :class:`RadixPrefixCache` — a radix tree over token-id prefixes at page
  granularity. A node's path from the root spells out a prompt prefix in
  whole pages; the node holds the ONE physical page id whose K/V encodes
  that page's tokens *given that prefix* (a page id is valid across every
  layer's pool — all layers allocate in lockstep). Admission walks the
  tree, bumps refcounts on matched pages, and the engine starts the
  suffix prefill at the matched length instead of position 0.

Ownership contract: a page's refcount = (#slots whose block table maps it)
+ (1 if a tree node holds it). Shared pages are provably never written —
slot writes happen at rows >= pos >= matched length, and a partially
matched page is copy-on-write cloned (``copy_page`` callback, device copy)
before the divergent stream touches it. Eviction removes least-recently
used refcount-1 leaves (tree-only pages) once the pool crosses the
pressure watermark, iteratively exposing parents.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class PagePool:
    """Refcounted allocator over ``num_pages`` physical pages.

    Page 0 is the trash page: pinned at construction, never handed out.
    ``alloc`` returns a page with refcount 1; ``ref``/``release`` adjust
    ownership; a page returns to the free list when its count hits 0.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.refcount = np.zeros(num_pages, np.int64)
        self.refcount[0] = 1                       # trash page, pinned forever
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                "page pool exhausted -- raise ServeConfig.num_pages or lower "
                "the eviction watermark")
        pg = self._free.pop()
        assert self.refcount[pg] == 0
        self.refcount[pg] = 1
        return pg

    def ref(self, pg: int) -> None:
        assert 0 < pg < self.num_pages and self.refcount[pg] > 0
        self.refcount[pg] += 1

    def release(self, pg: int) -> None:
        assert 0 < pg < self.num_pages and self.refcount[pg] > 0
        self.refcount[pg] -= 1
        if self.refcount[pg] == 0:
            self._free.append(pg)


@dataclasses.dataclass
class _Node:
    key: Tuple[int, ...]                 # this node's page_size token ids
    page: int                            # physical page holding their K/V
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(default_factory=dict)
    last_use: int = 0


@dataclasses.dataclass
class PrefixMatch:
    pages: List[int]        # physical pages backing the matched prefix
    matched: int            # tokens resolved (n_full_pages*ps [+ COW tail])
    hit_full: int           # tokens served straight from tree pages
    cow: bool               # last page is a fresh private copy


class RadixPrefixCache:
    """Page-granular radix tree over token-id prefixes.

    ``copy_page(src) -> Optional[int]`` is the engine-supplied COW hook: it
    allocates a fresh page (evicting under pressure if it must), device-
    copies ``src`` into it, and returns the new id — or ``None`` when the
    pool genuinely cannot produce a page, in which case the partial-page
    match is simply skipped (correct, just colder).
    """

    def __init__(self, pool: PagePool, page_size: int,
                 copy_page: Optional[Callable[[int], Optional[int]]] = None):
        self.pool = pool
        self.page_size = page_size
        self.copy_page = copy_page
        self.root = _Node(key=(), page=-1, parent=None)
        self._tick = 0
        self.evictions = 0

    # ------------------------------------------------------------------ walk
    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_use = self._tick

    def match(self, prompt: Sequence[int]) -> PrefixMatch:
        """Resolve the longest cached prefix of ``prompt``.

        Matched pages get a refcount bump (the caller now owns them via its
        block table). The match is capped at ``len(prompt) - 1`` so at
        least one prompt token is always computed — the logits that seed
        generation must come from a real forward pass.
        """
        ps = self.page_size
        toks = [int(t) for t in prompt]
        limit = len(toks) - 1
        pages: List[int] = []
        node = self.root
        i = 0
        while (i + 1) * ps <= limit:
            key = tuple(toks[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                break
            self.pool.ref(child.page)
            pages.append(child.page)
            self._touch(child)
            node = child
            i += 1
        matched = i * ps
        hit_full = matched
        cow = False
        # partial-page tail: if some child shares a strict prefix of the
        # next page chunk, clone it (COW) and resume mid-page.
        if self.copy_page is not None:
            tail = toks[i * ps:limit]
            best, best_r = None, 0
            for key, child in node.children.items():
                r = 0
                for a, b in zip(key, tail):
                    if a != b:
                        break
                    r += 1
                if r > best_r:
                    best, best_r = child, r
            if best is not None and best_r > 0:
                dst = self.copy_page(best.page)
                if dst is not None:
                    self._touch(best)
                    pages.append(dst)
                    matched += best_r
                    hit_full += best_r
                    cow = True
        return PrefixMatch(pages=pages, matched=matched, hit_full=hit_full,
                           cow=cow)

    def insert(self, prompt: Sequence[int], slot_pages: Sequence[int]) -> int:
        """Publish a freshly prefilled prompt's full pages into the tree.

        ``slot_pages`` is the slot's block list; page ``i`` holds tokens
        ``[i*ps, (i+1)*ps)``. Already-published pages are just touched; new
        nodes take a tree ref on the slot's page (which the slot keeps
        using — shared from this moment on, and past its write frontier so
        never written again). Returns the number of nodes added.
        """
        ps = self.page_size
        toks = [int(t) for t in prompt]
        n_full = min(len(toks) // ps, len(slot_pages))
        node = self.root
        added = 0
        for i in range(n_full):
            key = tuple(toks[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                pg = int(slot_pages[i])
                if pg <= 0:                      # unbacked block: stop here
                    break
                self.pool.ref(pg)
                child = _Node(key=key, page=pg, parent=node)
                node.children[key] = child
                added += 1
            self._touch(child)
            node = child
        return added

    # -------------------------------------------------------------- eviction
    def _evictable_leaves(self) -> List[_Node]:
        out: List[_Node] = []

        def walk(n: _Node):
            for c in n.children.values():
                walk(c)
            if n is not self.root and not n.children \
                    and self.pool.refcount[n.page] == 1:
                out.append(n)

        walk(self.root)
        return out

    def evict(self, n_pages: int) -> int:
        """Drop up to ``n_pages`` least-recently-used tree-only pages.

        Only refcount-1 leaves are candidates (pages a slot still maps are
        pinned; interior nodes become leaves as their children go). Returns
        the number of pages actually freed.
        """
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_use)
            self.pool.release(victim.page)
            del victim.parent.children[victim.key]
            self.evictions += 1
            freed += 1
        return freed

    def maybe_evict(self, watermark_pages: int) -> int:
        """Enforce the pool-pressure watermark: evict LRU tree pages until
        ``pages_in_use <= watermark_pages`` (or nothing is evictable)."""
        over = self.pool.pages_in_use - watermark_pages
        return self.evict(over) if over > 0 else 0

"""Host-side KV-page allocator + shared-prefix radix index -- the port's
copy of ``triton_kubernetes_tpu/serve/blocks.py``, with its own
``TRASH_PAGE`` (the port imports nothing of the JAX package).

Pure bookkeeping — the device arrays never change shape; this hands out
*indices* into them. Deterministic by construction (lowest-index-first),
so a seeded engine run allocates identically every time, which is what
lets the churn tests assert bitwise-identical schedules the way the
cloudsim tests do.

Page 0 (``TRASH_PAGE``) is never allocatable: it is
the shared scatter/gather sink for padded block-table entries and
inactive batch slots.

Pages are **refcounted**: a page may be mapped by several
sequences at once (shared-prefix KV reuse) plus the radix index itself,
and only returns to the free pool when the last reference drops.
Copy-on-write is unnecessary by design — shared pages are *immutable*
full prompt pages (every write the engine issues lands at a sequence's
own tail position, which is always in a page it exclusively owns), so
sharing is purely a matter of reference counting.

:class:`PrefixCache` is the radix/trie index over token-id prefixes that
makes the sharing findable: one node per **full, block-aligned page** of
prompt tokens, keyed by that page's exact token tuple. A system prompt
shared by thousands of users is prefilled once, indexed once, and every
later request maps the same physical pages — O(users) prefill becomes
O(1) (docs/guide/serving.md §Prefix caching).
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Physical page every allocator reserves (ops.paged_attention.TRASH_PAGE).
TRASH_PAGE = 0


class OutOfBlocksError(RuntimeError):
    """The pool cannot satisfy an allocation — the scheduler's signal to
    stop admitting (or start preempting/evicting), never a crash."""


class BlockAllocator:
    """Fixed pool of ``num_blocks - 1`` allocatable pages (page 0 reserved),
    with per-page reference counts.

    ``alloc`` returns the lowest-numbered free pages at refcount 1;
    ``incref`` adds holders (prefix sharing); ``free`` drops one
    reference per page and returns the page to the pool only when its
    count reaches zero. Double-frees (freeing a page with no references)
    and freeing the trash page still raise — leaked or double-freed
    pages are scheduler bugs the churn tests pin via :attr:`in_use`
    returning to zero.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (page {TRASH_PAGE} is reserved), "
                f"got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(1, num_blocks))
        heapq.heapify(self._free)
        self._refs: Dict[int, int] = {}

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Pages with at least one reference (each counted once, however
        many sequences share it)."""
        return len(self._refs)

    def refcount(self, block: int) -> int:
        """Current reference count of ``block`` (0 when free)."""
        return self._refs.get(block, 0)

    def alloc(self, n: int) -> List[int]:
        """The ``n`` lowest free page ids at refcount 1; all-or-nothing."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise OutOfBlocksError(
                f"need {n} blocks, {len(self._free)} free "
                f"(capacity {self.capacity})")
        out = [heapq.heappop(self._free) for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, blocks: Iterable[int]) -> None:
        """Add one reference per page — the shared-prefix mapping path.
        Only allocated pages can gain holders (a free page has no
        contents worth sharing)."""
        blocks = list(blocks)
        for b in blocks:
            if b not in self._refs:
                raise ValueError(
                    f"block {b} is not allocated (cannot share a free "
                    f"page)")
        for b in blocks:
            self._refs[b] += 1

    def free(self, blocks: Iterable[int]) -> None:
        """Drop ONE reference per page; pages reaching zero return to
        the pool."""
        for b in blocks:
            if b == TRASH_PAGE:
                raise ValueError("cannot free the reserved trash page")
            if b not in self._refs:
                raise ValueError(f"block {b} is not allocated (double free?)")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                heapq.heappush(self._free, b)


class _RadixNode:
    """One full page of prompt tokens: trie edge key is the page's exact
    token tuple; ``page`` is the physical page holding its K/V."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_RadixNode"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.last_used = 0


class PrefixCache:
    """Radix index: full-page-aligned token prefixes -> immutable KV pages.

    The cache itself holds ONE reference on every indexed page (via the
    shared :class:`BlockAllocator`), so indexed pages survive their
    writer finishing — that is the whole point: the next request with
    the same system prompt maps them instead of re-prefilling.

    * :meth:`lookup` returns the pages of the longest fully-matching
      page-aligned prefix (and marks the path recently used);
    * :meth:`insert` indexes a completed prefill's full prompt pages
      (already-indexed prefixes are skipped — first writer wins, a
      concurrent duplicate prefill simply fails to be indexed and its
      private pages die with its sequence);
    * :meth:`evict` frees least-recently-used **leaf** pages that no
      sequence currently maps (refcount 1 = the cache's own), cascading
      up the trie — the engine calls it under pool pressure before it
      resorts to preempting running sequences.

    Determinism: ``last_used`` advances on a logical counter bumped per
    lookup/insert, never wall clock, so eviction order is a pure
    function of the request history (the churn-parity contract).
    """

    def __init__(self, allocator: BlockAllocator, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.allocator = allocator
        self.block_size = block_size
        self._root = _RadixNode((), TRASH_PAGE, None)
        self._clock = 0
        self._pages = 0

    @property
    def pages(self) -> int:
        """Pages currently indexed (the tk8s_serve_prefix_cache_pages
        gauge's source)."""
        return self._pages

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        return [tuple(tokens[i * bs:(i + 1) * bs])
                for i in range(len(tokens) // bs)]

    def lookup(self, tokens: Sequence[int]) -> List[int]:
        """Pages of the longest indexed full-page prefix of ``tokens``
        (possibly empty). Marks every matched node recently-used. The
        caller owns nothing yet — it must ``incref`` the pages it
        actually maps before any eviction can run."""
        now = self._tick()
        node = self._root
        out: List[int] = []
        for key in self._chunks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = now
            out.append(child.page)
            node = child
        return out

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Index the full pages of ``tokens`` (``len(tokens) //
        block_size`` of them) as ``pages[:n_full]``; returns how many
        pages were NEWLY indexed (each gains one cache-owned reference).

        Where a node already exists for a page key, the existing page
        wins and descent continues through it — the caller's duplicate
        page stays private to its sequence and is never indexed.
        """
        now = self._tick()
        node = self._root
        added = 0
        for i, key in enumerate(self._chunks(tokens)):
            child = node.children.get(key)
            if child is None:
                page = pages[i]
                self.allocator.incref([page])
                child = _RadixNode(key, page, node)
                node.children[key] = child
                self._pages += 1
                added += 1
            child.last_used = now
            node = child
        return added

    def _walk(self) -> List[_RadixNode]:
        """Every node except the root, parents before their children —
        the ONE traversal evictable()/evict()/clear()/indexed_pages()
        all build on (they must agree: the admission path's
        evict-only-when-it-closes-the-gap guard is sound only if
        evictable() predicts exactly what evict() can reclaim).
        Iterate reversed() for children-before-parents."""
        post: List[_RadixNode] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self._root:
                post.append(node)
        return post

    def evictable(self) -> int:
        """Pages :meth:`evict` could reclaim RIGHT NOW: nodes whose
        whole subtree (themselves included) is unmapped by sequences
        (refcount 1 throughout) — a refcount-1 node above a shared
        descendant is pinned until that descendant's holders finish.
        The admission path checks this BEFORE evicting, so pool
        pressure that eviction cannot relieve never drains the hot
        cache for nothing."""
        free: Dict[int, bool] = {}
        count = 0
        for node in reversed(self._walk()):
            ok = (self.allocator.refcount(node.page) == 1
                  and all(free[id(c)] for c in node.children.values()))
            free[id(node)] = ok
            if ok:
                count += 1
        return count

    def evict(self, n: int) -> int:
        """Free up to ``n`` indexed pages no sequence maps (refcount 1),
        least-recently-used leaves first, cascading to parents as they
        become leaves. Returns pages actually freed.

        One victim per scan, not a batch: a lookup that matched only a
        proper prefix of a path leaves a parent NEWER than unrelated
        leaves, so a parent exposed mid-eviction may legitimately be
        colder than leaves already collected — true LRU has to re-look
        after every removal.
        """
        freed = 0
        while freed < n:
            leaves = [node for node in self._walk()
                      if not node.children
                      and self.allocator.refcount(node.page) == 1]
            if not leaves:
                break
            self._remove(min(leaves, key=lambda nd: nd.last_used))
            freed += 1
        return freed

    def _remove(self, node: _RadixNode) -> None:
        assert not node.children and node.parent is not None
        del node.parent.children[node.key]
        self._pages -= 1
        self.allocator.free([node.page])

    def clear(self) -> int:
        """Drop every cache-owned reference (leaves upward); pages still
        mapped by live sequences stay allocated until those sequences
        finish. Returns pages released by the cache."""
        released = 0
        for node in reversed(self._walk()):
            self._remove(node)
            released += 1
        return released

    def indexed_pages(self) -> List[int]:
        """Every physical page the trie currently references (test/
        invariant helper: must agree with allocator refcounts)."""
        return [node.page for node in self._walk()]

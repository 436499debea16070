"""Radix-tree prefix KV cache: cross-request page sharing for the paged
serving stack (counterpart of the reference's
``inference/prefix_cache.py``, which imports no JAX; the port keeps its
own copy).

The paged attention kernels accept any page table, so two requests
whose prompts share a prefix can point their page tables at the SAME
physical pages; only the host-side pool and scheduler need to know.
The design follows RadixAttention (SGLang) on a page-granular pool:

* the tree is a radix tree over token ids; each node's edge carries a
  token span and owns references (``PagedKVCacheManager.incref``) on the
  pages overlapping that span, one chain per model layer;
* a node split at a mid-page token boundary leaves the boundary page
  referenced by BOTH halves; reference counting makes that exact;
* a matched request ATTACHES the chain (pages shared, prefill starts at
  the first uncached token); its first write into the partial last page
  forks it copy-on-write inside the pool, so cached bytes never change;
* on retire the scheduler INSERTS the sequence's cached tokens: the new
  suffix nodes incref the retiring sequence's pages, which then survive
  the sequence's ``free``;
* eviction is LRU by leaf: unpinned leaves release their page
  references until enough pages return to the pool. Pinning
  (``pin``/``unpin`` on a match path) protects chains between match and
  attach, and admission holds it while a request is active.

Everything here is host-side bookkeeping; the device sees only which
page ids end up in the kernels' page tables. The reference's telemetry
counters are not ported, and the page sanitizer's per-node generations
(``gens``) stay None: the port has no sanitizer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["RadixPrefixCache", "PrefixMatch"]


def _ceil_div(a, b):
    return -(-a // b)


class _Node:
    """One radix-tree edge+node: ``key`` is the token span entering this
    node, ``start`` its absolute token offset from the root, and
    ``pages[l]`` the physical pages of layer ``l`` overlapping [start,
    start + len(key))."""

    __slots__ = ("key", "start", "children", "parent", "pages",
                 "gens", "last_use", "pin")

    def __init__(self, key, start, pages, parent):
        self.key: List[int] = key
        self.start: int = start
        self.children: Dict[int, "_Node"] = {}
        self.parent: Optional["_Node"] = parent
        self.pages: List[List[int]] = pages  # per layer
        self.gens = None  # page generations: sanitizer runs only
        self.last_use: int = 0
        self.pin: int = 0

    @property
    def end(self) -> int:
        return self.start + len(self.key)


@dataclass
class PrefixMatch:
    """Result of matching a prompt against the tree.

    ``length``: matched tokens; ``chains[l]``: the physical pages of
    layer ``l`` covering tokens [0, length), ready for
    ``PagedKVCacheManager.attach``; ``path``: the tree nodes walked (pin
    these while the request is active)."""

    length: int = 0
    chains: List[List[int]] = field(default_factory=list)
    path: Tuple["_Node", ...] = ()


class RadixPrefixCache:
    """Radix tree over token-id sequences whose nodes own KV pages.

    ``caches`` is the per-layer list of PagedKVCacheManager a model
    serves from (every layer must use the same page size, so chains stay
    index-aligned across layers)."""

    def __init__(self, caches: Sequence):
        caches = list(caches)
        if not caches:
            raise ValueError("prefix cache needs at least one cache")
        sizes = {c.page_size for c in caches}
        if len(sizes) != 1:
            raise ValueError(
                f"per-layer page sizes differ ({sorted(sizes)}); "
                "prefix chains cannot stay aligned")
        self.caches = caches
        self.page_size = caches[0].page_size
        self.root = _Node(key=[], start=0,
                          pages=[[] for _ in caches], parent=None)
        self._clock = 0  # monotonic LRU stamp (no wall clock)
        # bumped on every structural change (insert / evict): a caller
        # learns that a previous PrefixMatch may be stale or beatable
        self.mutations = 0
        self.stats = {
            "hits": 0, "misses": 0,
            "hit_tokens": 0, "lookup_tokens": 0,
            "inserted_tokens": 0, "inserted_nodes": 0,
            "evicted_nodes": 0, "evicted_pages": 0,
        }

    # -- helpers -----------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _node_page_span(self, start, end):
        """Page indices [lo, hi) overlapping token span [start, end)."""
        return start // self.page_size, _ceil_div(end, self.page_size)

    def _overlay(self, chains, node, upto):
        """Merge ``node``'s pages covering tokens [node.start, upto) into
        the root-anchored ``chains``. A boundary page shared with the
        parent is OVERRIDDEN by the child's copy: past a mid-page split
        only the child's page carries this path's tokens."""
        lo, hi = self._node_page_span(node.start, upto)
        for li, chain in enumerate(chains):
            for pi in range(lo, hi):
                pg = node.pages[li][pi - lo]
                if pi < len(chain):
                    chain[pi] = pg
                else:
                    chain.append(pg)

    @staticmethod
    def _common_len(a, b) -> int:
        n = min(len(a), len(b))
        i = 0
        while i < n and a[i] == b[i]:
            i += 1
        return i

    # -- lookup ------------------------------------------------------------
    def match(self, tokens: Sequence[int],
              limit: Optional[int] = None,
              align: int = 1) -> PrefixMatch:
        """Longest cached prefix of ``tokens`` (capped at ``limit``).
        Touches the walked nodes for LRU. The returned chains are valid
        until an eviction: pin the path before any operation that could
        evict.

        ``align`` > 1 rounds the match DOWN to a multiple of that many
        tokens: with ``align=page_size`` a hit covers only FULL pages,
        so a chunked-prefill resume starts at a page boundary and never
        pays the shared-tail copy-on-write fork, trading at most
        align-1 cached tokens for one fewer worst-case page draw at
        admission. The trimmed chains still cover exactly
        ceil(length/page_size) pages; the walked path keeps its tail
        node (pinning a little extra is harmless)."""
        tokens = list(tokens)
        n = len(tokens) if limit is None else min(limit, len(tokens))
        stamp = self._tick()
        chains = [[] for _ in self.caches]
        path = []
        node = self.root
        matched = 0
        while matched < n:
            child = node.children.get(tokens[matched])
            if child is None:
                break
            j = self._common_len(child.key, tokens[matched:n])
            if j == 0:
                break
            self._overlay(chains, child, child.start + j)
            child.last_use = stamp
            path.append(child)
            matched += j
            if j < len(child.key):
                break
            node = child
        if align > 1 and matched % align:
            matched -= matched % align
            keep = _ceil_div(matched, self.page_size)
            chains = [chain[:keep] for chain in chains]
            if matched == 0:
                path = []
                chains = [[] for _ in self.caches]
        self.stats["lookup_tokens"] += len(tokens)
        if matched:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += matched
        else:
            self.stats["misses"] += 1
        return PrefixMatch(length=matched, chains=chains,
                           path=tuple(path))

    # -- pinning -----------------------------------------------------------
    def pin(self, path):
        """Protect every node on a match path from eviction (hold for
        the lifetime of the request that attached the chains)."""
        for node in path:
            node.pin += 1

    def unpin(self, path):
        for node in path:
            if node.pin <= 0:
                raise AssertionError("unpin of an unpinned node")
            node.pin -= 1

    # -- insert ------------------------------------------------------------
    def insert(self, tokens: Sequence[int],
               chains: Sequence[Sequence[int]]) -> int:
        """Record that ``tokens`` are cached on ``chains`` (one page list
        per layer, root-anchored: chains[l][i] is the physical page of
        token block i). Increfs only the pages backing the NEW suffix:
        callers free the source sequence afterwards and the tree's
        references keep the prefix alive. Returns the number of newly
        cached tokens."""
        tokens = list(tokens)
        n = len(tokens)
        if len(chains) != len(self.caches):
            raise ValueError(
                f"{len(chains)} chains for {len(self.caches)} layers")
        need = _ceil_div(n, self.page_size) if n else 0
        for li, chain in enumerate(chains):
            if len(chain) < need:
                raise ValueError(
                    f"layer {li}: chain of {len(chain)} pages cannot "
                    f"back {n} tokens")
        stamp = self._tick()
        node = self.root
        pos = 0
        while pos < n:
            child = node.children.get(tokens[pos])
            if child is None:
                self._add_leaf(node, tokens, pos, n, chains, stamp)
                return n - pos
            j = self._common_len(child.key, tokens[pos:])
            child.last_use = stamp
            if j == len(child.key):
                node = child
                pos += j
                continue
            if pos + j == n:
                return 0  # fully contained in child's span: no split
            # diverges inside child's span: split at j, branch off
            child = self._split(child, j)
            child.last_use = stamp
            pos += j
            self._add_leaf(child, tokens, pos, n, chains, stamp)
            return n - pos
        return 0  # fully cached already

    def _add_leaf(self, parent, tokens, pos, n, chains, stamp):
        lo, hi = self._node_page_span(pos, n)
        pages = [list(chain[lo:hi]) for chain in chains]
        for cache, chain in zip(self.caches, pages):
            cache.incref(chain)
        leaf = _Node(key=tokens[pos:n], start=pos, pages=pages,
                     parent=parent)
        leaf.last_use = stamp
        parent.children[tokens[pos]] = leaf
        self.mutations += 1
        self.stats["inserted_tokens"] += n - pos
        self.stats["inserted_nodes"] += 1

    def _split(self, node, j):
        """Split ``node`` after j key tokens; returns the new upper node.
        The page overlapping the split point (mid-page split) ends up
        referenced by BOTH halves: it gains a reference."""
        assert 0 < j < len(node.key)
        cut = node.start + j
        lo, hi = self._node_page_span(node.start, node.end)
        up_lo, up_hi = self._node_page_span(node.start, cut)
        low_lo, low_hi = self._node_page_span(cut, node.end)
        upper_pages = [p[up_lo - lo:up_hi - lo] for p in node.pages]
        lower_pages = [p[low_lo - lo:low_hi - lo] for p in node.pages]
        if up_hi > low_lo:  # mid-page split: boundary page shared
            for cache, p in zip(self.caches, node.pages):
                cache.incref([p[low_lo - lo]])
        upper = _Node(key=node.key[:j], start=node.start,
                      pages=upper_pages, parent=node.parent)
        upper.last_use = node.last_use
        # pins stay on the LOWER half (the object match paths hold):
        # eviction is leaf-only, so the pinned child protects the new
        # upper node transitively, and unpin stays balanced
        node.parent.children[node.key[0]] = upper
        node.key = node.key[j:]
        node.start = cut
        node.pages = lower_pages
        node.parent = upper
        upper.children[node.key[0]] = node
        return upper

    # -- eviction ----------------------------------------------------------
    def _leaves(self):
        out = []
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out

    def evict(self, num_pages: int) -> int:
        """Release unpinned cached chains, LRU leaf first, until at least
        ``num_pages`` pages returned to the pools (summed across layers)
        or nothing evictable remains. Returns pages actually freed.
        Pinned leaves, and ancestors of pinned nodes (which still have
        children), are never reclaimed."""
        freed = 0
        candidates = [lf for lf in self._leaves() if lf.pin == 0]
        candidates.sort(key=lambda node: node.last_use)
        while candidates and freed < num_pages:
            leaf = candidates.pop(0)
            freed += self._drop_leaf(leaf)
            parent = leaf.parent
            if (parent is not None and parent is not self.root
                    and not parent.children and parent.pin == 0):
                # the parent became an evictable leaf: keep LRU order
                lu = parent.last_use
                i = 0
                while (i < len(candidates)
                       and candidates[i].last_use <= lu):
                    i += 1
                candidates.insert(i, parent)
        return freed

    def _drop_leaf(self, leaf):
        freed = 0
        for cache, pages in zip(self.caches, leaf.pages):
            freed += cache.decref(pages)
        del leaf.parent.children[leaf.key[0]]
        self.mutations += 1
        self.stats["evicted_nodes"] += 1
        self.stats["evicted_pages"] += freed
        return freed

    def clear(self) -> int:
        """Drop every unpinned cached chain (full flush)."""
        return self.evict(1 << 62)

    # -- introspection -----------------------------------------------------
    def iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    @property
    def num_nodes(self) -> int:
        return sum(1 for _ in self.iter_nodes())

    @property
    def cached_tokens(self) -> int:
        """Tokens reachable in the tree (sum of edge lengths)."""
        return sum(len(n.key) for n in self.iter_nodes())

    @property
    def cached_pages(self) -> int:
        """Tree-held page references, summed across layers (a page on a
        split boundary counts once per referencing node)."""
        return sum(len(p) for n in self.iter_nodes() for p in n.pages)

    def summary(self) -> dict:
        s = dict(self.stats)
        s["nodes"] = self.num_nodes
        s["cached_tokens"] = self.cached_tokens
        s["cached_pages"] = self.cached_pages
        return s

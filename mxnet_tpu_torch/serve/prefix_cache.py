"""Radix prefix cache over the paged KV pool (counterpart of
``mxnet_tpu/serve/prefix_cache.py``; host-only, so the port keeps its own
copy).

``PrefixCache`` is a trie over token-id sequences, one edge per
*full* KV page (``page_size`` tokens), mapping every cached prefix to
the pages that already hold its keys/values in a
:class:`~mxnet_tpu_torch.serve.kv_blocks.PagedKVPool`. Serving consults it at
admission: a hit hands the new request the matched pages via
``pool.assign_with_prefix()`` — refcounts bump, nothing is copied — and
the request's prefill starts *past* the matched tokens. A miss
costs one dict probe per page.

Sharing rules (the copy-on-extend contract):

* Only **full** pages are ever shared, and never the page holding a
  request's final prompt token: ``match()`` caps at
  ``(len(prompt) - 1) // page_size`` pages so at least one prompt token
  is always prefilled. That keeps "sample the last prompt position's
  logits" unchanged and guarantees the request's first write position is
  at/after the shared boundary — shared pages are read-only by
  construction (``paged_kv_scatter`` writes only ``start_pos + [0,
  t_len)``).
* The trie holds **one refcount per adopted page** (so a cached prefix
  survives its originating request's retirement); live slots hold their
  own references. ``release()``/eviction *decrement*; the device page
  recycles only when the last reference drops.
* Eviction is LRU over trie **leaves only** (an interior page is, by
  construction, more recently used than its deepest descendant), runs
  only under pool pressure (``reclaim()`` before surfacing
  ``PoolExhausted``), and never touches a page some slot still
  references (refcount > 1) or one in the caller's ``exclude`` set (the
  pages it just matched but has not yet assigned).

Token identity of cached decode: shared pages hold the K/V an earlier
prefill of the same tokens wrote, so a prefix hit attends over what a
cache-off prefill would have computed, up to the order of f32 sums (the
port's prefill at another ``start_pos`` and bucket runs other gemm
shapes); greedy output is held to the cache-off run's tokens by the
tests.

Lock order: ``PrefixCache._lock`` (outer) → ``PagedKVPool._lock``
(inner, via incref/decref/refcount). The pool never calls back into the
trie.
"""
import itertools
import threading

from ..base import MXNetError

__all__ = ["PrefixCache"]


class _Node:
    """One full page of cached prefix: ``key`` is its ``page_size``-token
    window, ``page`` the pool page holding those tokens' KV."""
    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key, page, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = {}
        self.last_used = 0


class PrefixCache:
    """Trie index from token-id prefixes to refcounted KV pages.

    Parameters
    ----------
    pool : PagedKVPool
        The pool whose pages are being indexed; the trie owns one
        reference per adopted page.
    name : str
        Label for stats/metrics.
    """

    def __init__(self, pool, name="prefix"):
        self.pool = pool
        self.page_size = pool.page_size
        self.name = name
        self._root = _Node(None, 0, None)
        self._lock = threading.Lock()
        self._clock = itertools.count(1)
        self._nodes = 0
        self.evictions = 0
        self.inserts = 0
        self.hits = 0
        self.misses = 0
        self.tokens_matched = 0

    # -- lookup --------------------------------------------------------------
    def match(self, tokens):
        """Longest cached prefix of ``tokens``.

        Returns ``(matched_tokens, pages)`` where ``matched_tokens`` is
        a multiple of ``page_size`` and ``pages`` the corresponding pool
        pages, front first. Caps at ``(len(tokens) - 1) // page_size``
        pages so the caller always prefills >= 1 token. The returned
        pages stay valid until the next ``reclaim()`` — callers that
        will assign them must pass them as ``exclude=`` to any reclaim
        in between.
        """
        ps = self.page_size
        max_pages = max(0, (len(tokens) - 1) // ps)
        pages = []
        with self._lock:
            node = self._root
            tick = next(self._clock)
            for i in range(max_pages):
                child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
                if child is None:
                    break
                child.last_used = tick
                pages.append(child.page)
                node = child
            matched = len(pages) * ps
            if pages:
                self.hits += 1
                self.tokens_matched += matched
            else:
                self.misses += 1
        return matched, pages

    # -- adoption ------------------------------------------------------------
    def insert(self, tokens, pages):
        """Adopt the full-page prefix of ``tokens`` into the trie.

        ``pages`` is the owning slot's page list (front first) — called
        at retirement, *before* ``pool.release(slot)``, while the slot's
        references still pin the pages. Each newly created node increfs
        its page; pages already cached under an identical token window
        keep the existing node's page (the duplicate copy just recycles
        with its slot). Returns the number of pages newly adopted.
        """
        ps = self.page_size
        n = min(len(tokens) // ps, len(pages))
        if n <= 0:
            return 0
        adopted = 0
        with self._lock:
            node = self._root
            tick = next(self._clock)
            for i in range(n):
                key = tuple(tokens[i * ps:(i + 1) * ps])
                child = node.children.get(key)
                if child is None:
                    page = int(pages[i])
                    self.pool.incref([page])
                    child = _Node(key, page, node)
                    node.children[key] = child
                    self._nodes += 1
                    adopted += 1
                child.last_used = tick
                node = child
            self.inserts += 1
        return adopted

    # -- eviction ------------------------------------------------------------
    def reclaim(self, need, exclude=()):
        """Evict LRU cached prefixes until ``need`` pages have recycled
        to the pool's free list, skipping pages a live slot still
        references (pool refcount > 1) and pages in ``exclude``.
        Returns the number of pages actually freed (may be < ``need``
        when everything left is pinned)."""
        exclude = {int(p) for p in exclude}
        freed = 0
        with self._lock:
            while freed < need:
                victims = [c for c in self._iter_leaves()
                           if c.page not in exclude
                           and self.pool.refcount(c.page) == 1]
                if not victims:
                    break
                victims.sort(key=lambda c: c.last_used)
                for c in victims:
                    if freed >= need:
                        break
                    freed += len(self.pool.decref([c.page]))
                    del c.parent.children[c.key]
                    self._nodes -= 1
                    self.evictions += 1
        return freed

    def clear(self):
        """Drop every cached prefix (tenancy eviction / shutdown): the
        trie's references release; pages pinned by live slots recycle
        when those slots retire."""
        with self._lock:
            pages = [c.page for c in self._iter_all()]
            self.pool.decref(pages)
            self.evictions += self._nodes
            self._root.children.clear()
            self._nodes = 0
        return len(pages)

    def _iter_all(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _iter_leaves(self):
        for node in self._iter_all():
            if not node.children:
                yield node

    # -- introspection -------------------------------------------------------
    @property
    def pages_held(self):
        """Pages the trie currently holds a reference on."""
        with self._lock:
            return self._nodes

    def stats(self):
        with self._lock:
            nodes = self._nodes
            hits, misses = self.hits, self.misses
        total = hits + misses
        return {"pages_held": nodes,
                "hits": hits,
                "misses": misses,
                "hit_rate": (hits / total) if total else 0.0,
                "tokens_matched": self.tokens_matched,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "pages_shared": self.pool.pages_shared}

    def __repr__(self):
        return (f"PrefixCache(name={self.name!r}, pages={self._nodes}, "
                f"evictions={self.evictions})")

"""Paged KV block allocator: one device-resident page pool per layer
(counterpart of ``mxnet_tpu/serve/kv_blocks.py``).

Instead of per-(batch-bucket) contiguous KV rings, every layer's K/V
storage is ONE pool of fixed-width pages — ``(P, KV, page, D)`` tensors,
plus ``(P, KV, page)`` f32 scale pools on the int8 rung — on the model's
device. A per-slot *page table* maps each slot's logical ring onto the
pages it owns; each step gathers the table into a contiguous ring, runs
the unchanged model cache path, and scatters the freshly written rows
back (``ops.nn.paged_kv_gather`` / ``paged_kv_scatter``, exact copies;
the scatter writes the pool in place, so a captured CUDA graph keeps
finding it where it was).

Page id 0 is the reserved **null page**: dead or idle slots point table
entries at it, their writes land there, and the scatter re-zeros it, so
one step shape serves every occupancy without masking inputs per slot.

The allocator itself is host-side and O(1): a LIFO free list of page
ids. ``assign()`` reserves a slot's whole token budget up front (prompt +
max_new rounded up to pages) so a request can never die mid-decode from
pool pressure — exhaustion surfaces once, at admission, as
:class:`~.engine.PoolExhausted` (503). ``release()`` recycles the pages
the moment a request retires.

Every allocated page carries a **reference count** so pages can be shared
across owners (``serve.prefix_cache``): ``assign_with_prefix()`` installs
already-written prefix pages at the front of a slot's table row and bumps
their refcounts instead of copying them, ``incref()`` lets the prefix
trie adopt a retiring request's prompt pages, and ``release()`` /
``decref()`` *decrement* — a page returns to the free list only when its
last reference drops. Sharing is copy-on-extend at page granularity:
``paged_kv_scatter`` only writes rows at ``start_pos + [0, t_len)``, and
a prefix-hit request's first write position starts past the shared
boundary, so shared pages are never written.

Page size defaults to the decode-attention kernel's natural block
(``ops.hopper.decode_attention.natural_block()`` = 32, its KV tile,
clamped to ``max_seq``), so a row's work stops at a whole page;
``MXNET_SERVE_KV_PAGE_SIZE`` / ``MXNET_SERVE_KV_PAGES`` override.
"""
from __future__ import annotations

import threading

import numpy as _onp
import torch

from .. import config
from ..base import MXNetError
from ..ops.hopper.decode_attention import natural_block
from .engine import PoolExhausted


def resolve_page_size(page_size, max_seq):
    """The pool's page width: an explicit argument wins, then
    ``MXNET_SERVE_KV_PAGE_SIZE``, then the decode kernel's natural block
    clamped to ``max_seq``. ``max_seq`` must divide into whole pages —
    the gathered ring must have exactly the contiguous ring's S extent,
    so the paged step runs the ring step's shapes."""
    ps = page_size
    if ps is None:
        ps = int(config.get("MXNET_SERVE_KV_PAGE_SIZE"))
    if ps <= 0:
        ps = min(natural_block(), int(max_seq))
    ps = int(ps)
    if int(max_seq) % ps:
        raise MXNetError(
            f"max_seq ({max_seq}) must be a multiple of the KV page size "
            f"({ps}); pick a page size that divides it "
            "(MXNET_SERVE_KV_PAGE_SIZE or the page_size argument)")
    return ps


class PagedKVPool:
    """Device page pools + host free-list allocator + per-slot page tables.

    Parameters
    ----------
    model : block with ``_blocks[i].attention`` KV geometry (same duck
        type :class:`~.generate.KVCache.alloc` reads).
    num_slots : fixed decode width — page-table rows (a Generator's
        batch bucket).
    max_seq : logical ring length per slot (page table width =
        ``max_seq // page_size``).
    page_size : page width in tokens; ``None`` resolves via
        :func:`resolve_page_size`.
    num_pages : pool capacity in pages **including** the reserved null
        page; ``None`` resolves ``MXNET_SERVE_KV_PAGES``, whose 0
        default auto-sizes to full capacity
        (``num_slots * pages_per_slot + 1`` — exhaustion impossible).
        Size it smaller to oversubscribe: admission then raises
        :class:`~.engine.PoolExhausted` until retirements recycle pages.
    quant : ``None`` (f32 pools) or ``"int8"`` (int8 ring pools + f32
        scale pools, written by quantize-on-write).
    device : where the pools live (default: the model's).
    """

    def __init__(self, model, num_slots, max_seq, page_size=None,
                 num_pages=None, quant=None, device=None):
        if device is None:
            device = next(model.parameters()).device
        self.device = torch.device(device)
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq)
        self.page_size = resolve_page_size(page_size, self.max_seq)
        self.pages_per_slot = self.max_seq // self.page_size
        if num_pages is None:
            num_pages = int(config.get("MXNET_SERVE_KV_PAGES"))
        if num_pages <= 0:
            num_pages = self.num_slots * self.pages_per_slot + 1
        self.num_pages = int(num_pages)
        if self.num_pages < 2:
            raise MXNetError(
                f"PagedKVPool needs >= 2 pages (1 null + 1 usable), got "
                f"{self.num_pages}")
        if quant not in (None, "int8"):
            raise MXNetError(f"unknown PagedKVPool quant {quant!r}")
        self.quant = quant
        # one (P, KV, page, D) k/v pool pair per layer; int8 adds the
        # (P, KV, page) f32 scale pools — interleaved in flat() exactly
        # like KVCache.flat() so _CacheForward's calling convention is
        # shared between ring and paged steps
        self._arrays = []

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        for blk in model._blocks:
            attn = blk.attention
            shape = (self.num_pages, attn._kv_heads, self.page_size,
                     attn._head_dim)
            if quant == "int8":
                self._arrays.extend((
                    zeros(shape, torch.int8), zeros(shape[:3], torch.float32),
                    zeros(shape, torch.int8), zeros(shape[:3], torch.float32)))
            else:
                self._arrays.extend((zeros(shape, torch.float32),
                                     zeros(shape, torch.float32)))
        # host allocator state: LIFO free list (hot pages recycle first),
        # per-slot owned pages, the canonical page-table matrix
        self._lock = threading.Lock()
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._owned = [[] for _ in range(self.num_slots)]
        self._refs = {}  # page id -> reference count (allocated pages)
        self._table = _onp.zeros((self.num_slots, self.pages_per_slot),
                                 _onp.int32)
        self._table_nd = None
        self.high_water = 0
        self.exhausted_count = 0

    # -- the serving step's calling convention -------------------------------
    def flat(self):
        """The pool tensors in the serving step's calling convention
        (interleaved per layer, like ``KVCache.flat()``)."""
        return list(self._arrays)

    def update_from_flat(self, arrays):
        """Rebind the pool state to the step's returned tensors (the same
        tensors, since the scatter writes in place; the count is
        checked)."""
        arrays = list(arrays)
        if len(arrays) != len(self._arrays):
            raise MXNetError(
                f"pool update: got {len(arrays)} arrays, expected "
                f"{len(self._arrays)}")
        self._arrays = arrays

    def table(self):
        """Copy of the canonical (num_slots, pages_per_slot) int32 page
        table. Rows of released slots are all-null (0)."""
        with self._lock:
            return self._table.copy()

    def table_nd(self):
        """The canonical page table as a cached int32 tensor on the pool's
        device — for callers whose table does not change between calls.
        Invalidated by assign/release."""
        with self._lock:
            if self._table_nd is None:
                self._table_nd = torch.as_tensor(self._table,
                                                 device=self.device)
            return self._table_nd

    # -- allocator -----------------------------------------------------------
    def pages_for(self, n_tokens):
        """Pages needed to hold ``n_tokens`` ring positions."""
        n = int(n_tokens)
        return max(1, -(-n // self.page_size))

    def slot_budget(self, slot):
        """Token positions ``slot``'s assigned pages can hold (pages
        owned x page_size); 0 for an unassigned slot. The multi-step
        super-step's scatter bracket writes a static-length block of
        ``N`` rows per slot starting at its current position — safe
        because (a) a lane's budget is reserved up front from prompt +
        max_new, and the device loop freezes the lane at its remaining
        budget, so every *advancing* write stays inside this bound; and
        (b) block rows past the lane's write extent scatter back the
        bytes the bracket gathered (a no-op), while positions past the
        table row's last page clip to the null page, which the scatter
        re-zeroes. No page-table view wider than the slot's own row is
        ever needed for an N-token write."""
        with self._lock:
            return len(self._owned[int(slot)]) * self.page_size

    def assign(self, slot, n_tokens):
        """Reserve ``pages_for(n_tokens)`` pages for ``slot`` and install
        them in its page-table row (remaining row entries stay null).
        Raises :class:`PoolExhausted` — atomically, nothing allocated —
        when the free list is short; raises :class:`MXNetError` on a
        slot that already owns pages (release it first).
        Returns the number of pages assigned."""
        return self.assign_with_prefix(slot, n_tokens, ())

    def assign_with_prefix(self, slot, n_tokens, prefix_pages):
        """Like :meth:`assign`, but the slot's table row *starts* with
        ``prefix_pages`` — already-written pages (a prefix-trie match)
        whose refcounts are bumped instead of allocating + rewriting
        them. Only ``pages_for(n_tokens) - len(prefix_pages)`` fresh
        pages come off the free list; exhaustion is still atomic
        (nothing increffed, nothing allocated). Shared pages are
        read-only for this slot by the copy-on-extend contract: its
        first write position is at/after the shared-token boundary, so
        every write lands in one of the slot-private pages."""
        slot = int(slot)
        need = self.pages_for(n_tokens)
        shared = [int(p) for p in prefix_pages]
        if n_tokens > self.max_seq:
            raise MXNetError(
                f"slot budget {n_tokens} exceeds max_seq {self.max_seq}")
        if shared and len(shared) >= need:
            raise MXNetError(
                f"prefix ({len(shared)} pages) must leave >= 1 private "
                f"page in a {need}-page budget (the divergent token "
                "needs somewhere to land)")
        fresh_need = need - len(shared)
        with self._lock:
            if self._owned[slot]:
                raise MXNetError(
                    f"slot {slot} already owns {len(self._owned[slot])} "
                    "pages; release() before re-assigning")
            if any(self._refs.get(p, 0) < 1 for p in shared):
                raise MXNetError(
                    f"prefix pages {shared} are not all live (evicted "
                    "between match and assign?)")
            if fresh_need > len(self._free):
                self.exhausted_count += 1
                err = PoolExhausted(
                    f"KV page pool exhausted: need {fresh_need} pages, "
                    f"{len(self._free)} free of {self.num_pages - 1}")
                # backpressure hint: pages free as requests retire; one
                # slot's worth of decode is the natural retry horizon
                err.retry_after_ms = 50.0
                raise err
            fresh = [self._free.pop() for _ in range(fresh_need)]
            for p in shared:
                self._refs[p] += 1
            for p in fresh:
                self._refs[p] = 1
            pages = shared + fresh
            self._owned[slot] = pages
            self._table[slot] = 0
            self._table[slot, :need] = pages
            self._table_nd = None
            used = self.pages_used
            if used > self.high_water:
                self.high_water = used
            return need

    def release(self, slot):
        """Drop ``slot``'s reference on every page it holds and null its
        table row; pages whose refcount reaches zero recycle to the free
        list (pages the prefix trie still references survive).
        Idempotent (releasing an empty slot is a no-op). The pages'
        device contents are left stale on purpose: the attention
        position mask plus prefill's exact overwrite make stale pages
        unreadable before they are rewritten, so retirement costs zero
        device work."""
        slot = int(slot)
        with self._lock:
            pages, self._owned[slot] = self._owned[slot], []
            if not pages:
                return 0
            if len(set(pages)) != len(pages) or 0 in pages:
                raise MXNetError(
                    f"corrupt page ownership for slot {slot}: {pages}")
            self._decref_locked(pages)
            self._table[slot] = 0
            self._table_nd = None
            return len(pages)

    # -- reference counting (prefix-cache sharing) ---------------------------
    def _decref_locked(self, pages):
        freed = []
        for p in pages:
            n = self._refs.get(p, 0) - 1
            if n > 0:
                self._refs[p] = n
            elif n == 0:
                del self._refs[p]
                freed.append(p)
            else:
                raise MXNetError(f"decref of free page {p}")
        self._free.extend(reversed(freed))
        return freed

    def incref(self, pages):
        """Add one reference to each of ``pages`` (the prefix trie
        adopting a retiring slot's prompt pages). Pages must be live."""
        pages = [int(p) for p in pages]
        with self._lock:
            for p in pages:
                if self._refs.get(p, 0) < 1:
                    raise MXNetError(f"incref of free page {p}")
            for p in pages:
                self._refs[p] += 1

    def decref(self, pages):
        """Drop one reference from each of ``pages``; returns the pages
        that reached zero and recycled to the free list (the prefix
        trie's eviction path)."""
        with self._lock:
            return self._decref_locked([int(p) for p in pages])

    def refcount(self, page):
        """Current reference count of ``page`` (0 = free)."""
        with self._lock:
            return self._refs.get(int(page), 0)

    @property
    def pages_shared(self):
        """Pages currently held by more than one reference (a live slot
        plus the trie, or several slots on one prefix)."""
        with self._lock:
            return sum(1 for n in self._refs.values() if n > 1)

    # -- readout -------------------------------------------------------------
    @property
    def pages_total(self):
        """Usable pages (the null page is bookkeeping, not capacity)."""
        return self.num_pages - 1

    @property
    def pages_free(self):
        with self._lock:
            return len(self._free)

    @property
    def pages_used(self):
        return self.pages_total - len(self._free)

    def nbytes(self):
        return sum(a.numel() * a.element_size() for a in self._arrays)

    def stats(self):
        with self._lock:
            free = len(self._free)
            owned = sum(len(o) for o in self._owned)
            shared = sum(1 for n in self._refs.values() if n > 1)
        return {"page_size": self.page_size,
                "pages_total": self.pages_total,
                "pages_free": free,
                "pages_used": self.pages_total - free,
                "pages_owned": owned,
                "pages_shared": shared,
                "high_water": self.high_water,
                "exhausted_count": self.exhausted_count,
                "nbytes": self.nbytes()}

"""Host-side block allocator, prefix index and swap area for the paged KV
cache (``repro/serve/paging.py``, pure numpy and hashlib, semantics intact).

The device side of paging is plain on purpose: pools and page tables
(``nn/attention.py`` ``init_paged_kv_cache``) and kernels that read through
the table (``kernels/qpaged_attn.py``).  The policy — which pool pages belong
to which request, when admission must wait for memory, which pages two
requests may share, which pages a preempted request parks on the host —
lives here, because it runs once per admission or eviction, not per token.

The Scheduler (``serve/scheduler.py``) drives one :class:`PageAllocator`
(and, with prefix sharing, one :class:`PrefixIndex`; with swap preemption,
one :class:`SwapArea`) per ``run()``:

* admission asks for the request's pages all or nothing; ``None`` defers
  the request in the queue (``page_stalls``) instead of failing;
* a request whose prompt prefix matches resident pages maps them and bumps
  their refcount (:meth:`PageAllocator.share`);
* eviction returns the slot's pages, each re-entering the free list only at
  refcount zero, so a prefix another live request maps survives its owner;
* under oversubscription the swap policy copies a victim's private pages
  into a :class:`SwapArea` until they can be restored.

Under a mesh the pool is split into one block a data rank and every rank
runs the same host policy: the allocator keeps a free list a block, the
prefix index matches a prompt only against the pages of the admitting
slot's block (a prefix held on another rank is a miss), and the swap area
of every rank books the same bytes while the rank that held the pages
keeps them (:class:`SwapBooking` stands in for them elsewhere).
"""
from __future__ import annotations

import hashlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class PageAllocator:
    """Refcounting free-list allocator over ``num_pages`` fixed-size pages.

    Pages are identified by their pool index (0..num_pages-1).  ``alloc``
    is all-or-nothing: a request that cannot get its full extent gets
    nothing (and the caller defers it), so a half-admitted request can never
    strand pages.  ``share`` bumps the refcount of already-held pages (prefix
    sharing maps one pool page into several slots' tables); ``free``
    decrements, and a page re-enters the free list only at refcount zero.
    Freeing a page more times than it was alloc'd/shared raises — better a
    loud ValueError than silent page aliasing between two live requests.

    ``blocks`` > 1 (a pool split over the data ranks of a mesh, rank d
    holding pages [d * P / blocks, (d + 1) * P / blocks)) keeps a free list
    per block: ``alloc(n, block=d)`` takes its pages from block d alone, so
    a slot's pages lie on the rank that holds the slot.
    """

    def __init__(self, num_pages: int, blocks: int = 1):
        """Create an allocator with all ``num_pages`` pages free."""
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if blocks < 1 or num_pages % blocks:
            raise ValueError(f"{num_pages} pages do not split into {blocks} blocks")
        self.num_pages = num_pages
        self.block_pages = num_pages // blocks
        # LIFO free lists: freshly freed pages are reused first, which keeps
        # the working set of pool pages small (cache-friendlier on device).
        self._frees: List[List[int]] = [
            list(range((b + 1) * self.block_pages - 1, b * self.block_pages - 1, -1))
            for b in range(blocks)]
        self._ref: Dict[int, int] = {}
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        """Pages currently available to alloc()."""
        return sum(len(f) for f in self._frees)

    @property
    def pages_in_use(self) -> int:
        """Pages currently held (refcount > 0) by live requests."""
        return self.num_pages - self.free_pages

    @property
    def free_list(self) -> Sequence[int]:
        """The free list (LIFO order, block after block), read-only — the
        auditor's view."""
        return tuple(p for f in self._frees for p in f)

    def refcount(self, page: int) -> int:
        """How many slots currently map ``page`` (0 = free)."""
        return self._ref.get(page, 0)

    def alloc(self, n: int, block: int = 0) -> Optional[List[int]]:
        """Take ``n`` pages off the free list (of ``block``); None if fewer
        than n remain.

        All-or-nothing: on None the free list is untouched, so the caller
        can simply retry at the next tick (admission deferral).  Each
        returned page starts at refcount 1.
        """
        if n < 0:
            raise ValueError(f"alloc({n})")
        free = self._frees[block]
        if n > len(free):
            return None
        pages = [free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one reference to each of ``pages`` (prefix-sharing admission).

        Every page must currently be held — sharing a free page would alias
        whatever the free list hands out next, so that raises instead.
        """
        for p in pages:
            if self._ref.get(p, 0) < 1:
                raise ValueError(f"share of page {p} not currently held")
        for p in pages:
            self._ref[p] += 1

    def free(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages actually released.

        A page re-enters the free list only when its refcount reaches zero
        (a shared prefix outlives its original owner).  The returned
        released-list is what the caller must retire from any side index
        (:meth:`PrefixIndex.drop_pages`).  Over-freeing raises.
        """
        released: List[int] = []
        for p in pages:
            if self._ref.get(p, 0) < 1:
                raise ValueError(f"free of page {p} not currently held")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._frees[p // self.block_pages].append(p)
                released.append(p)
        return released


class PrefixIndex:
    """Longest-prefix index over *full* prompt pages, keyed by token hashes.

    Maps the cumulative hash of a prompt's first ``k * page_size`` tokens to
    the pool page holding page ``k-1`` of some live request's prompt.
    Cumulative (not per-page) hashing means a page matches only when the
    *entire prefix* up to and including it matches — identical middle pages
    under different openings can never alias.

    Only pages fully covered by prompt tokens are ever registered: a page
    holding a prompt tail plus decode rows diverges immediately, and decode
    rows must never be shared.  The Scheduler inserts a request's full
    prompt pages once its prefill completes and drops entries when the
    allocator reports their page released (refcount zero) — while *any*
    sharer is live the entry stays valid, because the page still holds
    exactly the hashed tokens' K/V.

    ``block_pages`` (a pool split over the data ranks of a mesh into blocks
    of that many pages) keeps one index a block: a page is registered in
    its own block, and :meth:`match_keys` looks in the block it is given
    alone, since a slot's attention reads only its own rank's pages.
    """

    def __init__(self, page_size: int, block_pages: Optional[int] = None):
        """Index prompts at ``page_size``-token page granularity."""
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.block_pages = block_pages
        # cumulative hash -> pool page, and pool page -> its index key; a
        # key is (block, hash) when the pool is split into blocks
        self._page_of: Dict[Any, int] = {}
        self._key_of: Dict[int, Any] = {}

    def _key(self, block: int, digest: bytes):
        return digest if self.block_pages is None else (block, digest)

    def digests(self, prompt) -> List[bytes]:
        """Cumulative sha1 digests, one per *full* prompt page.

        Hashing is O(prompt) — the scheduler computes this once per request
        and reuses the digests across page-stalled admission retries and the
        post-prefill :meth:`insert_keys` (a deferred request must not
        re-hash its whole prompt every tick).
        """
        arr = np.asarray(prompt, np.int32).reshape(-1)
        ps = self.page_size
        h = hashlib.sha1()
        out: List[bytes] = []
        for i in range(arr.shape[0] // ps):
            h.update(arr[i * ps:(i + 1) * ps].tobytes())
            out.append(h.digest())
        return out

    def match_keys(self, keys: Sequence[bytes], block: int = 0) -> List[int]:
        """Longest resident page chain for precomputed :meth:`digests`
        (among the pages of ``block``)."""
        pages: List[int] = []
        for key in keys:
            page = self._page_of.get(self._key(block, key))
            if page is None:
                break
            pages.append(page)
        return pages

    def match(self, prompt) -> List[int]:
        """Longest chain of resident pool pages holding this prompt's prefix.

        Returns pool page indices for full prompt pages 0..m-1 where every
        page up to m matched; the caller maps them (and ``share``s their
        refcounts) into the new slot's table.
        """
        return self.match_keys(self.digests(prompt))

    def insert_keys(self, keys: Sequence[bytes],
                    pages: Sequence[int]) -> None:
        """Register precomputed :meth:`digests` against their pool pages
        (in each page's block)."""
        for key, page in zip(keys, pages):
            bk = self._key(page // self.block_pages if self.block_pages else 0, key)
            if bk not in self._page_of:
                self._page_of[bk] = page
                self._key_of[page] = bk

    def insert(self, prompt, pages: Sequence[int]) -> None:
        """Register ``prompt``'s full prompt pages (after its prefill).

        ``pages`` is the owning slot's page-table row prefix (one pool page
        per full prompt page).  First writer wins: a prefix already indexed
        keeps its existing page, so concurrent identical prompts converge on
        one shared copy.
        """
        self.insert_keys(self.digests(prompt), pages)

    def drop_pages(self, pages: Sequence[int]) -> None:
        """Retire index entries whose pages the allocator just released."""
        for p in pages:
            key = self._key_of.pop(p, None)
            if key is not None and self._page_of.get(key) == p:
                del self._page_of[key]


def _tree_bytes(data: Any) -> int:
    """Host bytes held by a nested list/dict tree of numpy arrays."""
    if data is None:
        return 0
    if isinstance(data, dict):
        return sum(_tree_bytes(v) for v in data.values())
    if isinstance(data, (list, tuple)):
        return sum(_tree_bytes(v) for v in data)
    return int(getattr(data, "nbytes", 0))


@dataclasses.dataclass(frozen=True)
class SwapBooking:
    """What a data rank books for a request whose swapped pages another
    rank holds (the pages lie in that rank's block): their byte count, read
    as a parked tree's (:func:`_tree_bytes`), so every rank's
    :class:`SwapArea` counts the same bytes."""

    nbytes: int


class SwapArea:
    """Host-side buffer for preempted requests' swapped-out KV pages.

    The ``preempt_policy="swap"`` half of oversubscription: when the pool
    runs dry mid-decode, the victim's *private* pages (refcount 1) are
    gathered device->host into this area and freed; its shared prefix pages
    stay resident (the refcount the victim keeps holding pins them for the
    other sharers — swapping a shared page would yank it from under live
    requests).  On resume the scheduler allocates fresh pages, scatters the
    saved contents back, and rebuilds the victim's table row.

    Purely host-side bookkeeping (numpy trees keyed by request id); the
    device gather/scatter primitives live in nn/attention.py
    (``gather_pool_pages`` / ``scatter_pool_pages``).  ``peak_bytes`` is the
    reporting hook: swap traffic is the cost knob the serve bench surfaces
    next to the admission win.

    ``capacity_bytes`` bounds the area (None = unbounded): the scheduler
    checks :meth:`fits` before parking and falls back to the recompute
    preemption path when a victim's pages do not fit — host memory refusal
    degrades, it does not crash.  :meth:`put` past capacity still raises
    (the loud net behind the polite check).
    """

    def __init__(self, capacity_bytes: Optional[int] = None):
        """Create an empty swap area (``capacity_bytes=None`` = unbounded)."""
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError(
                f"capacity_bytes must be >= 0, got {capacity_bytes}")
        self.capacity_bytes = capacity_bytes
        self._data: Dict[int, Any] = {}
        self.bytes_held = 0
        self.peak_bytes = 0

    def __contains__(self, rid: int) -> bool:
        return rid in self._data

    def __len__(self) -> int:
        return len(self._data)

    def fits(self, nbytes: int) -> bool:
        """Would ``nbytes`` more fit under ``capacity_bytes``?"""
        return (self.capacity_bytes is None
                or self.bytes_held + nbytes <= self.capacity_bytes)

    def put(self, rid: int, data: Any) -> None:
        """Park ``rid``'s swapped page contents (a numpy tree)."""
        if rid in self._data:
            raise ValueError(f"request {rid} already swapped out")
        nbytes = _tree_bytes(data)
        if not self.fits(nbytes):
            raise ValueError(
                f"request {rid}: {nbytes} swap bytes exceed capacity "
                f"{self.capacity_bytes} (held {self.bytes_held}) — the "
                f"scheduler should have checked fits() and recomputed")
        self._data[rid] = data
        self.bytes_held += nbytes
        self.peak_bytes = max(self.peak_bytes, self.bytes_held)

    def pop(self, rid: int) -> Any:
        """Take ``rid``'s parked page contents back for restore."""
        if rid not in self._data:
            raise KeyError(f"request {rid} has no swapped pages")
        data = self._data.pop(rid)
        self.bytes_held -= _tree_bytes(data)
        return data

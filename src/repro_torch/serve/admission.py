"""Admission planning and the preemption policy (``repro/serve/admission.py``).

The scheduler's host-side admission logic — paged sizing, prefix-match page
plans, copy-on-write bookkeeping, the shared-write invariant and the
preemption victim policy — lives here, apart from the serving loop.
Everything works on host integers and the allocator and index objects
(``serve/paging.py``); the device half of each decision (installing a table
row, privatizing a page, evicting a slot) goes through the slot-state
walkers (``serve/slot_state.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.paging import PageAllocator, PrefixIndex


@dataclasses.dataclass
class PrefillLane:
    """One request being prefilled, chunk by chunk, into its reserved (not
    yet live) slot."""

    req: Any                     # serve.scheduler.Request
    slot: int
    prompt: np.ndarray           # (P,) int32
    next_start: int = 0          # first row of the next chunk


@dataclasses.dataclass
class Preempted:
    """Swap-policy parking state for one preempted request: what the
    scheduler needs to resume it bit for bit once a slot and pages free up."""

    slot: Any                    # the live-slot state, carried across
    kept: List[int]              # shared prefix pages still resident (the
    #                              refcount this request keeps holding)
    n_priv: int                  # private pages swapped out (to re-alloc)
    data: Any                    # host tree of the private pages' contents
    #                              (None when n_priv == 0)
    pad: int                     # padded page-vector length of ``data``
    live_len: int                # cache len at preemption (rows written)
    last_tok: Any                # (1, 1) device token feeding the next step
    home: int = 0                # under a mesh, the data rank whose block holds
    #                              ``kept`` and whose host holds ``data``: the
    #                              request resumes into one of its slots


def pick_preemption_victim(candidates: Sequence[Tuple[int, int, int, int]],
                           counts: Dict[int, int], bound: int) -> Optional[int]:
    """Choose which live slot to preempt; None when there are no candidates.

    ``candidates``: (slot_index, rid, emitted, admitted_at) per live slot.
    Starvation-free by an aging bound: a request already preempted ``bound``
    or more times is chosen only when every candidate is.  Among eligible
    candidates the least decode progress goes first, the most recent
    admission breaking ties.
    """
    if not candidates:
        return None

    def key(c):
        j, rid, emitted, admitted_at = c
        return (counts.get(rid, 0) >= bound, emitted, -admitted_at, j)

    return min(candidates, key=key)[0]


@dataclasses.dataclass
class AdmissionPlanner:
    """Host-side paged-admission sizing and page planning, one per scheduler.

    Stateless across calls (the allocator and prefix index carry the state).
    ``oversubscribe`` switches reservation from the full extent (decode can
    never exhaust the pool) to the prompt only (decode pages grow lazily;
    exhaustion preempts a victim).
    """

    page_size: int
    max_pages: int               # page-table width (per-slot ceiling)
    chunk_size: int
    oversubscribe: bool = False

    def pages_needed(self, plen: int, max_new: int) -> int:
        """Pages covering a request's full extent: the chunk-padded prompt
        rows (the last chunk writes C rows) or prompt + decode tokens,
        whichever is larger — the pool-size feasibility floor."""
        c = self.chunk_size
        extent = max(-(-plen // c) * c, plen + max_new)
        return -(-extent // self.page_size)

    def page_row(self, pages: List[int]) -> np.ndarray:
        """A (max_pages,) host row: allocated pool indices then -1s."""
        row = np.full((self.max_pages,), -1, np.int32)
        row[:len(pages)] = pages
        return row

    def plan(self, r, plen: int, alloc: PageAllocator, index: Optional[PrefixIndex],
             keys: Optional[List[bytes]] = None, block: Optional[int] = None):
        """Page plan for admitting ``r``: match, share, allocate, COW — or
        None when the pool cannot serve the fresh-page balance (page stall).

        With sharing, the request maps the longest resident chain of full
        prompt pages and prefills from the divergence point.  ``keys`` are
        the request's cached prompt digests; ``block``: the allocator's
        block the fresh pages come from and the index's block the prefix
        is matched in (under a mesh, the slot's data rank's: its attention
        reads no other rank's pages).  When the whole prompt is
        resident, the last token is re-run for its first-token logits, so the
        final matched page is privatized up front (copy-on-write).

        Up-front mode reserves ``max(chunk_end, plen + max_new)`` rows;
        oversubscription reserves through ``chunk_end`` only.  The page count
        is clamped to the table width only when the overflow rows are
        droppable chunk padding; a plan that cannot cover the request's real
        rows raises.

        Returns ``(row_pages, copies, n_share, next_start)``.
        """
        ps = self.page_size
        C = self.chunk_size
        if index is None:
            matched = []
        else:
            if keys is None:
                keys = index.digests(r.prompt)
            matched = index.match_keys(keys, block or 0)
        s0 = len(matched) * ps
        # always prefill >= 1 token: the last chunk's logits sample the first
        next_start = min(s0, plen - 1)
        chunk_end = next_start + -(-(plen - next_start) // C) * C
        if self.oversubscribe:
            extent, required = chunk_end, plen
        else:
            extent, required = max(chunk_end, plen + r.max_new), plen + r.max_new
        total = min(-(-extent // ps), self.max_pages)
        if total * ps < required:
            raise ValueError(
                f"request {r.rid}: the page plan covers {total * ps} rows "
                f"(page-table width {self.max_pages} pages x {ps}) but the request "
                f"needs {required} (prompt {plen}"
                f"{'' if self.oversubscribe else f' + max_new {r.max_new}'}) — the overflow "
                f"rows would be dropped by the out-of-bounds sentinel and the request "
                f"would decode garbage attention; raise max_len or shrink the request")
        first_write_page = next_start // ps
        n_share = min(len(matched), first_write_page)
        copies_src = matched[n_share:]          # divergence page(s) to COW
        got = alloc.alloc(total - n_share) if block is None \
            else alloc.alloc(total - n_share, block)
        if got is None:
            return None
        alloc.share(matched[:n_share])
        row_pages = matched[:n_share] + got
        copies = list(zip(copies_src, got[:len(copies_src)]))
        return row_pages, copies, n_share, next_start

    def assert_private_write(self, pages: List[int], lo: int, hi: int,
                             alloc: PageAllocator) -> None:
        """Rows [lo, hi) of a slot mapping ``pages`` must touch only privately
        mapped (refcount <= 1) pages: a write through a shared mapping would
        corrupt every other slot reading that page."""
        ps = self.page_size
        for pi in range(lo // ps, min(-(-hi // ps), len(pages))):
            rc = alloc.refcount(pages[pi])
            if rc > 1:
                raise AssertionError(f"chunk write into shared page {pages[pi]} (refcount "
                                     f"{rc}) — copy-on-write must privatize it first")

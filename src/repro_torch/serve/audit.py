"""Invariant auditor for the paged serving state (``repro/serve/audit.py``;
the checks and their messages are the reference's).

The scheduler's paging keeps three records in agreement: the host
allocator's refcounts, the scheduler's per-slot page lists (and parked swap
state), and the device page tables the kernels read through.  A fault in
any one of them (a private page mapped twice, a leaked page, a stale
refcount, a table row pointing at a freed page) decodes plausible garbage.
``Scheduler(audit=True)`` runs :func:`check_allocator`,
:func:`check_page_tables` and :func:`check_swap` every tick and raises
:class:`AuditError` at the first breach.

Invariants:

* refcount conservation: every pool page's refcount equals the number of
  holders mapping it (live slot rows, mid-prefill reservations, parked
  requests' kept prefixes); the free list holds exactly the refcount-zero
  pages, without duplicates;
* page tables map only live pages: a resident slot's device row is its host
  page list, then -1; a slot holding no request has an all -1 row;
* no private page mapped twice: a page in several rows has refcount > 1;
* lens vs extents: a live slot's device ``len`` is its ``prompt + emitted -
  1`` write frontier and fits its mapped extent; a mid-prefill slot's
  ``len`` never falls behind its chunk cursor;
* SwapArea byte conservation: the area holds exactly the parked requests'
  pages, and its byte counter matches their sizes;
* recurrent rows (Mamba, RWKV-6 state): a slot that holds no request and no
  prefill lane has all-zero rows in every recurrent leaf
  (:func:`check_recurrent_rows`).  The scheduler computes each (leaf, slot)
  row's max |x| on the device and reads that small array back with the
  tick's health flags, so the check costs no read-back of its own;
* cross-attention lengths (EncDec): a live or lane-reserved slot's cached
  ``xlen`` equals its request's encoder length, every other slot's is 0,
  and a stacked node's layers agree (:func:`check_cross_lens`).  The
  scheduler reads the ``xlen`` rows back with the health flags too.

The NaN/Inf logit sentinel is the scheduler's half (the steps return
per-row health flags under ``audit=True``).

Under a mesh each data rank checks its own block of the pool, its own
slots' table rows (read in its local page ids, checked in pool ids) and
its swap area (the bytes it parks, and the bookings of those another rank
parks); :func:`agree_over_data` then makes the tick's verdict every
rank's, so every rank raises in the same tick.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.serve.paging import PageAllocator, SwapArea, _tree_bytes


class AuditError(RuntimeError):
    """A serving-state invariant was breached (see the module doc)."""


def check_allocator(alloc: PageAllocator, holders: Mapping[Any, Sequence[int]], *,
                    block: Optional[int] = None) -> None:
    """Refcount conservation between ``alloc`` and its ``holders``.

    ``holders`` maps a holder key (a live slot, a parked request) to the pool
    pages it maps.  Every page's refcount must equal the number of holder
    entries naming it, the free list must hold exactly the unreferenced
    pages, and no page may be on the free list twice.  ``block`` (under a
    mesh, a data rank's block of the pool): the pages of that block alone.
    """
    lo, hi = (0, alloc.num_pages) if block is None else \
        (block * alloc.block_pages, (block + 1) * alloc.block_pages)
    counts: Counter = Counter()
    for key, pages in holders.items():
        for p in pages:
            if not 0 <= p < alloc.num_pages:
                raise AuditError(f"holder {key!r} maps page {p} outside the pool "
                                 f"[0, {alloc.num_pages})")
            if lo <= p < hi:
                counts[p] += 1
    free = [p for p in alloc.free_list if lo <= p < hi]
    if len(free) != len(set(free)):
        dup = [p for p, c in Counter(free).items() if c > 1]
        raise AuditError(f"free list holds duplicate page(s) {sorted(dup)}")
    free_set = set(free)
    for p in range(lo, hi):
        rc = alloc.refcount(p)
        held = counts.get(p, 0)
        if rc != held:
            kind = "leaked (no holder)" if held < rc else "double-mapped"
            raise AuditError(f"page {p}: refcount {rc} but {held} holder mapping(s) — {kind}")
        if rc > 0 and p in free_set:
            raise AuditError(f"page {p} is on the free list with refcount {rc}")
        if rc == 0 and p not in free_set:
            raise AuditError(f"page {p} has refcount 0 but is missing from the free "
                             f"list — leaked out of the pool")


def check_page_tables(table: np.ndarray, lens: np.ndarray,
                      slot_rows: Mapping[int, Sequence[int]], refcount_of, *,
                      exact_lens: Optional[Mapping[int, int]] = None,
                      min_lens: Optional[Mapping[int, int]] = None,
                      page_size: int = 1, slots: Optional[Sequence[int]] = None) -> None:
    """Device page table and lens against the scheduler's host slot state.

    ``table`` is the (slots, max_pages) int32 table (every layer shares it),
    ``lens`` the (slots,) live lengths.  ``slot_rows`` maps each resident
    slot to its host page list; every other slot must have an all -1 row.
    ``exact_lens`` (live decode slots) pins ``len``; ``min_lens``
    (mid-prefill slots, whose ``len`` may run ahead over masked junk rows of
    the mixed step) bounds it from below.  ``refcount_of`` is asked about
    pages mapped by more than one row, which must be shared (refcount > 1).
    ``slots``: the slot of each row of ``table`` and ``lens`` (under a mesh,
    a data rank's slots, its table in pool ids); by default row j is slot j.
    """
    mapped_by: Dict[int, List[int]] = {}
    for i, j in enumerate(range(table.shape[0]) if slots is None else slots):
        row = table[i]
        pages = slot_rows.get(j)
        if pages is None:
            if (row != -1).any():
                raise AuditError(f"slot {j} holds no request but its table row still "
                                 f"maps pages {row[row != -1].tolist()}")
            continue
        n = len(pages)
        if not np.array_equal(row[:n], np.asarray(pages, row.dtype)):
            raise AuditError(f"slot {j}: device table row {row[:n].tolist()} != host "
                             f"page list {list(pages)}")
        if (row[n:] != -1).any():
            raise AuditError(f"slot {j}: table row maps {row[row != -1].size} pages "
                             f"past its host page list ({n})")
        for p in pages:
            mapped_by.setdefault(int(p), []).append(j)
        if exact_lens is not None and j in exact_lens:
            if int(lens[i]) != exact_lens[j]:
                raise AuditError(f"slot {j}: device len {int(lens[i])} != expected "
                                 f"write frontier {exact_lens[j]}")
            if exact_lens[j] > n * page_size:
                raise AuditError(f"slot {j}: live frontier {exact_lens[j]} exceeds its "
                                 f"mapped extent ({n} pages x {page_size})")
        elif min_lens is not None and j in min_lens:
            if int(lens[i]) < min_lens[j]:
                raise AuditError(f"slot {j}: device len {int(lens[i])} fell behind its "
                                 f"prefill cursor {min_lens[j]}")
    for p, rows in mapped_by.items():
        if len(rows) > 1 and refcount_of(p) <= 1:
            raise AuditError(f"page {p} is mapped by slots {rows} but its refcount is "
                             f"{refcount_of(p)} — a private page aliased across rows")


def check_swap(swap: Optional[SwapArea], parked: Sequence[Tuple[int, Any]]) -> None:
    """SwapArea byte conservation against the scheduler's parked list.

    ``parked``: (rid, data) per parked request (data None when it had no
    private pages).  The area must hold exactly the parked rids, and its
    byte counter must equal the sum of their trees' sizes.
    """
    if swap is None:
        if parked:
            raise AuditError(f"{len(parked)} parked request(s) but no SwapArea exists")
        return
    expect = 0
    for rid, data in parked:
        if rid not in swap:
            raise AuditError(f"parked request {rid} missing from SwapArea")
        expect += _tree_bytes(data)
    if len(swap) != len(parked):
        raise AuditError(f"SwapArea holds {len(swap)} request(s) but the scheduler has "
                         f"{len(parked)} parked")
    if swap.bytes_held != expect:
        raise AuditError(f"SwapArea bytes_held {swap.bytes_held} != parked page bytes "
                         f"{expect} — byte-conservation breach")


def check_recurrent_rows(cache, live: Set[int]) -> None:
    """Dead slots' recurrent-state rows must be exactly zero.

    ``live``: the slots holding a request or reserved by a prefill lane
    (their rows carry real state, partial for a mid-prefill lane).  Every
    other slot's row in every recurrent leaf (Mamba ``h``/``conv``, RWKV-6
    ``s``/``shift``) must be all zeros, the inert state admission assumes.
    A nonzero dead row means a masked batched step advanced it (a hole in
    the ``merge_inactive`` barrier) or an eviction missed a leaf; the next
    request admitted there would inherit foreign state."""
    from repro_torch.serve.slot_state import recurrent_row_max

    keys, maxes = recurrent_row_max(cache)
    if maxes is not None:
        check_recurrent_row_max(keys, maxes.cpu().numpy(), live)


def check_recurrent_row_max(keys: Sequence[str], maxes: np.ndarray, live: Set[int]) -> None:
    """:func:`check_recurrent_rows` on its read-back: ``maxes[i, j]`` is max
    |x| over slot ``j``'s row of leaf ``keys[i]`` (leaves in traversal order,
    ``slot_state.recurrent_row_max``).  A NaN entry is nonzero."""
    for key, row in zip(keys, maxes):
        for j, m in enumerate(row):
            if j not in live and m != 0:
                raise AuditError(f"recurrent leaf {key!r}: dead slot {j} holds nonzero "
                                 f"state (max |x| = {float(m)}) — leaked through the "
                                 f"inactive-merge barrier or missed by eviction")


def check_cross_lens(cache, want: Mapping[int, int]) -> None:
    """Cached cross-attention lengths against the scheduler's live slots.

    ``want`` maps every live or lane-reserved slot to its request's encoder
    length; every other slot must read 0.  The cached ``xk``/``xv`` rows are
    masked by ``xlen`` as KV rows are by ``len``, so a wrong value truncates
    the encoder context or attends a previous occupant's stale rows."""
    from repro_torch.serve.slot_state import cross_lens

    counts, rows = cross_lens(cache)
    if rows is not None:
        check_cross_len_rows(counts, rows.cpu().numpy(), want)


def check_cross_len_rows(counts: Sequence[int], rows: np.ndarray,
                         want: Mapping[int, int]) -> None:
    """:func:`check_cross_lens` on its read-back: ``rows`` stacks every
    cross node's ``xlen`` rows (``counts[i]`` of them for node i, one per
    stacked layer; ``slot_state.cross_lens``)."""
    at = 0
    for n in counts:
        xl = rows[at:at + n]
        at += n
        if n > 1 and np.any(xl != xl[0]):
            raise AuditError(f"cross-attention xlen disagrees across stacked layers: "
                             f"{xl.tolist()}")
        for j, got in enumerate(xl[0]):
            exp = int(want.get(j, 0))
            if int(got) != exp:
                raise AuditError(f"slot {j}: cached cross-attention xlen {int(got)} != "
                                 f"expected {exp} ({'live' if j in want else 'dead'} slot)")


def agree_over_data(err: Optional[AuditError], mesh, device, tick: int) -> None:
    """Under a mesh, one tick's audit verdict of every data rank, agreed in
    one all-reduce over ``data`` (counted ``("data", "audit")``): raises
    ``err`` on the rank that found it and, on every other rank, an
    :class:`AuditError` naming the data ranks that failed, so no rank goes
    on to a collective the others never reach."""
    import torch

    from repro_torch.dist import shard_ops

    world = shard_ops.axis_size(mesh, "data")
    flags = torch.zeros(world, dtype=torch.int32, device=device)
    flags[shard_ops.axis_index(mesh, "data")] = int(err is not None)
    failed = np.flatnonzero(shard_ops.all_reduce(flags, mesh, "data", kind="audit").cpu()
                            .numpy()).tolist()
    if err is not None:
        raise err
    if failed:
        raise AuditError(f"tick {tick}: the audit failed on data rank(s) {failed} (each "
                         f"raises its own breach)")

"""Per-slot decode-state adapters (``repro/serve/slot_state.py``), for dense
and paged KV caches.

The continuous-batching scheduler manages *slots*; the walkers below apply
one slot lifecycle event (admit a batch-1 prefilled cache, evict, install or
grow a page-table row, copy a page, park or restore pages) to every
per-layer KV node of a cache tree, so the scheduler never looks inside the
model.  The port serves attention models: recurrent (SSM/RWKV) and
cross-attention state wait for the other architectures slice of the port;
a cache node or a model of those kinds raises.  A paged cache node keeps one table and one
``len`` for all the layers it stacks, so each event writes them once.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.nn.attention import (copy_kv_page, gather_pool_pages, reset_kv_slot,
                                      scatter_pool_pages, set_kv_slot_len, set_page_entry,
                                      set_page_row, write_kv_slot)

# leaf keys of the reference's recurrent ({"h", "conv"}, {"s", "shift"}) and
# cross-attention ({"xk", "xv", "xlen"}) state nodes
_OTHER_STATE_KEYS = {"h", "conv", "s", "shift", "xk", "xv", "xlen"}


def _is_kv(node) -> bool:
    return isinstance(node, dict) and "k" in node and "len" in node


def _walk(big, small, fn):
    """``fn(big_kv, small_kv)`` on every KV node of ``big`` (``small`` is a
    structurally identical tree, or None); the rest is rebuilt as is."""
    if _is_kv(big):
        return fn(big, small)
    if isinstance(big, dict):
        if _OTHER_STATE_KEYS & set(big):
            raise NotImplementedError("recurrent and cross-attention slot state waits for "
                                      "the other architectures slice of the port")
        return {k: _walk(v, None if small is None else small[k], fn) for k, v in big.items()}
    if isinstance(big, (list, tuple)):
        return type(big)(_walk(v, None if small is None else small[i], fn)
                         for i, v in enumerate(big))
    return big


def _walk_paged(cache, fn):
    """``fn(kv)`` on every paged KV node (one with a ``page_table``)."""
    def op(kv, _):
        if "page_table" not in kv:
            raise ValueError("a page-table event on a dense KV cache")
        return fn(kv)
    return _walk(cache, None, op)


def find_paged_kv(cache):
    """The first paged KV node of ``cache`` (its table and ``len`` are every
    layer's), or None for a dense cache: what the auditor reads."""
    if _is_kv(cache):
        return cache if "page_table" in cache else None
    nodes = cache.values() if isinstance(cache, dict) else \
        cache if isinstance(cache, (list, tuple)) else ()
    for node in nodes:
        found = find_paged_kv(node)
        if found is not None:
            return found
    return None


def admit_cache_slot(big_cache, small_cache, slot: int, length: int):
    """Copy a batch-1 prefilled cache into ``slot`` of the per-slot cache
    (one-shot admission) and set the slot's live length to ``length``."""
    def op(b, s):
        if "page_table" in b:
            raise ValueError("one-shot admission copies a dense batch-1 cache; paged "
                             "caches admit through chunks")
        return write_kv_slot(b, s, slot, length)
    return _walk(big_cache, small_cache, op)


def evict_cache_slot(cache, slot: int):
    """O(1) eviction of ``slot``: its live length goes to 0, rows stay; a
    paged slot's table row is unmapped."""
    return _walk(cache, None, lambda kv, _: reset_kv_slot(kv, slot))


def set_cache_page_row(cache, slot: int, row):
    """Install ``slot``'s page-table row (host ints) in every paged node."""
    return _walk_paged(cache, lambda kv: set_page_row(kv, slot, row))


def set_cache_page_entry(cache, slot: int, idx: int, page: int):
    """``page_table[slot, idx] = page`` in every paged node (lazy growth)."""
    return _walk_paged(cache, lambda kv: set_page_entry(kv, slot, idx, page))


def copy_cache_page(cache, src: int, dst: int):
    """Copy pool page ``src`` onto ``dst`` in every paged node and layer —
    the device half of copy-on-write."""
    return _walk_paged(cache, lambda kv: copy_kv_page(kv, src, dst))


def gather_cache_pages(cache, pages):
    """Swap-out gather: pool pages ``pages`` of every paged node, as a list of
    ``{"k", "v"}`` device tensors in the tree's traversal order (what
    :func:`scatter_cache_pages` consumes).  The cache is not modified."""
    out = []

    def op(kv):
        out.append(gather_pool_pages(kv, pages))
        return kv

    _walk_paged(cache, op)
    return out


def scatter_cache_pages(cache, pages, data):
    """Swap-in restore: write :func:`gather_cache_pages` data (device tensors
    or host numpy arrays) into pool pages ``pages``, same traversal order."""
    it = iter(data)
    return _walk_paged(cache, lambda kv: scatter_pool_pages(kv, pages, next(it)))


def set_cache_slot_len(cache, slot: int, length: int):
    """``len[slot] = length`` in every KV node.  Prefix-sharing admission
    starts a slot at its shared-prefix length, so the decode half's junk
    append for the still-prefilling slot lands in its private pages."""
    return _walk(cache, None,
                 lambda kv, _: dict(kv, len=set_kv_slot_len(kv["len"], slot, length)))


def state_kinds(model) -> Tuple[str, ...]:
    """The per-slot state kinds ``model`` serves with: ``("kv",)`` for the
    attention models the port builds."""
    if hasattr(model, "encode") or any(getattr(b, "mixer", "attn") != "attn"
                                       for b in model.stack.body):
        raise NotImplementedError("recurrent and cross-attention models wait for the other "
                                  "architectures slice of the port")
    return ("kv",)


class SlotState:
    """One per-slot state kind and its lifecycle (admit, evict)."""

    kind: str = "abstract"

    def evict(self, cache, slot: int):
        """Make ``slot`` inert without touching other slots (O(1))."""
        return evict_cache_slot(cache, slot)

    def admit_write(self, big_cache, small_cache, slot: int, length: int):
        """Install a batch-1 prefilled state into ``slot``."""
        return admit_cache_slot(big_cache, small_cache, slot, length)

    def audit_check(self, cache, live: Dict[int, int]) -> None:
        """Assert this kind's device invariants (``serve/audit.py``).  Dense
        KV has none beyond what the scheduler's auditor checks."""


class DenseKVState(SlotState):
    """Dense per-slot K/V slabs with a per-slot ``len`` vector."""

    kind = "kv"


class PagedKVState(DenseKVState):
    """Paged K/V: shared pool + per-slot page tables (``serve/paging.py``).
    The one adapter with a swap path: private page contents gather and
    scatter host-side while shared prefix pages stay resident."""

    kind = "kv-paged"

    def preempt_pack(self, cache, pages):
        """Gather pool pages ``pages`` (swap-out; cache unmodified)."""
        return gather_cache_pages(cache, pages)

    def resume_unpack(self, cache, pages, data):
        """Scatter swapped page data back into pool pages ``pages``."""
        return scatter_cache_pages(cache, pages, data)

    def audit_check(self, cache, live: Dict[int, int]) -> None:
        """The page-table invariants run through ``serve/audit.py``
        ``check_page_tables``, which the scheduler feeds with its allocator's
        state; nothing more here."""


def adapters_for(model, *, paged: bool = False) -> Tuple[Any, ...]:
    """The adapter set a scheduler composes for ``model``."""
    return tuple(PagedKVState() if paged else DenseKVState() for _ in state_kinds(model))

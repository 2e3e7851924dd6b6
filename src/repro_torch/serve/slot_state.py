"""Per-slot decode-state adapters (``repro/serve/slot_state.py``): dense
and paged KV caches, recurrent (Mamba, RWKV-6) state and EncDec
cross-attention state.

The continuous-batching scheduler manages *slots*; the walkers below apply
one slot lifecycle event (admit a batch-1 prefilled cache, evict, install or
grow a page-table row, copy a page, park or restore pages, keep inactive
rows across a batched step) to every state node of a cache tree, so the
scheduler never looks inside the model.  A paged cache node keeps one table
and one ``len`` for all the layers it stacks, so each event writes them
once.  A recurrent node (Mamba ``{"h", "conv"}``, RWKV-6 ``{"s", "shift"}``
and the channel-mix's ``{"shift"}``, under block-cache keys ``"ssm"`` and
``"cm"``) is a fixed-size row per slot: admission writes the row, eviction
zeroes it (the inert state every recurrence starts from), and a batched
step's inactive rows are put back by :func:`merge_inactive`.  Its events
return new tensors and leave the old ones as they were.  A cross-attention
node (``{"xk", "xv", "xlen"}`` under block-cache key ``"xkv"``,
``nn/attention.py`` ``init_cross_cache``) holds each slot's projected
encoder K/V rows, written once at admission by ``EncDecLM.write_cross_kv``:
eviction sets the slot's ``xlen`` to 0 and leaves the rows for the next
admission to overwrite; a one-shot admission and the inactive merge pass it
by.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.nn.attention import (copy_kv_page, gather_pool_pages, reset_kv_slot,
                                      scatter_pool_pages, set_kv_slot_len, set_page_entry,
                                      set_page_row, write_kv_slot)

#: Unstacked rank of each recurrent-state leaf (``nn/ssm.py`` ``init_state``):
#: ``h`` (B, d_inner, N), ``conv`` (B, K-1, d_inner), ``s`` (B, H, N, N),
#: ``shift`` (B, 1, D).  A leaf one rank higher carries the stacked layer
#: axis in front and its slot axis is axis 1.
REC_BASE_RANK: Dict[str, int] = {"h": 3, "conv": 3, "s": 4, "shift": 3}



@dataclasses.dataclass(frozen=True)
class SlotShard:
    """The slots and pool pages one data rank holds under a mesh: slot j
    of the scheduler's B lives on data rank ``j // per_rank`` as its local
    slot ``j % per_rank``, and its pool pages in that rank's block of
    ``pages`` (pool page p is local page ``p % pages`` of rank ``p //
    pages``).  The slot events below take ``shard=`` and act on the owner's
    local slot, and nowhere else; without one, on ``slot`` itself."""

    rank: int
    per_rank: int
    pages: int = 0

    def owner(self, slot: int) -> int:
        return slot // self.per_rank

    def local(self, slot: int) -> Optional[int]:
        """``slot``'s local index here, or None where another rank holds it."""
        return slot % self.per_rank if self.owner(slot) == self.rank else None

    def local_pages(self, row) -> np.ndarray:
        """A page-table row (pool ids, -1 unmapped) in this rank's local ids."""
        row = np.asarray(row, np.int32)
        return np.where(row >= 0, row - self.rank * self.pages, row).astype(np.int32)

    def global_pages(self, row) -> np.ndarray:
        """A row of this rank's local page ids (-1 unmapped) in pool ids."""
        row = np.asarray(row)
        return np.where(row >= 0, row + self.rank * self.pages, row)

    def here(self, pages: Sequence[int]) -> Optional[List[int]]:
        """Pool pages that lie in one block, in this rank's local ids, or
        None where another rank's block holds them."""
        blocks = {int(p) // self.pages for p in pages}
        if len(blocks) > 1:
            raise ValueError(f"pages {list(pages)} span the blocks {sorted(blocks)}")
        if blocks != {self.rank}:
            return None
        return [int(p) - self.rank * self.pages for p in pages]


def _at(shard: Optional[SlotShard], slot: int) -> Optional[int]:
    return slot if shard is None else shard.local(slot)


def _is_kv(node) -> bool:
    return isinstance(node, dict) and "k" in node and "len" in node


def _is_xkv(node) -> bool:
    return isinstance(node, dict) and "xk" in node and "xlen" in node


def _is_recurrent(node) -> bool:
    return isinstance(node, dict) and bool(node) and set(node) <= set(REC_BASE_RANK)


def _rec_slot_axis(key: str, leaf: torch.Tensor) -> int:
    """Slot axis of one recurrent leaf: 1 under a stacked layer axis."""
    return 1 if leaf.ndim == REC_BASE_RANK[key] + 1 else 0


def _walk(big, small, fn, rec_fn: Optional[Callable] = None,
          xkv_fn: Optional[Callable] = None):
    """``fn(big_kv, small_kv)`` on every KV node of ``big``, ``rec_fn(big,
    small)`` on every recurrent node and ``xkv_fn(big)`` on every
    cross-attention node (None leaves them as they are); ``small`` is a
    structurally identical tree, or None.  The rest is rebuilt as is."""
    if _is_kv(big):
        return fn(big, small)
    if _is_xkv(big):
        return big if xkv_fn is None else xkv_fn(big)
    if _is_recurrent(big):
        return big if rec_fn is None else rec_fn(big, small)
    if isinstance(big, dict):
        return {k: _walk(v, None if small is None else small[k], fn, rec_fn, xkv_fn)
                for k, v in big.items()}
    if isinstance(big, (list, tuple)):
        return type(big)(_walk(v, None if small is None else small[i], fn, rec_fn, xkv_fn)
                         for i, v in enumerate(big))
    return big


def _zero_recurrent_slot(state: Dict[str, Any], slot: int) -> Dict[str, Any]:
    """A copy of a recurrent node with ``slot``'s row zeroed in every leaf:
    the inert state admission starts from, so an evicted slot is
    indistinguishable from a never-used one (the auditor's dead-slot
    invariant, ``serve/audit.py`` ``check_recurrent_rows``)."""
    out = {}
    for k, v in state.items():
        if v is not None:
            v = v.clone()
            v.select(_rec_slot_axis(k, v), slot).zero_()
        out[k] = v
    return out


def _scatter_recurrent_slot(big: Dict[str, Any], small: Dict[str, Any],
                            slot: int) -> Dict[str, Any]:
    """A copy of a recurrent node with a batch-1 state written into ``slot``
    (one-shot admission; chunked admission writes through the mixers'
    ``chunk`` path instead)."""
    out = {}
    for k, v in big.items():
        if v is not None:
            ax = _rec_slot_axis(k, v)
            v = v.clone()
            v.select(ax, slot).copy_(small[k].select(ax, 0))
        out[k] = v
    return out


def _reset_xkv_slot(node: Dict[str, Any], slot: int) -> Dict[str, Any]:
    """Evict one slot of a cross-attention node: a copy with ``xlen[...,
    slot] = 0`` in every stacked layer (``fill_``, no host sync).  The
    projected rows stay for the next admission to overwrite: consumers mask
    on ``xlen``, as on a KV ``len``, so eviction is O(1)."""
    xlen = node["xlen"].clone()
    xlen[..., slot].fill_(0)
    return dict(node, xlen=xlen)


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


def admit_cache_slot(big_cache, small_cache, slot: int, length: int, *,
                     shard: Optional[SlotShard] = None):
    """Copy a batch-1 prefilled cache into ``slot`` of the per-slot cache
    (one-shot admission): KV nodes copy their rows and set the slot's live
    length to ``length``; recurrent nodes take the batch-1 row (the whole
    recurrence fits it, so ``length`` does not apply).  Under a mesh
    (``shard``) the owner writes its local slot; elsewhere a no-op."""
    slot = _at(shard, slot)
    if slot is None:
        return big_cache

    def op(b, s):
        if "page_table" in b:
            raise ValueError("one-shot admission copies a dense batch-1 cache; paged "
                             "caches admit through chunks")
        return write_kv_slot(b, s, slot, length)
    return _walk(big_cache, small_cache, op,
                 lambda b, s: _scatter_recurrent_slot(b, s, slot))


def evict_cache_slot(cache, slot: int, *, shard: Optional[SlotShard] = None):
    """Eviction of ``slot`` across every state kind: a KV slot's live length
    goes to 0 and its rows stay (a paged slot's table row is unmapped); a
    recurrent slot's rows are zeroed (a recurrence has no length to hide
    stale rows behind, and the next occupant must start from zeros); a
    cross-attention slot's ``xlen`` goes to 0.  ``shard``: the owner's
    local slot only."""
    slot = _at(shard, slot)
    if slot is None:
        return cache
    return _walk(cache, None, lambda kv, _: reset_kv_slot(kv, slot),
                 lambda st, _: _zero_recurrent_slot(st, slot),
                 lambda node: _reset_xkv_slot(node, slot))


def merge_inactive(old_cache, new_cache, active: torch.Tensor):
    """Keep the inactive slots' recurrent rows at their values before a
    batched step: ``where(active, new, old)`` per slot row of every
    recurrent leaf.  KV state tolerates a batched step running every row
    (junk appends land at rows >= ``len``), but one masked step through a
    dead or mid-prefill slot would advance its recurrence with a pad token.
    The rows are selected, not blended, so a non-finite value in a
    discarded row cannot leak.  ``active`` is a (B,) bool device tensor; KV
    and cross-attention nodes pass through as they are."""
    def merge(o: Dict[str, Any], n: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, v in n.items():
            if v is not None:
                ax = _rec_slot_axis(k, v)
                shape = [1] * v.ndim
                shape[ax] = v.shape[ax]
                v = torch.where(active.reshape(shape), v, o[k])
            out[k] = v
        return out
    return _walk(new_cache, old_cache, lambda kv, _: kv, lambda n, o: merge(o, n))


def find_recurrent_nodes(cache) -> List[Dict[str, Any]]:
    """Every recurrent-state node of a cache tree, dict keys walked sorted:
    the reference walks its (jitted, so key-sorted) trees in that order."""
    out: List[Dict[str, Any]] = []

    def rec(node):
        if _is_recurrent(node):
            out.append(node)
        elif isinstance(node, dict) and not (_is_kv(node) or _is_xkv(node)):
            for k in sorted(node):
                rec(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                rec(v)

    rec(cache)
    return out


def find_cross_nodes(cache) -> List[Dict[str, Any]]:
    """Every cross-attention node of a cache tree, in traversal order."""
    out: List[Dict[str, Any]] = []

    def rec(node):
        if _is_xkv(node):
            out.append(node)
        elif isinstance(node, dict) and not _is_kv(node):
            for v in node.values():
                rec(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                rec(v)

    rec(cache)
    return out


def cross_lens(cache) -> Tuple[List[int], Optional[torch.Tensor]]:
    """The auditor's device half for cross-attention: (the row count of each
    cross node, their ``xlen`` rows stacked, (rows, slots) int32; a stacked
    node gives one row per layer), or ([], None) for a cache without
    cross-attention."""
    rows = [node["xlen"].reshape(-1, node["xlen"].shape[-1]) for node in find_cross_nodes(cache)]
    return [r.shape[0] for r in rows], (torch.cat(rows) if rows else None)


def recurrent_row_max(cache) -> Tuple[List[str], Optional[torch.Tensor]]:
    """The auditor's device half: (the leaf keys, a (leaves, B) float32
    tensor of max |x| over each leaf's slot rows), leaves in the reference's
    order (nodes and their keys sorted), so its first breach is this one's;
    or ([], None) for a cache without recurrent state.  A NaN in a row makes
    its entry NaN."""
    keys, rows = [], []
    for node in find_recurrent_nodes(cache):
        for k in sorted(node):
            v = node[k]
            if v is not None:
                ax = _rec_slot_axis(k, v)
                keys.append(k)
                rows.append(torch.amax(torch.abs(v), dim=[d for d in range(v.ndim) if d != ax]))
    return keys, (torch.stack(rows).to(torch.float32) if rows else None)


def set_cache_page_row(cache, slot: int, row, *, shard: Optional[SlotShard] = None):
    """Install ``slot``'s page-table row (host ints) in every paged node;
    ``shard``: the owner's local slot, in its local page ids."""
    local = _at(shard, slot)
    if local is None:
        return cache
    if shard is not None:
        row = shard.local_pages(row)
    return _walk_paged(cache, lambda kv: set_page_row(kv, local, row))


def set_cache_page_entry(cache, slot: int, idx: int, page: int, *,
                         shard: Optional[SlotShard] = None):
    """``page_table[slot, idx] = page`` in every paged node (lazy growth);
    ``shard``: the owner's local slot and page id."""
    local = _at(shard, slot)
    if local is None:
        return cache
    if shard is not None:
        page = int(shard.local_pages([page])[0])
    return _walk_paged(cache, lambda kv: set_page_entry(kv, local, idx, page))


def copy_cache_page(cache, src: int, dst: int, *, shard: Optional[SlotShard] = None):
    """Copy pool page ``src`` onto ``dst`` in every paged node and layer —
    the device half of copy-on-write.  ``shard``: on the rank whose block
    holds both pages, in its local ids; elsewhere a no-op."""
    if shard is not None:
        both = shard.here([src, dst])
        if both is None:
            return cache
        src, dst = both
    return _walk_paged(cache, lambda kv: copy_kv_page(kv, src, dst))


def gather_cache_pages(cache, pages, *, shard: Optional[SlotShard] = None):
    """Swap-out gather: pool pages ``pages`` of every paged node, as a list of
    ``{"k", "v"}`` device tensors in the tree's traversal order (what
    :func:`scatter_cache_pages` consumes).  The cache is not modified.
    ``shard``: on the rank whose block holds the pages, in its local ids;
    None elsewhere."""
    if shard is not None:
        pages = shard.here(pages)
        if pages is None:
            return None
    out = []

    def op(kv):
        out.append(gather_pool_pages(kv, pages))
        return kv

    _walk_paged(cache, op)
    return out


def scatter_cache_pages(cache, pages, data, *, shard: Optional[SlotShard] = None):
    """Swap-in restore: write :func:`gather_cache_pages` data (device tensors
    or host numpy arrays) into pool pages ``pages``, same traversal order.
    ``shard``: on the rank whose block holds the pages, in its local ids;
    elsewhere a no-op."""
    if shard is not None:
        pages = shard.here(pages)
        if pages is None:
            return cache
    it = iter(data)
    return _walk_paged(cache, lambda kv: scatter_pool_pages(kv, pages, next(it)))


def swap_bytes_of(cache, n: int) -> int:
    """Host bytes of :func:`gather_cache_pages` of ``n`` pages of ``cache``
    (K and V of every paged node), from the shapes alone: what a data rank
    books for pages another rank parks (``paging.SwapBooking``)."""
    total = 0

    def op(kv):
        nonlocal total
        ax = kv["k"].ndim - 4
        for name in ("k", "v"):
            x = kv[name]
            total += x.numel() // x.shape[ax] * n * x.element_size()
        return kv

    _walk_paged(cache, op)
    return total


def set_cache_slot_len(cache, slot: int, length: int, *, shard: Optional[SlotShard] = None):
    """``len[slot] = length`` in every KV node.  Prefix-sharing admission
    starts a slot at its shared-prefix length, so the decode half's junk
    append for the still-prefilling slot lands in its private pages.
    ``shard``: the owner's local slot only."""
    slot = _at(shard, slot)
    if slot is None:
        return cache
    return _walk(cache, None,
                 lambda kv, _: dict(kv, len=set_kv_slot_len(kv["len"], slot, length)))


def state_kinds(model) -> Tuple[str, ...]:
    """The per-slot state kinds ``model`` serves with, in the reference's
    order: ``"kv"`` for attention mixers, ``"recurrent"`` for Mamba and
    RWKV-6 mixers (a hybrid, jamba, has both), ``"cross"`` for an EncDec
    decoder with a sized cross-attention cache (``enc_len`` set); the
    stack's prelude blocks count with its body's."""
    stack = model.decoder if hasattr(model, "encode") else model.stack
    blocks = stack.blocks
    mixers = {b.mixer for b in blocks}
    kinds = []
    if "attn" in mixers:
        kinds.append("kv")
    if mixers & {"mamba", "rwkv"}:
        kinds.append("recurrent")
    if hasattr(model, "encode") and getattr(model, "enc_len", None) \
            and any(b.cross for b in blocks):
        kinds.append("cross")
    return tuple(kinds)


def _bytes_where(cache, pred, keys=None) -> int:
    """Storage bytes of the tensor leaves of the cache nodes matching
    ``pred`` (only those under ``keys``, if given)."""
    total = 0

    def rec(node):
        nonlocal total
        if pred(node):
            total += sum(v.numel() * v.element_size() for k, v in node.items()
                         if isinstance(v, torch.Tensor) and (keys is None or k in keys))
        elif isinstance(node, dict) and not (_is_kv(node) or _is_xkv(node)
                                             or _is_recurrent(node)):
            for v in node.values():
                rec(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                rec(v)

    rec(cache)
    return total


def state_bytes_per_slot(cache, slots: int) -> Dict[str, int]:
    """Per-slot device bytes of each state kind in ``cache`` (a ``device="meta"``
    cache will do): recurrent rows are constant in sequence length, KV
    slabs grow with ``max_len``, cross-attention rows with ``enc_len``."""
    n = max(slots, 1)
    return {"kv": _bytes_where(cache, _is_kv) // n,
            "recurrent": _bytes_where(cache, _is_recurrent) // n,
            "cross": _bytes_where(cache, _is_xkv) // n}


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


class RecurrentState(SlotState):
    """Fixed-size recurrence rows (Mamba, RWKV-6): constant bytes per slot.
    Admission writes the whole row (a one-shot scatter, or the mixers'
    ``chunk`` path), eviction zeroes it, batched steps run under
    :func:`merge_inactive`; preemption is recompute only."""

    kind = "recurrent"

    def audit_check(self, cache, live: Dict[int, int]) -> None:
        """Dead slots' rows must be exactly zero (inert)."""
        from repro_torch.serve.audit import check_recurrent_rows

        check_recurrent_rows(cache, set(live))


class CrossAttnState(SlotState):
    """Per-slot projected cross-attention K/V (EncDec serving): written once
    per admission (``EncDecLM.write_cross_kv``) and read by every step, in
    place of re-projecting the encoder output each tick.  Eviction sets
    ``xlen`` to 0; the rows are overwritten by the next admission."""

    kind = "cross"

    def audit_check(self, cache, live: Dict[int, int]) -> None:
        """Live slots' ``xlen`` must equal their encoder length; dead 0."""
        from repro_torch.serve.audit import check_cross_lens

        check_cross_lens(cache, live)


def adapters_for(model, *, paged: bool = False,
                 cross_attn_cache: bool = True) -> Tuple[Any, ...]:
    """The adapter set a scheduler composes for ``model``: ``paged`` picks
    :class:`PagedKVState` for the ``"kv"`` kind, and ``cross_attn_cache=False``
    drops :class:`CrossAttnState` (the engine re-projects the encoder output
    every step)."""
    out: List[Any] = []
    for kind in state_kinds(model):
        if kind == "kv":
            out.append(PagedKVState() if paged else DenseKVState())
        elif kind == "recurrent":
            out.append(RecurrentState())
        elif cross_attn_cache:
            out.append(CrossAttnState())
    return tuple(out)

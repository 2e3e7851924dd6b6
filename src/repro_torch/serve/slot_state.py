"""Per-slot decode-state adapters (``repro/serve/slot_state.py``), for dense
KV caches.

The continuous-batching scheduler manages *slots*; the walkers below apply
one slot lifecycle event (admit a batch-1 prefilled cache, evict) to every
per-layer KV node of a cache tree, so the scheduler never looks inside the
model.  The port serves dense attention models only: paged KV waits for
ROADMAP slice 3, and recurrent (SSM/RWKV) and cross-attention state for
slice 9; a cache node or a model of those kinds raises.
"""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch.nn.attention import reset_kv_slot, write_kv_slot

# leaf keys of the reference's recurrent ({"h", "conv"}, {"s", "shift"}) and
# cross-attention ({"xk", "xv", "xlen"}) state nodes
_OTHER_STATE_KEYS = {"h", "conv", "s", "shift", "xk", "xv", "xlen"}


def _is_kv(node) -> bool:
    return isinstance(node, dict) and "k" in node and "len" in node


def _check_dense_kv(node) -> None:
    if "page_table" in node:
        raise NotImplementedError("paged KV caches wait for ROADMAP slice 3 of the port")


def _walk(big, small, fn):
    """``fn(big_kv, small_kv)`` on every KV node of ``big`` (``small`` is a
    structurally identical tree, or None); the rest is rebuilt as is."""
    if _is_kv(big):
        _check_dense_kv(big)
        return fn(big, small)
    if isinstance(big, dict):
        if _OTHER_STATE_KEYS & set(big):
            raise NotImplementedError("recurrent and cross-attention slot state waits for "
                                      "ROADMAP slice 9 of the port")
        return {k: _walk(v, None if small is None else small[k], fn) for k, v in big.items()}
    if isinstance(big, (list, tuple)):
        return type(big)(_walk(v, None if small is None else small[i], fn)
                         for i, v in enumerate(big))
    return big


def admit_cache_slot(big_cache, small_cache, slot: int, length: int):
    """Copy a batch-1 prefilled cache into ``slot`` of the per-slot cache
    (one-shot admission) and set the slot's live length to ``length``."""
    return _walk(big_cache, small_cache, lambda b, s: write_kv_slot(b, s, slot, length))


def evict_cache_slot(cache, slot: int):
    """O(1) eviction of ``slot``: its live length goes to 0, rows stay."""
    return _walk(cache, None, lambda kv, _: reset_kv_slot(kv, slot))


def state_kinds(model) -> Tuple[str, ...]:
    """The per-slot state kinds ``model`` serves with: ``("kv",)`` for the
    dense attention models the port builds."""
    if hasattr(model, "encode") or any(getattr(b, "mixer", "attn") != "attn"
                                       for b in model.stack.body):
        raise NotImplementedError("recurrent and cross-attention models wait for ROADMAP "
                                  "slice 9 of the port")
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


class DenseKVState(SlotState):
    """Dense per-slot K/V slabs with a per-slot ``len`` vector."""

    kind = "kv"


def adapters_for(model, *, paged: bool = False) -> Tuple[Any, ...]:
    """The adapter set a scheduler composes for ``model``."""
    if paged:
        raise NotImplementedError("paged KV caches wait for ROADMAP slice 3 of the port")
    return tuple(DenseKVState() for _ in state_kinds(model))

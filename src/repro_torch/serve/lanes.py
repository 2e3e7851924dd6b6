"""Ragged-tick lane assembly (``repro/serve/lanes.py``): flatten decode
slots + prefill lanes to host metadata for the one-forward-per-tick ragged
step.

The ragged step (serve/engine.py ``make_ragged_step``) takes per-token
addressing — slot ids, logical positions, per-lane chunk tokens, and the
logit rows to sample — instead of the mixed step's scalar chunk metadata.
Building those vectors from the scheduler's live slots and admission lanes
is pure host bookkeeping with a token-budget split; this module owns it so
the serving loop stays policy-only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.admission import PrefillLane
from repro_torch.serve.slot_state import SlotShard


@dataclasses.dataclass
class RaggedTick:
    """One tick's assembled ragged-step metadata (host numpy, pre-device).

    ``sids``/``poss`` address every flattened token: token ``t`` is logical
    row ``poss[t]`` of slot ``sids[t]``; position -1 marks inert padding
    (idle decode slots, lane tails).  ``ctok`` is the (L, C) per-lane chunk
    token block; ``lrows`` the (B + L,) logit rows the step samples.
    ``ran`` lists (lane index, chunk length) for the lanes that carried
    tokens this tick; ``stalled`` counts lanes deferred by the token budget.
    """

    sids: np.ndarray             # (B + L*C,) int32 slot id per token
    poss: np.ndarray             # (B + L*C,) int32 position per token (-1 inert)
    ctok: np.ndarray             # (L, C) int32 chunk tokens (pad-filled)
    lrows: np.ndarray            # (B + L,) int32 logit rows to sample
    ran: List[Tuple[int, int]]   # (lane index, clen) lanes that ran
    stalled: int                 # lanes deferred under token_budget


def assemble_ragged_tick(slots: Sequence, lanes: Sequence[PrefillLane], *,
                         nslots: int, n_lanes: int, chunk: int, pad_id: int,
                         token_budget: Optional[int], n_active: int,
                         assert_private: Optional[Callable[[int, int, int],
                                                           None]] = None,
                         ) -> RaggedTick:
    """Build one tick's :class:`RaggedTick` from live slots and lanes.

    Decode rows: every live slot consumes its last sampled token and writes
    K/V at its next free row (``plen + emitted - 1``); idle slots are inert.
    Lane rows: the token budget (minus live decode tokens) splits over the
    lanes in admission order — older lanes drain first, younger lanes take
    the remainder; a lane granted no room this tick counts as ``stalled``
    (decode tokens are never dropped).  ``assert_private(slot, lo, hi)``,
    when given, runs per lane over its valid write rows — the paged
    shared-mapping invariant (serve/admission.py ``assert_private_write``).
    """
    L, C = n_lanes, chunk
    sids = np.zeros((nslots + L * C,), np.int32)
    poss = np.full((nslots + L * C,), -1, np.int32)
    ctok = np.full((L, C), pad_id, np.int32)
    lrows = np.full((nslots + L,), 0, np.int32)
    lrows[:nslots] = np.arange(nslots)
    for j, s in enumerate(slots):
        if s is not None:
            sids[j] = j
            # this tick consumes tok[j] (the slot's last sampled token) and
            # writes its K/V at the next free row
            poss[j] = s.plen + s.emitted - 1
    # split the token budget over the lanes in admission order: older lanes
    # drain first, younger lanes take the remainder
    avail = None if token_budget is None \
        else max(0, token_budget - n_active)
    ran: List[Tuple[int, int]] = []
    stalled = 0
    for li, p in enumerate(lanes):
        base = nslots + li * C
        lrows[nslots + li] = base
        room = int(p.prompt.shape[0]) - p.next_start
        clen = min(C, room) if avail is None else min(C, room, avail)
        if clen <= 0:
            stalled += 1                        # decode never waits
            continue
        if avail is not None:
            avail -= clen
        start = p.next_start
        ctok[li, :clen] = p.prompt[start:start + clen]
        sids[base:base + clen] = p.slot
        poss[base:base + clen] = np.arange(start, start + clen)
        lrows[nslots + li] = base + clen - 1
        if assert_private is not None:
            # ragged lanes write exactly their clen valid rows (pads are
            # inert): none may go through a shared mapping (COW ran at
            # admission)
            assert_private(p.slot, start, start + clen)
        ran.append((li, clen))
    return RaggedTick(sids=sids, poss=poss, ctok=ctok, lrows=lrows,
                      ran=ran, stalled=stalled)


@dataclasses.dataclass
class LocalTick:
    """One data rank's share of a ragged tick under a mesh (host numpy).

    ``meta`` addresses this rank's flat batch of n + L*C tokens: its n
    slots' decode rows (local slot ids) and every lane's C rows, live for
    the lanes whose slot it holds and inert for the rest, so every rank's
    batch has one shape.  ``select`` (B + L*C,) picks the one device's flat
    batch out of every rank's gathered over ``data`` (decode rows in slot
    order, each lane's rows from its owner, an empty lane's from rank 0's
    inert rows); ``take`` (n + L*C,) maps this rank's rows back into it;
    ``owners`` (L,) is the data rank that holds each lane's slot (0 for an
    empty lane).  ``meta.lrows`` keeps each lane's sampled row at its
    offset in the lane, and an empty lane's at row 0, as the one device's
    tick does (``nn/module.py`` ``DataRows``; ``serve/engine.py``
    ``make_ragged_step``).  ``sampled`` (n + L,) are this rank's sampled
    rows (its slots' decode rows, then every lane's) among the whole
    tick's B + L: the rows of the audit's poison vector it takes (a NaN on
    another rank's slot is nothing here); their health flags come back
    whole with the tick's gather."""

    meta: RaggedTick
    select: np.ndarray
    take: np.ndarray
    owners: np.ndarray
    sampled: np.ndarray


def localize_ragged_tick(rt: RaggedTick, lane_slots: Sequence[int], shard: SlotShard, *,
                         nslots: int, n_lanes: int, chunk: int, pad_id: int) -> LocalTick:
    """:class:`LocalTick` of ``shard.rank`` from the whole tick ``rt``
    (:func:`assemble_ragged_tick`) and the slots of its lanes, in order."""
    B, L, C = nslots, n_lanes, chunk
    n, d = shard.per_rank, shard.rank
    lo, t_l = d * n, n + L * C
    sids = np.zeros(t_l, np.int32)
    poss = np.full(t_l, -1, np.int32)
    ctok = np.full((L, C), pad_id, np.int32)
    lrows = np.zeros(n + L, np.int32)
    lrows[:n] = np.arange(n)
    dec = rt.poss[lo:lo + n]
    sids[:n] = np.where(dec >= 0, rt.sids[lo:lo + n] - lo, 0)
    poss[:n] = dec
    owners = np.zeros(L, np.int32)
    for li, slot in enumerate(lane_slots):
        base_g, base_l = B + li * C, n + li * C
        lrows[n + li] = base_l + rt.lrows[B + li] - base_g
        owners[li] = shard.owner(slot)
        if owners[li] == d:
            seg = rt.poss[base_g:base_g + C]
            sids[base_l:base_l + C] = np.where(seg >= 0, rt.sids[base_g:base_g + C] - lo, 0)
            poss[base_l:base_l + C] = seg
            ctok[li] = rt.ctok[li]
    lane_rows = np.arange(C)
    select = np.concatenate(
        [r * t_l + np.arange(n) for r in range(B // n)]
        + [owners[li] * t_l + n + li * C + lane_rows for li in range(L)]).astype(np.int32)
    take = np.concatenate([lo + np.arange(n), B + np.arange(L * C)]).astype(np.int32)
    return LocalTick(meta=RaggedTick(sids=sids, poss=poss, ctok=ctok, lrows=lrows, ran=rt.ran,
                                     stalled=rt.stalled),
                     select=select, take=take, owners=owners,
                     sampled=np.concatenate([lo + np.arange(n),
                                             B + np.arange(L)]).astype(np.int32))

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

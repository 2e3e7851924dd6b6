"""The split of ``csrc/attn_split.cuh``: how many blocks of a thread-block
cluster share one walk over a slot's positions in ``qpaged_decode_attn``
and ``qragged_attn``.

A walk is cut into tiles of :func:`tile` positions, and rank r of R takes
tiles [r n / R, (r + 1) n / R) of the n tiles the walk has.  R is chosen
here, from shapes alone (the table's reach ``max_pages * ps``, the number
of walks B or T, Hkv and the head dimension), never from ``kv_len`` or
``positions``, which live on the card: a call reads nothing back and is
safe under CUDA-graph capture.

The rule and the figures that chose it (``chip_smoke.py``'s shapes: D=64,
Hkv=3, ps 16; NVIDIA H100 80GB HBM3, 700 W; µs per call from CUDA graphs,
R = 1 / 2 / 4 / 8, side-by-side builds in one A/B run; PERF.md, §6):

- decode, B=8, S=2048 (32 tiles, 24 walks): 38.3 / 21.6 / 13.1 / 10.0;
- decode, B=8, S=192 (3 tiles): 7.3 / 6.7, and 5.9 / 7.1 with ranks that
  are always empty;
- ragged tick, T=72, S=2048 (216 walks): 44.5 / 26.1 / 30.6 / 55.4;
- ragged tick, T=72, S=192: 10.7 / 16.4 / 29.7 / 52.8; at page size 5
  (195 positions, 4 tiles) 16.2 at R = 2 against 10.2-10.8 at R = 1 for
  page sizes 1 and 16 (``chip_smoke.py``).

A cluster holds its R blocks until its longest rank ends, and a block of
the serving instantiation takes half an SM (128 registers a thread), so
more ranks shorten the longest walk but add waves of blocks.  R (at most
one rank per tile of a walk to the table's end, so none is empty there)
minimises the tiles of the longest rank plus ``WAVE_TILES`` per wave of
``2 * SMS`` blocks, the smallest R on a tie; ``WAVE_TILES`` = 5 fits every
figure above (the linear fit of the S=2048 ragged tick alone gives 2, and
then picks R = 4, which lost).
"""
from __future__ import annotations

import math

MAX_RANKS = 8       # the portable cluster size
WARPS = 8           # warps per block, each walking its own positions of a tile
SMS = 132           # H100 SXM streaming multiprocessors
WAVE = 2 * SMS      # blocks resident at once: two a SM
WAVE_TILES = 5      # what one more wave of blocks costs, in tiles of one walk


def tile(d: int) -> int:
    """Positions per tile: 8 warps of 8 positions (16 at D = 16, where 16
    groups of 2 lanes share a warp; 4 at D = 128)."""
    return WARPS * (16 if d == 16 else 4 if d == 128 else 8)


def split_ranks(walk: int, walks: int, hkv: int, d: int) -> int:
    """Ranks R (1, 2, 4 or 8) that share each walk of a launch of ``walks``
    (B slots or T tokens) x ``hkv`` walks of up to ``walk`` =
    ``max_pages * ps`` positions at head dimension ``d``."""
    if walk < 1 or walks < 1 or hkv < 1 or d < 1:
        raise ValueError(f"attn_split: no split for {walks} x {hkv} walks of {walk} at D={d}")
    tiles = math.ceil(walk / tile(d))

    def cost(r: int) -> int:
        return math.ceil(tiles / r) + WAVE_TILES * math.ceil(walks * hkv * r / WAVE)

    return min((r for r in (1, 2, 4, MAX_RANKS) if r <= tiles), key=cost)

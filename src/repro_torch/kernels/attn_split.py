"""The splits of ``csrc/attn_split.cuh`` and ``csrc/chunk_split.cuh``: how
many blocks of a thread-block cluster share one walk over a slot's
positions in ``qdecode_attn``, ``qpaged_decode_attn`` and ``qragged_attn``
(:func:`split_ranks`), and in ``qchunk_attn`` and ``qpaged_chunk_attn``
(:func:`chunk_tiles`, :func:`chunk_ranks`).

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


CHUNK_TILE = 64      # positions per tile of the chunk core
CHUNK_QUERIES = 32   # queries per query tile: two m16 slabs


def chunk_tiles(c: int, g: int) -> tuple:
    """(query tiles, rows per tile) of a chunk of ``c`` rows at ``g`` query
    heads per KV head: as few tiles of at most :data:`CHUNK_QUERIES`
    queries (whole rows times their heads) as ``g`` allows, the rows spread
    evenly over them (``chunk_split::query_rows``)."""
    most = CHUNK_QUERIES // g
    tiles = math.ceil(c / most)
    rows = math.ceil(c / tiles)
    return math.ceil(c / rows), rows


def chunk_ranks(walk: int, tiles: int, hkv: int, d: int) -> int:
    """Ranks R (1, 2, 4 or 8) that share the prefix of each (query tile,
    KV head) of a chunk launch of ``tiles`` query tiles x ``hkv`` heads
    over a table that reaches ``walk`` = ``max_pages * ps`` positions (S
    for a dense cache) at head dimension ``d``.

    Shapes alone: never ``start``, which the paged entry may read on the
    card, so a call reads nothing back and is safe under CUDA-graph
    capture.  R has at most one rank per :data:`CHUNK_TILE` positions of
    the reach (none is empty at the table's end) and minimises the tiles
    of the longest rank plus ``WAVE_TILES`` per wave of ``SMS`` blocks,
    the smallest R on a tie, as :func:`split_ranks` does.  The figures
    behind it (``chip_smoke.py``'s rank sweep: C=32, G=3, Hkv=3, D=64,
    four query tiles; NVIDIA H100 80GB HBM3, 700 W; µs per call from CUDA
    graphs, R = 1 / 2 / 4 / 8; PERF.md, §6):

    - dense, S=2048, start 1984 (32 tiles): 63.65 / 32.63 / 19.87 / 13.70;
      paged (ps 16): 67.15 / 34.24 / 20.74 / 14.13;
    - dense, S=192, start 160 (3 tiles): 12.62 / 10.09.

    A tile costs one rank about 1.8 µs (the sweep's slope at S=2048), and
    a cluster pays its prologue and fold once, so ranks pay wherever the
    prefix is long.  A chunk early in a long table takes the table's R;
    its later ranks then have no tile.
    """
    if walk < 1 or tiles < 1 or hkv < 1 or d < 1:
        raise ValueError(f"chunk_split: no split for {tiles} x {hkv} tiles over {walk} at D={d}")
    n = math.ceil(walk / CHUNK_TILE)

    def cost(r: int) -> int:
        return math.ceil(n / r) + WAVE_TILES * math.ceil(tiles * hkv * r / SMS)

    return min((r for r in (1, 2, 4, MAX_RANKS) if r <= n), key=cost)

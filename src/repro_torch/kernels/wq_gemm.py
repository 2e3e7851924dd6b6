"""The tiling of ``csrc/wq_gemm.cuh``: the bf16 tensor-core GEMM that
``wq_matmul`` and ``wq4_matmul`` launch, once per call, at every M.

A block owns a ``bm`` x ``BN`` output tile; the ``ranks`` blocks of a
thread-block cluster each sum ``k_per_rank`` rows of K and add their
partial tiles through distributed shared memory.  The plan is made here,
in Python, so that the CPU tests check it; the kernel refuses a plan that
does not cover K in whole steps, one rank each.
"""
from __future__ import annotations

import math
from typing import NamedTuple

SMS = 132                  # H100 SXM streaming multiprocessors
BN, BK = 64, 32            # the kernel's N tile and K step
TILES_M = (16, 32, 64)     # the kernel's M tiles
STAGES = 4                 # the kernel's ring of K steps in flight
MAX_RANKS = 8              # the portable cluster size
TARGET_BLOCKS = 2 * SMS    # about two blocks per SM: one waits on loads while one computes
# Each row of blocks widens the same weight tiles again: past 8 rows a taller
# tile is cheaper.
MAX_M_TILES = 8
SMEM_MAX = 232_448         # shared memory one H100 block can have (227 KB)
_LDS, _RLD = BK + 8, BN + 4   # bf16 plane and f32 partial-tile row strides


class Plan(NamedTuple):
    bm: int           # rows of x per block
    ranks: int        # blocks per cluster, K split between them
    k_per_rank: int   # K rows per rank, a multiple of BK


def tile_plan(m: int, k: int, n: int) -> Plan:
    """The tensor-core tiling of an (M, K) @ (K, N) call.

    The M tile is the smallest that needs at most ``MAX_M_TILES`` rows of
    blocks, or 64; then K is split over up to ``MAX_RANKS`` cluster ranks
    until the launch has about ``TARGET_BLOCKS`` blocks, each rank a whole
    number of K steps and none empty.
    """
    if m < 1 or k < 1 or n < 1:
        raise ValueError(f"wq_gemm: no tiling for M={m}, K={k}, N={n}")
    bm = next((t for t in TILES_M if math.ceil(m / t) <= MAX_M_TILES), TILES_M[-1])
    out_tiles = math.ceil(m / bm) * math.ceil(n / BN)
    steps = math.ceil(k / BK)
    want = max(1, min(MAX_RANKS, steps, math.ceil(TARGET_BLOCKS / out_tiles)))
    per = math.ceil(steps / want)
    return Plan(bm, math.ceil(steps / per), per * BK)


def blocks(plan: Plan, m: int, n: int) -> int:
    """Blocks of the launch (clusters times ranks)."""
    return math.ceil(m / plan.bm) * math.ceil(n / BN) * plan.ranks


def smem_bytes(bm: int, packed: bool) -> int:
    """Dynamic shared memory of one block (``Smem`` in the header): the
    ``STAGES`` staging stages of x and weight bytes (or, over them, the
    partial tile), three bf16 planes of x and one of the codes."""
    stage = bm * BK * 4 + (BK // 2 if packed else BK) * BN
    return max(STAGES * stage, bm * _RLD * 4) + 3 * bm * _LDS * 2 + BN * _LDS * 2

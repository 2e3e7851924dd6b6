"""The tiling of ``csrc/int_mma.cuh``'s integer tensor-core kernels:
``qmm``/``qmm_requant`` (``csrc/qmm.cu``) and ``qconv1d``
(``csrc/qconv1d.cu``), one launch per call.

The plans are made here, in Python, so that the CPU tests check them (and
an int64 emulation of the kernels walks them); each kernel refuses a plan
that does not fit its call.

- ``qmm``: a block owns a ``bm`` x ``QMM_BN`` output tile and walks K in
  steps of 64 bytes per row; where the output tiles would not fill the
  card, the ``ranks`` blocks of a thread-block cluster each sum
  ``k_per_rank`` rows of K and add their partial tiles through distributed
  shared memory.
- ``qconv1d``: a block owns ``conv_bm`` GEMM rows (output positions) as
  ``segs`` segments of ``seg_len`` positions and ``8 * nf`` filters, and
  walks the taps in chunks of ``kc`` and the (16-padded) channels in
  chunks of ``cc`` where one chunk of all of them would pass the shared
  memory budget.
"""
from __future__ import annotations

import math
from typing import NamedTuple

from repro_torch.kernels.wq_gemm import MAX_RANKS, SMEM_MAX, SMS, TARGET_BLOCKS

QMM_BN = 64                                           # the qmm kernel's N tile
QMM_TILES_M = {1: (16, 32, 64, 128), 2: (16, 32, 64)}   # its M tiles, by code bytes
QMM_STAGES = 4                   # its ring of K steps in flight
_ROW_BYTES = 64                  # bytes of a row of x per K step

CONV_NF = (4, 10)                # n8 fragments of the qconv1d kernel's filter tile: 32 or 80
CONV_SMEM_BUDGET = 64 << 10      # dynamic shared memory a qconv1d block stages at most


def pitch(nbytes: int) -> int:
    """Bytes of a shared plane row holding ``nbytes`` of the reduction: an
    odd multiple of 16, so 8 consecutive rows lie in distinct bank groups
    (``int_mma::pitch``)."""
    g = -(-nbytes // 16)
    return 16 * (g if g % 2 else g + 1)


# ---- qmm ------------------------------------------------------------------------

class QmmPlan(NamedTuple):
    bm: int           # rows of x per block
    ranks: int        # blocks per cluster, K split between them
    k_per_rank: int   # K rows per rank, a multiple of qmm_bk


def qmm_bk(elem_bytes: int) -> int:
    """K rows per step: 64 int8 or 32 int16 codes (64 bytes)."""
    return _ROW_BYTES // elem_bytes


def qmm_plan(m: int, k: int, n: int, elem_bytes: int) -> QmmPlan:
    """The tiling of an (M, K) @ (K, N) call with ``elem_bytes``-byte codes.

    The M tile is the largest that still gives ``SMS`` output tiles, or 16;
    where the tiles are fewer than ``SMS``, K is split over up to
    ``MAX_RANKS`` cluster ranks until the launch has about
    ``TARGET_BLOCKS`` blocks, each rank a whole number of K steps and none
    empty.
    """
    if m < 1 or k < 0 or n < 1 or elem_bytes not in (1, 2):
        raise ValueError(f"qmm: no tiling for M={m}, K={k}, N={n}, {elem_bytes}-byte codes")
    bk = qmm_bk(elem_bytes)
    cols = math.ceil(n / QMM_BN)
    tiles_m = QMM_TILES_M[elem_bytes]
    bm = next((t for t in reversed(tiles_m) if math.ceil(m / t) * cols >= SMS), tiles_m[0])
    tiles = math.ceil(m / bm) * cols
    steps = math.ceil(k / bk)
    if steps == 0 or tiles >= SMS:
        return QmmPlan(bm, 1, max(1, steps) * bk)
    want = max(1, min(MAX_RANKS, steps, math.ceil(TARGET_BLOCKS / tiles)))
    per = math.ceil(steps / want)
    return QmmPlan(bm, math.ceil(steps / per), per * bk)


def qmm_blocks(plan: QmmPlan, m: int, n: int) -> int:
    """Blocks of the launch (clusters times ranks)."""
    return math.ceil(m / plan.bm) * math.ceil(n / QMM_BN) * plan.ranks


def qmm_smem(bm: int, elem_bytes: int) -> int:
    """Dynamic shared memory of one qmm block (``Smem`` in ``qmm.cu``): the
    ring of raw x and w steps (or, over it, the partial int32 tile), the
    int16 x planes and the weight planes."""
    bk = qmm_bk(elem_bytes)
    planes = 2 if elem_bytes == 2 else 1
    ring = QMM_STAGES * (bm * pitch(_ROW_BYTES) + bk * QMM_BN * elem_bytes)
    red = bm * (QMM_BN + 4) * 4
    ap = 2 * bm * pitch(bk) if elem_bytes == 2 else 16
    return max(ring, red) + ap + planes * QMM_BN * pitch(bk)


# ---- qconv1d --------------------------------------------------------------------

class ConvPlan(NamedTuple):
    nf: int        # n8 fragments of the filter tile (8 * nf filters a block)
    seg_len: int   # output positions per segment
    segs: int      # segments per block (seg_len * segs <= conv_bm)
    kc: int        # taps per chunk
    cc: int        # channels per chunk, a multiple of 16


def conv_bm(elem_bytes: int) -> int:
    """GEMM rows (output positions) per qconv1d block: 128 int8, 64 int16."""
    return 128 if elem_bytes == 1 else 64


def conv_smem(plan: ConvPlan, stride: int, elem_bytes: int) -> int:
    """Dynamic shared memory of one qconv1d block (``smem_bytes`` in
    ``qconv1d.cu``): each segment's input rows and the weights, one byte
    plane each for int8, two (hi, lo) for int16."""
    rows = (plan.seg_len - 1) * stride + plan.kc
    planes = 2 if elem_bytes == 2 else 1
    return planes * (plan.segs * rows * pitch(plan.cc) + 8 * plan.nf * pitch(plan.kc * plan.cc))


def conv_plan(b: int, c: int, k: int, f: int, wout: int, stride: int,
              elem_bytes: int) -> ConvPlan:
    """The tiling of a (B, W, C) * (K, C, F) convolution with ``wout``
    output positions a batch row.

    Filters: 32 a block up to F = 32, else 80 (ResNetv1-6's width).  Rows:
    whole batch rows while W' fits the block's GEMM rows (no more segments
    than the call has), else tiles of one batch row.  Then all taps and
    channels in one chunk if they fit ``CONV_SMEM_BUDGET``; else all taps
    unless one 16-channel slice of them would not fit (halving until it
    does), and as many 16-channel groups a chunk as fit; positions per
    segment are halved only where even one tap of 16 channels would not
    fit (a stride far above the taps).
    """
    if min(b, c, k, f, wout, stride) < 1 or elem_bytes not in (1, 2):
        raise ValueError(f"qconv1d: no tiling for B={b}, C={c}, K={k}, F={f}, W'={wout}, "
                         f"stride {stride}, {elem_bytes}-byte codes")
    bm = conv_bm(elem_bytes)
    nf = CONV_NF[0] if f <= 8 * CONV_NF[0] else CONV_NF[1]
    seg_len = min(wout, bm)
    cp = -(-c // 16) * 16

    def plan(sl, kc, cc):
        return ConvPlan(nf, sl, min(bm // sl, b * math.ceil(wout / sl)), kc, cc)

    def fits(p):
        return conv_smem(p, stride, elem_bytes) <= CONV_SMEM_BUDGET

    while seg_len > 1 and not fits(plan(seg_len, 1, 16)):
        seg_len = -(-seg_len // 2)
    if fits(plan(seg_len, k, cp)):
        return plan(seg_len, k, cp)
    kc = k
    while kc > 1 and not fits(plan(seg_len, kc, 16)):
        kc = -(-kc // 2)
    groups = 1
    while groups * 16 < cp and fits(plan(seg_len, kc, (groups + 1) * 16)):
        groups += 1
    return plan(seg_len, kc, groups * 16)


def conv_blocks(plan: ConvPlan, b: int, f: int, wout: int) -> int:
    """Blocks of the launch."""
    segments = b * math.ceil(wout / plan.seg_len)
    return math.ceil(segments / plan.segs) * math.ceil(f / (8 * plan.nf))

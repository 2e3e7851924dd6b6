"""The arithmetic and the planners of the integer tensor-core kernels
(``src/repro_torch/kernels/csrc/int_mma.cuh``, included by ``qmm.cu`` and
``qconv1d.cu``), on the CPU:

- the int16 byte split a = 256 * hi + lo (hi signed, lo unsigned) is exact,
  and its four 8-bit products, each wrapped to int32 on its own and
  combined as (hh << 16) + (mixed << 8) + ll modulo 2^32, give the plain
  ``qmm`` and repro's interpret-mode Pallas kernel, at the extreme codes
  and where the sums pass int32;
- a tile-by-tile int64 emulation of each kernel, driven by its planner
  (staged tiles masked at every edge, one wrapping sum per 32- or 16-deep
  product, ``qmm``'s split K summed over cluster ranks in rank order,
  ``qconv1d``'s per-lane row ``s * rows + p * stride + k`` over segments
  of several batch rows, its halo masks and channel padding, chunks of taps
  and channels), equals the plain versions and interpret-mode Pallas;
- the planners cover K (and every (tap, channel) pair) once, use clusters
  of at most 8, fit a block's shared memory, and fill the card at the
  ``chip_smoke.py`` shapes where K allows;
- the build hash covers the shared header.

The kernels themselves run only on the card (``chip_smoke.py`` and the
``cuda``-marked tests of ``test_torch_integer_kernels.py``).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.qconv1d import qconv1d_pallas
from repro.kernels.qmm import qmm_pallas
from repro_torch.kernels import _build, int_mma, ref

torch.set_num_threads(2)
_NP = {1: np.int8, 2: np.int16}
# ResNetv1-6 at filters 80 on UCI-HAR windows (chip_smoke.py's integer engine)
PATH_BATCH, FILTERS = 2947, 80
CONV_SHAPES = {"conv1": (128, 9, 3), "conv2/3": (128, FILTERS, 3),
               "short1": (128, FILTERS, 1), "conv4/5": (32, FILTERS, 3)}   # (W, C, K), SAME
QMM_SHAPES = {"classifier": (PATH_BATCH, FILTERS, 6), "4096^3": (4096, 4096, 4096),
              "odd": (100, 300, 50), "int16 overflow": (128, 512, 128),
              "wrap": (16, 196608, 8)}


def _codes(rng, shape, nbytes):
    info = np.iinfo(_NP[nbytes])
    return rng.integers(info.min, info.max + 1, shape).astype(_NP[nbytes])


def _extreme(rng, shape):
    """int16 codes at and next to both ends of the range, and around 0."""
    return rng.choice(np.array([-32768, -32767, -256, -1, 0, 1, 255, 256, 32767],
                               dtype=np.int16), shape)


def wrap32(v):
    """int64 values modulo 2^32 as int32 values (still int64)."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def split16(a):
    """The kernels' byte split of int16 codes: hi = a >> 8 (a signed byte),
    lo = a & 0xFF (an unsigned byte), as int64."""
    a = a.astype(np.int64)
    return a >> 8, a & 0xFF


def planes(codes, nbytes):
    """The byte planes a tile is staged into: the int8 codes, or int16's hi
    and lo bytes."""
    return [codes.astype(np.int64)] if nbytes == 1 else list(split16(codes))


def mma(acc, a, b):
    """One tensor-core product into the accumulators, each wrapping modulo
    2^32 on its own: a (rows, depth) and b (cols, depth) per plane; int8
    one accumulator, int16 three (hh, mixed = hi*lo + lo*hi, ll)."""
    if len(a) == 1:
        acc[0] = wrap32(acc[0] + a[0] @ b[0].T)
        return
    (ah, al), (bh, bl) = a, b
    acc[0] = wrap32(acc[0] + ah @ bh.T)
    acc[1] = wrap32(wrap32(acc[1] + ah @ bl.T) + al @ bh.T)
    acc[2] = wrap32(acc[2] + al @ bl.T)


def combine(acc):
    """The epilogue: (hh << 16) + (mixed << 8) + ll in unsigned 32 bits."""
    if len(acc) == 1:
        return acc[0] & 0xFFFFFFFF
    hh, mixed, ll = (a & 0xFFFFFFFF for a in acc)
    return ((hh << 16) + (mixed << 8) + ll) & 0xFFFFFFFF


def emulate_qmm(x, w):
    """``qmm.cu`` tile by tile under ``qmm_plan``: per (M tile, N tile),
    each cluster rank walks its K range in 64-byte steps of staged tiles
    (zero past M, N and the rank's end), one wrapping product per 32 codes
    (skipped past the rank's end); the ranks' partial tiles add in rank
    order in unsigned 32 bits."""
    nbytes = x.dtype.itemsize
    m, k = x.shape
    n = w.shape[1]
    plan = int_mma.qmm_plan(m, k, n, nbytes)
    bk, bn, bm = int_mma.qmm_bk(nbytes), int_mma.QMM_BN, plan.bm
    out = np.zeros((m, n), np.int64)
    for m0 in range(0, m, bm):
        rows = min(bm, m - m0)
        for n0 in range(0, n, bn):
            cols = min(bn, n - n0)
            total = np.zeros((bm, bn), np.int64)
            for rank in range(plan.ranks):
                kbeg = rank * plan.k_per_rank
                kend = min(k, kbeg + plan.k_per_rank)
                acc = [np.zeros((bm, bn), np.int64) for _ in range(1 if nbytes == 1 else 3)]
                for k0 in range(kbeg, kend, bk):
                    depth = min(bk, kend - k0)
                    xt = np.zeros((bm, bk), x.dtype)
                    wt = np.zeros((bk, bn), w.dtype)
                    xt[:rows, :depth] = x[m0:m0 + rows, k0:k0 + depth]
                    wt[:depth, :cols] = w[k0:k0 + depth, n0:n0 + cols]
                    a, b = planes(xt, nbytes), planes(wt.T, nbytes)   # [m][k], [n][k]
                    for kk in range(0, bk, 32):
                        if k0 + kk >= kend:
                            break
                        mma(acc, [p[:, kk:kk + 32] for p in a], [p[:, kk:kk + 32] for p in b])
                total = (total + combine(acc)) & 0xFFFFFFFF
            out[m0:m0 + rows, n0:n0 + cols] = total[:rows, :cols]
    return wrap32(out).astype(np.int32)


def emulate_qconv1d(x, w, stride, padding):
    """``qconv1d.cu`` tile by tile under ``conv_plan``: a block's GEMM rows
    are ``segs`` segments of ``seg_len`` output positions (segment gs =
    block * segs + s is tile gs % wt of batch row gs // wt); per chunk of
    taps and 16-padded channels it stages each segment's input rows (row r
    holds input position tile * seg_len * stride - pad_lo + k0 + r, 0 past
    the row's ends, the batch and C) and the weights as [f][k * cc + c]
    bytes; for tap k, GEMM row m reads shared row s * rows + p * stride + k
    (rows past the segments read row k); per tap one wrapping product per
    32 channels and one for a 16-deep rest."""
    nbytes = x.dtype.itemsize
    bsz, width, c = x.shape
    ksz, _, f = w.shape
    pad_lo, _, wout = ref.conv_pads(width, ksz, stride, padding)
    plan = int_mma.conv_plan(bsz, c, ksz, f, wout, stride, nbytes)
    bm, bn = int_mma.conv_bm(nbytes), 8 * plan.nf
    sl, segs, kc, cc = plan.seg_len, plan.segs, plan.kc, plan.cc
    sr = (sl - 1) * stride + kc
    wt = math.ceil(wout / sl)
    cp = -(-c // 16) * 16
    m = np.arange(bm)
    seg, p = m // sl, m % sl
    a_row = np.where(seg < segs, seg * sr + p * stride, 0)
    xpad = np.zeros((bsz + 1, width, cp + cc), x.dtype)   # one spare batch row of zeros
    xpad[:bsz, :, :c] = x
    wpad = np.zeros((ksz, cp + cc, f + bn), w.dtype)
    wpad[:, :c, :f] = w
    out = np.zeros((bsz, wout, f), np.int64)
    for bx in range(math.ceil(bsz * wt / segs)):
        gs = bx * segs + np.arange(segs)
        bs, tiles = np.minimum(gs // wt, bsz), gs % wt   # past the batch: the zero row
        for f0 in range(0, f, bn):
            acc = [np.zeros((bm, bn), np.int64) for _ in range(1 if nbytes == 1 else 3)]
            for k0 in range(0, ksz, kc):
                for c0 in range(0, cp, cc):
                    kn, cn = min(kc, ksz - k0), min(cc, cp - c0)
                    rows = (sl - 1) * stride + kn
                    xs = np.zeros((segs * sr, cn), x.dtype)
                    for s in range(segs):
                        pos = tiles[s] * sl * stride - pad_lo + k0 + np.arange(rows)
                        ok = (pos >= 0) & (pos < width)
                        xs[s * sr + np.flatnonzero(ok)] = xpad[bs[s], pos[ok], c0:c0 + cn]
                    ws = wpad[k0:k0 + kn, c0:c0 + cn, f0:f0 + bn].transpose(2, 0, 1)  # [f][k][c]
                    a_pl, b_pl = planes(xs, nbytes), planes(ws, nbytes)
                    for k in range(kn):
                        a = [pl[a_row + k] for pl in a_pl]
                        b = [pl[:, k] for pl in b_pl]
                        cb = 0
                        while cb + 32 <= cn:
                            mma(acc, [t[:, cb:cb + 32] for t in a], [t[:, cb:cb + 32] for t in b])
                            cb += 32
                        if cb < cn:
                            mma(acc, [t[:, cb:cn] for t in a], [t[:, cb:cn] for t in b])
            vals = combine(acc)
            for row in range(bm):
                s = row // sl
                if s >= segs or gs[s] // wt >= bsz:
                    continue
                wo = tiles[s] * sl + row % sl
                if wo < wout:
                    cols = min(bn, f - f0)
                    out[gs[s] // wt, wo, f0:f0 + cols] = vals[row, :cols]
    return wrap32(out).astype(np.int32)


# ---- the byte split ------------------------------------------------------------------

def test_int16_byte_split_is_exact_at_every_code():
    a = np.arange(-32768, 32768, dtype=np.int64).astype(np.int16)
    hi, lo = split16(a)
    assert hi.min() == -128 and hi.max() == 127 and lo.min() == 0 and lo.max() == 255
    np.testing.assert_array_equal(256 * hi + lo, a.astype(np.int64))
    # the bytes the kernel stages: hi is the code's high byte as s8, lo its low byte
    raw = a.view(np.uint8).reshape(-1, 2)
    np.testing.assert_array_equal(raw[:, 1].view(np.int8), hi)
    np.testing.assert_array_equal(raw[:, 0], lo)


@pytest.mark.parametrize("m,k,n,codes", [(8, 64, 8, "random"), (100, 300, 50, "random"),
                                         (16, 512, 24, "extreme"), (128, 512, 128, "random"),
                                         (32, 96, 16, "min"), (32, 96, 16, "max")])
def test_four_byte_products_give_the_wrapping_int32_dot(m, k, n, codes):
    """Each of hh, hi*lo + lo*hi and ll wrapped to int32 on its own, then
    (hh << 16) + (mixed << 8) + ll modulo 2^32: the plain ``qmm`` and
    interpret-mode Pallas, bit for bit; the full-range K=512 case passes
    int32 (so the wrap is exercised)."""
    rng = np.random.default_rng(m * k + n)
    if codes == "random":
        x, w = _codes(rng, (m, k), 2), _codes(rng, (k, n), 2)
    elif codes == "extreme":
        x, w = _extreme(rng, (m, k)), _extreme(rng, (k, n))
    else:
        v = -32768 if codes == "min" else 32767
        x, w = np.full((m, k), v, np.int16), np.full((k, n), v, np.int16)
    (xh, xl), (wh, wl) = split16(x), split16(w)
    acc = [wrap32(xh @ wh), wrap32(wrap32(xh @ wl) + xl @ wh), wrap32(xl @ wl)]
    got = wrap32(combine(acc)).astype(np.int32)
    want = ref.qmm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(qmm_pallas(jnp.asarray(x), jnp.asarray(w), bm=32, bk=32, bn=32,
                                   interpret=True))
    np.testing.assert_array_equal(got, pallas)
    exact = x.astype(np.int64) @ w.astype(np.int64)
    if k >= 512 or codes in ("min", "max"):
        assert (exact != got).any(), "no sum passed int32: the wrap is untested"


# ---- the kernels, tile by tile ----------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(100, 300, 50), (1, 512, 64), (128, 512, 128), (40, 80, 6),
                                   (33, 1000, 70)])
@pytest.mark.parametrize("nbytes", [1, 2])
def test_emulated_qmm_matches_plain_and_pallas(m, k, n, nbytes):
    rng = np.random.default_rng(m + k + n + nbytes)
    x, w = _codes(rng, (m, k), nbytes), _codes(rng, (k, n), nbytes)
    plan = int_mma.qmm_plan(m, k, n, nbytes)
    got = emulate_qmm(x, w)
    want = ref.qmm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(qmm_pallas(jnp.asarray(x), jnp.asarray(w), bm=32, bk=64, bn=32,
                                   interpret=True))
    np.testing.assert_array_equal(got, pallas)
    if (m, k, n) in ((1, 512, 64), (128, 512, 128), (33, 1000, 70)):
        assert plan.ranks > 1, "K is not split: the rank sum is untested"


def test_emulated_qmm_wraps_at_int8_extremes():
    """All codes -128 at (16, 196608) @ (196608, 8), chip_smoke.py's wrap
    case: every sum is 3 * 2^30 and wraps to -2^30, over 8 cluster ranks."""
    x = np.full((16, 196608), -128, np.int8)
    w = np.full((196608, 8), -128, np.int8)
    assert int_mma.qmm_plan(16, 196608, 8, 1).ranks == 8
    got = emulate_qmm(x, w)
    want = ref.qmm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == -(1 << 30)).all()


_CONV_CASES = [(2, 128, 9, 16, 3, 1, "SAME"), (1, 64, 8, 32, 5, 1, "SAME"),
               (3, 128, 16, 24, 3, 2, "SAME"), (2, 50, 4, 8, 3, 1, "VALID"),
               (1, 33, 3, 130, 7, 2, "VALID"), (2, 31, 5, 7, 4, 3, "SAME"),
               (2, 65, 12, 40, 1, 2, "SAME"), (3, 70, 9, 16, 2, 3, "VALID"),
               # ResNetv1-6 at filters 80: conv1 (C=9), conv4/5 (W'=32: 4 batch rows a block)
               (3, 128, 9, 80, 3, 1, "SAME"), (5, 32, 80, 80, 3, 1, "SAME")]


@pytest.mark.parametrize("b,w,c,f,ksize,stride,padding", _CONV_CASES)
@pytest.mark.parametrize("nbytes", [1, 2])
def test_emulated_qconv1d_matches_plain_and_pallas(b, w, c, f, ksize, stride, padding, nbytes):
    rng = np.random.default_rng(b * w + f + nbytes)
    x, wgt = _codes(rng, (b, w, c), nbytes), _codes(rng, (ksize, c, f), nbytes)
    got = emulate_qconv1d(x, wgt, stride, padding)
    want = ref.qconv1d_ref(torch.from_numpy(x), torch.from_numpy(wgt), stride=stride,
                           padding=padding).numpy()
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(qconv1d_pallas(jnp.asarray(x), jnp.asarray(wgt), stride=stride,
                                       padding=padding, bf=64, interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_emulated_qconv1d_walks_chunks_of_taps_and_channels():
    """Past the shared-memory budget: C=1024 int16 at K=7 goes in chunks of
    channels, and an int8 stride far above the taps halves the segment;
    each still equals the plain version."""
    rng = np.random.default_rng(7)
    x, wgt = _codes(rng, (1, 20, 1024), 2), _codes(rng, (7, 1024, 8), 2)
    _, _, wout = ref.conv_pads(20, 7, 1, "SAME")
    plan = int_mma.conv_plan(1, 1024, 7, 8, wout, 1, 2)
    assert plan.cc < 1024
    np.testing.assert_array_equal(emulate_qconv1d(x, wgt, 1, "SAME"), ref.qconv1d_ref(
        torch.from_numpy(x), torch.from_numpy(wgt)).numpy())
    x, wgt = _codes(rng, (2, 5000, 40), 1), _codes(rng, (2, 40, 8), 1)
    _, _, wout = ref.conv_pads(5000, 2, 900, "VALID")
    plan = int_mma.conv_plan(2, 40, 2, 8, wout, 900, 1)
    assert plan.seg_len < wout
    np.testing.assert_array_equal(emulate_qconv1d(x, wgt, 900, "VALID"), ref.qconv1d_ref(
        torch.from_numpy(x), torch.from_numpy(wgt), stride=900, padding="VALID").numpy())


# ---- the planners ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(QMM_SHAPES))
@pytest.mark.parametrize("nbytes", [1, 2])
def test_qmm_planner_covers_k_fills_the_card_and_fits_shared_memory(shape, nbytes):
    """Every K row in exactly one rank (whole steps, none empty), clusters
    of at most 8, a block under 227 KB, and at least 132 blocks unless no
    even split of K over a larger cluster would give more ranks."""
    m, k, n = QMM_SHAPES[shape]
    p = int_mma.qmm_plan(m, k, n, nbytes)
    bk = int_mma.qmm_bk(nbytes)
    assert p.bm in int_mma.QMM_TILES_M[nbytes] and 1 <= p.ranks <= int_mma.MAX_RANKS
    assert p.k_per_rank % bk == 0
    owners = np.zeros(k, int)
    for r in range(p.ranks):
        rows = np.arange(r * p.k_per_rank, min(k, (r + 1) * p.k_per_rank))
        assert rows.size > 0
        owners[rows] += 1
    assert (owners == 1).all()
    assert int_mma.qmm_smem(p.bm, nbytes) <= int_mma.SMEM_MAX
    if int_mma.qmm_blocks(p, m, n) < int_mma.SMS:
        steps = math.ceil(k / bk)
        assert p.bm == int_mma.QMM_TILES_M[nbytes][0]
        for r in range(p.ranks + 1, int_mma.MAX_RANKS + 1):
            assert math.ceil(steps / math.ceil(steps / r)) <= p.ranks


@pytest.mark.parametrize("name", list(CONV_SHAPES))
@pytest.mark.parametrize("nbytes", [1, 2])
def test_conv_planner_fills_the_card_at_resnet_shapes(name, nbytes):
    """One chunk, whole batch rows at W'=32 (4 a block int8, 2 int16), at
    least 132 blocks and a block under the budget."""
    w, c, k = CONV_SHAPES[name]
    p = int_mma.conv_plan(PATH_BATCH, c, k, FILTERS, w, 1, nbytes)
    assert (p.kc, p.cc) == (k, -(-c // 16) * 16)
    assert p.seg_len == min(w, int_mma.conv_bm(nbytes))
    assert p.segs == int_mma.conv_bm(nbytes) // p.seg_len
    assert 8 * p.nf == FILTERS
    assert int_mma.conv_blocks(p, PATH_BATCH, FILTERS, w) >= int_mma.SMS
    assert int_mma.conv_smem(p, 1, nbytes) <= int_mma.CONV_SMEM_BUDGET


@pytest.mark.parametrize("b,w,c,f,ksize,stride,padding", _CONV_CASES + [
    (1, 64, 1024, 8, 7, 1, "SAME"), (1, 4, 65536, 8, 3, 1, "SAME"),
    (2, 5000, 40, 8, 2, 900, "VALID"), (1, 5000, 7, 3, 1, 900, "VALID")])
@pytest.mark.parametrize("nbytes", [1, 2])
def test_conv_planner_covers_every_tap_and_channel_once(b, w, c, f, ksize, stride, padding,
                                                       nbytes):
    _, _, wout = ref.conv_pads(w, ksize, stride, padding)
    p = int_mma.conv_plan(b, c, ksize, f, wout, stride, nbytes)
    assert p.nf in int_mma.CONV_NF and p.cc % 16 == 0 and 1 <= p.kc <= ksize
    assert 1 <= p.segs and p.seg_len * p.segs <= int_mma.conv_bm(nbytes)
    assert int_mma.conv_smem(p, stride, nbytes) <= min(int_mma.CONV_SMEM_BUDGET,
                                                       int_mma.SMEM_MAX)
    cp = -(-c // 16) * 16
    seen = np.zeros((ksize, cp), int)
    for k0 in range(0, ksize, p.kc):
        for c0 in range(0, cp, p.cc):
            seen[k0:k0 + min(p.kc, ksize - k0), c0:c0 + min(p.cc, cp - c0)] += 1
    assert (seen == 1).all()
    # every output position of every batch row in exactly one block's segment
    wt = math.ceil(wout / p.seg_len)
    assert math.ceil(b * wt / p.segs) * p.segs >= b * wt


def test_planners_refuse_empty_calls():
    with pytest.raises(ValueError, match="no tiling"):
        int_mma.qmm_plan(0, 8, 8, 1)
    with pytest.raises(ValueError, match="no tiling"):
        int_mma.conv_plan(1, 8, 3, 8, 0, 1, 1)
    assert int_mma.qmm_plan(4, 0, 8, 1).ranks == 1   # K = 0: zeros, one rank


def test_pitch_is_an_odd_number_of_16_byte_groups():
    for nbytes in range(1, 600):
        p = int_mma.pitch(nbytes)
        assert p >= nbytes and p % 16 == 0 and (p // 16) % 2 == 1 and p - nbytes < 32


@pytest.mark.parametrize("header,users", [
    ("int_mma.cuh", {"qmm", "qconv1d"}),
    ("cp_async.cuh", {"qmm", "qconv1d", "wq_matmul", "wq4_matmul", "qdecode_attn",
                      "qchunk_attn", "qpaged_attn", "qragged_attn"}),   # included by headers
    ("attn_split.cuh", {"qdecode_attn", "qchunk_attn", "qpaged_attn", "qragged_attn"}),
    ("chunk_split.cuh", {"qchunk_attn", "qpaged_attn"})])
def test_library_hash_covers_the_headers_a_source_reaches(tmp_path, monkeypatch, header, users):
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    (tmp_path / header).write_text((tmp_path / header).read_text() + "\n// edit\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    assert {name for name in _build.KERNELS if before[name] != after[name]} == users

"""The chunk core of ``csrc/chunk_split.cuh`` (``qchunk_attn`` and
``qpaged_chunk_attn`` on the card), emulated in torch and held to the plain
versions, to repro's oracles and to repro's Pallas kernels in interpret
mode; and the rules of ``kernels/attn_split.py`` that shape it
(``chunk_tiles``, ``chunk_ranks``).

The emulation below follows the kernel step by step on the CPU (it is used
by nothing else).  A dense cache is a pool of page size S under the
one-entry table row {slot}.  Per (KV head, query tile of ``rows`` chunk rows
times their G heads): rank 0 writes the tile's rows (``quantize``, dropped
on a -1 entry or past the table), and nothing of the launch reads a written
row: a position in [start, start + C), or an unmapped entry's page-0 row
that the chunk writes, takes the chunk's codes, every other position the
pool as it was.  [0, s_end), s_end = min(start + c0 + rows, reach), is cut
into 64-position tiles and rank r of R takes tiles [r n / R, (r + 1) n /
R); in a rank, four streams each take 16 positions of every tile, an online
softmax of its own in base 2: scores Q K^T from q 2^-k_n split into three
bf16 parts (``split3``) against exact codes, the first part apart from the
other two, times sm_scale log2 e; a position at or past the rank's end
scores -inf, one past the query's row -1e30; (m, l) start at (-1e30, 0); P
split into three bf16 parts against V's codes.  Then m goes back to natural
units, acc takes 2^-v_n, the streams fold and then the ranks in order by
exp(m_i - max m), and out = acc / max(l, 1e-30).

Inputs are drawn with numpy from seeds, K/V codes with the spread of
post-norm K/V on the Q4.3 grid.  Outputs are held at rtol 1e-5 / atol 1e-5,
as ``test_torch_attn_split.py`` holds the split walk; pools bit for bit.
repro's Pallas paged kernel is not asked about unmapped entries (its
docstring requires every entry under [0, start + C) to be mapped), so
those cases are held to the plain version and repro's oracle.
"""
import inspect
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as j_ref
from repro.kernels.qchunk_attn import qchunk_attn_pallas
from repro.kernels.qpaged_attn import qpaged_chunk_attn_pallas
from repro_torch.core import qformat
from repro_torch.kernels import attn_split, ref
from test_torch_wq_gemm import split3

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-5
K_N, V_N = 3, 3
TILE = attn_split.CHUNK_TILE
STREAMS, PW = 4, 16          # warps per m16 slab, and each one's positions per tile
LOG2E, LN2 = 1.44269504088896341, 0.693147180559945309


def _post_norm_codes(rng, shape):
    x = np.clip(np.rint(rng.normal(0, 8, shape)), -128, 127).astype(np.int8)
    x.reshape(-1)[::97] = 127
    return x


def _chunk(rng, c, g, hkv, d):
    """Chunk q/k/v as ``test_torch_chunk.py`` draws them: a few values past
    the grid's range, so that codes saturate."""
    q = rng.normal(0, 1, (c, g * hkv, d)).astype(np.float32)
    kc, vc = (rng.normal(0, 1.5, (c, hkv, d)).astype(np.float32) for _ in range(2))
    kc.reshape(-1)[::31] = 9.0
    vc.reshape(-1)[::37] = -9.0
    return q, kc, vc


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------------------------------
# The emulation
# --------------------------------------------------------------------------

def _ranges(s_end, ranks):
    n = -(-s_end // TILE)
    return [(r * n // ranks * TILE, min((r + 1) * n // ranks * TILE, s_end))
            for r in range(ranks)]


def _fold(m, l, acc):
    """Fold partials (N, rows), (N, rows), (N, rows, D) in order."""
    mx = m.amax(0)
    f = torch.exp(m - mx)
    return mx, (l * f).sum(0), (acc * f[..., None]).sum(0)


def _walk(parts, kf, vf, vis, lo, hi, scale2):
    """One rank's streams: (m, l, acc) each (STREAMS, rows, D) in base 2.
    parts: q 2^-k_n in three parts (rows, D); kf, vf: the codes (S', D) of
    positions [0, hi) as f32; vis (rows,): last visible position."""
    rows, d = parts[0].shape
    m = torch.full((STREAMS, rows), -1e30)
    l = torch.zeros(STREAMS, rows)
    acc = torch.zeros(STREAMS, rows, d)
    for t0 in range(lo, hi, TILE):
        for st in range(STREAMS):
            pos = t0 + st * PW + torch.arange(PW)
            k = kf[pos.clamp(max=kf.shape[0] - 1)]
            v = vf[pos.clamp(max=vf.shape[0] - 1)]
            s = (parts[0] @ k.T + (parts[2] @ k.T + parts[1] @ k.T)) * scale2
            s = torch.where(pos[None, :] > vis[:, None], torch.tensor(-1e30), s)
            s = torch.where(pos[None, :] >= hi, torch.tensor(-math.inf), s)
            m_new = torch.maximum(m[st], s.amax(1))
            alpha = torch.exp2(m[st] - m_new)
            p = torch.exp2(s - m_new[:, None])
            l[st] = l[st] * alpha + p.sum(1)
            pp = split3(p)
            acc[st] = acc[st] * alpha[:, None] + (pp[2] @ v + pp[1] @ v + pp[0] @ v)
            m[st] = m_new
    return m, l, acc


def emulate_chunk(q, kc, vc, k_pool, v_pool, trow, start, ranks, writes=None):
    """out (C, Hq, D) of the chunk core, writing the pools in place.
    ``writes`` (Hkv, C) counts the writers of each (head, chunk row)."""
    c, hq, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    g, mp = hq // hkv, len(trow)
    reach = mp * ps
    tiles, rows = attn_split.chunk_tiles(c, g)
    kq, vq = qformat.quantize(kc, K_N, 8), qformat.quantize(vc, V_N, 8)
    k0, v0 = k_pool.clone(), v_pool.clone()       # what every read sees
    scale2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * LOG2E
    v_scale = 2.0 ** -V_N
    out = torch.zeros(c, hq, d)

    def source(pos):
        """chunk row whose codes position pos takes, or -1 (the pool)."""
        e = int(trow[pos // ps])
        if e >= 0:
            return pos - start if start <= pos < start + c else -1
        src = -1
        for lq in range(start // ps, min((start + c - 1) // ps, mp - 1) + 1):
            p2 = lq * ps + pos % ps
            if start <= p2 < start + c and int(trow[lq]) == 0:
                src = p2 - start
        return src

    for h in range(hkv):
        for tile in range(tiles):
            c0 = tile * rows
            n_rows = min(rows, c - c0)
            for cc in range(c0, c0 + n_rows):          # rank 0, the one writer
                pos = start + cc
                if pos // ps < mp and int(trow[pos // ps]) >= 0:
                    page = int(trow[pos // ps])
                    k_pool[page, pos % ps, h] = kq[cc, h]
                    v_pool[page, pos % ps, h] = vq[cc, h]
                    if writes is not None:
                        writes[h, cc] += 1
            s_end = min(start + c0 + n_rows, reach)
            pos = torch.arange(s_end)
            src = torch.tensor([source(p) for p in range(s_end)], dtype=torch.int64)[:, None]
            page = trow.long()[pos // ps].clamp(min=0)
            kf = torch.where(src >= 0, kq[src[:, 0].clamp(min=0), h],
                             k0[page, pos % ps, h]).float()
            vf = torch.where(src >= 0, vq[src[:, 0].clamp(min=0), h],
                             v0[page, pos % ps, h]).float()
            qi = torch.arange(n_rows * g)
            rows_q = q[c0 + qi // g, h * g + qi % g] * 2.0 ** -K_N
            parts = split3(rows_q)
            vis = start + c0 + qi // g
            folds = []
            for lo, hi in _ranges(s_end, ranks):
                m, l, acc = _walk(parts, kf, vf, vis, lo, hi, scale2)
                folds.append(_fold(m * LN2, l, acc * v_scale))      # the streams
            m, l, acc = (torch.stack(x) for x in zip(*folds))
            _, l, acc = _fold(m, l, acc)                             # the ranks
            out[c0 + qi // g, h * g + qi % g] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out


def _dense(q, kc, vc, k_cache, v_cache, slot, start, ranks):
    """The dense entry: slot `slot` of the cache is pool page `slot` of
    page size S under the table row {slot}."""
    row = torch.tensor([slot], dtype=torch.int32)
    return emulate_chunk(q, kc, vc, k_cache, v_cache, row, start, ranks)


# --------------------------------------------------------------------------
# Dense
# --------------------------------------------------------------------------

DENSE = [(ranks, d, g, c) for ranks, gc in ((1, (3, 32)), (2, (1, 16)), (4, (16, 32)),
                                            (8, (3, 1)))
         for d in (16, 32, 64, 128) for g, c in [gc]]


@pytest.mark.parametrize("ranks,d,g,c", DENSE)
def test_emulated_chunk_matches_plain_and_pallas_dense(ranks, d, g, c):
    """S=600 (nine 64-position tiles), slot 1 of 3, the chunk's end 8 rows
    short of S: R = 8 leaves the last rank a partial tile and the first
    ones the whole prefix."""
    rng = np.random.default_rng(1000 * ranks + d + g + c)
    hkv, s, b, slot = 2, 600, 3, 1
    start = s - 8 - c
    q, kc, vc = _chunk(rng, c, g, hkv, d)
    kcache, vcache = (_post_norm_codes(rng, (b, s, hkv, d)) for _ in range(2))
    ek, ev = _t(kcache.copy(), vcache.copy())
    got = _dense(*_t(q, kc, vc), ek, ev, slot, start, ranks)
    pk, pv = _t(kcache.copy(), vcache.copy())
    plain = ref.qchunk_attn_ref(*_t(q, kc, vc), pk, pv, K_N, V_N, slot, start)
    pallas, jk, jv = qchunk_attn_pallas(
        *(jnp.asarray(x) for x in (q, kc, vc, kcache, vcache)), jnp.int32(K_N), jnp.int32(V_N),
        jnp.int32(slot), jnp.int32(start), interpret=True)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=RTOL, atol=ATOL)
    for mine, want in ((ek, pk), (ev, pv), (ek, torch.from_numpy(np.array(jk))),
                       (ev, torch.from_numpy(np.array(jv)))):
        assert torch.equal(mine, want)


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_emulated_chunk_at_a_short_prefix_keeps_masked_ranks_out_of_the_fold(ranks):
    """G=1, C=32 at start 40 (s_end 72, two tiles): at R >= 2 the rank
    holding positions 64..71 sees only masked positions (-1e30) for rows
    0..23, and ranks past the second tile are empty; both fold with weight
    0.  Start 0 puts every tile's prefix in one tile."""
    for start in (40, 0):
        rng = np.random.default_rng(ranks + start)
        q, kc, vc = _chunk(rng, 32, 1, 2, 32)
        kcache, vcache = (_post_norm_codes(rng, (2, 128, 2, 32)) for _ in range(2))
        ek, ev = _t(kcache.copy(), vcache.copy())
        got = _dense(*_t(q, kc, vc), ek, ev, 0, start, ranks)
        pk, pv = _t(kcache.copy(), vcache.copy())
        plain = ref.qchunk_attn_ref(*_t(q, kc, vc), pk, pv, K_N, V_N, 0, start)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)
        assert torch.equal(ek, pk) and torch.equal(ev, pv)


@pytest.mark.parametrize("ranks", [1, 8])
def test_emulated_chunk_of_one_row_equals_decode(ranks):
    """C = 1 is decode at kv_len start + 1 over the written cache."""
    rng = np.random.default_rng(ranks)
    hkv, g, d, s, start = 2, 3, 64, 600, 517
    q, kc, vc = _chunk(rng, 1, g, hkv, d)
    kcache, vcache = (_post_norm_codes(rng, (2, s, hkv, d)) for _ in range(2))
    ek, ev = _t(kcache, vcache)
    got = _dense(*_t(q, kc, vc), ek, ev, 1, start, ranks)
    qd = torch.zeros(2, g * hkv, d)
    qd[1] = torch.from_numpy(q[0])
    dec = ref.qdecode_attn_ref(qd, ek, ev, K_N, V_N, torch.tensor([1, start + 1]))
    np.testing.assert_allclose(got[0].numpy(), dec[1].numpy(), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# Paged
# --------------------------------------------------------------------------

def _paged_case(rng, c, g, d, ps, mp, start):
    hkv = 2
    n_pool = 2 * mp + 3
    q, kc, vc = _chunk(rng, c, g, hkv, d)
    kp, vp = (_post_norm_codes(rng, (n_pool, ps, hkv, d)) for _ in range(2))
    row = rng.permutation(n_pool)[:mp].astype(np.int32)
    return q, kc, vc, kp, vp, row, start


def _paged_all(ranks, q, kc, vc, kp, vp, row, start, pallas=True):
    """(emulated out, pools, writers), (plain out, pools) and repro's oracle
    (and Pallas kernel) answers."""
    c, hkv = q.shape[0], kc.shape[1]
    ek, ev = _t(kp.copy(), vp.copy())
    writes = torch.zeros(hkv, c, dtype=torch.int64)
    got = emulate_chunk(*_t(q, kc, vc), ek, ev, torch.from_numpy(row), start, ranks, writes)
    pk, pv = _t(kp.copy(), vp.copy())
    plain = ref.qpaged_chunk_attn_ref(*_t(q, kc, vc), pk, pv, K_N, V_N, torch.from_numpy(row),
                                      start)
    jargs = [jnp.asarray(x) for x in (q, kc, vc, kp, vp)]
    wants = [j_ref.qpaged_chunk_attn_ref(*jargs, K_N, V_N, jnp.asarray(row), start)]
    if pallas:
        wants.append(qpaged_chunk_attn_pallas(*jargs, jnp.int32(K_N), jnp.int32(V_N),
                                              jnp.asarray(row), jnp.int32(start),
                                              interpret=True))
    return ((got, ek, ev, writes), (plain, pk, pv),
            [tuple(np.asarray(x) for x in w) for w in wants])


def _hold(mine, plain, wants):
    got, ek, ev = mine[:3]
    np.testing.assert_allclose(got.numpy(), plain[0].numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(ek, plain[1]) and torch.equal(ev, plain[2])
    for wo, wk, wv in wants:
        np.testing.assert_allclose(got.numpy(), wo, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(ek.numpy(), wk)
        np.testing.assert_array_equal(ev.numpy(), wv)


PAGED = [(ranks, d, g, c) for ranks in (1, 2, 4, 8)
         for d, g, c in [((16, 3, 16), (32, 16, 32), (64, 1, 1), (128, 3, 32))[ranks.bit_length() - 1]]]


@pytest.mark.parametrize("ranks,d,g,c", PAGED)
def test_emulated_paged_chunk_matches_plain_oracle_and_pallas(ranks, d, g, c):
    """A fragmented, out-of-order row of 36 pages of 16 (reach 576), the
    chunk ending 20 rows short of it; pools equal, one writer per row."""
    rng = np.random.default_rng(10 * ranks + d)
    case = _paged_case(rng, c, g, d, 16, 36, 576 - 20 - c)
    mine, plain, wants = _paged_all(ranks, *case)
    _hold(mine, plain, wants)
    assert bool((mine[3] == 1).all())


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_emulated_paged_chunk_drops_the_tail_past_the_table(ranks):
    """Page size 5 (an odd tile edge), 40 pages (reach 200), C=32 at start
    184: rows 200.. are dropped (no writer), and the queries see positions
    up to the table's end only."""
    rng = np.random.default_rng(100 + ranks)
    case = _paged_case(rng, 32, 3, 32, 5, 40, 184)
    mine, plain, wants = _paged_all(ranks, *case)
    _hold(mine, plain, wants)
    assert bool((mine[3][:, :16] == 1).all()) and not bool(mine[3][:, 16:].any())


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_emulated_paged_chunk_unmapped_entries_read_page_zero(ranks):
    """Logical pages 2 and 9 are unmapped (-1): their positions read pool
    page 0.  The chunk (C=32 at start 160, page size 16) is written through
    logical page 10, which maps pool page 0, so positions 32..47 and
    144..159 read the codes this launch writes there; logical page 11 is
    unmapped, so chunk rows 16..31 are dropped (no writer) and read page 0
    as well.  Held to the plain version and repro's oracle."""
    rng = np.random.default_rng(200 + ranks)
    q, kc, vc, kp, vp, row, start = _paged_case(rng, 32, 3, 64, 16, 12, 160)
    hit = np.nonzero(row == 0)[0]
    if len(hit):
        row[hit[0]] = row[10]
    row[10] = 0
    row[[2, 9, 11]] = -1
    mine, plain, wants = _paged_all(ranks, q, kc, vc, kp, vp, row, start, pallas=False)
    _hold(mine, plain, wants)
    assert bool((mine[3][:, :16] == 1).all()) and not bool(mine[3][:, 16:].any())
    kq = qformat.quantize(torch.from_numpy(kc), K_N, 8)
    assert torch.equal(mine[1][0, :, :], kq[:16])      # page 0 holds the chunk's rows 0..15


# --------------------------------------------------------------------------
# The rules
# --------------------------------------------------------------------------

def test_chunk_tiles_cover_the_chunk_in_whole_rows():
    for g in range(1, 17):
        for c in list(range(1, 70)) + [127, 512]:
            tiles, rows = attn_split.chunk_tiles(c, g)
            assert rows * g <= attn_split.CHUNK_QUERIES
            assert (tiles - 1) * rows < c <= tiles * rows         # no tile is empty
            assert tiles == math.ceil(c / (attn_split.CHUNK_QUERIES // g))


SHAPES = [(walk, tiles, hkv, d) for walk in (1, 16, 63, 64, 192, 256, 1000, 2048, 32768)
          for tiles in (1, 4, 16) for hkv in (1, 3, 8) for d in (16, 32, 64, 128)]


def test_chunk_rule_is_a_power_of_two_up_to_eight_and_leaves_no_rank_empty():
    """At a chunk whose last query sees the table's end every rank has a
    tile, for every shape."""
    for walk, tiles, hkv, d in SHAPES:
        r = attn_split.chunk_ranks(walk, tiles, hkv, d)
        assert r in (1, 2, 4, 8)
        assert all(lo < hi for lo, hi in _ranges(walk, r)), (walk, tiles, hkv, d, r)


def test_chunk_rule_depends_on_shapes_alone():
    """Its inputs are the launch's shapes (ints); never start, which may
    live on the card."""
    assert list(inspect.signature(attn_split.chunk_ranks).parameters) == \
        ["walk", "tiles", "hkv", "d"]
    for shape in SHAPES[::5]:
        assert attn_split.chunk_ranks(*shape) == attn_split.chunk_ranks(*shape)
    with pytest.raises(ValueError):
        attn_split.chunk_ranks(0, 4, 3, 64)


@pytest.mark.parametrize("walk,c,g,want", [(192, 32, 3, 2), (2048, 32, 3, 8), (2048, 1, 3, 8),
                                           (2048, 16, 3, 8), (192, 16, 3, 2), (2048, 32, 16, 4)])
def test_chunk_rule_at_the_smoke_run_shapes(walk, c, g, want):
    """``chip_smoke.py``'s shapes (Hkv=3, D=64): a cluster of 8 at S=2048,
    2 at the serving cache (S=192), 4 where G=16 makes 16 query tiles."""
    assert attn_split.chunk_ranks(walk, attn_split.chunk_tiles(c, g)[0], 3, 64) == want


@pytest.mark.parametrize("s_end", [1, 63, 64, 65, 600, 2016])
def test_chunk_rank_ranges_cover_the_prefix_in_order(s_end):
    for ranks in (1, 2, 4, 8):
        ranges = _ranges(s_end, ranks)
        assert ranges[0][0] == 0 and ranges[-1][1] == s_end
        assert all(a[1] == b[0] or b[0] >= b[1] for a, b in zip(ranges, ranges[1:]))
        assert all(lo % TILE == 0 for lo, hi in ranges if lo < hi)
